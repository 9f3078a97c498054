"""The port's analysis driver (``repro_torch.core.analyze``) on the paper's
three models against the JAX package's, on the CPU, at narrow widths
(Digits 784→32→16→10, Pendulum h 16, ConvNet with c1 4, c2 8 on a 12×12
crop of a digit), on JAX-initialised and briefly JAX-trained parameters
handed over through numpy.

Tolerances: δ̄/ε̄ (final, per class, per layer and per sensitivity probe)
within a relative 1e-9 (the rules are the reference's; f64 sums differ in
order); required k, decisions, trace names and scopes equal; certified
decisions equal the f64 model's argmax (no violation) and the reference's
certification of the same inputs.
"""
import _torch_test_setup  # noqa: F401  (before any reference compile)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analyze as JA
from repro.core import caa as JC
from repro.core import precision as JP
from repro.core.backend import CaaOps as JCaaOps
from repro.core.backend import JOps
from repro.data import synthetic_digits as jdigits
from repro.models import paper_models as JPM
from repro_torch.convert import params_from_numpy
from repro_torch.core import analyze as TA
from repro_torch.core import caa as TC
from repro_torch.core import precision as TP
from repro_torch.core.backend import CaaOps, TorchOps
from repro_torch.data import synthetic_digits as tdigits
from repro_torch.models import paper_models as TPM

RTOL = 1e-9


def _to_torch(jp):
    host = jax.tree_util.tree_map(
        lambda a: np.asarray(a) if isinstance(a, jax.Array) else a, jp)
    return params_from_numpy(host, "cpu")


def _train(forward_logits, params, imgs, labels, steps, lr=0.2):
    bk = JOps()

    def loss_fn(p, x, y):
        lp = jax.nn.log_softmax(forward_logits(bk, p, x))
        return -jnp.take_along_axis(lp, y[:, None], axis=-1).mean()

    step = jax.jit(lambda p, x, y: jax.tree_util.tree_map(
        lambda a, g: a - lr * g, p, jax.grad(loss_fn)(p, x, y)))
    for i in range(steps):
        idx = np.random.RandomState(i).choice(imgs.shape[0], 64)
        params = step(params, jnp.asarray(imgs[idx]),
                      jnp.asarray(labels[idx]))
    return params


@pytest.fixture(scope="module")
def digits():
    imgs, labels = jdigits.make_dataset(300, seed=0)
    jp = JPM.init_digits(jax.random.PRNGKey(0), h1=32, h2=16)
    jp = _train(JPM.digits_logits, jp, imgs, labels, steps=60)
    return jp, _to_torch(jp), imgs, labels


def _close(a, b):
    a, b = float(a), float(b)
    if np.isinf(a) or np.isinf(b):
        assert a == b
    else:
        np.testing.assert_allclose(b, a, rtol=RTOL)


def _same_decision(dj, dt):
    assert (dj is None) == (dt is None)
    if dj is not None:
        assert dj.required_k == dt.required_k
        assert dj.satisfied_by == dt.satisfied_by
        _close(dj.final_abs_bound_u, dt.final_abs_bound_u)
        _close(dj.final_rel_bound_u, dt.final_rel_bound_u)


def _same_layers(lj, lt):
    assert [(r.name, r.kind, tuple(r.shape)) for r in lj] == \
        [(r.name, r.kind, tuple(r.shape)) for r in lt]
    for rj, rt in zip(lj, lt):
        _close(rj.max_dbar, rt.max_dbar)
        _close(rj.max_ebar, rt.max_ebar)
        _close(rj.out_mag, rt.out_mag)


def test_synthetic_digits_copy_is_the_reference():
    a = jdigits.make_dataset(40, seed=3)
    b = tdigits.make_dataset(40, seed=3)
    for x, y in zip(a, b):
        assert isinstance(y, np.ndarray) and x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("cfg_kw", [dict(u_max=2.0 ** -7, emulate_k=8),
                                    dict(u_max=2.0 ** -12)])
def test_analyze_digits(digits, cfg_kw):
    jp, tp, imgs, _ = digits
    x = imgs[0].astype(np.float64)
    jc, tc = JC.CaaConfig(**cfg_kw), TC.CaaConfig(**cfg_kw)
    rj = JA.analyze(JPM.digits_forward, jp, JC.weight(x, jc), p_star=0.6,
                    cfg=jc)
    rt = TA.analyze(TPM.digits_forward, tp, TC.weight(torch.from_numpy(x),
                                                      tc), p_star=0.6, cfg=tc)
    _close(rj.final_abs_u, rt.final_abs_u)
    _close(rj.final_rel_u, rt.final_rel_u)
    _same_decision(rj.decision, rt.decision)
    _same_layers(rj.layers, rt.layers)
    assert rt.analysis_seconds > 0
    assert rt.dominant_layer().name == rj.dominant_layer().name
    if cfg_kw.get("emulate_k"):
        aj = JC.actual_error_in_u(JPM.digits_forward(
            JCaaOps(jc), jp, JC.weight(x, jc)), jc.u_max)
        at = TC.actual_error_in_u(TPM.digits_forward(
            CaaOps(tc), tp, TC.weight(torch.from_numpy(x), tc)), tc.u_max)
        for a, b in zip(aj, at):
            fin = np.isfinite(np.asarray(a))
            np.testing.assert_allclose(b.numpy()[fin], np.asarray(a)[fin],
                                       rtol=RTOL)


def _class_inputs(imgs, labels):
    idx = [int(np.nonzero(labels == c)[0][0]) for c in range(10)]
    return imgs[idx].astype(np.float64)


@pytest.mark.parametrize("ranged", [False, True])
def test_analyze_batched_and_sequential(digits, ranged):
    jp, tp, imgs, labels = digits
    x = _class_inputs(imgs, labels)
    cfg_kw = dict(u_max=2.0 ** -14)
    jc, tc = JC.CaaConfig(**cfg_kw), TC.CaaConfig(**cfg_kw)
    if ranged:
        lo, hi = np.clip(x - 0.01, 0, 1), np.clip(x + 0.01, 0, 1)
        xj = JC.from_range(lo, hi)
        xt = TC.from_range(torch.from_numpy(lo), torch.from_numpy(hi))
    else:
        xj, xt = JC.weight(x, jc), TC.weight(torch.from_numpy(x), tc)
    bj = JA.analyze_batched(JPM.digits_forward, jp, xj, p_star=0.6, cfg=jc)
    bt = TA.analyze_batched(TPM.digits_forward, tp, xt, p_star=0.6, cfg=tc)
    assert bt.n_classes == 10 and bt.scopes == bj.scopes
    for c in range(10):
        for a, b in zip(bj.per_class(c), bt.per_class(c)):
            _close(a, b)
        _same_decision(bj.decisions[c], bt.decisions[c])
    _same_layers(bj.layers, bt.layers)
    # the port's stacked pass equals its own per-class passes
    for c in (0, 4, 9):
        xc = (TC.from_range(torch.from_numpy(lo[c]), torch.from_numpy(hi[c]))
              if ranged else TC.weight(torch.from_numpy(x[c]), tc))
        seq = TA.analyze(TPM.digits_forward, tp, xc, p_star=0.6, cfg=tc)
        np.testing.assert_allclose(bt.per_class(c)[0], seq.final_abs_u,
                                   rtol=RTOL)
        np.testing.assert_allclose(bt.per_class(c)[1], seq.final_rel_u,
                                   rtol=RTOL)
        np.testing.assert_allclose(bt.output_range[0][c].numpy(),
                                   seq.output_range[0].numpy(), rtol=1e-12)
        _same_decision(seq.decision, bt.decisions[c])
    assert ranged or any(d is not None for d in bt.decisions)


def test_decide_iterative_sensitivity_and_plans(digits):
    jp, tp, imgs, _ = digits
    x = imgs[1].astype(np.float64)

    def bounds(PM, CC, ops, xx):
        return lambda u: CC.worst(PM.digits_forward(
            ops(CC.CaaConfig(u_max=u)), jp if CC is JC else tp,
            CC.weight(xx, CC.CaaConfig(u_max=u))))

    dj = JP.decide_iterative(bounds(JPM, JC, JCaaOps, x), p_star=0.6)
    dt = TP.decide_iterative(bounds(TPM, TC, CaaOps, torch.from_numpy(x)),
                             p_star=0.6)
    _same_decision(dj, dt)
    names = ["dense1", "dense2", "dense3", "softmax"]
    jc, tc = JC.CaaConfig(u_max=2.0 ** -14), TC.CaaConfig(u_max=2.0 ** -14)
    xj, xt = JC.weight(x, jc), TC.weight(torch.from_numpy(x), tc)
    sj = JA.sensitivity(JPM.digits_forward, jp, xj, names, jc)
    st = TA.sensitivity(TPM.digits_forward, tp, xt, names, tc)
    assert list(sj) == list(st)
    for n in names:
        _close(sj[n], st[n])
    assert all(st[n] > 0 for n in names)
    plan = lambda ps: [(p.layer, p.k, p.format) for p in ps]
    assert plan(JA.mixed_precision(JPM.digits_forward, jp, xj, 0.6, names,
                                   jc)) == \
        plan(TA.mixed_precision(TPM.digits_forward, tp, xt, 0.6, names, tc))
    assert JA.discover_scopes(JPM.digits_forward, jp, xj, jc) == \
        TA.discover_scopes(TPM.digits_forward, tp, xt, tc) == names
    pred = int(np.argmax(np.asarray(JPM.digits_forward(JOps(), jp, x))))
    for fmt in ("bfloat16", "float16", 16):
        assert JA.verify_classification(JPM.digits_forward, jp, xj, fmt,
                                        pred) == \
            TA.verify_classification(TPM.digits_forward, tp, xt, fmt, pred)


def test_certified_inference_stacked(digits):
    """quickstart step 3 as one stacked pass: every certified decision at
    k = 8 equals the f64 model's argmax, and the port certifies exactly the
    inputs the reference certifies."""
    jp, tp, imgs, _ = digits
    n = 24
    x = imgs[:n].astype(np.float64)
    cfg_kw = dict(u_max=2.0 ** -7, emulate_k=8)
    tc = TA.batch_config(TC.CaaConfig(**cfg_kw), n)
    jc = JA.batch_config(JC.CaaConfig(**cfg_kw), n)
    pt = TPM.digits_forward(CaaOps(tc), tp, TC.weight(torch.from_numpy(x),
                                                      tc))
    pj = JPM.digits_forward(JCaaOps(jc), jp, JC.weight(x, jc))
    exact = TPM.digits_forward(TorchOps(torch.float64), tp,
                               torch.from_numpy(x)).argmax(-1)
    n_cert = n_ok = 0
    for i in range(n):
        pred = int(pt.val[i].argmax())
        assert pred == int(np.argmax(np.asarray(pj.val)[i]))
        cert = TP.classification_safe(pt.exact.lo[i], pt.exact.hi[i], pred)
        assert cert == JP.classification_safe(np.asarray(pj.exact.lo)[i],
                                              np.asarray(pj.exact.hi)[i],
                                              pred)
        if cert:
            n_cert += 1
            n_ok += int(int(exact[i]) == pred)
    assert n_cert > 0 and n_ok == n_cert


def test_pendulum_and_convnet():
    jpp = JPM.init_pendulum(jax.random.PRNGKey(2), h=16)
    tpp = _to_torch(jpp)
    cfg = dict(u_max=2.0 ** -7)
    lo, hi = np.full(2, -6.0), np.full(2, 6.0)
    rj = JA.analyze(JPM.pendulum_forward, jpp, JC.from_range(lo, hi),
                    cfg=JC.CaaConfig(**cfg))
    rt = TA.analyze(TPM.pendulum_forward, tpp,
                    TC.from_range(torch.from_numpy(lo), torch.from_numpy(hi)),
                    cfg=TC.CaaConfig(**cfg))
    _close(rj.final_abs_u, rt.final_abs_u)
    assert np.isfinite(rt.final_abs_u) and rt.final_rel_u == np.inf
    _same_layers(rj.layers, rt.layers)

    jcp = JPM.init_convnet(jax.random.PRNGKey(1), img=12, c1=4, c2=8)
    tcp = _to_torch(jcp)
    imgs, _ = jdigits.make_dataset(2, seed=1)
    x = imgs[:1].reshape(1, 28, 28, 1)[:, 8:20, 8:20].astype(np.float64)
    jc = JC.CaaConfig(u_max=2.0 ** -7, emulate_k=8)
    tc = TC.CaaConfig(u_max=2.0 ** -7, emulate_k=8)
    rj = JA.analyze(JPM.convnet_forward, jcp, JC.weight(x, jc), p_star=0.6,
                    cfg=jc)
    rt = TA.analyze(TPM.convnet_forward, tcp, TC.weight(torch.from_numpy(x),
                                                        tc), p_star=0.6,
                    cfg=tc)
    _close(rj.final_abs_u, rt.final_abs_u)
    _close(rj.final_rel_u, rt.final_rel_u)
    _same_decision(rj.decision, rt.decision)
    _same_layers(rj.layers, rt.layers)


def test_models_under_plain_backends():
    """The paper models run unchanged under TorchOps (f32 and the f64
    'exact model'), equal to JOps's outputs."""
    jdp = JPM.init_digits(jax.random.PRNGKey(3), h1=32, h2=16)
    jcp = JPM.init_convnet(jax.random.PRNGKey(4), img=8, c1=4, c2=8)
    jpp = JPM.init_pendulum(jax.random.PRNGKey(5), h=16)
    rng = np.random.RandomState(0)
    cases = [(JPM.digits_forward, TPM.digits_forward, jdp, rng.rand(3, 784)),
             (JPM.digits_logits, TPM.digits_logits, jdp, rng.rand(3, 784)),
             (JPM.convnet_forward, TPM.convnet_forward, jcp,
              rng.rand(2, 8, 8, 1)),
             (JPM.pendulum_forward, TPM.pendulum_forward, jpp,
              rng.uniform(-6, 6, (5, 2)))]
    for jf, tf, jp, x in cases:
        tp = _to_torch(jp)
        for dt_j, dt_t, tol in ((jnp.float32, torch.float32, 2e-6),
                                (jnp.float64, torch.float64, 1e-13)):
            want = np.asarray(jf(JOps(dt_j, dt_j), jp, jnp.asarray(x)))
            got = tf(TorchOps(dt_t), tp, torch.from_numpy(x))
            assert got.dtype == dt_t
            np.testing.assert_allclose(got.numpy(), want, rtol=tol,
                                       atol=tol)


def test_params_from_numpy_keeps_non_array_leaves():
    jcp = JPM.init_convnet(jax.random.PRNGKey(1), img=8, c1=4, c2=8)
    tcp = _to_torch(jcp)
    assert tcp["meta"] == {"img": 8, "c_in": 1, "ksz": 3}
    assert all(type(v) is int for v in tcp["meta"].values())
    assert isinstance(tcp["k1"], torch.Tensor)
    assert tcp["k1"].dtype == torch.float32
    np.testing.assert_array_equal(tcp["wd"].numpy(), np.asarray(jcp["wd"]))


def test_port_inits_and_device_argument():
    g = torch.Generator().manual_seed(0)
    p = TPM.init_digits(g, h1=32, h2=16, device="cpu")
    assert p["w1"].shape == (784, 32) and p["b3"].shape == (10,)
    assert sum(t.numel() for t in TPM.init_digits(
        torch.Generator().manual_seed(0)).values()) == 784 * 700 + 700 + \
        700 * 256 + 256 + 256 * 10 + 10
    q = TPM.init_digits(torch.Generator().manual_seed(0), h1=32, h2=16)
    assert all(torch.equal(p[k], q[k]) for k in p)
    c = TPM.init_convnet(torch.Generator().manual_seed(1), img=8, c1=4, c2=8)
    assert c["k1"].shape == (9, 4) and c["wd"].shape == (2 * 2 * 8, 10)
    out = TPM.convnet_forward(TorchOps(), c, torch.rand(2, 8, 8, 1))
    assert out.shape == (2, 10)
    pend = TPM.init_pendulum(torch.Generator().manual_seed(2), h=16)
    assert TPM.pendulum_forward(TorchOps(), pend,
                                torch.rand(4, 2)).shape == (4, 1)
