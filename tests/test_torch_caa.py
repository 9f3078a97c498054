"""The port's CAA rules (``repro_torch.core.caa``) and emulated dot products
(``repro_torch.core.quantize``) against the JAX package's on the CPU, on
seeded CaaTensors made with numpy.

Tolerances, per output field:
* ``val``: bit for bit for elementwise rules and shape ops; for a rule
  with a reduction, within one ulp at k when the config emulates k bits,
  else within what two f64 sums of the same terms differ by in another
  order (n·2⁻⁵³·Σ|terms|);
* ``exact``: the port's enclosure contains the reference's midpoint;
* ``dbar``/``ebar``: +inf at the same elements, else within a relative
  1e-12 (the bound expressions are the reference's, evaluated in f64 with
  sums in another order);
* ``seq_dot``/``pairwise_dot``/``kahan_dot``: bit for bit (every step is an
  elementwise rounding).
"""
import _torch_test_setup  # noqa: F401  (before any reference compile)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import caa as JC
from repro.core import interval as JI
from repro.core import quantize as JQ
from repro_torch.core import caa as TC
from repro_torch.core import interval as TI
from repro_torch.core import quantize as TQ

CFGS = {
    "default": dict(),
    "emul11": dict(u_max=2.0 ** -10, emulate_k=11),
    "round_abs": dict(u_max=2.0 ** -12, round_abs=3.0),
}


def _cfgs(name, **extra):
    kw = {**CFGS[name], **extra}
    return JC.CaaConfig(**kw), TC.CaaConfig(**kw)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float64).copy())


def _pair(rng, shape, positive=False, inf_frac=0.3, scale=1.0):
    val = rng.randn(*shape) * scale
    if positive:
        val = np.exp(rng.randn(*shape)) * scale
    r = np.abs(rng.randn(*shape)) * 1e-3 * np.abs(val) + 1e-6
    lo, hi = val - r, val + r
    if positive:
        lo = np.maximum(lo, val * 0.5)
    dbar = np.abs(rng.randn(*shape)) * 5
    ebar = np.abs(rng.randn(*shape)) * 3
    ebar[rng.rand(*shape) < inf_frac] = np.inf
    j = JC.make(val, JI.Interval(jnp.asarray(lo), jnp.asarray(hi)), dbar,
                ebar)
    t = TC.make(_t(val), TI.Interval(_t(lo), _t(hi)), _t(dbar), _t(ebar))
    return j, t


def _bounds_close(a, b):
    a = np.broadcast_to(np.asarray(a, np.float64), b.shape)
    b = b.numpy()
    assert np.array_equal(np.isinf(a), np.isinf(b)), (
        int((np.isinf(a) != np.isinf(b)).sum()))
    f = np.isfinite(a)
    np.testing.assert_allclose(b[f], a[f], rtol=1e-12, atol=1e-300)


def _check(j, t, val_tol=None):
    jv = np.asarray(j.val, np.float64)
    tv = t.val.numpy()
    assert jv.shape == tv.shape
    if val_tol is None:
        assert np.array_equal(jv.view(np.int64), tv.view(np.int64)) or \
            np.array_equal(jv, tv)
    else:
        assert (np.abs(jv - tv) <= val_tol).all(), float(
            np.abs(jv - tv).max())
    mid = 0.5 * (np.asarray(j.exact.lo) + np.asarray(j.exact.hi))
    fin = np.isfinite(mid)
    assert (t.exact.lo.numpy()[fin] <= mid[fin]).all()
    assert (mid[fin] <= t.exact.hi.numpy()[fin]).all()
    _bounds_close(j.dbar, torch.broadcast_to(t.dbar, t.shape))
    _bounds_close(j.ebar, torch.broadcast_to(t.ebar, t.shape))


def _ulp_at_k(v, k):
    _, e = np.frexp(np.abs(v))
    return np.ldexp(1.0, e - k)


@pytest.mark.parametrize("cfg_name", sorted(CFGS))
def test_elementwise_rules(cfg_name):
    jc, tc = _cfgs(cfg_name)
    rng = np.random.RandomState(1)
    (ja, ta), (jb, tb) = _pair(rng, (5, 7)), _pair(rng, (5, 7))
    (jp, tp) = _pair(rng, (5, 7), positive=True)
    for name in ("add", "sub", "mul", "div", "maximum", "minimum"):
        _check(getattr(JC, name)(ja, jb, jc), getattr(TC, name)(ta, tb, tc))
    for name in ("exp", "tanh", "sigmoid", "relu", "square", "silu",
                 "gelu"):
        # transcendental values may differ by libm ulps (within one ulp at
        # k when emulated)
        tol = (_ulp_at_k(np.asarray(getattr(JC, name)(ja, jc).val), 11)
               if tc.emulate_k else 4e-16 * (1 + np.abs(
                   np.asarray(getattr(JC, name)(ja, jc).val))))
        _check(getattr(JC, name)(ja, jc), getattr(TC, name)(ta, tc),
               val_tol=None if name in ("relu", "square") else tol)
    for name in ("log", "sqrt", "rsqrt"):
        jr = getattr(JC, name)(jp, jc)
        tol = (_ulp_at_k(np.asarray(jr.val), 11) if tc.emulate_k
               else 4e-16 * (1 + np.abs(np.asarray(jr.val))))
        _check(jr, getattr(TC, name)(tp, tc), val_tol=tol)
    _check(JC.neg(ja), TC.neg(ta))
    c = rng.randn(7)
    _check(JC.scale_const(ja, jnp.asarray(c), cfg=jc),
           TC.scale_const(ta, _t(c), cfg=tc))
    _check(JC.scale_const(ja, 0.25, exact_const=True, cfg=jc),
           TC.scale_const(ta, 0.25, exact_const=True, cfg=tc))
    _check(JC.shift_const(ja, 1.5, jc), TC.shift_const(ta, 1.5, tc))
    mask = rng.rand(5, 7) > 0.5
    _check(JC.where(jnp.asarray(mask), ja, jb),
           TC.where(torch.from_numpy(mask), ta, tb))
    _check(JC.clamp_exact(ja, -0.5, 0.5), TC.clamp_exact(ta, -0.5, 0.5))
    for u in (2.0 ** -10, 2.0 ** -20):
        jr, tr = ja.fp_range(u), ta.fp_range(u)
        np.testing.assert_array_equal(np.asarray(jr.lo), tr.lo.numpy())
        np.testing.assert_array_equal(np.asarray(jr.hi), tr.hi.numpy())
        for jx, tx in zip(JC.actual_error_in_u(ja, u),
                          TC.actual_error_in_u(ta, u)):
            _bounds_close(jx, tx)


def _weights(rng, shape, exact, jc, tc):
    w = rng.randn(*shape) / np.sqrt(shape[0])
    if exact:
        return JC.weight(w, jc), TC.weight(_t(w), tc)
    return (JC.weight(w, jc, exact=False), TC.weight(_t(w), tc, exact=False))


MATMUL_CASES = {
    "traj_seq": dict(),
    "traj_pairwise": dict(acc_order="pairwise"),
    "gamma_gate": dict(traj_max_elems=16),
    "gamma_off": dict(use_trajectory=False),
    "kahan": dict(acc_order="kahan"),
}


@pytest.mark.parametrize("cfg_name", ["default", "emul11"])
@pytest.mark.parametrize("case", sorted(MATMUL_CASES))
def test_matmul_rule_both_branches(cfg_name, case):
    jc, tc = _cfgs(cfg_name, **MATMUL_CASES[case])
    rng = np.random.RandomState(2)
    ja, ta = _pair(rng, (3, 4, 30), inf_frac=0.0)
    for exact in (True, False):
        jw, tw = _weights(rng, (30, 9), exact, jc, tc)
        jo, to = JC.matmul(ja, jw, jc), TC.matmul(ta, tw, tc)
        jv = np.asarray(jo.val)
        if tc.emulate_k:
            tol = _ulp_at_k(jv, tc.emulate_k)
        else:
            tol = 30 * 2.0 ** -53 * (np.abs(np.asarray(ja.val))
                                     @ np.abs(np.asarray(jw.val)))
        _check(jo, to, val_tol=tol)
        _check(JC.dense(ja, jw, None, jc), TC.dense(ta, tw, None, tc),
               val_tol=tol)


def test_trajectory_and_gamma_branches_differ_and_both_sound():
    """The two branches give different bounds on the same operands (the
    trajectory one tighter), and the gate picks them as the reference."""
    rng = np.random.RandomState(4)
    ja, ta = _pair(rng, (2, 64), inf_frac=0.0)
    jw, tw = _weights(rng, (64, 8), True, *_cfgs("default"))
    out = {}
    for case in ("traj_seq", "gamma_gate"):
        jc, tc = _cfgs("default", **MATMUL_CASES[case])
        to = TC.matmul(ta, tw, tc)
        _bounds_close(JC.matmul(ja, jw, jc).dbar, to.dbar)
        out[case] = float(to.dbar.max())
    assert out["traj_seq"] < out["gamma_gate"]


@pytest.mark.parametrize("cfg_name", sorted(CFGS))
def test_reductions_einsum_softmax(cfg_name):
    jc, tc = _cfgs(cfg_name)
    rng = np.random.RandomState(3)
    ja, ta = _pair(rng, (4, 6, 10), inf_frac=0.0)
    k = tc.emulate_k
    for name in ("reduce_sum", "reduce_mean"):
        for axis, keep in ((-1, False), (1, True)):
            jo = getattr(JC, name)(ja, axis, keep, jc)
            to = getattr(TC, name)(ta, axis, keep, tc)
            jv = np.asarray(jo.val)
            tol = (_ulp_at_k(jv, k) if k else
                   10 * 2.0 ** -53 * np.asarray(jnp.sum(jnp.abs(ja.val), axis,
                                                        keepdims=keep)))
            _check(jo, to, val_tol=tol)
    _check(JC.reduce_max(ja, 2, False, jc), TC.reduce_max(ta, 2, False, tc))
    jb, tb = _pair(rng, (10, 5), inf_frac=0.0)
    jo = JC.einsum("bij,jk->bik", ja, jb, jc)
    to = TC.einsum("bij,jk->bik", ta, tb, tc)
    jv = np.asarray(jo.val)
    tol = (_ulp_at_k(jv, k) if k else 10 * 2.0 ** -53 * np.einsum(
        "bij,jk->bik", np.abs(np.asarray(ja.val)), np.abs(np.asarray(jb.val))))
    _check(jo, to, val_tol=tol)
    js, ts = JC.softmax(ja, -1, jc), TC.softmax(ta, -1, tc)
    jv = np.asarray(js.val)
    _check(js, ts, val_tol=_ulp_at_k(jv, k) if k else 4e-16)


def test_shape_ops_bitwise():
    rng = np.random.RandomState(5)
    ja, ta = _pair(rng, (2, 3, 4))
    jb, tb = _pair(rng, (2, 3, 4))
    _check(JC.reshape(ja, (6, 4)), TC.reshape(ta, (6, 4)))
    _check(JC.transpose(ja, (2, 0, 1)), TC.transpose(ta, (2, 0, 1)))
    _check(JC.broadcast_to(JC.reshape(ja, (1, 2, 3, 4)), (5, 2, 3, 4)),
           TC.broadcast_to(TC.reshape(ta, (1, 2, 3, 4)), (5, 2, 3, 4)))
    _check(JC.concatenate([ja, jb], -1), TC.concatenate([ta, tb], -1))
    idx = np.array([[2, 0], [1, 1]])
    _check(JC.take(ja, jnp.asarray(idx), 1),
           TC.take(ta, torch.from_numpy(idx), 1))
    _check(JC.take(ja, jnp.asarray([3, 0]), 2),
           TC.take(ta, torch.tensor([3, 0]), 2))
    sl = (slice(None), slice(0, 3, 2))
    _check(JC.slice_(ja, sl), TC.slice_(ta, sl))
    assert JC.worst(ja) == TC.worst(ta)


def test_config_gamma_and_constructors():
    for kw in ({}, dict(acc_order="pairwise"), dict(acc_order="kahan"),
               dict(u_max=2.0 ** -3), dict(round_scale=0.0)):
        jc, tc = JC.CaaConfig(**kw), TC.CaaConfig(**kw)
        for n in (1, 2, 7, 100, 4096):
            assert float(jc.gamma(n)) == tc.gamma(n)
        assert jc.half == tc.half and jc.libm == tc.libm
    assert TC.CaaConfig(u_max=0.5).gamma(10) == float("inf")
    with pytest.raises(ValueError):
        TC.CaaConfig(acc_order="tree").gamma(4)
    rng = np.random.RandomState(6)
    lo = rng.rand(3, 4)
    hi = lo + 0.1
    _check(JC.from_range(lo, hi), TC.from_range(_t(lo), _t(hi)))
    _check(JC.const_rounded(jnp.asarray(lo)), TC.const_rounded(_t(lo)))
    cfg = dataclasses.replace(JC.CaaConfig(), emulate_k=8)
    tcfg = TC.CaaConfig(emulate_k=8)
    _check(JC.weight(lo, cfg), TC.weight(_t(lo), tcfg))
    _check(JC.weight(lo, cfg, exact=False),
           TC.weight(_t(lo), tcfg, exact=False))


@pytest.mark.parametrize("fmt", [8, "bfloat16", "float16", 11])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_emulated_dots_bitwise(fmt, dtype):
    rng = np.random.RandomState(7)
    x = (rng.randn(3, 5, 17) * 2).astype(dtype)
    w = (rng.randn(17, 6) / 4).astype(dtype)
    for name in ("seq_dot", "pairwise_dot", "kahan_dot"):
        j = np.asarray(getattr(JQ, name)(jnp.asarray(x), jnp.asarray(w), fmt))
        t = getattr(TQ, name)(torch.from_numpy(x), torch.from_numpy(w),
                              fmt).numpy()
        assert j.dtype == t.dtype
        assert np.array_equal(j, t), (name, float(np.abs(j - t).max()))
    j = np.asarray(JQ.quantize(jnp.asarray(x), fmt))
    t = TQ.quantize(torch.from_numpy(x), fmt).numpy()
    assert np.array_equal(j, t)
    add_j = JQ.quantized_op(jnp.add, fmt)(jnp.asarray(x), jnp.asarray(x))
    add_t = TQ.quantized_op(torch.add, fmt)(torch.from_numpy(x),
                                            torch.from_numpy(x))
    assert np.array_equal(np.asarray(add_j), add_t.numpy())
    exact = x.astype(np.float64) @ w.astype(np.float64)
    approx = TQ.seq_dot(torch.from_numpy(x), torch.from_numpy(w), fmt)
    for a, b in zip(JQ.measured_error_in_u(jnp.asarray(exact),
                                           jnp.asarray(approx.numpy()), fmt),
                    TQ.measured_error_in_u(torch.from_numpy(exact), approx,
                                           fmt)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_backends_share_one_interface():
    """Every op of the port's Backend under TorchOps (f64) and CaaOps
    against the reference's JOps/CaaOps on the same inputs (axes named
    ``dim`` in the port, ``axis`` in the reference); top_k_mask's route and
    recorded margin; scope bookkeeping."""
    from repro.core.backend import CaaOps as JCaaOps
    from repro.core.backend import JOps
    from repro_torch.core.backend import CaaOps, TorchOps

    rng = np.random.RandomState(9)
    a = rng.randn(3, 8)
    b = np.exp(rng.randn(3, 8))
    jb, tb = JOps(jnp.float64, jnp.float64), TorchOps(torch.float64)
    ja_, ta_ = jnp.asarray(a), _t(a)
    jb_, tb_ = jnp.asarray(b), _t(b)
    pairs = [
        (jb.tanh(ja_), tb.tanh(ta_)), (jb.relu(ja_), tb.relu(ta_)),
        (jb.maximum(ja_, jb_), tb.maximum(ta_, tb_)),
        (jb.mean(ja_, 1), tb.mean(ta_, dim=1)),
        (jb.softmax(ja_, -1), tb.softmax(ta_, dim=-1)),
        (jb.take(ja_, jnp.asarray([2, 0]), 1),
         tb.take(ta_, torch.tensor([2, 0]), dim=1)),
        (jb.take(ja_, jnp.asarray([[2, 0]]), 0),
         tb.take(ta_, torch.tensor([[2, 0]]))),
        (jb.concat([ja_, jb_], 0), tb.concat([ta_, tb_], dim=0)),
        (jb.broadcast_to(ja_[None], (2, 3, 8)),
         tb.broadcast_to(ta_[None], (2, 3, 8))),
        (jb.slice(ja_, (slice(None), slice(1, 5, 2))),
         tb.slice(ta_, (slice(None), slice(1, 5, 2)))),
        (jb.softcap(ja_, 2.0), tb.softcap(ta_, 2.0)),
    ]
    for j, t in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-13,
                                   atol=1e-15)
    assert tb.record("x", ta_) is ta_ and tb.clamp_range(ta_, 0, 1) is ta_

    jc, tc = _cfgs("default")
    (jx, tx), (jy, ty) = _pair(rng, (3, 8)), _pair(rng, (3, 8))
    jo, to = JCaaOps(jc), CaaOps(tc)
    _check(jo.sum(jx, 1, True), to.sum(tx, dim=1, keepdim=True),
           val_tol=1e-15 * 8)
    _check(jo.max(jx, 0), to.max(tx, dim=0))
    _check(jo.concat([jx, jy], 1), to.concat([tx, ty], dim=1))
    _check(jo.take(jx, jnp.asarray([1, 1, 0]), 0),
           to.take(tx, torch.tensor([1, 1, 0])))
    _check(jo.const(2.5), to.const(2.5, like=tx))
    _check(jo.softcap(jx, 3.0), to.softcap(tx, 3.0), val_tol=1e-15)
    assert torch.equal(to.value_of(tx), tx.val)
    with to.scope("block"):
        with to.scope("inner"):
            m_t = to.top_k_mask(tx, 2)
    with jo.scope("block"):
        with jo.scope("inner"):
            m_j = jo.top_k_mask(jx, 2)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    rj, rt = jo.trace[-1], to.trace[-1]
    assert (rt.name, rt.kind, rt.shape) == (rj.name, rj.kind, rj.shape) == \
        ("block/inner/router", "router", (3, 8))
    for key in ("min_margin", "flip_safe_if_u_le"):
        np.testing.assert_allclose(rt.extra[key], rj.extra[key], rtol=1e-12)
    assert to.seen_scopes == jo.seen_scopes == ["block", "block/inner"]
    # the recurrence rule (the fixpoint bound of the worst step over the
    # 8 steps of axis 1), its values the f64 scan's
    _check(jo.ssm_scan(jx, jy, 8), to.ssm_scan(tx, ty, 8), val_tol=1e-13)
