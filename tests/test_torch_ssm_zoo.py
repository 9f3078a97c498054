"""The recurrent families on the port, against the JAX package, on the CPU:
RWKV6 (attention-free; time mix with a data-dependent decay, channel mix)
and Hymba (windowed GQA attention beside Mamba heads, averaged), each at
its SMOKE config on the reference's own parameters (JAX ``init_params``
through numpy and ``params_from_numpy``; the ``tmix``, ``cmix`` and
``mamba`` subtrees cross unchanged).

* Serving: a prefill of 12 tokens and 12 greedy decode steps through plain
  ``TorchOps`` against ``JOps``, ``QuantJOps(12)`` and ``FormatQuantJOps``
  against the reference's unrolled backends; tokens equal (a mismatch
  reports the top-1 gap). Tolerances are those of
  ``tests/_torch_serve_parity.py::check_steps`` as its callers state
  them: plain, logits within 2e-6 and the cache within 1e-5 (a recurrent
  state, whose entries grow past 1, within 1e-5 of its largest magnitude:
  Hymba's h_ssm reaches ~5 and moved by 1.24e-5); k = 12 and the
  format map, logits within 1e-3 and k and v within one ulp at the
  coarsest k the products run at of themselves plus one ulp of their
  largest value (``tests/test_torch_zoo.py``'s k rule). Two widenings:
  the recurrent state and the token-shift rows (RWKV's S, x_tm and x_cm,
  Hymba's h_ssm) each add up several rounded products (a residual sum, a
  sum over steps), so one product that crosses a rounding boundary moves
  them by more than one ulp: within one ulp of themselves plus two of
  their largest value (1.6 measured, Hymba's h_ssm at k = 12); and under
  the format map Hymba's attention runs at k = 8, whose one-ulp moves
  reach the logits through the averaged heads: logits within one ulp at
  k = 8 of the largest logit, 2^(1-k)·max|logits| (1.7e-3 measured, the
  MoE models' rule in ``tests/test_torch_zoo.py``).
* Decode against a full forward (no cache) of the same tokens, from a
  28-token prompt to 36 tokens: past a chunk of 32 for RWKV, past the
  window of 16 for Hymba; within 2e-6 of the port's full forward and of
  the reference's.
* Hymba's decode attention goes to ``bk.windowed_decode_attention`` with
  the window, never to ``decode_attention``.
* Parameter shapes and ``analytic_params`` at SMOKE and FULL equal the
  reference's; ``init_params`` draws each leaf of the recurrent blocks
  with the reference's distribution.
* ``certify_lm`` (uniform, k_max 24, the profile of ``tests/
  _torch_nano.py``): decisions equal — required k, satisfied formats, the
  probes — and the final bound within 1e-5 relative (it reads the exact
  enclosure of the logits, as in ``tests/test_torch_zoo.py``).
* The layer-stacked analyses equal the eager ones (the port's own
  invariant, as ``chip_smoke.py``'s ``ranges`` phase holds it).
* The CLIs ``serve`` and ``analyze`` at SMOKE.
"""
import _torch_test_setup  # noqa: F401  (before any reference compile)
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import certify as jcertify
from repro import configs as jconfigs
from repro.core.backend import JOps
from repro.launch import serve as jserve
from repro.launch.batching import make_backend
from repro.models import transformer as JT
from repro_torch import certify as tcertify
from repro_torch import configs as tconfigs
from repro_torch.core.backend import TorchOps
from repro_torch.launch import analyze as tanalyze
from repro_torch.launch import serve as tserve
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from _torch_serve_parity import top1_gap
from test_torch_zoo import B, MAX_SEQ, PROMPT, both, serve_both

ARCHS = ("rwkv6_1p6b", "hymba_1p5b")
# RWKV's products all run in layer{i} (no sub-scope), Hymba's Mamba heads
# too: the layer* key reaches them
FMT_MAP = {"": {"k": 11, "emax": 15, "emin": -14},
           "layer*": {"k": 10, "emax": 15, "emin": -14},
           "layer*/attn": {"k": 8, "emax": 15, "emin": -14},
           "layer0/mlp": {"k": 9, "emax": 7, "emin": -6}}
CERT_BOUND_REL = 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_subtrees_cross_unchanged(arch):
    _, jp, _, tp = both(arch)
    blocks = ("tmix", "cmix") if arch == "rwkv6_1p6b" else ("mamba",)
    for block in blocks:
        j, t = jp["layers"][block], tp["layers"][block]
        assert set(j) == set(t)
        for name in j:
            assert t[name].dtype == torch.float32
            assert np.array_equal(t[name].numpy(), np.asarray(j[name])), (
                block, name)


RECURRENT = ("S", "x_tm", "x_cm", "h_ssm")


def check_steps(arch, steps, logit_atol, cache_tol):
    for i, (jl, tl, jc, tc) in enumerate(steps):
        jtok, ttok = jl.argmax(-1), tl.argmax(-1)
        assert np.array_equal(jtok, ttok), (
            f"{arch} step {i}: tokens {jtok} vs {ttok}; top-1 gap "
            f"{top1_gap(jl)}")
        np.testing.assert_allclose(tl, jl, rtol=0, atol=logit_atol(jl))
        for name in jc:
            want, got = np.asarray(jc[name]), tc[name].numpy()
            assert got.shape == want.shape, name
            if name == "idx":
                assert np.array_equal(got, want)
            else:
                cache_tol(name, got, want)


def _k_cache_tol(k):
    def tol(name, got, want):
        u = 2.0 ** (1 - k)
        ulps = 2 if name in RECURRENT else 1
        np.testing.assert_allclose(got, want, rtol=u,
                                   atol=ulps * u * float(np.abs(want).max()),
                                   err_msg=name)
    return tol


@pytest.mark.parametrize("path", ("plain", "k12", "format"))
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_steps_match_jax(arch, path):
    if path == "plain":
        def cache_tol(name, got, want):
            scale = (max(1.0, float(np.abs(want).max()))
                     if name in RECURRENT else 1.0)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale,
                                       err_msg=name)

        steps = serve_both(arch, JOps(jnp.float32, jnp.float32), TorchOps())
        check_steps(arch, steps, lambda jl: 2e-6, cache_tol)
        return
    kw = (dict(precision_k=12) if path == "k12"
          else dict(precision_layer_format=FMT_MAP))
    sc = jserve.ServeConfig(arch=arch, batch=B, max_seq=MAX_SEQ, **kw)
    jbk = make_backend(sc, unrolled=True)
    tbk = tserve._backend(tserve.ServeConfig(arch=arch, **kw))
    steps = serve_both(arch, jbk, tbk)
    k = 12 if path == "k12" else 8
    if path == "format" and arch == "hymba_1p5b":
        logit_atol = lambda jl: max(1e-3, 2.0 ** (1 - k) * np.abs(jl).max())
    else:
        logit_atol = lambda jl: 1e-3
    check_steps(arch, steps, logit_atol, _k_cache_tol(k))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_past_a_chunk_and_the_window_equals_a_full_forward(arch):
    """Every cached decode step's logits equal the last position of a full
    forward (no cache) of the same tokens within 2e-6, and the JAX
    package's full forward's; the sequence runs from 28 to 36 tokens."""
    jcfg, jp, tcfg, tp = both(arch)
    prompt, steps = 28, 8
    bk = TorchOps()
    toks = np.random.RandomState(2).randint(0, tcfg.vocab, (B, prompt))
    cache = TT.init_cache(tcfg, B, prompt + steps + 1, device="cpu")
    with torch.no_grad():
        lg, cache = tserve.prefill_step(bk, tp, tcfg, cache,
                                        torch.from_numpy(toks))
        tok = torch.argmax(lg[:, -1], -1)
        seq = np.concatenate([toks, tok.numpy()[:, None]], 1)
        for i in range(steps):
            tok, last, cache = tserve.decode_step(bk, tp, tcfg, cache,
                                                  tok[:, None], prompt + i)
            full, _ = TT.forward(bk, tp, tcfg, torch.from_numpy(seq))
            torch.testing.assert_close(last, full[:, -1], rtol=0, atol=2e-6)
            seq = np.concatenate([seq, tok.numpy()[:, None]], 1)
    assert seq.shape[1] - 1 > 32
    jfull, _ = JT.forward(JOps(jnp.float32, jnp.float32), jp, jcfg,
                          jnp.asarray(seq[:, :-1]))
    np.testing.assert_allclose(last.numpy(), np.asarray(jfull[:, -1]),
                               rtol=0, atol=2e-6)


class _WindowedOps(TorchOps):
    """TorchOps recording each windowed decode call's (scope, window)."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def windowed_decode_attention(self, q, k, v, lengths, window, softcap):
        self.calls.append(("/".join(self.scope_path), window, softcap))
        return None


def test_hymba_decode_goes_to_the_windowed_route():
    _, _, tcfg, tp = both("hymba_1p5b")
    bk = _WindowedOps()
    bk.decode_attention = lambda *a: pytest.fail("fused hook offered")
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, tcfg.vocab, (B, PROMPT)))
    cache = TT.init_cache(tcfg, B, MAX_SEQ, device="cpu")
    with torch.no_grad():
        lg, cache = tserve.prefill_step(bk, tp, tcfg, cache, toks)
        tok = torch.argmax(lg[:, -1], -1)
        for i in range(3):
            tok, _, cache = tserve.decode_step(bk, tp, tcfg, cache,
                                               tok[:, None], PROMPT + i)
    assert bk.calls == [("layer0/attn", 16, 0.0),
                        ("layer1/attn", 16, 0.0)] * 3


def _extra_leaves(cfg):
    """Parameters ``analytic_params`` does not count: norm gains, RWKV's
    token-shift mixes, w0, u and ln_out, Mamba's A_log and D."""
    d, L = cfg.d_model, cfg.n_layers
    if cfg.rwkv:
        return L * 12 * d + d
    return L * (2 * d + cfg.ssm_state + cfg.mamba_expand * d) + d


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_and_counts_match_reference(arch):
    jcfg, jp, tcfg, tp = both(arch)
    jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    assert TT.param_shapes(tcfg) == jshapes
    own = TT.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), own) == jshapes
    for size in ("SMOKE", "FULL"):
        jc = getattr(jconfigs.get(arch), size)
        tc = getattr(tconfigs.get(arch), size)
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert TT.analytic_params(tc) == JT.analytic_params(jc)
    n = sum(t.numel() for t in jax.tree_util.tree_leaves(tp))
    assert n == TT.analytic_params(tcfg) + _extra_leaves(tcfg)
    full = tconfigs.get(arch).FULL
    assert 1.5e9 < TT.analytic_params(full) < 1.7e9


# (mean, std) of each random leaf; the rest are constants
_DRAWN = {"u": 0.3, "wB": 0.01, "w_dt": 0.1}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_follow_the_reference_distributions(arch):
    """Each leaf of the recurrent blocks, drawn by the port at a width of
    256: constants exact (mu_* 0.5, w0 −0.6, ln_out and D ones, A_log
    log(1..N) in every layer), the rest N(0, σ²) with σ the reference's
    (u 0.3, wB 0.01, w_dt 0.1, every other dense weight 1/√fan_in): the
    sample mean within 5 standard errors of 0, the sample σ within 10 %."""
    cfg = dataclasses.replace(tconfigs.get(arch).SMOKE, d_model=256,
                              d_ff=512)
    p = TT.init_params(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")["layers"]
    blocks = ("tmix", "cmix") if cfg.rwkv else ("mamba",)
    seen = 0
    for block in blocks:
        for name, t in p[block].items():
            seen += 1
            if name.startswith("mu_"):
                assert torch.equal(t, torch.full_like(t, 0.5))
            elif name == "w0":
                assert torch.equal(t, torch.full_like(t, -0.6))
            elif name in ("ln_out", "D"):
                assert torch.equal(t, torch.ones_like(t))
            elif name == "A_log":
                N = cfg.ssm_state
                want = torch.log(torch.linspace(1.0, N, N))
                assert torch.equal(t, want.expand_as(t))
            else:
                sigma = _DRAWN.get(name, 1.0 / math.sqrt(t.shape[-2]))
                n = t.numel()
                assert abs(float(t.mean())) < 5 * sigma / math.sqrt(n), name
                assert abs(float(t.std()) / sigma - 1) < 0.1, (name, sigma)
    assert seen == (len(TS.rwkv_tmix_shapes(8, 2))
                    + len(TS.rwkv_cmix_shapes(8, 8)) if cfg.rwkv
                    else len(TS.mamba_shapes(8, 16)))


@pytest.mark.parametrize("arch", ARCHS)
def test_certify_lm_decisions_match_reference(arch, tmp_path):
    jcfg, jp, tcfg, tp = both(arch)
    kw = dict(seq=6, batch=2, seed=0, k_max=24)
    js = jcertify.certify_lm(arch, jcfg, jp, **kw,
                             store=jcertify.CertificateStore(
                                 str(tmp_path / "j")))
    ts = tcertify.certify_lm(arch, tcfg, tp, **kw,
                             store=tcertify.CertificateStore(
                                 str(tmp_path / "t")))
    assert len(js.certificates) == len(ts.certificates) > 0
    for a, b in zip(js.certificates, ts.certificates):
        assert a.class_key == b.class_key
        assert a.required_k == b.required_k
        assert a.satisfied_by == b.satisfied_by
        assert a.layer_k == b.layer_k
        assert a.meta.get("sample_next_tokens") == \
            b.meta.get("sample_next_tokens")
        x, y = a.final_abs_u, b.final_abs_u
        assert x == y or abs(x - y) <= CERT_BOUND_REL * max(abs(x), abs(y))
        assert [r["name"] for r in a.trace_summary] == \
            [r["name"] for r in b.trace_summary]
    assert js.meta["probes"] == ts.meta["probes"]
    assert js.serving_k == ts.serving_k


@pytest.mark.parametrize("arch", ARCHS)
def test_stacked_passes_equal_the_eager_ones(arch, tmp_path):
    """The layer-stacked analyses (``StackedCaaOps``, the stacked IA range
    pass with attn / mlp lanes, the stacked affine pass) run through the
    recurrences and equal the eager unroll, value for value and scope for
    scope; ``certify_lm`` mixed + formats runs to a set (here, on random
    weights, one that certifies nothing)."""
    from repro_torch.certify.tokens import profile_tokens
    from repro_torch.core import analyze as TA
    from repro_torch.core import caa as TC
    from repro_torch.core import formats as TF
    from repro_torch.core.backend import CaaOps, StackedCaaOps

    _, _, tcfg, tp = both(arch)
    toks = profile_tokens(1, 1, 8, tcfg.vocab)

    def forward(bk, params, x):
        logits, _ = TT.forward(bk, params, tcfg, toks)
        return TC.slice_(logits, (slice(None), slice(-1, None)))

    x = TC.make(torch.zeros((1, 1), dtype=torch.float64))
    cfg = TC.CaaConfig(u_max=2.0 ** -20)
    eager, stacked = forward(CaaOps(cfg), tp, x), forward(StackedCaaOps(cfg),
                                                         tp, x)
    for name in ("val", "dbar", "ebar"):
        assert torch.equal(getattr(eager, name), getattr(stacked, name))
    keys = [f"layer{i}" for i in range(tcfg.n_layers)] + ["embed", "head"]
    sub = () if tcfg.rwkv else ("attn", "mlp")
    fmts = {"layer*": TF.custom(12)}
    for a, b in (
            (TA.analyze_ranges(forward, tp, x, cfg, keys=keys),
             TA.analyze_ranges_stacked(forward, tp, x, cfg, keys=keys,
                                       sublanes=sub)),
            (TA.analyze_ranges_affine(forward, tp, x, fmts, TF.custom(14),
                                      keys=keys, stacked=False),
             TA.analyze_ranges_affine(forward, tp, x, fmts, TF.custom(14),
                                      keys=keys, stacked=True,
                                      sublanes=sub))):
        assert set(a) == set(b)
        for key in a:
            assert a[key].to_dict() == b[key].to_dict(), key
    cs = tcertify.certify_lm(arch, tcfg, tp, seq=6, batch=2, seed=0,
                             k_max=24, mixed=True, formats=True,
                             store=tcertify.CertificateStore(str(tmp_path)))
    assert len(cs.certificates) == 1 and cs.serving_layer_format is None


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_and_analyze_clis_at_smoke(arch, capsys):
    cfg = tconfigs.get(arch).SMOKE
    for extra in ([], ["--precision-k", "12"],
                  ["--layer-format", '{"": {"k": 12, "emax": 15, '
                                     '"emin": -14}}']):
        res = tserve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                           "--prefill-len", "20", "--decode-steps", "3",
                           *extra])
        assert res.cfg == cfg and res.tokens.shape == (2, 4)
        assert bool(((res.tokens >= 0) & (res.tokens < cfg.vocab)).all())
        for lg in [res.prefill_logits] + res.decode_logits:
            assert bool(torch.isfinite(lg).all())
    out = tanalyze.main(["--device", "cpu", "--arch", arch, "--k", "12",
                         "--seq", "6"])
    assert math.isfinite(out["abs_u"]) and out["trace"]
    assert f"=== {arch} (reduced config)" in capsys.readouterr().out
    assert tconfigs.get(arch.replace("_1p6b", "-1.6b").replace(
        "_1p5b", "-1.5b")) is tconfigs.get(arch)
