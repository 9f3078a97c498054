"""The GQA model zoo on the port, against the JAX package, on the CPU:
Command-R, Gemma-2 (softcapped scores and logits, √d embedding scale,
local / global layers, tanh-GELU), Mixtral (a sliding window on every layer,
MoE top-2) and Llama-4 (MoE top-1), each at its SMOKE config, on the
reference's own parameters (JAX ``init_params`` through numpy and
``params_from_numpy``, the ``moe`` subtree included).

* Serving: a prefill of 12 tokens and 12 greedy decode steps (positions up
  to 24, past the SMOKE window of 16) through plain ``TorchOps`` against
  ``JOps``, ``QuantJOps(12)`` and ``FormatQuantJOps`` against the
  reference's unrolled backends. Tolerances are those of
  ``tests/_torch_serve_parity.py::check_steps`` as its callers state them:
  plain, logits within 2e-6 and cache within 1e-5; k = 12, logits within
  1e-3 and cache within one ulp at k of itself plus one ulp of the largest
  cache value (``tests/test_torch_quant_k.py``); format map, logits within
  1e-3 and cache within one ulp at the attention format's k
  (``tests/test_torch_serve.py``). Tokens equal; a mismatch reports the
  top-1 gap. One widening, for the MoE models under the format map: the
  format path lets a product cross a rounding boundary and move by one ulp
  at its scope's k (an attention output at k = 8, at Mixtral's last step);
  the router rounds its own product at k and its gates are a smooth
  function of it, so that one ulp reaches the logits through the gates:
  logits within one ulp at the attention's k of the largest logit,
  2^(1-k)·max|logits| (2.4e-3 measured, 4.7e-3 allowed), and the cache as
  on the k path.
* The windowed decode route: an S = 1 step of a softcapped or windowed
  model goes to ``bk.windowed_decode_attention`` with the layer's window
  and softcap (kernel 4 on the card); here a backend answering it with the
  kernel's plain version serves the same logits as the composed path
  within the plain tolerance.
* Decode against a full forward (no cache) of the same tokens, past the
  window, within 2e-6 (the MoE models in their ``dense`` mode: capacity
  dropping couples a chunk's tokens by design, so a 48-token forward drops
  other tokens than a 2-token step).
* Parameter shapes, ``analytic_params`` (total and active) at SMOKE and
  FULL, equal to the reference's.
* The analysis: ``CaaOps`` forward at emulated k = 12 on 8 tokens. δ̄ and
  ε̄ of every trace record and the emulated values within 1e-9 relative
  (measured: equal). The records' ``out_mag`` (sup of the exact
  enclosure) within 1e-6: the two packages' f64 interval matmuls add in
  other orders, 2.5e-10 apart relative at the first projection, and
  cancellation in the enclosures' endpoints carries that to 5.7e-7 at
  layer 1's scores (measured op by op on Gemma-2).
* ``certify_lm`` (uniform, k_max 24, the profile of ``tests/
  _torch_nano.py``): decisions equal — required k, satisfied formats, the
  probes — and the final bound within 1e-5 relative (it reads the exact
  enclosure of the logits, above; 3.5e-6 measured on Gemma-2).
* The CLIs at SMOKE: ``serve`` on each arch, ``--max-layers``.

The MoE module itself, Mixtral's and Llama-4's analysis with router
records and their certificates are in ``tests/test_torch_moe.py``.
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
from repro.core import caa as jcaa
from repro.core.backend import CaaOps as JCaaOps
from repro.core.backend import JOps
from repro.launch import serve as jserve
from repro.launch.batching import make_backend
from repro.models import transformer as JT
from repro_torch import certify as tcertify
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core import caa as tcaa
from repro_torch.core.backend import CaaOps as TCaaOps
from repro_torch.core.backend import TorchOps
from repro_torch.kernels import flash_decode as tfd
from repro_torch.launch import serve as tserve
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from _torch_serve_parity import top1_gap

ZOO = ("command_r_35b", "gemma2_27b", "mixtral_8x22b", "llama4_maverick")
MOE = ("mixtral_8x22b", "llama4_maverick")
B, PROMPT, STEPS = 2, 12, 12
MAX_SEQ = PROMPT + STEPS + 1
FMT_MAP = {"": {"k": 11, "emax": 15, "emin": -14},
           "layer*/attn": {"k": 8, "emax": 15, "emin": -14},
           "layer0/mlp": {"k": 9, "emax": 7, "emin": -6}}
K_ATTN_FMT = 8
CAA_REL = 1e-9
OUT_MAG_REL = 1e-6
CERT_BOUND_REL = 1e-5

_PARAMS = {}


def both(arch):
    """(JAX config, JAX params, port config, port params) at SMOKE: the
    reference's ``init_params`` (key 0), carried across through numpy."""
    if arch not in _PARAMS:
        jcfg = jconfigs.get(arch).SMOKE
        tcfg = tconfigs.get(arch).SMOKE
        jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        _PARAMS[arch] = (jcfg, jp, tcfg, tp)
    return _PARAMS[arch]


def serve_both(arch, jbk, tbk):
    """Prefill + STEPS greedy decode steps through both packages, each on
    its own tokens. Returns per-step (j_logits, t_logits, j_cache,
    t_cache)."""
    jcfg, jp, tcfg, tp = both(arch)
    toks = np.random.RandomState(0).randint(0, jcfg.vocab, (B, PROMPT))
    jstep = jax.jit(lambda p, c, t, pos: JT.forward(jbk, p, jcfg, t,
                                                    cache=c, q_offset=pos))
    jc = JT.init_cache(jcfg, B, MAX_SEQ, jnp.float32)
    tc = TT.init_cache(tcfg, B, MAX_SEQ, device="cpu")
    jl, jc = jstep(jp, jc, jnp.asarray(toks), jnp.int32(0))
    with torch.no_grad():
        tl, tc = tserve.prefill_step(tbk, tp, tcfg, tc,
                                     torch.from_numpy(toks))
    snap = lambda c: {k: v.clone() for k, v in c.items()}
    out = [(np.asarray(jl[:, -1]), tl[:, -1].numpy(), jc, snap(tc))]
    jt = jnp.argmax(jl[:, -1], -1)
    tt = torch.argmax(tl[:, -1], -1)
    for i in range(STEPS):
        jl, jc = jstep(jp, jc, jt[:, None], jnp.int32(PROMPT + i))
        with torch.no_grad():
            tt, tlast, tc = tserve.decode_step(tbk, tp, tcfg, tc,
                                               tt[:, None], PROMPT + i)
        jt = jnp.argmax(jl[:, -1], -1)
        out.append((np.asarray(jl[:, -1]), tlast.numpy(), jc, snap(tc)))
    return out


def check_steps(arch, steps, logit_atol, cache_tol):
    cfg = both(arch)[0]
    for i, (jl, tl, jc, tc) in enumerate(steps):
        jtok, ttok = jl.argmax(-1), tl.argmax(-1)
        assert np.array_equal(jtok, ttok), (
            f"{arch} step {i}: tokens {jtok} vs {ttok}; top-1 gap "
            f"{top1_gap(jl)}")
        np.testing.assert_allclose(tl, jl, rtol=0, atol=logit_atol(jl))
        assert np.array_equal(np.asarray(jc["idx"]), tc["idx"].numpy())
        for name in ("k", "v"):
            want = np.asarray(jc[name])
            got = tc[name].numpy()
            assert got.shape == want.shape == (
                cfg.n_layers, B, MAX_SEQ, cfg.n_kv_heads, cfg.head_dim)
            cache_tol(got, want)


def _k_cache_tol(k):
    def tol(got, want):
        u = 2.0 ** (1 - k)
        np.testing.assert_allclose(got, want, rtol=u,
                                   atol=u * float(np.abs(want).max()))
    return tol


PATHS = ("plain", "k12", "format")


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("arch", ZOO)
def test_serving_steps_match_jax(arch, path):
    if path == "plain":
        def cache_tol(got, want):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

        steps = serve_both(arch, JOps(jnp.float32, jnp.float32), TorchOps())
        check_steps(arch, steps, lambda jl: 2e-6, cache_tol)
        return
    kw = (dict(precision_k=12) if path == "k12"
          else dict(precision_layer_format=FMT_MAP))
    sc = jserve.ServeConfig(arch=arch, batch=B, max_seq=MAX_SEQ, **kw)
    jbk = make_backend(sc, unrolled=True)
    tbk = tserve._backend(tserve.ServeConfig(arch=arch, **kw))
    steps = serve_both(arch, jbk, tbk)
    if path == "k12":
        check_steps(arch, steps, lambda jl: 1e-3, _k_cache_tol(12))
    elif arch in MOE:
        u = 2.0 ** (1 - K_ATTN_FMT)
        check_steps(arch, steps,
                    lambda jl: max(1e-3, u * float(np.abs(jl).max())),
                    _k_cache_tol(K_ATTN_FMT))
    else:
        def cache_tol(got, want):
            np.testing.assert_allclose(got, want,
                                       rtol=2.0 ** (1 - K_ATTN_FMT),
                                       atol=1e-6)

        check_steps(arch, steps, lambda jl: 1e-3, cache_tol)


class _PlainWindowedOps(TorchOps):
    """TorchOps answering the windowed decode hook with kernel 4's plain
    version (what the card computes through the kernel), recording each
    call's (scope, window, softcap)."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def windowed_decode_attention(self, q, k, v, lengths, window, softcap):
        self.calls.append(("/".join(self.scope_path), window, softcap))
        return tfd.flash_decode_ref(q, k, v, lengths, window, softcap)


@pytest.mark.parametrize("arch", ("gemma2_27b", "mixtral_8x22b"))
def test_windowed_decode_route_serves_the_composed_attention(arch):
    """Each decode step of Gemma-2 / Mixtral offers every layer to the
    windowed hook with that layer's window and softcap (Gemma-2: layer 0
    local, window 16, layer 1 global; softcap 50 on both; Mixtral: window
    16 on both), never to ``decode_attention``; the kernel's plain
    version there gives the composed path's logits within 2e-6."""
    _, _, tcfg, tp = both(arch)
    bk = _PlainWindowedOps()
    bk.decode_attention = lambda *a: pytest.fail("fused hook offered")
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, tcfg.vocab, (B, PROMPT)))
    runs = []
    for ops in (TorchOps(), bk):
        cache = TT.init_cache(tcfg, B, MAX_SEQ, device="cpu")
        with torch.no_grad():
            lg, cache = tserve.prefill_step(ops, tp, tcfg, cache, toks)
            tok, rows = torch.argmax(lg[:, -1], -1), []
            for i in range(STEPS):
                tok, last, cache = tserve.decode_step(ops, tp, tcfg, cache,
                                                      tok[:, None],
                                                      PROMPT + i)
                rows.append(last)
        runs.append(torch.stack(rows))
    torch.testing.assert_close(runs[1], runs[0], rtol=0, atol=2e-6)
    if arch == "gemma2_27b":
        want = [("layer0/attn", 16, 50.0), ("layer1/attn", 0, 50.0)]
    else:
        want = [("layer0/attn", 16, 0.0), ("layer1/attn", 16, 0.0)]
    assert bk.calls == want * STEPS


@pytest.mark.parametrize("arch", ZOO)
def test_decode_past_the_window_equals_a_full_forward(arch, monkeypatch):
    """Every cached decode step's logits equal the last position of a full
    forward (no cache) of the same tokens within 2e-6, and of the JAX
    package's full forward; positions run to 24, past the window of 16."""
    jcfg, jp, tcfg, tp = both(arch)
    if arch in MOE:
        dense = TM.moe_mlp

        def moe_dense(*a, **kw):
            return dense(*a, **dict(kw, mode="dense"))

        monkeypatch.setattr(TM, "moe_mlp", moe_dense)
    bk = TorchOps()
    toks = np.random.RandomState(2).randint(0, tcfg.vocab, (B, PROMPT))
    cache = TT.init_cache(tcfg, B, MAX_SEQ, device="cpu")
    with torch.no_grad():
        lg, cache = tserve.prefill_step(bk, tp, tcfg, cache,
                                        torch.from_numpy(toks))
        tok = torch.argmax(lg[:, -1], -1)
        seq = np.concatenate([toks, tok.numpy()[:, None]], 1)
        for i in range(STEPS):
            tok, last, cache = tserve.decode_step(bk, tp, tcfg, cache,
                                                  tok[:, None], PROMPT + i)
            full, _ = TT.forward(bk, tp, tcfg, torch.from_numpy(seq))
            torch.testing.assert_close(last, full[:, -1], rtol=0, atol=2e-6)
            seq = np.concatenate([seq, tok.numpy()[:, None]], 1)
    if arch not in MOE:
        jfull, _ = JT.forward(JOps(jnp.float32, jnp.float32), jp, jcfg,
                              jnp.asarray(seq[:, :-1]))
        np.testing.assert_allclose(last.numpy(), np.asarray(jfull[:, -1]),
                                   rtol=0, atol=2e-6)


@pytest.mark.parametrize("arch", ZOO)
def test_param_shapes_and_counts_match_reference(arch):
    jcfg, jp, tcfg, tp = both(arch)
    shapes = TT.param_shapes(tcfg)
    jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    assert shapes == jshapes
    got = jax.tree_util.tree_map(lambda t: tuple(t.shape), tp)
    assert got == jshapes
    gen = torch.Generator().manual_seed(0)
    own = TT.init_params(tcfg, generator=gen, device="cpu")
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), own) == jshapes
    for size in ("SMOKE", "FULL"):
        jc = getattr(jconfigs.get(arch), size)
        tc = getattr(tconfigs.get(arch), size)
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        for active in (False, True):
            assert TT.analytic_params(tc, active) == \
                JT.analytic_params(jc, active)
    n = sum(t.numel() for t in jax.tree_util.tree_leaves(tp))
    assert n == TT.analytic_params(tcfg) + tcfg.d_model * (
        2 * tcfg.n_layers + 1)                       # + the norm gains
    if arch in MOE:
        assert TT.analytic_params(tcfg, True) < TT.analytic_params(tcfg)


def caa_traces(arch, k=12, seq=8):
    """The reference's and the port's ``CaaOps`` forward at emulated k on
    ``seq`` seeded tokens: (JAX backend, JAX logits, port backend, port
    logits)."""
    jcfg, jp, tcfg, tp = both(arch)
    toks = np.random.RandomState(1).randint(0, jcfg.vocab, (1, seq))
    jbk = JCaaOps(jcaa.CaaConfig(u_max=2.0 ** (1 - k), emulate_k=k))
    jl, _ = JT.forward(jbk, jp, jcfg, jnp.asarray(toks))
    tbk = TCaaOps(tcaa.CaaConfig(u_max=2.0 ** (1 - k), emulate_k=k))
    tl, _ = TT.forward(tbk, tp, tcfg, torch.from_numpy(toks))
    return jbk, jl, tbk, tl


def _rel(a, b):
    if a == b:
        return 0.0
    return abs(a - b) / max(abs(a), abs(b))


def check_traces(jbk, jl, tbk, tl, extra_rel=None,
                 out_mag_rel=OUT_MAG_REL):
    """Trace records: names and kinds equal; δ̄, ε̄ and every router
    record's ``min_margin`` within CAA_REL, ``out_mag`` within
    ``out_mag_rel``; ``extra_rel``: {extra key: tolerance} for the router
    records' other fields. The logits' values equal and their δ̄ / ε̄
    within CAA_REL."""
    assert [(r.name, r.kind) for r in jbk.trace] == \
        [(r.name, r.kind) for r in tbk.trace]
    for a, b in zip(jbk.trace, tbk.trace):
        for f in ("max_dbar", "max_ebar"):
            x, y = getattr(a, f), getattr(b, f)
            assert x == y or _rel(x, y) <= CAA_REL, (a.name, f, x, y)
        assert _rel(a.out_mag, b.out_mag) <= out_mag_rel, (
            a.name, a.out_mag, b.out_mag)
        assert set(a.extra) == set(b.extra)
        for f, x in a.extra.items():
            tol = (extra_rel or {}).get(f, CAA_REL)
            assert _rel(x, b.extra[f]) <= tol, (a.name, f, x, b.extra[f])
    np.testing.assert_array_equal(tl.val.numpy(), np.asarray(jl.val))
    for x, y in zip(jcaa.worst(jl), tcaa.worst(tl)):
        assert x == y or _rel(x, y) <= CAA_REL, (x, y)


@pytest.mark.parametrize("arch", ("command_r_35b", "gemma2_27b"))
def test_caa_forward_matches_reference(arch):
    jbk, jl, tbk, tl = caa_traces(arch)
    check_traces(jbk, jl, tbk, tl)
    if arch == "gemma2_27b":      # the softcapped scores and logits
        assert sum(r.kind == "softmax" for r in tbk.trace) == 2


def certify_both(arch, tmp_path):
    """``certify_lm`` (uniform, k_max 24) through both packages on the
    reference's SMOKE params, each into its own store."""
    jcfg, jp, tcfg, tp = both(arch)
    kw = dict(seq=6, batch=2, seed=0, k_max=24)
    js = jcertify.certify_lm(arch, jcfg, jp, **kw,
                             store=jcertify.CertificateStore(
                                 str(tmp_path / "j")))
    ts = tcertify.certify_lm(arch, tcfg, tp, **kw,
                             store=tcertify.CertificateStore(
                                 str(tmp_path / "t")))
    return js, ts


def check_decisions(js, ts, bound_rel=CERT_BOUND_REL):
    assert len(js.certificates) == len(ts.certificates) > 0
    for a, b in zip(js.certificates, ts.certificates):
        assert a.class_key == b.class_key
        assert a.required_k == b.required_k
        assert a.satisfied_by == b.satisfied_by
        assert a.layer_k == b.layer_k
        assert a.meta.get("sample_next_tokens") == \
            b.meta.get("sample_next_tokens")
        assert _rel(a.final_abs_u, b.final_abs_u) <= bound_rel, (
            a.final_abs_u, b.final_abs_u)
        assert [r["name"] for r in a.trace_summary] == \
            [r["name"] for r in b.trace_summary]
    assert js.meta.get("probes") == ts.meta.get("probes")
    assert js.serving_k == ts.serving_k


@pytest.mark.parametrize("arch", ("command_r_35b", "gemma2_27b"))
def test_certify_lm_decisions_match_reference(arch, tmp_path):
    js, ts = certify_both(arch, tmp_path)
    check_decisions(js, ts)


@pytest.mark.parametrize("arch", ZOO)
def test_serve_cli_at_smoke(arch):
    res = tserve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                       "--prefill-len", "20", "--decode-steps", "3",
                       "--precision-k", "12"])
    cfg = tconfigs.get(arch).SMOKE
    assert res.cfg == cfg and res.tokens.shape == (2, 4)
    assert bool(((res.tokens >= 0) & (res.tokens < cfg.vocab)).all())
    for lg in [res.prefill_logits] + res.decode_logits:
        assert bool(torch.isfinite(lg).all())
    cut = tserve.main(["--arch", arch, "--device", "cpu", "--batch", "1",
                       "--prefill-len", "4", "--decode-steps", "1",
                       "--max-layers", "1"])
    assert cut.cfg.n_layers == 1 and cut.cfg.d_model == cfg.d_model
    assert len(cut.params["layers"]["ln1"]) == 1
