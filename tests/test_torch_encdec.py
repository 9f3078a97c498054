"""The encoder-decoder family (Whisper) and the vision prefix (PaliGemma) on
the port, against the JAX package, on the CPU, at their SMOKE configs on
the reference's own parameters (JAX ``init_params`` through numpy and
``params_from_numpy``: ``enc_layers``, ``enc_norm``, ``cross``,
``ln1_b`` / ``ln2_b`` and ``frontend_proj`` cross unchanged). Helpers and
tolerances: ``tests/_torch_families.py`` (those of
``tests/_torch_serve_parity.py`` as ``tests/test_torch_zoo.py`` states
them).

* Serving: a prefill of 12 tokens and 12 greedy decode steps through plain
  ``TorchOps`` against ``JOps``, ``QuantJOps(12)`` and ``FormatQuantJOps``
  against the reference's unrolled backends. Whisper's frames are encoded
  once and the encoder states reused by every step (the reference's
  ``_fwd_kwargs``; the port's ``serve.encode_step``); PaliGemma's 8 patches
  are prepended at prefill and its decode positions follow them.
* Decode against a full forward (no cache) of the same tokens and stub
  inputs within 2e-6, and against the reference's full forward.
* ``layernorm``, ``mlp_plain`` and ``groupless_norm_bound`` alone, on
  ``TorchOps`` against ``JOps`` (2e-6); under the port's ``CaaOps`` the
  layernorm's enclosure inside its clamp β ± √n·|γ| (held to the
  reference's analysis on Whisper's forward).
* Parameter shapes and ``analytic_params`` at SMOKE and FULL.
* ``CaaOps`` forward at emulated k = 12 on ``certify_lm``'s profile and
  stub inputs (``certify.lm.frontend_kwargs``, the reference's draw):
  records within the zoo's rule (``check_traces``); ``certify_lm``
  decisions equal (``check_decisions``) through the stacked pipeline, the
  one that passes the stub's inputs (the uniform probe passes none: Whisper
  raises ValueError there in both packages, PaliGemma certifies
  text-only).
* The batching engine: PaliGemma served text-only, every request's tokens
  equal ``reference_generate``'s; Whisper raises ``NotImplementedError``.
* ``serve.main`` encodes Whisper's frames once a run; the CLIs ``serve``
  and ``analyze`` (and ``batching`` for PaliGemma) at SMOKE.
* The layer-stacked analyses (CAA, IA ranges, affine ranges) equal the
  eager ones on the port (``_torch_families.stacked_equals_eager``).
"""
import _torch_test_setup  # noqa: F401  (before any reference compile)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_families as F
from repro.core.backend import JOps
from repro.models import layers as JL
from repro_torch.core import caa as tcaa
from repro_torch.core.backend import CaaOps as TCaaOps
from repro_torch.core.backend import TorchOps
from repro_torch.launch import analyze as tanalyze
from repro_torch.launch import batching as tbatching
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from test_torch_zoo import check_decisions, check_traces

ARCHS = ("whisper_medium", "paligemma_3b")


@pytest.mark.parametrize("path", F.PATHS)
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_steps_match_jax(arch, path):
    F.serving_steps_match(arch, path)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_equals_full_forward(arch):
    F.decode_matches_full_forward(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_match_reference(arch):
    F.params_match_reference(arch)


def _blocks_inputs():
    rng = np.random.RandomState(3)
    n, h = 24, 40
    x = rng.randn(2, 5, n).astype(np.float32) * 3 + 1
    return {"x": x, "gamma": rng.randn(n).astype(np.float32),
            "beta": rng.randn(n).astype(np.float32),
            "w_in": rng.randn(n, h).astype(np.float32) / np.sqrt(n),
            "b_in": rng.randn(h).astype(np.float32),
            "w_out": rng.randn(h, n).astype(np.float32) / np.sqrt(h),
            "b_out": rng.randn(n).astype(np.float32)}


def _blocks(L, bk, a, to):
    ln = L.layernorm(bk, bk.input(to(a["x"])), to(a["gamma"]),
                     to(a["beta"]))
    mlp = L.mlp_plain(bk, ln, to(a["w_in"]), to(a["b_in"]),
                      to(a["w_out"]), to(a["b_out"]))
    return ln, mlp


def test_layernorm_mlp_plain_and_norm_bound_match_reference():
    a = _blocks_inputs()
    j = _blocks(JL, JOps(jnp.float32, jnp.float32), a, jnp.asarray)
    t = _blocks(TL, TorchOps(), a, torch.from_numpy)
    for jv, tv in zip(j, t):
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                                   atol=2e-6)
    assert TL.groupless_norm_bound(24) == JL.groupless_norm_bound(24)
    # under the analysis (held to the reference's on Whisper's forward in
    # the test below): the layernorm's enclosure lies in β ± √n·|γ|, and
    # the clamp does not move the values
    t = _blocks(TL, TCaaOps(tcaa.CaaConfig(u_max=2.0 ** -11, emulate_k=12)),
                a, torch.from_numpy)
    bound = TL.groupless_norm_bound(24) * np.abs(a["gamma"]).astype(
        np.float64)
    assert np.all(t[0].exact.hi.numpy() <= a["beta"] + bound)
    assert np.all(t[0].exact.lo.numpy() >= a["beta"] - bound)
    assert bool(torch.isfinite(t[1].dbar).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_caa_forward_and_certificates_match_reference(arch, tmp_path):
    jbk, jl, tbk, tl = F.caa_both(arch)
    check_traces(jbk, jl, tbk, tl)
    cfg = F.both(arch)[2]
    if cfg.enc_dec:
        # the encoder's and the decoder's self-attention (the reference
        # records no cross-attention probabilities)
        assert sum(r.kind == "softmax" for r in tbk.trace) == (
            cfg.n_enc_layers + cfg.n_layers)
        jcfg, jp, _, tp = F.both(arch)
        kw = dict(F.CERT, seq=F.caa_seq(cfg))
        with pytest.raises(ValueError):
            F.jcertify.certify_lm(arch, jcfg, jp, **kw)
        with pytest.raises(ValueError, match="frames"):
            F.tcertify.certify_lm(arch, cfg, tp, **kw, device="cpu")
    js, ts = F.certify_both(arch, tmp_path, True)
    check_decisions(js, ts)
    assert js.meta.get("reason") == ts.meta.get("reason")


def test_engine_paligemma_text_only_and_whisper_raises():
    _, _, cfg, tp = F.both("paligemma_3b")
    sc = tserve.ServeConfig(arch="paligemma_3b", batch=3, max_seq=48,
                            precision_k=12, device="cpu")
    eng = tbatching.ContinuousBatchingEngine(
        cfg, sc, tp, n_lanes=3, max_seq=48, page_size=16, device="cpu")
    rng = np.random.RandomState(6)
    reqs = [tbatching.Request(rid=i, prompt=rng.randint(
        0, cfg.vocab, n).tolist(), max_new_tokens=6, arrival_step=i)
        for i, n in enumerate((5, 17, 9, 12))]
    for r in eng.run(reqs):
        want = tbatching.reference_generate(
            cfg, sc, tp, reqs[r["id"]].prompt, 6, max_seq=48)
        assert r["tokens"] == want, r["id"]
    _, _, wcfg, wp = F.both("whisper_medium")
    wsc = tserve.ServeConfig(arch="whisper_medium", batch=2, max_seq=32,
                             device="cpu")
    with pytest.raises(NotImplementedError, match="encoder input"):
        tbatching.ContinuousBatchingEngine(wcfg, wsc, wp, n_lanes=2,
                                           max_seq=32, device="cpu")
    with pytest.raises(NotImplementedError, match="encoder input"):
        tbatching.reference_generate(wcfg, wsc, wp, [1, 2], 2, max_seq=32)


def test_serve_encodes_whisper_once(monkeypatch):
    calls = []
    encode = TT.encode

    def counted(*a, **kw):
        calls.append(1)
        return encode(*a, **kw)

    monkeypatch.setattr(TT, "encode", counted)
    res = F.serve_cli("whisper_medium")
    assert len(calls) == 1 and len(res.decode_logits) == 3


@pytest.mark.parametrize("arch", ARCHS)
def test_clis_at_smoke(arch):
    F.serve_cli(arch)
    out = tanalyze.main(["--arch", arch, "--device", "cpu", "--seq", "6"])
    assert np.isfinite(out["abs_u"]) or out["abs_u"] == np.inf
    assert any(r.kind == "softmax" for r in out["trace"])
    if arch == "paligemma_3b":
        _, responses = tbatching.main(["--arch", arch, "--device", "cpu",
                                       "--requests", "3", "--check-ref"])
        assert len(responses) == 3


@pytest.mark.parametrize("arch", ARCHS)
def test_stacked_passes_equal_the_eager_ones(arch):
    F.stacked_equals_eager(arch)
