"""Multi-head latent attention (MiniCPM3) on the port, against the JAX
package, on the CPU, at ``minicpm3_4b.SMOKE`` on the reference's own
parameters (JAX ``init_params`` through numpy and ``params_from_numpy``:
MLA's ``wq_a``, ``wq_b``, ``wkv_a``, ``wkv_b``, ``wo``, ``q_norm`` and
``kv_norm`` cross unchanged). Helpers and tolerances:
``tests/_torch_families.py`` (those of ``tests/_torch_serve_parity.py`` as
``tests/test_torch_zoo.py`` states them).

* Serving: a prefill of 12 tokens and 12 greedy decode steps through plain
  ``TorchOps`` against ``JOps``, ``QuantJOps(12)`` and ``FormatQuantJOps``
  against the reference's unrolled backends; the latent cache (k = c
  [L, B, S, kv_rank], v = the rope key [L, B, S, d_rope]) as the
  reference's.
* Decode against a full forward (no cache) of the same tokens within 2e-6,
  and against the reference's full forward.
* The card's routes rehearsed with the kernels' plain versions: a
  single-token step's two per-head weight products as one product against
  a block-diagonal table (bit for bit the heads' own fmaf chains; the
  tables made once per parameter view, shared by backends, remade after an
  in-place write, freed with the parameter) and the decode attention as one
  kv head of keys [c | k_rope] with the scale (d_nope + d_rope)^-½
  (kernel 4's split algorithm), within 2e-6 of the composed path.
* Parameter shapes and ``analytic_params`` at SMOKE and FULL.
* ``CaaOps`` forward at emulated k = 12: δ̄, ε̄ and router-free trace
  records within 1e-9 relative (``tests/test_torch_zoo.py::
  check_traces``), ``out_mag`` within 1e-5 (the zoo's 1e-6 widened: the
  exact enclosure's endpoints go through five chained f64 interval
  einsums, each package adding in its own order, and cancel in them; the
  logits' sup was 1.8e-6 apart); ``certify_lm`` uniform
  (k_max 5: it certifies k = 5, two probes), decisions equal
  (``check_decisions``),
  the final bound within 1e-4 relative (the zoo's 1e-5 widened alike: it
  is the emulated logits' distance to those endpoints, 4.0e-5 apart).
* The batching engine: every request's tokens equal ``reference_generate``'s
  (the CPU's library products do not keep a lane's bits, so bits are the
  card's gate, ``chip_smoke.py``'s ``mla_encdec`` phase).
* The CLIs ``serve``, ``analyze`` and ``batching`` at SMOKE.
* The layer-stacked analyses (CAA, IA ranges, affine ranges) equal the
  eager ones on the port (``_torch_families.stacked_equals_eager``).
"""
import numpy as np
import pytest
import torch

import _torch_families as F
from repro_torch import configs as tconfigs
from repro_torch.core import backend as tbackend
from repro_torch.core.backend import TorchOps
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import row_order as ro
from repro_torch.launch import analyze as tanalyze
from repro_torch.launch import batching as tbatching
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT
from test_torch_zoo import check_decisions, check_traces

ARCH = "minicpm3_4b"


@pytest.mark.parametrize("path", F.PATHS)
def test_serving_steps_match_jax(path):
    F.serving_steps_match(ARCH, path)


def test_decode_equals_full_forward():
    F.decode_matches_full_forward(ARCH)


class _PlainRoutedOps(TorchOps):
    """TorchOps taking the card's MLA routes with the kernels' plain
    versions: a single-token step's per-head weight products through
    ``f32_matmul``'s fmaf chain on the block-diagonal tables, the decode
    attention through kernel 4's split algorithm (one kv head, the latent
    scale)."""

    def per_head_matmul(self, x, w, into):
        if x.shape[1] != 1:
            return super().per_head_matmul(x, w, into)
        B, S, H, n = x.shape
        out = ro.f32_matmul_seq_ref(x.reshape(-1, H * n),
                                    tbackend.per_head_table(w, into))
        return out.reshape(B, S, H, -1)

    def latent_decode_attention(self, q_lat, q_rope, c, k_rope, lengths,
                                scale):
        B, _, H, R = q_lat.shape
        q = torch.cat([q_lat, q_rope], -1).reshape(B, 1, H, -1)
        kv = torch.cat([c, k_rope], -1)[:, :, None, :]
        out = tfd.flash_decode_split_ref(q, kv, kv, lengths, scale=scale)
        return out[..., :R].reshape(B, 1, H, R)


def test_card_routes_rehearsed_with_plain_versions():
    F.decode_matches_full_forward(ARCH, _PlainRoutedOps())
    gen = torch.Generator().manual_seed(4)
    w = torch.randn(16, 4, 8, generator=gen)                  # [R, H, d]
    for into, x, blocks in (
            (True, torch.randn(5, 4, 8, generator=gen), w.permute(1, 2, 0)),
            (False, torch.randn(5, 4, 16, generator=gen),
             w.permute(1, 0, 2))):
        got = ro.f32_matmul_seq_ref(x.reshape(5, -1),
                                    ro.block_diagonal(blocks))
        want = torch.cat([ro.f32_matmul_seq_ref(
            x[:, h], blocks[h].contiguous()) for h in range(4)], 1)
        assert torch.equal(got, want), into


def test_per_head_tables_live_with_their_parameter():
    gen = torch.Generator().manual_seed(6)
    stacked = torch.randn(2, 16, 4 * 12, generator=gen)    # [L, R, H*(dn+dv)]
    w_uk = stacked[1].reshape(16, 4, 12)[..., :8]
    w_uv = stacked[1].reshape(16, 4, 12)[..., 8:]
    into = tbackend.per_head_table(w_uk, True)
    assert into.shape == (4 * 8, 4 * 16)
    assert torch.equal(into[8:16, 16:32], w_uk[:, 1, :].t())
    assert not into[:8, 16:].any()
    # the same view through another reshape, on another backend: one table
    again = stacked[1].reshape(16, 4, 12)[..., :8]
    assert tbackend.per_head_table(again, True) is into
    out = tbackend.per_head_table(w_uv, False)
    assert out.shape == (4 * 16, 4 * 4)
    assert torch.equal(out[16:32, 4:8], w_uv[:, 1, :])
    assert tbackend.per_head_table(stacked[0].reshape(16, 4, 12)[..., :8],
                                   True) is not into       # another layer
    stacked.mul_(2.0)                                      # written in place
    assert torch.equal(tbackend.per_head_table(w_uk, True)[8:16, 16:32],
                       w_uk[:, 1, :].t())
    owner = id(stacked)
    assert owner in tbackend._PER_HEAD_TABLES
    del stacked, w_uk, w_uv, again
    assert owner not in tbackend._PER_HEAD_TABLES


def test_params_match_reference():
    F.params_match_reference(ARCH)
    cache = TT.init_cache(tconfigs.get(ARCH).FULL, 4, 8, device="meta",
                          per_lane_idx=True)
    assert cache["k"].shape == (62, 4, 8, 256)
    assert cache["v"].shape == (62, 4, 8, 32)
    assert cache["idx"].shape == (62, 4)


def test_caa_forward_and_certificates_match_reference(tmp_path):
    jbk, jl, tbk, tl = F.caa_both(ARCH)
    check_traces(jbk, jl, tbk, tl, out_mag_rel=F.MLA_OUT_MAG_REL)
    assert sum(r.kind == "softmax" for r in tbk.trace) == 2
    js, ts = F.certify_both(ARCH, tmp_path, False, k_max=5)
    check_decisions(js, ts, bound_rel=F.MLA_BOUND_REL)
    assert ts.serving_k == 5


def test_engine_serves_requests_as_alone():
    _, _, cfg, tp = F.both(ARCH)
    sc = tserve.ServeConfig(arch=ARCH, batch=3, max_seq=48,
                            precision_layer_format=F.FMT_MAP, device="cpu")
    eng = tbatching.ContinuousBatchingEngine(
        cfg, sc, tp, n_lanes=3, max_seq=48, page_size=16, device="cpu")
    rng = np.random.RandomState(5)
    reqs = [tbatching.Request(rid=i, prompt=rng.randint(
        0, cfg.vocab, n).tolist(), max_new_tokens=6, arrival_step=i)
        for i, n in enumerate((5, 17, 9, 12))]
    for r in eng.run(reqs):
        want = tbatching.reference_generate(
            cfg, sc, tp, reqs[r["id"]].prompt, 6, max_seq=48)
        assert r["tokens"] == want, r["id"]


def test_clis_at_smoke(capsys):
    F.serve_cli(ARCH)
    out = tanalyze.main(["--arch", ARCH, "--device", "cpu", "--seq", "6"])
    assert np.isfinite(out["abs_u"])
    assert any(r.name.endswith("attn/attn_probs") for r in out["trace"])
    _, responses = tbatching.main(["--arch", ARCH, "--device", "cpu",
                                   "--requests", "3", "--check-ref"])
    assert len(responses) == 3


def test_stacked_passes_equal_the_eager_ones():
    F.stacked_equals_eager(ARCH)
