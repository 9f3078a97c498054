"""The narrow instances of the port's kernels on a card (``compute_dtype``
"bfloat16", ``param_dtype`` / ``cache_dtype`` "fp8"): each bit for bit its
f32 instance on the upcast operands, cast to the output's dtype; kernel 4's
bf16 instance (the reference's composed bf16 attention) bit for bit its
plain version ``flash_decode_bf16_ref``; an f32 q with a bf16 or e4m3
cache (kernels 2 and 4) bit for bit the f32 instance on the upcast cache;
``serve.main`` in f32 with a narrow cache for a GQA, a windowed and an MLA
model; MLA's bf16 decode through the latent kernel, bit for bit its plain
version ``latent_decode_bf16_ref``. They need a CUDA device and skip
without one; they import nothing of JAX: ``python -m pytest -q --noconftest
-m cuda tests/test_torch_dtypes_cuda.py``.
"""
import math

import pytest
import torch

from repro_torch.core import dtypes
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import quant_matmul as tqm
from repro_torch.kernels import row_order as tro

BF16, FP8 = torch.bfloat16, torch.float8_e4m3fn
FMT = (12, 15, -14)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def same_bits(got, want):
    assert got.dtype == want.dtype
    view = {2: torch.int16, 4: torch.int32}[got.element_size()]
    assert torch.equal(got.view(view), want.view(view))


GEMMS = {"quant_matmul_format": lambda x, w: tqm.quant_matmul_format(
             x, w, FMT),
         "quant_matmul": lambda x, w: tqm.quant_matmul(x, w, k=12),
         "f32_matmul": tro.f32_matmul}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", list(GEMMS))
@pytest.mark.parametrize("xdt,wdt", [(BF16, BF16), (BF16, FP8),
                                     (BF16, torch.float32),
                                     (torch.float32, BF16),
                                     (torch.float32, FP8)],
                         ids=["bf16-bf16", "bf16-e4m3", "bf16-f32",
                              "f32-bf16", "f32-e4m3"])
@pytest.mark.parametrize("M,K,N", [(4, 200, 96), (37, 130, 70),
                                   (512, 256, 128)])
def test_narrow_gemm_is_the_f32_instance(cuda_device, kernel, xdt, wdt, M,
                                         K, N):
    """Ragged shapes (K, N off the tiles; N % 16 != 0: element loads) and
    the decode / prefill configurations."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(M, K, device=cuda_device, generator=gen).to(xdt)
    w = dtypes.cast(torch.randn(K, N, device=cuda_device, generator=gen)
                    / math.sqrt(K), wdt)
    fn = GEMMS[kernel]
    got = fn(x, w)
    assert got.dtype == xdt
    same_bits(got, fn(x.float(), w.float()).to(xdt))


@pytest.mark.cuda
def test_raw_k_instance_writes_the_f32_accumulator(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn(4, 256, device=cuda_device, generator=gen).to(BF16)
    w = dtypes.cast(torch.randn(256, 64, device=cuda_device, generator=gen)
                    / 16, FP8)
    raw = tqm.quant_matmul(x, w, k=12, raw=True)
    assert raw.dtype == torch.float32
    same_bits(raw, tqm.quant_matmul(x.float(), w.float(), k=12, raw=True))


@pytest.mark.cuda
def test_row_mean_bf16_is_the_f32_instance(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = (torch.randn(37, 3584, device=cuda_device, generator=gen) ** 2).to(
        BF16)
    same_bits(tro.row_mean(x), tro.row_mean(x.float()).to(BF16))


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [BF16, FP8, torch.float32],
                         ids=["bf16", "e4m3", "f32"])
@pytest.mark.parametrize("G,D", [(7, 128), (2, 256), (5, 64), (3, 96)])
def test_narrow_decode_attention(cuda_device, cdt, G, D):
    """Kernel 2 on bf16 q with a bf16, e4m3 or f32 cache: the f32 instance
    on the upcast operands; kernel 4's bf16 instance: its plain version,
    with and without a window and a softcap, a lane of length 0 among
    them."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    B, H, S = 4, 2, 300
    lengths = torch.tensor([300, 129, 1, 0], dtype=torch.int32,
                           device=cuda_device)
    q = torch.randn(B, H, G, D, device=cuda_device, generator=gen).to(BF16)
    k, v = (dtypes.cast(torch.randn(B, S, H, D, device=cuda_device,
                                    generator=gen), cdt) for _ in range(2))
    got = tfd.flash_decode_certified(q, k, v, lengths, FMT)
    same_bits(got, tfd.flash_decode_certified(
        q.float(), k.float(), v.float(), lengths, FMT).to(BF16))
    for window, cap in ((0, 0.0), (100, 50.0)):
        got = tfd.flash_decode_attention(q, k, v, lengths, window=window,
                                         softcap=cap)
        same_bits(got, tfd.flash_decode_bf16_ref(q, k, v, lengths,
                                                 window=window, softcap=cap))


@pytest.mark.cuda
def test_card_refuses_other_product_dtypes(cuda_device):
    from repro_torch.core.backend import TorchOps

    x = torch.ones(2, 8, dtype=torch.float16, device=cuda_device)
    with pytest.raises(ValueError):
        TorchOps(torch.float16).matmul(x, x.t().contiguous())
    with pytest.raises(ValueError):
        tfd.flash_decode_attention(
            torch.ones(1, 1, 1, 8, dtype=torch.float16, device=cuda_device),
            *(torch.ones(1, 4, 1, 8, dtype=BF16, device=cuda_device)
              for _ in range(2)),
            torch.ones(1, dtype=torch.int32, device=cuda_device))
    with pytest.raises(ValueError):
        tfd.flash_decode_attention(
            torch.ones(1, 1, 1, 8, device=cuda_device),
            *(torch.ones(1, 4, 1, 8, dtype=torch.float16, device=cuda_device)
              for _ in range(2)),
            torch.ones(1, dtype=torch.int32, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [BF16, FP8], ids=["bf16", "e4m3"])
@pytest.mark.parametrize("G,D", [(7, 128), (3, 96)])
def test_f32_decode_attention_on_a_narrow_cache(cuda_device, cdt, G, D):
    """Kernels 2 and 4 on an f32 q with a bf16 or e4m3 cache (f32 compute,
    narrow ``cache_dtype``): the f32 instance on the upcast cache, with and
    without a window and a softcap."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    B, H, S = 4, 2, 300
    lengths = torch.tensor([300, 129, 1, 0], dtype=torch.int32,
                           device=cuda_device)
    q = torch.randn(B, H, G, D, device=cuda_device, generator=gen)
    k, v = (dtypes.cast(torch.randn(B, S, H, D, device=cuda_device,
                                    generator=gen), cdt) for _ in range(2))
    got = tfd.flash_decode_certified(q, k, v, lengths, FMT)
    assert got.dtype == torch.float32
    same_bits(got, tfd.flash_decode_certified(q, k.float(), v.float(),
                                              lengths, FMT))
    for window, cap in ((0, 0.0), (100, 50.0)):
        got = tfd.flash_decode_attention(q, k, v, lengths, window=window,
                                         softcap=cap)
        same_bits(got, tfd.flash_decode_attention(
            q, k.float(), v.float(), lengths, window=window, softcap=cap))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2_7b", "gemma2_27b", "minicpm3_4b"])
@pytest.mark.parametrize("cache", ["bfloat16", "fp8"])
def test_serve_main_f32_compute_with_a_narrow_cache(cuda_device, arch,
                                                    cache):
    """``serve.main --device cuda --cache-dtype ...`` in f32 compute at
    SMOKE size: the GQA, windowed / softcapped and latent decode steps take
    the narrow-cache instances (kernel 4 launched on a narrow cache for the
    first two), and the logits are finite."""
    from repro_torch.launch import serve as tserve

    before = dict(tfd.BY_DTYPE["flash_decode_attention"])
    res = tserve.main(["--device", "cuda", "--arch", arch, "--batch", "2",
                       "--prefill-len", "6", "--decode-steps", "3",
                       "--cache-dtype", cache])
    assert res.prefill_logits.dtype == torch.float32
    assert all(bool(torch.isfinite(t).all()) for t in res.decode_logits)
    key = "f32/" + {"bfloat16": "bf16", "fp8": "e4m3"}[cache]
    grew = (tfd.BY_DTYPE["flash_decode_attention"][key]
            - before.get(key, 0))
    assert grew > 0 if arch != "minicpm3_4b" else grew == 0


@pytest.mark.cuda
def test_mla_bf16_decode_is_refused_on_the_card(cuda_device):
    """MLA's bf16 decode on the card: served through the latent kernel
    (one launch a layer and decode step, none at prefill) since it exists;
    an f16 step is still refused rather than composed."""
    from repro_torch.core.backend import TorchOps
    from repro_torch.launch import serve as tserve

    tfd.latent_decode_bf16.launches = 0
    res = tserve.main(["--device", "cuda", "--arch", "minicpm3_4b",
                       "--batch", "2", "--prefill-len", "6",
                       "--decode-steps", "2", "--compute-dtype", "bfloat16",
                       "--cache-dtype", "bfloat16"])
    assert tfd.latent_decode_bf16.launches == 2 * res.cfg.n_layers
    assert all(torch.isfinite(lg.float()).all() for lg in res.decode_logits)
    B, S, H, R, Dr = 2, 9, 4, 16, 8
    with pytest.raises(ValueError, match="latent decode"):
        TorchOps(torch.float16).latent_decode_attention(
            torch.randn(B, 1, H, R, device=cuda_device).half(),
            torch.randn(B, 1, H, Dr, device=cuda_device).half(),
            torch.randn(B, S, R, device=cuda_device).to(BF16),
            torch.randn(B, S, Dr, device=cuda_device).to(BF16),
            torch.full((B,), S, dtype=torch.int32, device=cuda_device), 0.5)


LATENT_SHAPES = {"minicpm3_decode": (4, 40, 256, 32, 145, [145, 130, 64, 1]),
                 "minicpm3_32k": (4, 40, 256, 32, 32768,
                                  [32768, 20001, 4097, 65]),
                 "ragged_smoke": (3, 4, 16, 8, 200, [0, 129, 64]),
                 "narrow_widths": (2, 6, 100, 20, 70, [70, 3])}


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [BF16, FP8, torch.float32],
                         ids=["bf16", "e4m3", "f32"])
@pytest.mark.parametrize("shape", list(LATENT_SHAPES))
def test_latent_kernel_is_its_plain_version(cuda_device, cdt, shape):
    """The latent kernel bit for bit its plain version at MiniCPM3's decode
    shape, at 32K, with ragged lengths (0 included) and widths off the
    parts; a bf16, an e4m3 and an f32 latent cache, read in place."""
    B, H, R, Dr, S, lens = LATENT_SHAPES[shape]
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    f = lambda *sh: torch.randn(*sh, device=cuda_device, generator=gen)
    q_lat, q_rope = f(B, H, R).to(BF16), f(B, H, Dr).to(BF16)
    c, k_rope = dtypes.cast(f(B, S, R), cdt), dtypes.cast(f(B, S, Dr), cdt)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    n = tfd.latent_decode_bf16.launches
    got = tfd.latent_decode_bf16(q_lat, q_rope, c, k_rope, lengths,
                                 (64 + 32) ** -0.5)
    assert tfd.latent_decode_bf16.launches == n + 1
    want = tfd.latent_decode_bf16_ref(q_lat, q_rope, c, k_rope, lengths,
                                      (64 + 32) ** -0.5)
    torch.cuda.synchronize()
    same_bits(got, want)
