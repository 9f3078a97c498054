"""The port's kernel modules on the CPU: each plain PyTorch version against
the JAX package's oracle AND its Pallas kernel in interpret mode; the
serving dispatches on CPU tensors; the wrappers' guards. (The CUDA kernels
themselves are held against their plain versions on a card by
tests/test_torch_kernels_cuda.py and by chip_smoke.py.)

Tolerance (kernel or oracle vs plain version): equal, or apart by at most
one ulp at k plus what two f32 sums of the same terms differ by when they
add in different orders — PyTorch's CPU GEMM, XLA's and a kernel's tiles
each sum in their own order. For a GEMM that is 2·√K·2⁻²⁴·(|q(x)|@|q(w)|):
the sums' rounding errors have random signs, so their difference grows as
√K, well inside the worst case 2·γ_K·(|q(x)|@|q(w)|); for decode attention
a few f32 ulps of the largest |v| attended, 2·(len + 16)·2⁻²⁴·max|v|.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as JQ
from repro.kernels import flash_decode as jfd
from repro.kernels import quant_matmul as jqm
from repro.kernels import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import quant_matmul as tqm

FORMATS = [(24, 127, -126), (12, 15, -14), (8, 7, -6), (10, 15, -14)]


def _ulp_at_k(a, k, emin):
    _, e = np.frexp(np.abs(a))
    return np.ldexp(1.0, np.maximum(e - 1, emin) - (k - 1))


def assert_ulp_rule(got, want, fmt, pre_tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    k, _, emin = fmt
    diff = np.abs(got - want)
    ulp = _ulp_at_k(np.maximum(np.abs(got), np.abs(want)), k, emin)
    bad = ~((got == want) | (diff <= ulp + pre_tol))
    assert not bad.any(), (int(bad.sum()), float(diff.max()))


def _gemm_inputs(M, K, N, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(M, K).astype(np.float32)
    w = (rng.randn(K, N) / np.sqrt(K)).astype(np.float32)
    return x, w


def _gemm_pre_tol(x, w, fmt, K):
    q = lambda a: np.asarray(JQ.quantize_to_format(jnp.asarray(a), *fmt),
                             np.float64)
    return 2 * np.sqrt(K) * 2.0 ** -24 * (np.abs(q(x)) @ np.abs(q(w)))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("shape", [(4, 64, 32), (7, 96, 40)])
def test_quant_matmul_plain_vs_jax_oracle_and_pallas(fmt, shape):
    M, K, N = shape
    x, w = _gemm_inputs(M, K, N, seed=M + K + N)
    got = tqm.quant_matmul_format_ref(torch.from_numpy(x),
                                      torch.from_numpy(w), fmt).numpy()
    oracle = np.asarray(jqm.quant_matmul_format_ref(jnp.asarray(x),
                                                    jnp.asarray(w), fmt))
    pallas = np.asarray(jqm.quant_matmul_format(
        jnp.asarray(x), jnp.asarray(w), fmt, block_k=K, interpret=True))
    pre = _gemm_pre_tol(x, w, fmt, K)
    assert_ulp_rule(oracle, got, fmt, pre)
    assert_ulp_rule(pallas, got, fmt, pre)


@pytest.mark.parametrize("flags", [(True, True), (False, False)])
def test_quant_matmul_flags_and_saturation(flags):
    subn, sat = flags
    fmt = (6, 3, -2)                       # tiny range: overflow + underflow
    x, w = _gemm_inputs(8, 32, 16, seed=3)
    x = x * 8.0
    got = tqm.quant_matmul_format_ref(torch.from_numpy(x),
                                      torch.from_numpy(w), fmt,
                                      has_subnormals=subn,
                                      saturating=sat).numpy()
    oracle = np.asarray(jqm.quant_matmul_format_ref(
        jnp.asarray(x), jnp.asarray(w), fmt, has_subnormals=subn,
        saturating=sat))
    finite = np.isfinite(oracle)
    assert np.array_equal(np.isfinite(got), finite)
    assert np.array_equal(got[~finite], oracle[~finite], equal_nan=True)
    assert_ulp_rule(oracle[finite], got[finite], fmt,
                    _gemm_pre_tol(x, w, fmt, 32)[finite])


def test_quant_matmul_dispatch_on_cpu_is_plain_and_counts_nothing():
    x, w = _gemm_inputs(6, 32, 24, seed=4)
    x3 = torch.from_numpy(x).reshape(2, 3, 32)
    tqm.quant_matmul_format.launches = 0
    out = tqm.quant_matmul_format_dispatch(x3, torch.from_numpy(w),
                                           (12, 15, -14))
    assert out.shape == (2, 3, 24)
    want = tqm.quant_matmul_format_ref(torch.from_numpy(x),
                                       torch.from_numpy(w), (12, 15, -14))
    assert torch.equal(out.reshape(6, 24), want)
    assert tqm.quant_matmul_format.launches == 0


def _attn_inputs(B, H, G, D, S, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, G, D).astype(np.float32)
    k = rng.randn(B, S, H, D).astype(np.float32)
    v = rng.randn(B, S, H, D).astype(np.float32)
    return q, k, v


def _attn_pre_tol(v, lengths, fmt):
    """2·(n + 16)·2⁻²⁴·max|v̂| over the n positions a lane attends: its
    length, or all S for a lane of length 0 (every score masked alike)."""
    vq = np.abs(np.asarray(JQ.quantize_to_format(jnp.asarray(v), *fmt)))
    S = v.shape[1]
    n = np.asarray(lengths, np.int64)
    n = np.where(n <= 0, S, np.minimum(n, S))
    valid = np.arange(S)[None, :] < n[:, None]
    vmax = np.where(valid[:, :, None, None], vq, 0).max(axis=(1, 3))
    slack = 2.0 * (n.astype(np.float64) + 16)[:, None] * 2.0 ** -24
    return (slack * vmax)[:, :, None, None]


@pytest.mark.parametrize("fmt", FORMATS)
def test_flash_decode_plain_vs_jax_oracle_and_pallas(fmt):
    B, H, G, D, S = 3, 2, 3, 16, 32
    q, k, v = _attn_inputs(B, H, G, D, S, seed=sum(fmt) % 97)
    lengths = np.asarray([1, 17, 32], np.int32)
    got = tfd.flash_decode_quantized_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lengths), fmt).numpy()
    oracle = np.asarray(jfd.flash_decode_quantized_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(lengths), fmt))
    pallas = np.asarray(jfd.flash_decode_certified(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        fmt, block_s=S, interpret=True))
    pre = _attn_pre_tol(v, lengths, fmt)
    assert got.shape == (B, H, G, D)
    assert_ulp_rule(oracle, got, fmt, pre)
    assert_ulp_rule(pallas, got, fmt, pre)


@pytest.mark.parametrize("fmt", FORMATS)
def test_flash_decode_certified_plain_at_length_zero(fmt):
    """A lane of length 0: every score is masked to -1e30, every weight is
    exp(0) = 1, so the plain version, the JAX oracle and the interpret-mode
    Pallas kernel all give the mean of the rounded v over all S, rounded."""
    B, H, G, D, S = 3, 2, 3, 16, 32
    q, k, v = _attn_inputs(B, H, G, D, S, seed=sum(fmt) % 89)
    lengths = np.asarray([0, 9, 0], np.int32)
    got = tfd.flash_decode_quantized_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lengths), fmt).numpy()
    assert np.isfinite(got).all()
    oracle = np.asarray(jfd.flash_decode_quantized_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(lengths), fmt))
    pre = _attn_pre_tol(v, lengths, fmt)
    assert_ulp_rule(oracle, got, fmt, pre)
    for bs in (S, 8):
        pallas = np.asarray(jfd.flash_decode_certified(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(lengths), fmt, block_s=bs, interpret=True))
        assert_ulp_rule(pallas, got, fmt, pre)
    mean_v = np.asarray(JQ.quantize_to_format(jnp.asarray(v), *fmt)).mean(1)
    assert_ulp_rule(got[0], np.broadcast_to(mean_v[0][:, None, :],
                                            (H, G, D)), fmt, pre[0])


@pytest.mark.parametrize("B,H,G,D,S,lens", [
    (3, 2, 3, 16, 32, [1, 17, 32]),
    (3, 2, 7, 16, 48, [0, 5, 48]),
    (2, 1, 2, 8, 64, [64, 0]),
])
def test_flash_decode_attention_plain_vs_jax_oracle_and_pallas(B, H, G, D, S,
                                                               lens):
    """The uncertified pair over ragged lengths, length 0 included: the
    plain version against ``ref.flash_decode_ref`` and the Pallas kernel in
    interpret mode, one S block and several."""
    q, k, v = _attn_inputs(B, H, G, D, S, seed=S + G)
    lengths = np.asarray(lens, np.int32)
    got = tfd.flash_decode_ref(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v),
                               torch.from_numpy(lengths)).numpy()
    assert got.shape == (B, H, G, D) and np.isfinite(got).all()
    f32 = (24, 127, -126)            # nothing is rounded: ulps of f32
    pre = _attn_pre_tol(v, lengths, f32)
    oracle = np.asarray(jref.flash_decode_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths)))
    assert_ulp_rule(oracle, got, f32, pre)
    for bs in (S, 16):
        pallas = np.asarray(jfd.flash_decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(lengths), block_s=bs, interpret=True))
        assert_ulp_rule(pallas, got, f32, pre)



# lengths at and around the kernels' chunk edges (FD_CHUNK = 64), a lane of
# length 0 and of length 1; Smax a multiple of the Pallas block (32 < S)
SPLIT_CASES = [(192, [0, 1, 63, 64, 65, 192]), (256, [127, 128, 129, 255])]


@pytest.mark.parametrize("fmt", [None] + FORMATS)
@pytest.mark.parametrize("S,lens", SPLIT_CASES)
def test_flash_decode_split_ref_vs_jax_oracle_and_pallas(fmt, S, lens):
    """The split algorithm's plain version (chunk partials folded in chunk
    order) against the JAX oracle and the Pallas kernel in interpret mode
    over several S-blocks: certified for a format, uncertified for None."""
    B, H, G, D = len(lens), 2, 3, 16
    q, k, v = _attn_inputs(B, H, G, D, S, seed=S + len(str(fmt)))
    lengths = np.asarray(lens, np.int32)
    got = tfd.flash_decode_split_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lengths), fmt).numpy()
    assert got.shape == (B, H, G, D) and np.isfinite(got).all()
    jq, jk, jv, jl = (jnp.asarray(a) for a in (q, k, v, lengths))
    if fmt is None:
        f = (24, 127, -126)          # nothing is rounded: ulps of f32
        oracle = jref.flash_decode_ref(jq, jk, jv, jl)
        pallas = jfd.flash_decode_attention(jq, jk, jv, jl, block_s=32,
                                            interpret=True)
    else:
        f = fmt
        oracle = jfd.flash_decode_quantized_ref(jq, jk, jv, jl, fmt)
        pallas = jfd.flash_decode_certified(jq, jk, jv, jl, fmt, block_s=32,
                                            interpret=True)
    pre = _attn_pre_tol(v, lengths, f)
    assert_ulp_rule(np.asarray(oracle), got, f, pre)
    assert_ulp_rule(np.asarray(pallas), got, f, pre)


@pytest.mark.parametrize("fmt", [None, (12, 15, -14)])
def test_flash_decode_split_ref_never_reads_past_length(fmt):
    """NaN in the cache at and past every lane's length changes no bit."""
    S, lens = SPLIT_CASES[0]
    q, k, v = _attn_inputs(len(lens), 2, 3, 16, S, seed=31)
    lengths = torch.tensor(lens, dtype=torch.int32)
    k2, v2 = k.copy(), v.copy()
    for b, n in enumerate(lens):
        if n > 0:
            k2[b, n:] = np.nan
            v2[b, n:] = np.nan
    clean = tfd.flash_decode_split_ref(*(torch.from_numpy(a)
                                         for a in (q, k, v)), lengths, fmt)
    poisoned = tfd.flash_decode_split_ref(*(torch.from_numpy(a)
                                            for a in (q, k2, v2)), lengths,
                                          fmt)
    assert torch.isfinite(poisoned).all()
    assert torch.equal(clean, poisoned)


@pytest.mark.parametrize("fmt", [None, (12, 15, -14), (8, 7, -6)])
@pytest.mark.parametrize("S,lens", SPLIT_CASES + [(2240, [0, 2112, 2113,
                                                          2240])])
def test_flash_decode_split_ref_in_f64_is_the_softmax(fmt, S, lens):
    """In f64 the split version (the card checks' yardstick) is the masked
    softmax over the rounded inputs, summed in f64 by numpy, to 1e-12 of
    max|v̂| before the output's rounding into the format."""
    B, H, G, D = len(lens), 2, 3, 16
    q, k, v = _attn_inputs(B, H, G, D, S, seed=S + 7)
    lengths = np.asarray(lens, np.int32)
    got = tfd.flash_decode_split_ref(
        *(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(lengths),
        fmt, dtype=torch.float64).numpy()
    f = fmt or (53, 1023, -1022)
    rnd = lambda a: np.asarray(JQ.quantize_to_format(
        jnp.asarray(a, jnp.float64), *f), np.float64)
    qq, kq, vq = (rnd(a.astype(np.float64)) for a in (q, k, v))
    s = np.einsum("bhgd,bshd->bhgs", qq, kq) / np.sqrt(D)
    n = np.where(lengths <= 0, S, lengths)
    s = np.where(np.arange(S)[None, None, None, :] < lengths[:, None, None,
                                                             None], s, -1e30)
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    p = np.where(np.arange(S)[None, None, None, :] < n[:, None, None, None],
                 p, 0.0)
    want = rnd(np.einsum("bhgs,bshd->bhgd", p, vq) / p.sum(-1)[..., None])
    assert got.dtype == np.float64 and np.isfinite(got).all()
    assert_ulp_rule(got, want, f, 1e-12 * np.abs(vq).max())


def test_flash_decode_split_ref_chunk_is_the_kernels():
    """The plain version, and the wrappers' scratch for the partials, split
    the cache where the CUDA body does."""
    src = (_build.CSRC / "flash_decode.cuh").read_text()
    assert f"constexpr int kFdChunk = {tfd.FD_CHUNK};" in src

def test_flash_decode_masks_past_length():
    """Cache entries at or beyond a lane's length never reach its output."""
    B, H, G, D, S = 2, 2, 2, 8, 16
    q, k, v = _attn_inputs(B, H, G, D, S, seed=9)
    lengths = torch.tensor([5, 16], dtype=torch.int32)
    fmt = (12, 15, -14)
    base = tfd.flash_decode_quantized_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        lengths, fmt)
    k2, v2 = k.copy(), v.copy()
    k2[0, 5:] = 1e3
    v2[0, 5:] = -1e3
    moved = tfd.flash_decode_quantized_ref(
        torch.from_numpy(q), torch.from_numpy(k2), torch.from_numpy(v2),
        lengths, fmt)
    assert torch.equal(base[0], moved[0])


def test_certified_decode_dispatch_on_cpu_is_plain_and_counts_nothing():
    q, k, v = _attn_inputs(2, 2, 2, 8, 16, seed=2)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    lengths = torch.tensor([3, 16], dtype=torch.int32)
    tfd.flash_decode_certified.launches = 0
    out = tfd.certified_decode_attention(*args, lengths, (8, 7, -6))
    want = tfd.flash_decode_quantized_ref(*args, lengths, (8, 7, -6))
    assert torch.equal(out, want)
    assert tfd.flash_decode_certified.launches == 0


def test_kernel_wrappers_refuse_cpu_tensors():
    """On a CPU tensor the CUDA wrappers raise (the dispatches are what
    pick the plain version); no build is attempted."""
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        tqm.quant_matmul_format(x, torch.zeros(8, 4), (12, 15, -14))
    with pytest.raises(ValueError):
        tqm.quantize_format_cuda(x, (12, 15, -14))
    q = torch.zeros(1, 1, 2, 8)
    kv = torch.zeros(1, 4, 1, 8)
    with pytest.raises(ValueError):
        tfd.flash_decode_certified(q, kv, kv, torch.ones(1, dtype=torch.int32),
                                   (12, 15, -14))
    with pytest.raises(ValueError):
        tqm.quant_matmul(x, torch.zeros(8, 4), k=12)
    with pytest.raises(ValueError):
        tfd.flash_decode_attention(q, kv, kv,
                                   torch.ones(1, dtype=torch.int32))


def test_build_recipe():
    """Hopper target, no fast math, build dir under build/repro_torch, one
    library per source named by a digest of sources and flags."""
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast-math" not in flags and "fast_math" not in flags
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
        p = _build.lib_path(name)
        assert p.parent == _build.BUILD_DIR
        assert p.parent.parts[-2:] == ("build", "repro_torch")
        assert p == _build.lib_path(name)
    assert (_build.lib_path(_build.SOURCES[0])
            != _build.lib_path(_build.SOURCES[1]))


def test_cuda_sources_carry_their_notes():
    """Each kernel source names the TPU kernel it replaces and its bound."""
    for name, tpu in [("quant_matmul_format", "_quant_matmul_format_kernel"),
                      ("flash_decode_certified", "_flash_decode_fmt_kernel"),
                      ("quant_matmul", "_quant_matmul_kernel"),
                      ("flash_decode", "_flash_decode_kernel")]:
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert tpu in text
        assert "What bounds it" in text
        assert "__expf" not in text.replace("(not __expf)", "")
