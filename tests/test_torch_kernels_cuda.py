"""Each CUDA kernel of the port against its plain PyTorch version, on a
card. These tests need a CUDA device (the kernels have no CPU mode) and skip
without one; they import nothing of JAX, so they run on a machine that has
only PyTorch: ``python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py``.

Tolerance: equal, or apart by at most one ulp at k plus what two f32 sums
of the same terms differ by when they add in different orders
(2·√K·2⁻²⁴·(|q(x)|@|q(w)|) for the GEMM, whose rounding errors have random
signs; 2·(len + 16)·2⁻²⁴·max|v| for decode attention, whose exp and division
also differ by ulps; against decode attention's f64 split version,
8·√(len + 16)·2⁻²⁴·max|v|). On operands whose partial sums are all exact in
f32 the GEMM must equal its plain version bit for bit. One test runs on the
CPU: it shows that the f64 rule fails a decode that drops a chunk.

Serving's two port-only fixed-order kernels (``row_order.row_mean``,
``row_order.f32_matmul``) equal their plain versions bit for bit (the
plain versions compute the kernels' own order), and a row alone equals the
same row in a batch.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.quantize import _quantize_normal, quantize_to_format
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import quant_matmul as tqm

FORMATS = [(24, 127, -126), (12, 15, -14), (8, 7, -6), (10, 15, -14)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def assert_ulp_rule(got, want, fmt, pre_tol):
    got, want = got.double().cpu(), want.double().cpu()
    k, _, emin = fmt
    diff = (got - want).abs()
    _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
    ulp = torch.ldexp(torch.ones_like(got),
                      (torch.clamp(e - 1, min=emin) - (k - 1)).double())
    bad = ~((got == want) | (diff <= ulp + pre_tol.cpu()))
    assert not bool(bad.any()), (int(bad.sum()), float(diff.max()))


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS)
def test_quant_matmul_kernel_vs_plain_on_card(cuda_device, fmt):
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    M, K, N = 37, 200, 70
    x = torch.randn(M, K, device=cuda_device, generator=gen)
    w = torch.randn(K, N, device=cuda_device, generator=gen) / np.sqrt(K)
    got = tqm.quant_matmul_format(x, w, fmt)
    want = tqm.quant_matmul_format_ref(x, w, fmt)
    q = lambda t: quantize_to_format(t, *fmt).abs().double()
    pre = 2 * np.sqrt(K) * 2.0 ** -24 * (q(x) @ q(w))
    assert_ulp_rule(got, want, fmt, pre)
    alone = tqm.quant_matmul_format(x[:5].contiguous(), w, fmt)
    assert torch.equal(alone.view(torch.int32), got[:5].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("M,K,N", [(4, 3584, 512), (37, 1000, 70)])
def test_quant_matmul_kernel_exact_on_coarse_grid(cuda_device, fmt, M, K, N):
    # integers in [-3, 3] times 2^-2 resp. 2^-3 lie in every format tested,
    # and every partial sum of their products is an exact f32, so any
    # summation order gives the same bits
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    x = torch.randint(-3, 4, (M, K), device=cuda_device,
                      generator=gen).float() * 2.0 ** -2
    w = torch.randint(-3, 4, (K, N), device=cuda_device,
                      generator=gen).float() * 2.0 ** -3
    got = tqm.quant_matmul_format(x, w, fmt)
    want = tqm.quant_matmul_format_ref(x, w, fmt)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS)
def test_flash_decode_kernel_vs_plain_on_card(cuda_device, fmt):
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    B, H, G, D, S = 3, 4, 7, 128, 100
    q = torch.randn(B, H, G, D, device=cuda_device, generator=gen)
    k = torch.randn(B, S, H, D, device=cuda_device, generator=gen)
    v = torch.randn(B, S, H, D, device=cuda_device, generator=gen)
    lengths = torch.tensor([1, 33, 100], dtype=torch.int32,
                           device=cuda_device)
    got = tfd.flash_decode_certified(q, k, v, lengths, fmt)
    want = tfd.flash_decode_quantized_ref(q, k, v, lengths, fmt)
    valid = torch.arange(S, device=cuda_device)[None, :] < lengths[:, None]
    vq = quantize_to_format(v, *fmt).abs()
    vmax = torch.where(valid[:, :, None, None], vq, 0).amax(dim=(1, 3))
    slack = 2.0 * (lengths.double() + 16)[:, None] * 2.0 ** -24
    assert_ulp_rule(got, want, fmt, (slack * vmax.double())[:, :, None, None])


@pytest.mark.cuda
def test_kernels_count_their_launches(cuda_device):
    x = torch.randn(4, 64, device=cuda_device)
    w = torch.randn(64, 32, device=cuda_device)
    tqm.quant_matmul_format.launches = 0
    tqm.quant_matmul_format_dispatch(x.reshape(2, 2, 64), w, (12, 15, -14))
    tqm.quant_matmul_format_ref(x, w, (12, 15, -14))
    assert tqm.quant_matmul_format.launches == 1


KS = [2, 8, 12, 23, 24]


def _k_pre_tol(x, w, k):
    """2·√K·2⁻²⁴·(|q_k(x)|@|q_k(w)|): the order difference of two f32 sums."""
    K = x.shape[1]
    xq = _quantize_normal(x, k).abs().double()
    wq = _quantize_normal(w, k).abs().double()
    return 2 * np.sqrt(K) * 2.0 ** -24 * (xq @ wq)


def assert_same_bits(got, want):
    """Equal bit for bit, except that any NaN equals any NaN."""
    got, want = got.cpu(), want.cpu()
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("k", KS)
def test_quant_matmul_k_kernel_vs_plain_on_card(cuda_device, k):
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    M, K, N = 37, 200, 70
    x = torch.randn(M, K, device=cuda_device, generator=gen)
    w = torch.randn(K, N, device=cuda_device, generator=gen) / np.sqrt(K)
    got = tqm.quant_matmul(x, w, k=k)
    want = tqm.quant_matmul_ref(x, w, k)
    assert_ulp_rule(got, want, (k, 127, -126), _k_pre_tol(x, w, k))
    alone = tqm.quant_matmul(x[:5].contiguous(), w, k=k)
    assert torch.equal(alone.view(torch.int32), got[:5].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("M,K,N", [(4, 3584, 512), (37, 1000, 70)])
def test_quant_matmul_k_kernel_exact_on_coarse_grid(cuda_device, k, M, K, N):
    # integers in [-3, 3] times 2^-2 resp. 2^-3 need 2 mantissa bits, and
    # every partial sum of their products is an exact f32
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    x = torch.randint(-3, 4, (M, K), device=cuda_device,
                      generator=gen).float() * 2.0 ** -2
    w = torch.randint(-3, 4, (K, N), device=cuda_device,
                      generator=gen).float() * 2.0 ** -3
    assert_same_bits(tqm.quant_matmul(x, w, k=k),
                     tqm.quant_matmul_ref(x, w, k))


@pytest.mark.cuda
@pytest.mark.parametrize("k", KS)
def test_quant_matmul_k_kernel_nonfinite_and_near_max(cuda_device, k):
    """NaN and ±inf pass through the rounding; ±f32 max carries into ±inf
    at k < 24; a near-max row absorbs the small terms in any order."""
    gen = torch.Generator(device=cuda_device).manual_seed(17)
    M, K, N = 9, 64, 40
    x = torch.randint(-3, 4, (M, K), device=cuda_device,
                      generator=gen).float() * 2.0 ** -2
    w = torch.randint(-3, 4, (K, N), device=cuda_device,
                      generator=gen).float() * 2.0 ** -3
    big = 3.4028234663852886e38
    x[0, 3] = float("nan")
    x[1, 5] = float("inf")
    x[2, 7] = -float("inf")
    x[3, 0] = big
    x[4, 1] = -big
    x[5, 2] = 3.3e38
    x[6, 9] = -1.5e38
    # weights of ±1/8, ±1/4 or 0 against the near-max inputs keep their
    # products exact, so no tie can be broken by the order of the sum
    w[[0, 1, 2, 9]] = w[[0, 1, 2, 9]].clamp(-0.25, 0.25)
    assert_same_bits(tqm.quant_matmul(x, w, k=k),
                     tqm.quant_matmul_ref(x, w, k))


def _attended_vmax(v, lengths, rounded=None):
    """The n positions each lane attends (all S for a lane of length 0) and
    the largest |v| there, per (b, kv-head)."""
    S = v.shape[1]
    n = torch.where(lengths <= 0, S, lengths.clamp(max=S))
    valid = torch.arange(S, device=v.device)[None, :] < n[:, None]
    va = (v if rounded is None else rounded).abs()
    return n.double(), torch.where(valid[:, :, None, None], va,
                                   0).amax(dim=(1, 3)).double()


def _flash_slack(v, lengths, rounded=None):
    """2·(n + 16)·2⁻²⁴·max|v| over the n positions a lane attends."""
    n, vmax = _attended_vmax(v, lengths, rounded)
    return (2.0 * (n + 16)[:, None] * 2.0 ** -24 * vmax)[:, :, None, None]


def _f64_slack(v, lengths, rounded=None):
    """8·√(n + 16)·2⁻²⁴·max|v|: against the f64 split version, the
    probabilistic bound (λ = 8; Higham and Mary, SIAM J. Sci. Comput.
    41(5), 2019) on the f32 sums' rounding errors, as chip_smoke.py's
    ``flash_f64_tol``: below what one 64-position chunk moves an output."""
    n, vmax = _attended_vmax(v, lengths, rounded)
    return (8.0 * (n + 16).sqrt()[:, None] * 2.0 ** -24
            * vmax)[:, :, None, None]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,G,D,S,lens", [
    (3, 4, 7, 128, 100, [0, 33, 100]),
    (2, 2, 2, 64, 256, [256, 1]),
    (4, 4, 7, 128, 145, [129, 144, 0, 7]),
])
def test_flash_decode_attention_kernel_vs_plain_on_card(cuda_device, B, H, G,
                                                        D, S, lens):
    gen = torch.Generator(device=cuda_device).manual_seed(19)
    q = torch.randn(B, H, G, D, device=cuda_device, generator=gen)
    k = torch.randn(B, S, H, D, device=cuda_device, generator=gen)
    v = torch.randn(B, S, H, D, device=cuda_device, generator=gen)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    got = tfd.flash_decode_attention(q, k, v, lengths)
    want = tfd.flash_decode_ref(q, k, v, lengths)
    diff = (got.double() - want.double()).abs()
    assert bool((diff <= _flash_slack(v, lengths)).all()), float(diff.max())


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS)
def test_flash_decode_certified_at_length_zero(cuda_device, fmt):
    """A lane of length 0 gives the plain version's result: uniform weights
    over all S positions, the mean of the rounded v, rounded."""
    gen = torch.Generator(device=cuda_device).manual_seed(23)
    B, H, G, D, S = 2, 4, 7, 128, 70
    q = torch.randn(B, H, G, D, device=cuda_device, generator=gen)
    k = torch.randn(B, S, H, D, device=cuda_device, generator=gen)
    v = torch.randn(B, S, H, D, device=cuda_device, generator=gen)
    lengths = torch.tensor([0, 40], dtype=torch.int32, device=cuda_device)
    got = tfd.flash_decode_certified(q, k, v, lengths, fmt)
    want = tfd.flash_decode_quantized_ref(q, k, v, lengths, fmt)
    assert bool(torch.isfinite(got).all())
    assert_ulp_rule(got, want, fmt, _flash_slack(
        v, lengths, quantize_to_format(v, *fmt)))


@pytest.mark.cuda
def test_new_kernels_count_their_launches_and_state_limits(cuda_device):
    x = torch.randn(4, 64, device=cuda_device)
    w = torch.randn(64, 32, device=cuda_device)
    tqm.quant_matmul.launches = 0
    tqm.quant_matmul_dynamic_k(x.reshape(2, 2, 64), w, 12)
    tqm.quant_matmul_ref(x, w, 12)
    assert tqm.quant_matmul.launches == 1
    q = torch.randn(1, 1, 2, 64, device=cuda_device)
    kv = torch.randn(1, 8, 1, 64, device=cuda_device)
    lengths = torch.tensor([8], dtype=torch.int32, device=cuda_device)
    tfd.flash_decode_attention.launches = 0
    tfd.flash_decode_attention(q, kv, kv, lengths)
    tfd.flash_decode_ref(q, kv, kv, lengths)
    assert tfd.flash_decode_attention.launches == 1
    with pytest.raises(ValueError):
        tfd.flash_decode_attention(torch.randn(1, 1, 9, 64,
                                               device=cuda_device),
                                   kv, kv, lengths)
    with pytest.raises(ValueError):
        tqm.quant_matmul(x, w, k=0)



# --- kernels 2 and 4: the split decode-attention body -----------------------
#
# The body splits the cache into 64-position chunks and folds them in chunk
# order; each output's summation order depends on its lane's length only.
# So a lane's bits are the same at B = 1 and B = 4 in every lane position,
# under Smax 145 and 1024, whatever the other lanes' lengths; a cache
# poisoned with NaN at and past every lane's length gives the clean bits;
# and at the chunk edges and past one group of the combine the rule above
# holds against the plain versions, and the tighter f64 rule against the
# f64 split version.

DECODE_KERNELS = [None] + FORMATS     # None: kernel 4 (uncertified)
DECODE_GD = [(2, 64), (7, 128), (8, 128), (2, 128), (7, 64), (8, 64)]


def _decode(fmt, q, k, v, lengths):
    if fmt is None:
        return tfd.flash_decode_attention(q, k, v, lengths)
    return tfd.flash_decode_certified(q, k, v, lengths, fmt)


def _assert_f64_rule(got, fmt, q, k, v, lengths):
    """``got`` against the f64 split version: one ulp at k (of f32 for
    kernel 4) plus :func:`_f64_slack`."""
    exact = tfd.flash_decode_split_ref(q, k, v, lengths, fmt,
                                       dtype=torch.float64)
    rounded = None if fmt is None else quantize_to_format(v, *fmt)
    assert_ulp_rule(got, exact, fmt or (24, 127, -126),
                    _f64_slack(v, lengths, rounded))


def _decode_vs_plain(fmt, q, k, v, lengths):
    got = _decode(fmt, q, k, v, lengths)
    assert bool(torch.isfinite(got).all())
    if fmt is None:
        want = tfd.flash_decode_ref(q, k, v, lengths)
        assert_ulp_rule(got, want, (24, 127, -126), _flash_slack(v, lengths))
    else:
        want = tfd.flash_decode_quantized_ref(q, k, v, lengths, fmt)
        assert_ulp_rule(got, want, fmt, _flash_slack(
            v, lengths, quantize_to_format(v, *fmt)))
    _assert_f64_rule(got, fmt, q, k, v, lengths)
    return got


def _lanes(gen, B, H, G, D, S, device):
    return (torch.randn(B, H, G, D, device=device, generator=gen),
            torch.randn(B, S, H, D, device=device, generator=gen),
            torch.randn(B, S, H, D, device=device, generator=gen))


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", DECODE_KERNELS)
@pytest.mark.parametrize("G,D", DECODE_GD)
def test_flash_decode_lane_bits_independent_of_batch_and_capacity(
        cuda_device, fmt, G, D):
    gen = torch.Generator(device=cuda_device).manual_seed(29)
    H, S, L = 2, 1024, 144
    q1, k1, v1 = _lanes(gen, 1, H, G, D, S, cuda_device)
    one = torch.tensor([L], dtype=torch.int32, device=cuda_device)
    alone = _decode(fmt, q1, k1, v1, one)
    small = _decode(fmt, q1, k1[:, :145].contiguous(),
                    v1[:, :145].contiguous(), one)
    assert_same_bits(small, alone)
    for pos in range(4):
        q, k, v = _lanes(gen, 4, H, G, D, S, cuda_device)
        q[pos], k[pos], v[pos] = q1[0], k1[0], v1[0]
        for others in ([1024, 0, 65, 1], [7, 144, 1000, 0]):
            lens = list(others)
            lens[pos] = L
            out = _decode(fmt, q, k, v, torch.tensor(
                lens, dtype=torch.int32, device=cuda_device))
            assert_same_bits(out[pos:pos + 1], alone)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", DECODE_KERNELS)
@pytest.mark.parametrize("G,D", [(2, 64), (7, 128), (8, 128)])
@pytest.mark.parametrize("S,lens", [
    (200, [63, 64, 65, 1]),
    (200, [0, 200, 128, 129]),
    # the combine folds chunk 0, then groups of 32 chunks: 33 chunks end
    # the first group, 34 open a second, 65 end it and 66 open a third
    (4224, [2112, 2113, 4160, 4161]),
    (32768, [32768, 0, 5000, 64]),
])
def test_flash_decode_length_edges_vs_plain(cuda_device, fmt, G, D, S, lens):
    """Chunk and group edges, lengths 0 and 1 and a 32K lane, against the
    plain version and the f64 split version."""
    gen = torch.Generator(device=cuda_device).manual_seed(31)
    q, k, v = _lanes(gen, len(lens), 2, G, D, S, cuda_device)
    _decode_vs_plain(fmt, q, k, v, torch.tensor(
        lens, dtype=torch.int32, device=cuda_device))


@pytest.mark.parametrize("fmt", [None, (12, 15, -14)])
def test_f64_rule_fails_a_dropped_chunk(fmt):
    """On the CPU, no card needed: the split algorithm in f32 (the kernels'
    order) meets the f64 rule, and the same cache with chunk 40 (positions
    2560..2623) cut out fails it in every lane that holds that chunk, the
    32K one included; the lane of 64 positions does not hold it."""
    gen = torch.Generator().manual_seed(43)
    S, lens = 32768, [32768, 5000, 2625, 64]
    q, k, v = _lanes(gen, len(lens), 2, 4, 128, S, "cpu")
    lengths = torch.tensor(lens, dtype=torch.int32)
    _assert_f64_rule(tfd.flash_decode_split_ref(q, k, v, lengths, fmt), fmt,
                     q, k, v, lengths)
    cut = [torch.cat([t[:, :2560], t[:, 2624:]], 1) for t in (k, v)]
    dropped = tfd.flash_decode_split_ref(
        q, *cut, torch.where(lengths > 2624, lengths - 64, lengths), fmt)
    for b, n in enumerate(lens):
        if n > 2624:
            with pytest.raises(AssertionError):
                _assert_f64_rule(dropped[b:b + 1], fmt, q[b:b + 1],
                                 k[b:b + 1], v[b:b + 1], lengths[b:b + 1])
        else:
            _assert_f64_rule(dropped[b:b + 1], fmt, q[b:b + 1], k[b:b + 1],
                             v[b:b + 1], lengths[b:b + 1])


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", DECODE_KERNELS)
@pytest.mark.parametrize("G,D", [(2, 64), (7, 128), (8, 128)])
def test_flash_decode_poisoned_cache_past_lengths(cuda_device, fmt, G, D):
    gen = torch.Generator(device=cuda_device).manual_seed(37)
    lens = [1, 64, 65, 130]
    q, k, v = _lanes(gen, len(lens), 2, G, D, 200, cuda_device)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    clean = _decode_vs_plain(fmt, q, k, v, lengths)
    for b, n in enumerate(lens):
        k[b, n:] = float("nan")
        v[b, n:] = float("nan")
    poisoned = _decode(fmt, q, k, v, lengths)
    assert bool(torch.isfinite(poisoned).all())
    assert_same_bits(poisoned, clean)


@pytest.mark.cuda
def test_flash_decode_refuses_what_its_copies_cannot_take(cuda_device):
    q = torch.randn(1, 1, 2, 62, device=cuda_device)
    kv = torch.randn(1, 8, 1, 62, device=cuda_device)
    lengths = torch.tensor([8], dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):                       # D % 4 != 0
        tfd.flash_decode_attention(q, kv, kv, lengths)
    q = torch.randn(1, 1, 2, 64, device=cuda_device)
    buf = torch.randn(8 * 64 + 1, device=cuda_device)
    kv = buf[1:].view(1, 8, 1, 64)                        # 4-byte aligned
    with pytest.raises(ValueError):
        tfd.flash_decode_certified(q, kv, kv, lengths, (12, 15, -14))

# --- kernels 5 and 6: the CAA analysis GEMMs --------------------------------
#
# caa_matmul: val within the GEMM rule 2·√K·2⁻²⁴·(|x|@|W|) of the plain
# version; err at least E = (dbar + g↑·|x|)@|W| in f64 from the same f32
# operands (g↑ = g rounded up to f32) and at most E·(1 + (2K+2)·2⁻²³).
# interval_matmul (through ops.interval_matmul_rigorous): after widening
# lo' ≤ L and hi' ≥ H, the f64 sign-split bounds of the same f32 operands;
# its width at most the plain version's + 4·√K·2⁻²⁴·mag; mag' within the
# GEMM rule. Exact-sum operands: every output bit for bit.

from repro_torch.kernels import caa_matmul as tcaa  # noqa: E402
from repro_torch.kernels import interval_matmul as tim  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

CAA_SHAPES = [(37, 200, 70), (4, 3584, 512), (9, 1000, 70), (7, 13, 9)]


def _gemm_rule(a, w):
    K = a.shape[1]
    return 2 * np.sqrt(K) * 2.0 ** -24 * (a.abs().double() @ w.abs().double())


def _caa_inputs(M, K, N, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(M, K, device=device, generator=gen)
    d = torch.rand(M, K, device=device, generator=gen) * 3.0
    w = torch.randn(K, N, device=device, generator=gen) / np.sqrt(K)
    return x, d, w


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", CAA_SHAPES)
def test_caa_matmul_kernel_vs_plain_on_card(cuda_device, M, K, N):
    x, d, w = _caa_inputs(M, K, N, cuda_device, 29)
    g = (K / 2) / (1 - K * 2.0 ** -25) * (1 + 2.0 ** -40)  # γ(K) at u 2^-24
    val, err = tcaa.caa_matmul(x, d, w, g=g)
    pval, _ = tcaa.caa_matmul_plain(x, d, w, g=g)
    diff = (val.double() - pval.double()).abs()
    assert bool((diff <= _gemm_rule(x, w)).all()), float(diff.max())
    g32 = tcaa.g_up_f32(g)
    assert g32 >= g
    E = (d.double() + g32 * x.abs().double()) @ w.abs().double()
    assert bool((err.double() >= E).all())
    assert bool((err.double() <= E * (1 + (2 * K + 2) * 2.0 ** -23)).all())
    if M > 5:
        v5, e5 = tcaa.caa_matmul(x[:5].contiguous(), d[:5].contiguous(), w,
                                 g=g)
        assert torch.equal(v5.view(torch.int32), val[:5].view(torch.int32))
        assert torch.equal(e5.view(torch.int32), err[:5].view(torch.int32))


def _coarse(M, K, N, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(-3, 4, (M, K), device=device,
                      generator=gen).float() * 2.0 ** -2
    d = torch.randint(0, 4, (M, K), device=device,
                      generator=gen).float() * 2.0 ** -3
    w = torch.randint(-3, 4, (K, N), device=device,
                      generator=gen).float() * 2.0 ** -3
    return x, d, w


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(4, 3584, 512), (37, 1000, 70)])
def test_caa_and_interval_kernels_exact_on_coarse_grid(cuda_device, M, K, N):
    # integers times 2^-2/2^-3 and g = 1/2: every t, product and partial
    # sum is an exact f32, so any order and any rounding give the same bits
    x, d, w = _coarse(M, K, N, cuda_device, 31)
    for got, want in zip(tcaa.caa_matmul(x, d, w, g=0.5),
                         tcaa.caa_matmul_plain(x, d, w, g=0.5)):
        assert_same_bits(got, want)
    lo, hi = x - d, x + d
    for got, want in zip(tim.interval_matmul(lo, hi, w),
                         tim.interval_matmul_plain(lo, hi, w)):
        assert_same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", CAA_SHAPES)
def test_interval_matmul_kernel_vs_plain_on_card(cuda_device, M, K, N):
    x, d, w = _caa_inputs(M, K, N, cuda_device, 37)
    lo, hi = x - 0.05 * d, x + 0.05 * d
    klo, khi, kmag = tops.interval_matmul_rigorous(lo, hi, w)
    raw = tim.interval_matmul(lo, hi, w)
    plo, phi, pmag = tim.interval_matmul_plain(lo, hi, w)
    g = tops.gamma_in_u(2 * K + 2, 2.0 ** -23) * 2.0 ** -23
    plo, phi = plo - g * pmag, phi + g * pmag
    L64, H64, W64 = lo.double(), hi.double(), w.double()
    Lx = L64 @ W64.clamp(min=0) + H64 @ W64.clamp(max=0)
    Hx = H64 @ W64.clamp(min=0) + L64 @ W64.clamp(max=0)
    assert bool((klo.double() <= Lx).all())
    assert bool((khi.double() >= Hx).all())
    mag64 = torch.maximum(lo.abs(), hi.abs()).double() @ W64.abs()
    slack = 4 * np.sqrt(K) * 2.0 ** -24 * mag64
    assert bool(((khi - klo).double()
                 <= (phi - plo).double() + slack).all())
    mdiff = (kmag.double() - pmag.double()).abs()
    assert bool((mdiff <= _gemm_rule(torch.maximum(lo.abs(), hi.abs()),
                                     w)).all())
    assert torch.equal(kmag.view(torch.int32), raw[2].view(torch.int32))
    for _ in range(3):
        t = torch.rand(M, K, device=cuda_device, dtype=torch.float64)
        pts = (L64 + (H64 - L64) * t) @ W64
        assert bool(((klo.double() <= pts) & (pts <= khi.double())).all())


@pytest.mark.cuda
def test_caa_kernels_count_launches_and_refuse_mixed_devices(cuda_device):
    x, d, w = _caa_inputs(6, 64, 32, cuda_device, 41)
    tcaa.caa_matmul.launches = 0
    tim.interval_matmul.launches = 0
    tops.caa_matmul_fused(x.reshape(2, 3, 64), d.reshape(2, 3, 64), w, g=2.0)
    tops.interval_matmul_rigorous(x - d, x + d, w)
    tcaa.caa_matmul_plain(x, d, w, g=2.0)
    tim.interval_matmul_plain(x - d, x + d, w)
    assert tcaa.caa_matmul.launches == 1
    assert tim.interval_matmul.launches == 1
    with pytest.raises(ValueError):
        tops.caa_matmul_fused(x, d, w.cpu(), g=2.0)
    with pytest.raises(ValueError):
        tops.interval_matmul_rigorous(x.cpu(), x, w)


# The certified GEMM body (csrc/quant_gemm.cuh) has a decode configuration
# (M <= 8) and a prefill one (M > 8); both keep one fmaf order per element,
# so at k <= 12 (exact products) each kernel equals its sequential-order
# plain version bit for bit, whatever the shape, the tile or the alignment.
GEMM_FMT = (12, 15, -14)
# Kernel 1 has one GEMM instantiation per has_subnormals value: the default
# flags, and a format without subnormals that overflows to inf (at emin =
# -6 many of these weights lie below the smallest normal).
GEMM_FLAGS = [(GEMM_FMT, True, True), ((8, 7, -6), False, False)]


def _gemm_pair(x, w, fmt=GEMM_FMT, subn=True, sat=True):
    """(kernel, sequential-order plain version) outputs of both kernels."""
    flags = dict(has_subnormals=subn, saturating=sat)
    return [(tqm.quant_matmul_format(x, w, fmt, **flags),
             tqm.quant_matmul_format_seq_ref(x, w, fmt, **flags)),
            (tqm.quant_matmul(x, w, k=12), tqm.quant_matmul_seq_ref(x, w, 12))]


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,subn,sat", GEMM_FLAGS)
@pytest.mark.parametrize("M", [1, 4, 8, 9, 65, 129, 512])
@pytest.mark.parametrize("N", [1, 70, 513, 3584])
def test_quant_gemm_ragged_shapes_keep_the_sequential_order(cuda_device, M,
                                                            N, fmt, subn,
                                                            sat):
    gen = torch.Generator(device=cuda_device).manual_seed(29)
    for K in (1, 31, 200, 3584):
        x = torch.randn(M, K, device=cuda_device, generator=gen)
        w = torch.randn(K, N, device=cuda_device, generator=gen) / np.sqrt(K)
        for got, want in _gemm_pair(x, w, fmt, subn, sat):
            assert_same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", [(200, 70), (3584, 512), (31, 3584)])
def test_quant_gemm_rows_invariant_across_configurations(cuda_device, K, N):
    """Rows 0..M-1 alone equal the same rows inside M = 512, for M on both
    sides of the decode/prefill switch."""
    gen = torch.Generator(device=cuda_device).manual_seed(31)
    x = torch.randn(512, K, device=cuda_device, generator=gen)
    w = torch.randn(K, N, device=cuda_device, generator=gen) / np.sqrt(K)
    full = [tqm.quant_matmul_format(x, w, GEMM_FMT),
            tqm.quant_matmul(x, w, k=12)]
    for M in (1, 2, 4, 7, 8, 9, 65, 129):
        xm = x[:M].contiguous()
        alone = [tqm.quant_matmul_format(xm, w, GEMM_FMT),
                 tqm.quant_matmul(xm, w, k=12)]
        for a, f in zip(alone, full):
            assert torch.equal(a.view(torch.int32), f[:M].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [3, 40])
@pytest.mark.parametrize("K", [17, 33])
def test_quant_gemm_negative_zero_at_a_ragged_k_edge(cuda_device, M, K):
    """Products that are all -0 sum to +0 from the +0 start; sums that
    cancel exactly give +0; no zero-padded term past K changes a sign."""
    x = torch.full((M, K), -0.0, device=cuda_device)
    x[:, ::2] = 0.0
    w = torch.ones(K, 5, device=cuda_device)
    w[::3] = -1.0
    x[-1, 0], x[-1, 1] = -0.5, 0.5
    w[0, :], w[1, :] = 1.0, 1.0
    for got, want in _gemm_pair(x, w):
        assert_same_bits(got, want)
        assert not bool(torch.signbit(got).any())


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,subn,sat", GEMM_FLAGS)
@pytest.mark.parametrize("M", [4, 129])
@pytest.mark.parametrize("N", [512, 70])
def test_quant_gemm_unaligned_operands(cuda_device, M, N, fmt, subn, sat):
    """w and x whose base is 4 bytes past a 16-byte boundary take the
    4-byte copies; they give the aligned copies' bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(37)
    K = 200
    wbuf = torch.randn(K * N + 1, device=cuda_device, generator=gen)
    xbuf = torch.randn(M * K + 1, device=cuda_device, generator=gen)
    w, x = wbuf[1:].view(K, N), xbuf[1:].view(M, K)
    assert w.data_ptr() % 16 != 0 and x.data_ptr() % 16 != 0
    aligned = _gemm_pair(x.clone(), w.clone(), fmt, subn, sat)
    for (got, want), (ref, _) in zip(_gemm_pair(x, w, fmt, subn, sat),
                                     aligned):
        assert_same_bits(got, want)
        assert_same_bits(got, ref)


# The interval GEMM body (csrc/interval_gemm.cuh, kernels caa_matmul and
# interval_matmul) has a decode configuration (M <= 8) and prefill tiles
# chosen by the grid; every one keeps one fmaf / __fmaf_ru order per
# element, so each kernel equals its sequential-order plain version (exact
# emulated steps) bit for bit, whatever the shape, tile or alignment.
IVL_G = 0.5 + 2.0 ** -20     # a g whose t = g·|x| + dbar is rarely exact


def _ivl_pairs(x, d, w, lohi=None):
    """(kernel, sequential-order plain version) outputs of both kernels;
    interval_matmul takes ``lohi`` or [x - d/20, x + d/20]."""
    lo, hi = lohi if lohi is not None else (x - 0.05 * d, x + 0.05 * d)
    return (list(zip(tcaa.caa_matmul(x, d, w, g=IVL_G),
                     tcaa.caa_matmul_seq_ref(x, d, w, g=IVL_G)))
            + list(zip(tim.interval_matmul(lo, hi, w),
                       tim.interval_matmul_seq_ref(lo, hi, w))))


def _ivl_operands(gen, M, K, N, device):
    x = torch.randn(M, K, device=device, generator=gen)
    d = torch.rand(M, K, device=device, generator=gen) * 3.0
    w = torch.randn(K, N, device=device, generator=gen) / np.sqrt(K)
    return x, d, w


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4, 8, 9, 40, 129, 512])
@pytest.mark.parametrize("N", [1, 10, 513, 3584])
def test_interval_gemm_ragged_shapes_keep_the_sequential_order(cuda_device,
                                                               M, N):
    gen = torch.Generator(device=cuda_device).manual_seed(43)
    for K in (1, 31, 200, 1001):
        for got, want in _ivl_pairs(*_ivl_operands(gen, M, K, N,
                                                   cuda_device)):
            assert_same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", [(200, 70), (3584, 512), (31, 3584),
                                 (784, 700)])
def test_interval_gemm_rows_invariant_for_m_1_to_512(cuda_device, K, N):
    """Rows 0..M-1 alone equal the same rows inside M = 512, for M across
    the decode configuration and every prefill tile."""
    gen = torch.Generator(device=cuda_device).manual_seed(47)
    x, d, w = _ivl_operands(gen, 512, K, N, cuda_device)
    lo, hi = x - 0.05 * d, x + 0.05 * d
    full = (tcaa.caa_matmul(x, d, w, g=IVL_G)
            + tim.interval_matmul(lo, hi, w))
    for M in (1, 2, 3, 4, 5, 7, 8, 9, 10, 16, 17, 33, 64, 65, 129, 257, 511):
        alone = (tcaa.caa_matmul(x[:M].contiguous(), d[:M].contiguous(), w,
                                 g=IVL_G)
                 + tim.interval_matmul(lo[:M].contiguous(),
                                       hi[:M].contiguous(), w))
        for a, f in zip(alone, full):
            assert torch.equal(a.view(torch.int32), f[:M].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [4, 10, 129])
@pytest.mark.parametrize("K,N", [(201, 10), (203, 512), (256, 10)])
def test_interval_gemm_unaligned_operands(cuda_device, M, K, N):
    """N = 10 or K % 4 != 0, and bases 4 bytes past a 16-byte boundary,
    take the 4-byte copies; they give the sequential order's bits and the
    aligned copies' bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(53)
    bufs = [torch.randn(n + 1, device=cuda_device, generator=gen)
            for n in (M * K, M * K, K * N)]
    x, d, w = (b[1:].view(s) for b, s in zip(bufs, ((M, K), (M, K), (K, N))))
    lohi = []
    for t in (x - 0.05 * d.abs(), x + 0.05 * d.abs()):
        u = torch.empty(M * K + 1, device=cuda_device)[1:].view(M, K)
        lohi.append(u.copy_(t))
    assert all(t.data_ptr() % 16 != 0 for t in (x, d, w, *lohi))
    aligned = _ivl_pairs(x.clone(), d.clone(), w.clone(),
                         [t.clone() for t in lohi])
    for (got, want), (ref, _) in zip(_ivl_pairs(x, d, w, lohi), aligned):
        assert_same_bits(got, want)
        assert_same_bits(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [3, 40])
@pytest.mark.parametrize("K", [17, 33])
def test_interval_gemm_negative_zero_at_a_ragged_k_edge(cuda_device, M, K):
    """Products that are all ±0 sum to +0 from the +0 start in every
    accumulator; sums that cancel exactly give +0; no zero-padded term past
    K changes a sign."""
    x = torch.full((M, K), -0.0, device=cuda_device)
    x[:, ::2] = 0.0
    d = torch.zeros(M, K, device=cuda_device)
    d[:, -1] = -0.0
    w = torch.ones(K, 5, device=cuda_device)
    w[::3] = -1.0
    w[-1] = -0.0
    x[-1, 0], x[-1, 1] = -0.5, 0.5
    w[0, :], w[1, :] = 1.0, 1.0
    for got, want in _ivl_pairs(x, d, w):
        assert_same_bits(got, want)
        assert not bool(torch.signbit(got).any())


# ---------------------------------------------------------------------------
# the port-only fixed-order kernels of serving: row_mean and f32_matmul
# ---------------------------------------------------------------------------

from repro_torch.kernels import row_order as tro  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 255, 256, 300, 3584, 18944])
def test_row_mean_kernel_bitwise_vs_plain_and_row_invariant(cuda_device, n):
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    x = torch.randn(37, n, device=cuda_device, generator=gen) ** 2
    before = tro.row_mean.launches
    got = tro.row_mean(x)
    assert tro.row_mean.launches == before + 1
    want = tro.row_mean_ref(x)[:, 0]
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    for r in (0, 5, 36):
        alone = tro.row_mean(x[r:r + 1].contiguous())
        assert torch.equal(alone.view(torch.int32),
                           got[r:r + 1].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(1, 3584, 1000), (4, 3584, 4000),
                                   (4, 130, 1001), (37, 200, 70),
                                   (96, 3584, 520)])
def test_f32_matmul_kernel_bitwise_vs_fmaf_chain(cuda_device, M, K, N):
    gen = torch.Generator(device=cuda_device).manual_seed(M + N)
    x = torch.randn(M, K, device=cuda_device, generator=gen)
    w = torch.randn(K, N, device=cuda_device, generator=gen) / np.sqrt(K)
    before = tro.f32_matmul.launches
    got = tro.f32_matmul(x, w)
    assert tro.f32_matmul.launches == before + 1
    cols = torch.arange(0, N, max(1, N // 64), device=cuda_device)
    want = tro.f32_matmul_seq_ref(x, w[:, cols])
    assert torch.equal(got[:, cols].view(torch.int32),
                       want.view(torch.int32))
    # one order per element in both tiers (GEMV M <= 8, SGEMM M > 8): a
    # row alone gives the bits it gives in the batch
    for r in (0, M - 1):
        alone = tro.f32_matmul(x[r:r + 1].contiguous(), w)
        assert torch.equal(alone.view(torch.int32),
                           got[r:r + 1].view(torch.int32))


@pytest.mark.cuda
def test_torch_ops_route_mean_and_lm_head_through_the_kernels(cuda_device):
    from repro_torch.core.backend import TorchOps

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(4, 1, 3584, device=cuda_device, generator=gen)
    table = torch.randn(1000, 3584, device=cuda_device, generator=gen)
    bk = TorchOps()
    m0, h0 = tro.row_mean.launches, tro.f32_matmul.launches
    ms = bk.mean(bk.square(x), dim=-1, keepdim=True)
    logits = bk.einsum("bsd,vd->bsv", x, table)
    bk.einsum("bsd,vd->bsv", x[:1], table)
    assert (tro.row_mean.launches, tro.f32_matmul.launches) == (m0 + 1,
                                                                h0 + 2)
    assert torch.equal(ms, tro.row_mean_ref(x * x))
    assert logits.shape == (4, 1, 1000)
    # the transposed table is made once and kept while the table is
    assert bk._head_t[1].shape == (3584, 1000)
    # f64 (the exact model) and other reductions keep the library
    assert torch.equal(bk.mean(x.double(), dim=-1, keepdim=True),
                       x.double().mean(-1, keepdim=True))
    assert tro.row_mean.launches == m0 + 1


@pytest.mark.cuda
def test_row_order_kernels_refuse_what_they_cannot_take(cuda_device):
    x = torch.randn(4, 64, device=cuda_device)
    for bad in (x.double(), x.t(), x.cpu()):
        with pytest.raises(ValueError):
            tro.row_mean(bad)
        with pytest.raises(ValueError):
            tro.f32_matmul(bad, torch.randn(64, 8, device=cuda_device))
    with pytest.raises(ValueError):
        tro.f32_matmul(x, torch.randn(63, 8, device=cuda_device))
