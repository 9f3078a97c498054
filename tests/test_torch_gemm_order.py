"""The sequential-order plain versions of the two certified GEMMs
(``quant_matmul_format_seq_ref``, ``quant_matmul_seq_ref``) on the CPU.

They sum x̂[:, j]·ŵ[j, :] for j = 0..K-1 in f32 from +0, one rounding per
step — the CUDA kernels' fmaf order. For k ≤ 12 every product is exact in
f32, so each step is the kernels' fmaf: the card checks (chip_smoke.py's
``gemm_order`` phase, tests/test_torch_kernels_cuda.py) hold the kernels to
these bit for bit. Here they are held:

* bit for bit against the JAX package's oracles (``quant_matmul_format_ref``,
  ``ref.quant_matmul_ref``) on exact-sum operands, where any order gives the
  same bits;
* against the same oracles on random operands within one ulp at k plus
  2·√K·2⁻²⁴·(|x̂|@|ŵ|), what two f32 sums of the same K terms differ by when
  they add in another order (their rounding errors have random signs);
* bit for bit against an fmaf chain emulated in f64 with numpy for k ≤ 12
  (the product is exact in f64; adding two f32 values in f64 and rounding to
  f32 is the f32 sum, since 53 ≥ 2·24 + 2).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quant_matmul as jqm
from repro.kernels import ref as jref
from repro_torch.core.quantize import _quantize_normal, quantize_to_format
from repro_torch.kernels import quant_matmul as tqm

FORMATS = [(12, 15, -14), (8, 7, -6), (10, 15, -14), (24, 127, -126)]
KS = [2, 8, 12, 24]
SHAPES = [(1, 1, 1), (5, 37, 9), (9, 200, 70)]


def _coarse(rng, M, K, N):
    """Integers in [-3, 3] times 2^-2 resp. 2^-3: exact in every format and
    precision here, and every partial sum of their products is exact."""
    x = rng.integers(-3, 4, (M, K)).astype(np.float32) * np.float32(0.25)
    w = rng.integers(-3, 4, (K, N)).astype(np.float32) * np.float32(0.125)
    return x, w


def _random(rng, M, K, N):
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    return x, w


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _ulp_at_k(a, k, emin):
    _, e = np.frexp(np.abs(a))
    return np.ldexp(1.0, np.maximum(e - 1, emin) - (k - 1))


def _assert_order_rule(got, want, xq, wq, k, emin):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    K = xq.shape[1]
    tol = 2 * np.sqrt(K) * 2.0 ** -24 * (np.abs(np.asarray(xq, np.float64))
                                         @ np.abs(np.asarray(wq, np.float64)))
    ulp = _ulp_at_k(np.maximum(np.abs(got), np.abs(want)), k, emin)
    bad = ~((got == want) | (np.abs(got - want) <= ulp + tol))
    assert not bad.any(), (int(bad.sum()), float(np.abs(got - want).max()))


def _fma_chain_f64(xq, wq):
    """acc_j = f32(acc_{j-1} + x̂_j·ŵ_j) from +0, each step in f64."""
    xq = np.asarray(xq, np.float64)
    wq = np.asarray(wq, np.float64)
    acc = np.zeros((xq.shape[0], wq.shape[1]), np.float32)
    for j in range(xq.shape[1]):
        acc = (acc.astype(np.float64)
               + xq[:, j:j + 1] * wq[j:j + 1, :]).astype(np.float32)
    return acc


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_format_seq_ref_bitwise_on_exact_sums(fmt, M, K, N):
    x, w = _coarse(np.random.default_rng(1), M, K, N)
    got = tqm.quant_matmul_format_seq_ref(torch.from_numpy(x),
                                          torch.from_numpy(w), fmt)
    want = jqm.quant_matmul_format_ref(jnp.asarray(x), jnp.asarray(w), fmt)
    assert np.array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_k_seq_ref_bitwise_on_exact_sums(k, M, K, N):
    x, w = _coarse(np.random.default_rng(2), M, K, N)
    got = tqm.quant_matmul_seq_ref(torch.from_numpy(x), torch.from_numpy(w),
                                   k)
    want = jref.quant_matmul_ref(jnp.asarray(x), jnp.asarray(w), k)
    assert np.array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("fmt", FORMATS)
def test_format_seq_ref_within_order_rule(fmt):
    x, w = _random(np.random.default_rng(3), 9, 300, 40)
    got = tqm.quant_matmul_format_seq_ref(torch.from_numpy(x),
                                          torch.from_numpy(w), fmt)
    want = jqm.quant_matmul_format_ref(jnp.asarray(x), jnp.asarray(w), fmt)
    xq = quantize_to_format(torch.from_numpy(x), *fmt).numpy()
    wq = quantize_to_format(torch.from_numpy(w), *fmt).numpy()
    _assert_order_rule(got.numpy(), want, xq, wq, fmt[0], fmt[2])


@pytest.mark.parametrize("k", KS)
def test_k_seq_ref_within_order_rule(k):
    x, w = _random(np.random.default_rng(4), 9, 300, 40)
    got = tqm.quant_matmul_seq_ref(torch.from_numpy(x), torch.from_numpy(w),
                                   k)
    want = jref.quant_matmul_ref(jnp.asarray(x), jnp.asarray(w), k)
    xq = _quantize_normal(torch.from_numpy(x), k).numpy()
    wq = _quantize_normal(torch.from_numpy(w), k).numpy()
    _assert_order_rule(got.numpy(), want, xq, wq, k, -126)


@pytest.mark.parametrize("fmt", [f for f in FORMATS if f[0] <= 12])
def test_format_seq_ref_is_the_fmaf_chain(fmt):
    x, w = _random(np.random.default_rng(5), 6, 257, 33)
    got = tqm.quant_matmul_format_seq_ref(torch.from_numpy(x),
                                          torch.from_numpy(w), fmt)
    q = lambda a: quantize_to_format(torch.from_numpy(a), *fmt)
    want = q(_fma_chain_f64(q(x).numpy(), q(w).numpy())).numpy()
    assert np.array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("k", [k for k in KS if k <= 12])
def test_k_seq_ref_is_the_fmaf_chain(k):
    x, w = _random(np.random.default_rng(6), 6, 257, 33)
    got = tqm.quant_matmul_seq_ref(torch.from_numpy(x), torch.from_numpy(w),
                                   k)
    q = lambda a: _quantize_normal(torch.from_numpy(np.asarray(a)), k)
    want = q(_fma_chain_f64(q(x).numpy(), q(w).numpy())).numpy()
    assert np.array_equal(_bits(got.numpy()), _bits(want))


def test_seq_ref_keeps_plus_zero_over_negative_zero_products():
    """A row whose products are all -0 sums to +0 from the +0 start, as the
    kernels' fmaf chain does; a sum that is -0 only through a zero-padded
    term would be the kernels' bug, not this function's."""
    x = np.array([[-0.0, 0.0, -0.5]], np.float32)
    w = np.array([[1.0], [-1.0], [0.0]], np.float32)
    got = tqm.quant_matmul_seq_ref(torch.from_numpy(x), torch.from_numpy(w),
                                   12)
    assert _bits(got.numpy())[0, 0] == 0
    assert np.array_equal(_bits(got.numpy()),
                          _bits(_fma_chain_f64(x, w)))
