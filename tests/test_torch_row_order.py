"""The plain versions of serving's two port-only fixed-order kernels
(``repro_torch.kernels.row_order``) on the CPU, and the routing of
``TorchOps.mean`` / ``TorchOps.einsum`` that reaches them on the card.

* ``row_mean_ref`` (``csrc/row_mean.cu``'s order: 256 strided per-thread
  sums, an xor butterfly a warp, the 8 warp sums in order, ÷ n) and
  ``f32_matmul_seq_ref`` (``csrc/f32_matmul.cu``'s fmaf chain from +0 in k
  order) against ``torch.mean`` / ``torch.einsum`` and against the JAX
  package's ``jnp.mean`` / ``jnp.einsum`` of the same f32 inputs, within the
  order rule the GEMM tests use: 2·√n·2⁻²⁴ times the sum of magnitudes
  (two f32 sums of the same n terms in other orders; a summation error
  with random signs grows as √n).
* A row's bits do not depend on the other rows: each row alone equals the
  same row in a batch, bit for bit.
* ``f32_matmul_seq_ref`` is an exact fmaf chain: against an f64 numpy
  chain with the f32 rounding done once per step (Boldo–Melquiond: round
  to odd, then to nearest), bit for bit.
* On the CPU, ``TorchOps`` keeps ``Tensor.mean`` and ``torch.einsum``
  (the routing is card-only), so CPU serving keeps its bits.
"""
import _torch_test_setup  # noqa: F401  (before any reference compile)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core.backend import TorchOps
from repro_torch.kernels import row_order as ro

NS = [1, 7, 255, 256, 300, 3584]


def _order_rule(got, want, mag, n):
    tol = 2.0 * np.sqrt(n) * 2.0 ** -24 * mag
    np.testing.assert_array_less(np.abs(np.float64(got) - np.float64(want)),
                                 tol + 1e-45)


@pytest.mark.parametrize("n", NS)
def test_row_mean_ref_against_library_means(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, 2, n)).astype(np.float32) ** 2
    got = ro.row_mean_ref(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 2, 1) and got.dtype == np.float32
    mag = np.abs(x).sum(-1, keepdims=True) / n
    _order_rule(got, torch.from_numpy(x).mean(-1, keepdim=True).numpy(),
                mag, n)
    _order_rule(got, np.asarray(jnp.mean(jnp.asarray(x), axis=-1,
                                         keepdims=True)), mag, n)


def test_row_mean_ref_rows_independent_and_exact_sums():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((5, 300)).astype(np.float32))
    batch = ro.row_mean_ref(x)
    for r in range(5):
        assert torch.equal(ro.row_mean_ref(x[r:r + 1]), batch[r:r + 1])
    # small integers: every partial sum is exact, so any order agrees
    ints = torch.from_numpy(rng.integers(-8, 9, (4, 3584)).astype(
        np.float32))
    assert torch.equal(ro.row_mean_ref(ints),
                       (ints.double().sum(-1, keepdim=True) / 3584).float())


def test_row_mean_dispatch_is_the_plain_version_on_the_cpu():
    x = torch.randn(2, 3, 100, generator=torch.Generator().manual_seed(0))
    assert torch.equal(ro.row_mean_dispatch(x), ro.row_mean_ref(x))


def _fmaf_chain_np(x, w):
    """acc = fl32(x[:, j]·w[j, :] + acc) for j = 0..K-1, each step rounded
    once: the f64 sum of the exact product and acc, made odd where inexact
    (two-sum), then rounded to f32."""
    acc = np.zeros((x.shape[0], w.shape[1]), np.float32)
    for j in range(x.shape[1]):
        p = x[:, j:j + 1].astype(np.float64) * w[j:j + 1].astype(np.float64)
        c = acc.astype(np.float64)
        s = p + c
        bb = s - p
        e = (p - (s - bb)) + (c - bb)
        odd = (s.view(np.int64) & 1) == 1
        s = np.where((e != 0) & ~odd, np.nextafter(s, np.copysign(
            np.inf, e)), s)
        acc = s.astype(np.float32)
    return acc


@pytest.mark.parametrize("shape", [(1, 1, 1), (3, 37, 9), (9, 130, 50)])
def test_f32_matmul_seq_ref_is_an_fmaf_chain(shape):
    M, K, N = shape
    rng = np.random.default_rng(K)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    got = ro.f32_matmul_seq_ref(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  _fmaf_chain_np(x, w).view(np.int32))


def test_lm_head_plain_against_library_einsums_and_rows_independent():
    rng = np.random.default_rng(2)
    B, S, D, V = 2, 3, 96, 40
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    table = (rng.standard_normal((V, D)) * 0.05).astype(np.float32)
    tt = ro.transposed(torch.from_numpy(table))
    assert tt.is_contiguous() and tt.shape == (D, V)
    got = ro.lm_head_dispatch(torch.from_numpy(x), tt)
    assert got.shape == (B, S, V)
    mag = np.abs(x) @ np.abs(table).T
    _order_rule(got.numpy(), torch.einsum(
        "bsd,vd->bsv", torch.from_numpy(x), torch.from_numpy(table)).numpy(),
        mag, D)
    _order_rule(got.numpy(), np.asarray(jnp.einsum(
        "bsd,vd->bsv", jnp.asarray(x), jnp.asarray(table))), mag, D)
    for b in range(B):
        assert torch.equal(ro.lm_head_dispatch(torch.from_numpy(x[b:b + 1]),
                                               tt), got[b:b + 1])


def test_torch_ops_keep_the_library_on_the_cpu():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 4, 64, generator=g)
    table = torch.randn(30, 64, generator=g)
    bk = TorchOps()
    assert torch.equal(bk.mean(x * x, dim=-1, keepdim=True),
                       (x * x).mean(dim=-1, keepdim=True))
    assert torch.equal(bk.einsum("bsd,vd->bsv", x, table),
                       torch.einsum("bsd,vd->bsv", x, table))
    assert bk._head_t is None
