"""The port's CAA analysis kernels on the CPU: the plain versions and the
``ops`` wrappers (``repro_torch.kernels.ops``) against the JAX package's
``repro.kernels.ops`` with its Pallas kernels in interpret mode, at the
shapes of the reference's own kernel tests (a ragged (7, 13, 9) case and a
batched leading dim included). The CUDA kernels themselves are held
against these plain versions on a card (tests/test_torch_kernels_cuda.py,
chip_smoke.py).

Tolerances: every output within what two f32 sums of the same K terms
differ by when they add in other orders, 2·√K·2⁻²⁴·Σ|terms| (the terms of
val and of the interval bounds are x·w, those of err and mag are
non-negative); the interval enclosure contains the f64 product at sampled
points of [lo, hi] and the f64 sign-split bounds of the f32 operands.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import caa_matmul as tcaa
from repro_torch.kernels import interval_matmul as tim
from repro_torch.kernels import ops as tops

SHAPES = [(8, 16, 8), (32, 64, 16), (40, 100, 30), (128, 256, 64), (7, 13, 9)]


def _order_tol(a, w):
    K = a.shape[-1]
    return 2 * np.sqrt(K) * 2.0 ** -24 * (np.abs(a.astype(np.float64))
                                          @ np.abs(w.astype(np.float64)))


def _pallas_blocks(M, K, N):
    return dict(block_m=8 if M % 16 else 16, block_n=8 if N % 16 else 16,
                block_k=8 if K % 32 else 32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("g", [0.5, 3.0, 1.0 / 3.0])
def test_caa_matmul_fused_vs_reference(shape, g):
    M, K, N = shape
    rng = np.random.RandomState(N + K)
    x = rng.randn(M, K).astype(np.float32)
    d = np.abs(rng.randn(M, K)).astype(np.float32)
    w = rng.randn(K, N).astype(np.float32)
    jv, je = jops.caa_matmul_fused(x, d, w, g=g, interpret=True,
                                   **_pallas_blocks(M, K, N))
    rv, re = jref.caa_matmul_ref(jnp.asarray(x), jnp.asarray(d),
                                 jnp.asarray(w), g)
    tv, te = tops.caa_matmul_fused(torch.from_numpy(x), torch.from_numpy(d),
                                   torch.from_numpy(w), g=g)
    pv, pe = tcaa.caa_matmul_plain(torch.from_numpy(x), torch.from_numpy(d),
                                   torch.from_numpy(w), g=g)
    assert torch.equal(tv, pv) and torch.equal(te, pe)
    assert tv.dtype == te.dtype == torch.float32 and tv.shape == (M, N)
    t = d.astype(np.float64) + tcaa.g_up_f32(g) * np.abs(x)
    for want in (jv, rv):
        assert (np.abs(np.asarray(want) - tv.numpy())
                <= _order_tol(x, w)).all()
    # err of the f32-rounded g (reference) and of g rounded up (port):
    # apart by at most one f32 ulp of g on each term, plus the order
    gap = (2.0 ** -23 * tcaa.g_up_f32(g) * np.abs(x).astype(np.float64)
           @ np.abs(w).astype(np.float64))
    for want in (je, re):
        assert (np.abs(np.asarray(want) - te.numpy())
                <= _order_tol(t, w) + gap).all()
    exact = t @ np.abs(w.astype(np.float64))
    assert (np.abs(te.numpy() - exact) <= _order_tol(t, w)).all()


def test_g_rounds_up_to_f32():
    for g in (0.5, 1.0 / 3.0, 392.00000000001, 1e-30, 0.0):
        g32 = tcaa.g_up_f32(g)
        assert g32 >= g and float(np.float32(g32)) == g32
        assert float(np.nextafter(np.float32(g32), np.float32(0))) < g or \
            g32 == 0.0


def _interval_case(shape, seed, spread=0.01):
    M, K, N = shape
    rng = np.random.RandomState(seed)
    x = rng.randn(M, K).astype(np.float32)
    r = (np.abs(rng.randn(M, K)) * spread).astype(np.float32)
    w = rng.randn(K, N).astype(np.float32)
    return x - r, x + r, w, rng


@pytest.mark.parametrize("shape", SHAPES)
def test_interval_matmul_rigorous_vs_reference(shape):
    M, K, N = shape
    lo, hi, w, _ = _interval_case(shape, M + K)
    jlo, jhi, jmag = jops.interval_matmul_rigorous(
        lo, hi, w, interpret=True, **_pallas_blocks(M, K, N))
    tlo, thi, tmag = tops.interval_matmul_rigorous(
        torch.from_numpy(lo), torch.from_numpy(hi), torch.from_numpy(w))
    plo, phi, pmag = tim.interval_matmul_plain(
        torch.from_numpy(lo), torch.from_numpy(hi), torch.from_numpy(w))
    assert torch.equal(tmag, pmag)
    mag = np.maximum(np.abs(lo), np.abs(hi))
    tol = _order_tol(mag, w)
    for j, t in ((jlo, tlo), (jhi, thi), (jmag, tmag)):
        assert (np.abs(np.asarray(j) - t.numpy()) <= tol).all()
    rlo, rhi, rmag = jref.interval_matmul_ref(
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(w))
    assert (np.abs(np.asarray(rmag) - pmag.numpy()) <= tol).all()
    g = tops.gamma_in_u(2 * K + 2, 2.0 ** -23) * 2.0 ** -23
    assert g == jref.gamma_in_u(2 * K + 2, 2.0 ** -23) * 2.0 ** -23
    np.testing.assert_array_equal((plo - g * pmag).numpy(), tlo.numpy())
    np.testing.assert_array_equal((phi + g * pmag).numpy(), thi.numpy())


@pytest.mark.parametrize("shape", [(8, 16, 8), (32, 64, 16), (40, 100, 30),
                                   (7, 13, 9)])
def test_interval_matmul_enclosure(shape):
    M, K, N = shape
    lo, hi, w, rng = _interval_case(shape, K, spread=0.05)
    tlo, thi, _ = tops.interval_matmul_rigorous(
        torch.from_numpy(lo), torch.from_numpy(hi), torch.from_numpy(w))
    tlo, thi = tlo.numpy().astype(np.float64), thi.numpy().astype(np.float64)
    L, H, W = (a.astype(np.float64) for a in (lo, hi, w))
    assert (tlo <= L @ np.maximum(W, 0) + H @ np.minimum(W, 0)).all()
    assert (thi >= H @ np.maximum(W, 0) + L @ np.minimum(W, 0)).all()
    for _ in range(5):
        y = (L + (H - L) * rng.rand(M, K)) @ W
        assert (tlo <= y).all() and (y <= thi).all()


def test_batched_leading_dims():
    rng = np.random.RandomState(6)
    x = rng.randn(2, 5, 32).astype(np.float32)
    d = np.abs(rng.randn(2, 5, 32)).astype(np.float32)
    w = rng.randn(32, 8).astype(np.float32)
    jv, je = jops.caa_matmul_fused(x, d, w, g=2.0, interpret=True,
                                   block_m=8, block_n=8, block_k=16)
    tv, te = tops.caa_matmul_fused(torch.from_numpy(x), torch.from_numpy(d),
                                   torch.from_numpy(w), g=2.0)
    assert tv.shape == te.shape == (2, 5, 8)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5,
                               atol=1e-5)
    outs = tops.interval_matmul_rigorous(torch.from_numpy(x - d),
                                         torch.from_numpy(x + d),
                                         torch.from_numpy(w))
    jouts = jops.interval_matmul_rigorous(x - d, x + d, w, interpret=True,
                                          block_m=8, block_n=8, block_k=16)
    for j, t in zip(jouts, outs):
        assert t.shape == (2, 5, 8)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-4)


def test_kernel_wrappers_refuse_cpu_tensors_and_count_nothing():
    """The CUDA wrappers take only card tensors (the plain versions are
    used for CPU tensors by ``ops``, never as a fallback)."""
    x = torch.randn(4, 8)
    w = torch.randn(8, 3)
    tcaa.caa_matmul.launches = 0
    tim.interval_matmul.launches = 0
    with pytest.raises(ValueError):
        tcaa.caa_matmul(x, x.abs(), w, g=1.0)
    with pytest.raises(ValueError):
        tim.interval_matmul(x, x + 1, w)
    tops.caa_matmul_fused(x, x.abs(), w, g=1.0)
    tops.interval_matmul_rigorous(x, x + 1, w)
    assert tcaa.caa_matmul.launches == 0
    assert tim.interval_matmul.launches == 0
