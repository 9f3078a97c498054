"""The sequential-order plain versions of the two interval GEMMs
(``caa_matmul_seq_ref``, ``interval_matmul_seq_ref``) and their emulated
f32 steps (``fmaf_rn``, ``fmaf_ru``) on the CPU.

The CUDA kernels sum k = 0..K-1 from +0 with one ``fmaf`` (round to
nearest) or ``__fmaf_ru`` (toward +inf) per term and accumulator; the card
checks (chip_smoke.py's ``interval_gemm_order`` phase,
tests/test_torch_kernels_cuda.py) hold them to these plain versions bit for
bit. Here they are held:

* each emulated step against exact rational arithmetic (``fractions``):
  sampled triples, f32 midpoints whose f64 sum hides the residual, signed
  zeros, subnormals and overflow;
* against the JAX package's oracles (``ref.caa_matmul_ref``,
  ``ref.interval_matmul_ref`` before its slop) within the order rule of
  tests/test_torch_caa_kernels.py, 2·√K·2⁻²⁴·Σ|terms|, on random operands;
  err, rounded up at every step, by the kernel's rule E ≤ err ≤
  E·(1 + (2K+2)·2⁻²³) around the exact f64 value E of the f32 operands;
* bit for bit against the plain versions on exact-sum operands, where any
  order and any rounding give the same bits;
* on zeros of either sign at a ragged K edge.
"""
import _torch_test_setup  # noqa: F401  (before any reference compile)
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import caa_matmul as tcaa
from repro_torch.kernels import interval_matmul as tim

F32_MAX = float(np.finfo(np.float32).max)
MIDPOINT_TOP = Fraction(2) ** 128 - Fraction(2) ** 103   # FLT_MAX + ulp/2


def _f32(v):
    return np.float32(v)


def _neighbours(v: Fraction):
    """The f32 values lo ≤ v ≤ hi next to a finite v with |v| ≤ FLT_MAX."""
    c = _f32(float(v))
    while Fraction(float(c)) > v:
        c = np.nextafter(c, _f32(-np.inf))
    lo = c
    hi = lo if Fraction(float(lo)) == v else np.nextafter(lo, _f32(np.inf))
    return lo, hi


def _exact_fma(a, b, c, mode):
    """IEEE fma of f32 a, b, c rounded to f32 by ``mode`` ('rn' or 'ru'),
    from exact rationals."""
    v = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    if v == 0:
        # an exact zero sum: -0 only if the product and c are both -0
        p_neg = (np.signbit(a) != np.signbit(b))
        neg = p_neg and np.signbit(c) and float(a) * float(b) == 0 \
            and float(c) == 0
        return _f32(-0.0) if neg else _f32(0.0)
    if abs(v) > F32_MAX:
        if mode == "ru":
            return _f32(np.inf) if v > 0 else _f32(-F32_MAX)
        big = abs(v) >= MIDPOINT_TOP
        return _f32(np.copysign(np.inf if big else F32_MAX, float(v)))
    lo, hi = _neighbours(v)
    if mode == "ru":
        return hi
    dl, dh = v - Fraction(float(lo)), Fraction(float(hi)) - v
    if dl != dh:
        return lo if dl < dh else hi
    even_lo = int(np.abs(lo).view(np.int32)) % 2 == 0
    return lo if even_lo else hi


def _emulated(a, b, c, mode):
    fn = tcaa.fmaf_rn if mode == "rn" else tcaa.fmaf_ru
    t = [torch.from_numpy(np.asarray(v, np.float32)) for v in (a, b, c)]
    return fn(*t).numpy()


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _random_triples(rng, n):
    """Finite f32 triples: random bit patterns (subnormals and zeros of
    both signs among them), and c near a·b so that the sum cancels."""
    bits = rng.integers(0, 2 ** 32, (n, 3), dtype=np.uint64).astype(np.uint32)
    t = bits.view(np.float32).copy()
    t[~np.isfinite(t)] = 1.0
    a, b, c = t[:, 0], t[:, 1], t[:, 2]
    k = n // 2
    m = rng.standard_normal((k, 2)).astype(np.float32)
    a[:k], b[:k] = m[:, 0], m[:, 1]
    c[:k] = (-(a[:k].astype(np.float64) * b[:k]) * (1 + rng.uniform(
        -1e-6, 1e-6, k))).astype(np.float32)
    sub = rng.integers(0, 2 ** 23, (n // 8, 3)).astype(np.uint32)
    sub |= (rng.integers(0, 2, (n // 8, 3)).astype(np.uint32) << 31)
    t[-(n // 8):] = sub.view(np.float32)
    t[:8] = [[0.0, 1.0, -0.0], [-0.0, 1.0, -0.0], [-0.0, -1.0, 0.0],
             [1.0, -1.0, 1.0], [-1.0, 1.0, 1.0], [1e-45, 1e-45, -0.0],
             [-1e-45, 1e-45, 0.0], [1e-45, -0.5, 0.0]]
    return t


HUGE = F32_MAX
TIES = [
    # c + a·b: the exact sum lies 2⁻⁷⁰ below / above an f32 midpoint, which
    # the f64 sum rounds onto (rounding it to f32 by ties-to-even is wrong)
    (2.0 ** -12 * (1 + 2.0 ** -23), 2.0 ** -12 * (1 - 2.0 ** -23),
     1 + 2.0 ** -23),
    (-(2.0 ** -12) * (1 + 2.0 ** -23), 2.0 ** -12 * (1 - 2.0 ** -23),
     -(1 + 2.0 ** -23)),
    (2.0 ** -12 * (1 + 2.0 ** -23), 2.0 ** -12 * (1 - 2.0 ** -23), 1.0),
    # exact midpoints: ties to even
    (2.0 ** -12, 2.0 ** -12, 1.0), (2.0 ** -12, 2.0 ** -12, 1 + 2.0 ** -23),
    # an f32 c plus a residual far below its ulp (toward +inf moves up)
    (2.0 ** -40, 2.0 ** -40, 1.0), (-(2.0 ** -40), 2.0 ** -40, 1.0),
    (2.0 ** -100, 2.0 ** -49, -(2.0 ** -149)),
    # overflow at and near FLT_MAX
    (HUGE, 1.0, HUGE), (HUGE, -1.0, -HUGE), (HUGE, 1.0, 2.0 ** 103),
    (HUGE, 1.0, 2.0 ** 102), (2.0 ** 127, 2.0, -(2.0 ** 103)),
]


@pytest.mark.parametrize("mode", ["rn", "ru"])
def test_emulated_fmaf_is_the_exact_rounding(mode):
    t = _random_triples(np.random.default_rng(15), 1500)
    ties = np.array(TIES, np.float64).astype(np.float32)
    t = np.concatenate([t, ties, -ties, ties[:, [1, 0, 2]]])
    got = _emulated(t[:, 0], t[:, 1], t[:, 2], mode)
    want = np.array([_exact_fma(a, b, c, mode) for a, b, c in t], np.float32)
    bad = _bits(got) != _bits(want)
    assert not bad.any(), t[bad][:5]


def test_emulated_fmaf_passes_infinities_and_nans():
    a = np.array([np.inf, np.inf, 1.0, np.nan, 0.0], np.float32)
    b = np.array([1.0, 0.0, 1.0, 1.0, np.inf], np.float32)
    c = np.array([1.0, 1.0, -np.inf, 1.0, 1.0], np.float32)
    for mode in ("rn", "ru"):
        got = _emulated(a, b, c, mode)
        assert got[0] == np.inf and np.isnan(got[1]) and got[2] == -np.inf
        assert np.isnan(got[3]) and np.isnan(got[4])


SHAPES = [(1, 1, 1), (5, 37, 9), (9, 200, 70), (7, 13, 9)]


def _random(rng, M, K, N):
    x = rng.standard_normal((M, K)).astype(np.float32)
    d = np.abs(rng.standard_normal((M, K))).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    return x, d, w


def _order_tol(a, w):
    K = a.shape[-1]
    return 2 * np.sqrt(K) * 2.0 ** -24 * (np.abs(a.astype(np.float64))
                                          @ np.abs(w.astype(np.float64)))


@pytest.mark.parametrize("M,K,N", SHAPES)
@pytest.mark.parametrize("g", [0.5, 1.0 / 3.0])
def test_caa_seq_ref_within_order_rule_of_the_oracle(M, K, N, g):
    x, d, w = _random(np.random.default_rng(M + K + N), M, K, N)
    val, err = tcaa.caa_matmul_seq_ref(torch.from_numpy(x),
                                       torch.from_numpy(d),
                                       torch.from_numpy(w), g=g)
    g32 = tcaa.g_up_f32(g)
    rv, re = jref.caa_matmul_ref(jnp.asarray(x), jnp.asarray(d),
                                 jnp.asarray(w), g32)
    assert (np.abs(val.numpy() - np.asarray(rv)) <= _order_tol(x, w)).all()
    # err is rounded up at every step: the kernel's rule (chip_smoke.py's
    # check_caa), E ≤ err ≤ E·(1 + (2K+2)·2⁻²³), E exact in f64; the
    # oracle's round-to-nearest err lies in the same band
    E = ((d.astype(np.float64) + g32 * np.abs(x).astype(np.float64))
         @ np.abs(w).astype(np.float64))
    top = E * (1 + (2 * K + 2) * 2.0 ** -23)
    e64 = err.numpy().astype(np.float64)
    assert (E <= e64).all() and (e64 <= top).all()
    assert (np.abs(np.asarray(re, np.float64) - E) <= top - E).all()


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_interval_seq_ref_within_order_rule_of_the_oracle(M, K, N):
    x, d, w = _random(np.random.default_rng(M * K + N), M, K, N)
    lo, hi = x - 0.05 * d, x + 0.05 * d
    got = tim.interval_matmul_seq_ref(torch.from_numpy(lo),
                                      torch.from_numpy(hi),
                                      torch.from_numpy(w))
    want = jref.interval_matmul_ref(jnp.asarray(lo), jnp.asarray(hi),
                                    jnp.asarray(w), slop=0.0)
    tol = _order_tol(np.maximum(np.abs(lo), np.abs(hi)), w)
    for t, j in zip(got, want):
        assert (np.abs(t.numpy() - np.asarray(j)) <= tol).all()


def _coarse(rng, M, K, N):
    """Integers times 2⁻², 2⁻³, 2⁻³ (and g = 1/2): every t, product and
    partial sum is an exact f32."""
    x = rng.integers(-3, 4, (M, K)).astype(np.float32) * np.float32(0.25)
    d = rng.integers(0, 4, (M, K)).astype(np.float32) * np.float32(0.125)
    w = rng.integers(-3, 4, (K, N)).astype(np.float32) * np.float32(0.125)
    return x, d, w


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_seq_refs_bitwise_equal_plain_on_exact_sums(M, K, N):
    x, d, w = (torch.from_numpy(a)
               for a in _coarse(np.random.default_rng(K), M, K, N))
    for got, want in zip(tcaa.caa_matmul_seq_ref(x, d, w, g=0.5),
                         tcaa.caa_matmul_plain(x, d, w, g=0.5)):
        assert np.array_equal(_bits(got.numpy()), _bits(want.numpy()))
    for got, want in zip(tim.interval_matmul_seq_ref(x - d, x + d, w),
                         tim.interval_matmul_plain(x - d, x + d, w)):
        assert np.array_equal(_bits(got.numpy()), _bits(want.numpy()))


def _chain(a, b, c0, mode):
    """One accumulator's exact-rounding chain over k (scalars)."""
    acc = _f32(c0)
    for ak, bk in zip(a, b):
        acc = _exact_fma(_f32(ak), _f32(bk), acc, mode)
    return acc


@pytest.mark.parametrize("K", [17, 33])
def test_zeros_at_a_ragged_k_edge(K):
    """Terms that are all ±0 products sum to +0 from the +0 start in every
    accumulator; a lone -0·w at the last, ragged k keeps it +0; the chains
    equal the exact-rounding chain."""
    x = np.full((3, K), -0.0, np.float32)
    x[:, ::2] = 0.0
    x[1, -1] = -0.0
    x[2, -2], x[2, -1] = -0.5, 0.5
    d = np.zeros((3, K), np.float32)
    d[0, -1] = -0.0
    w = np.ones((K, 4), np.float32)
    w[::3] = -1.0
    w[-1] = [-0.0, 0.0, -1.0, 1.0]
    w[-2] = [1.0, -1.0, -0.0, 0.5]
    tx, td, tw = (torch.from_numpy(a) for a in (x, d, w))
    val, err = tcaa.caa_matmul_seq_ref(tx, td, tw, g=0.5)
    outs = (val, err) + tim.interval_matmul_seq_ref(tx - td, tx + td, tw)
    for o in outs:
        assert not bool(torch.signbit(o[:2]).any())
    for m in range(3):
        for n in range(4):
            assert _bits(val[m, n].item()) == _bits(
                _chain(x[m], w[:, n], 0.0, "rn"))
            t = [_exact_fma(_f32(0.5), _f32(abs(v)), _f32(dv), "ru")
                 for v, dv in zip(x[m], d[m])]
            assert _bits(err[m, n].item()) == _bits(
                _chain(t, np.abs(w[:, n]), 0.0, "ru"))
