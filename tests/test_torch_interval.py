"""The port's interval arithmetic (``repro_torch.core.interval``) against the
JAX package's ``repro.core.interval`` on the CPU, on seeded inputs made with
numpy.

Tolerances:
* arithmetic, structural helpers and the nextafter rounding: bit for bit
  (both are IEEE f64 round-to-nearest followed by the same ``nextafter``
  steps); inputs stay clear of the subnormal range, where the reference's
  flush-to-zero arithmetic differs from PyTorch's. One exception: PyTorch's
  CPU f64 ``sqrt`` is faithful but not correctly rounded (about 0.7 % of
  values one ulp off numpy's), so ``sqrt``'s endpoints agree within one
  ulp, and its 1-ulp widening still encloses numpy's value;
* transcendental enclosures: each contains the other package's unwidened
  f64 value, and both contain numpy's/scipy's f64 value at every point
  (the libms differ by ulps; the enclosures are widened by 4 ulps);
* matmul_const, einsum_ball and softmax_range: the endpoints agree within a
  few f64 ulps plus what two f64 sums of the same terms differ by in
  another order (n·2⁻⁵³·Σ|terms|), and both enclose the exact value at
  sampled points.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

from repro.core import interval as J
from repro_torch.core import interval as T


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float64).copy())


def _ivs(lo, hi):
    return J.Interval(jnp.asarray(lo), jnp.asarray(hi)), T.Interval(_t(lo),
                                                                  _t(hi))


def _bits_equal(j, t):
    if t.dtype == torch.bool:
        assert np.array_equal(np.asarray(j), t.numpy())
        return
    a = np.asarray(j, np.float64).view(np.int64)
    b = t.numpy().view(np.int64)
    nan = np.isnan(np.asarray(j, np.float64))
    assert np.array_equal(nan, np.isnan(t.numpy()))
    assert np.array_equal(a[~nan], b[~nan]), (
        int((a[~nan] != b[~nan]).sum()))


def _iv_equal(j, t):
    _bits_equal(j.lo, t.lo)
    _bits_equal(j.hi, t.hi)


def _random_iv(rng, n, scale=3.0, spread=10.0 ** np.arange(-6, 3)):
    mid = rng.randn(n) * scale * rng.choice(spread, n)
    w = np.abs(rng.randn(n)) * rng.choice(spread, n) * 0.1
    return mid - w, mid + w


def test_nextafter_rounding_bitwise():
    rng = np.random.RandomState(0)
    x = np.concatenate([
        rng.randn(4000) * 10.0 ** rng.randint(-300, 300, 4000),
        [0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0, 1e-310, -1e-310,
         3e-308, -3e-308, 1.7976931348623157e308, -1.7976931348623157e308],
    ])
    for jf, tf in ((J._down, T._down), (J._up, T._up)):
        _bits_equal(jf(jnp.asarray(x)), tf(_t(x)))
    for n in (1, 4):
        _bits_equal(J._down_n(jnp.asarray(x), n), T._down_n(_t(x), n))
        _bits_equal(J._up_n(jnp.asarray(x), n), T._up_n(_t(x), n))


@pytest.mark.parametrize("seed", range(3))
def test_arithmetic_bitwise(seed):
    rng = np.random.RandomState(seed)
    (ja, ta), (jb, tb) = (_ivs(*_random_iv(rng, 500)) for _ in range(2))
    c = rng.randn(500) * 3
    for name in ("add", "sub", "mul", "div", "maximum", "minimum", "hull"):
        _iv_equal(getattr(J, name)(ja, jb), getattr(T, name)(ta, tb))
    for name in ("neg", "recip", "abs_", "square"):
        _iv_equal(getattr(J, name)(ja), getattr(T, name)(ta))
    js, ts = J.sqrt(ja), T.sqrt(ta)
    for a, b, x in ((js.lo, ts.lo, ta.lo), (js.hi, ts.hi, ta.hi)):
        a = np.asarray(a)
        assert (np.abs(a - b.numpy()) <= np.spacing(np.abs(a))).all()
        root = np.sqrt(np.maximum(x.numpy(), 0.0))
        assert ((ts.lo.numpy() <= root) | (x is ta.hi)).all()
        assert ((root <= ts.hi.numpy()) | (x is ta.lo)).all()
    _iv_equal(J.scale(ja, jnp.asarray(c)), T.scale(ta, _t(c)))
    _iv_equal(J.scale(ja, 0.37), T.scale(ta, 0.37))
    _iv_equal(J.shift(ja, jnp.asarray(c)), T.shift(ta, _t(c)))
    _iv_equal(J.clamp_min(ja, 0.0), T.clamp_min(ta, 0.0))
    _iv_equal(J.widen(ja, 3), T.widen(ta, 3))
    _iv_equal(J.widen_abs(ja, 1e-9), T.widen_abs(ta, 1e-9))
    for name in ("mag", "mig", "width", "midpoint", "radius"):
        _bits_equal(getattr(J, name)(ja), getattr(T, name)(ta))
    _bits_equal(J.contains(ja, jnp.asarray(c)), T.contains(ta, _t(c)))
    _bits_equal(J.subset(ja, jb), T.subset(ta, tb))
    _iv_equal(J.make(ja.lo, ja.hi), T.make(ta.lo, ta.hi))
    _iv_equal(J.point(jnp.asarray(c)), T.point(_t(c)))
    m_j, r_j = J.ball(ja)
    m_t, r_t = T.ball(ta)
    _bits_equal(m_j, m_t)
    _bits_equal(r_j, r_t)
    _iv_equal(J.from_ball(m_j, r_j), T.from_ball(m_t, r_t))


def test_division_by_zero_and_unbounded():
    ja, ta = _ivs([-1.0, 2.0, -np.inf], [1.0, 3.0, np.inf])
    _iv_equal(J.recip(ja), T.recip(ta))
    _iv_equal(J.mul(ja, ja), T.mul(ta, ta))
    m_j, r_j = J.ball(ja)
    m_t, r_t = T.ball(ta)
    _bits_equal(m_j, m_t)
    _bits_equal(r_j, r_t)


def test_reductions_bitwise_or_within_order():
    rng = np.random.RandomState(3)
    lo, hi = _random_iv(rng, 6 * 40)
    ja, ta = _ivs(lo.reshape(6, 40), hi.reshape(6, 40))
    for axis, keep in ((1, False), (0, True), (None, False)):
        _iv_equal(J.max_(ja, axis, keep), T.max_(ta, axis, keep))
        _iv_equal(J.min_(ja, axis, keep), T.min_(ta, axis, keep))
        for fn in ("sum_", "mean"):
            j = getattr(J, fn)(ja, axis, keep)
            t = getattr(T, fn)(ta, axis, keep)
            n = 240 if axis is None else ta.lo.shape[axis]
            for a, b, src in ((j.lo, t.lo, ta.lo), (j.hi, t.hi, ta.hi)):
                tol = n * 2.0 ** -53 * np.asarray(
                    torch.sum(src.abs(), dim=axis if axis is not None else
                              (0, 1), keepdim=keep))
                np.testing.assert_array_less(
                    np.abs(np.asarray(a) - b.numpy()), tol + 1e-300)
    # a sum of non-negative lows stays non-negative
    s = T.sum_(T.Interval(torch.zeros(7, dtype=torch.float64),
                          torch.ones(7, dtype=torch.float64)))
    assert float(s.lo) == 0.0


def _np_fn(name):
    """numpy/scipy f64 values; gelu_tanh as x·σ(2y), free of the
    cancellation of 0.5·x·(1 + tanh(y)) for x ≲ -3."""
    c = np.sqrt(2 / np.pi)
    gelu = lambda x: x * scipy.special.expit(2 * c * (x + 0.044715 * x ** 3))
    return {"exp": np.exp, "expm1": np.expm1, "log": np.log,
            "tanh": np.tanh, "sigmoid": scipy.special.expit,
            "erf": scipy.special.erf,
            "silu": lambda x: x * scipy.special.expit(x),
            "gelu_tanh": gelu}[name]


_UNWIDENED = {
    "exp": (jnp.exp, torch.exp), "expm1": (jnp.expm1, torch.expm1),
    "log": (jnp.log, torch.log), "tanh": (jnp.tanh, torch.tanh),
    "sigmoid": (jax.nn.sigmoid, torch.sigmoid),
    "erf": (jax.scipy.special.erf, torch.erf),
    "silu": (lambda x: x * jax.nn.sigmoid(x), lambda x: x * torch.sigmoid(x)),
    "gelu_tanh": (lambda x: jax.nn.gelu(x, approximate=True),
                  lambda x: x * torch.sigmoid(2 * np.sqrt(2 / np.pi)
                                              * (x + 0.044715 * x ** 3))),
}

#: where the reference's libm is more than 3 ulps off numpy's value, its
#: unwidened value is no yardstick (4-ulp slop); that happens only for XLA's
#: CPU tanh (up to 6 ulps near saturation, where the reference's own
#: enclosure misses the true value: ROADMAP §3) and the reference's gelu,
#: whose 1 + tanh(y) cancels for x ≲ -3
_REFERENCE_LIBM_DRIFT = ("tanh", "gelu_tanh")


@pytest.mark.parametrize("name", sorted(_UNWIDENED))
def test_transcendental_enclosures_contain_each_other(name):
    rng = np.random.RandomState(7)
    if name == "log":
        x = np.exp(rng.uniform(-30, 30, 20000))
    else:
        x = np.concatenate([rng.uniform(-40, 40, 15000),
                            rng.randn(5000) * 3])
    jf, tf = _UNWIDENED[name]
    ji = getattr(J, name)(J.Interval(jnp.asarray(x), jnp.asarray(x)))
    ti = getattr(T, name)(T.Interval(_t(x), _t(x)))
    ref_np = _np_fn(name)(x)
    j_val = np.asarray(jf(jnp.asarray(x)), np.float64)
    t_val = tf(_t(x)).numpy()
    tlo, thi = ti.lo.numpy(), ti.hi.numpy()
    jlo, jhi = np.asarray(ji.lo), np.asarray(ji.hi)
    spacing = np.spacing(np.abs(ref_np))
    trusted = np.abs(j_val - ref_np) <= 3 * spacing
    assert trusted.all() or name in _REFERENCE_LIBM_DRIFT, x[~trusted][:5]
    assert trusted.mean() > (0.5 if name in _REFERENCE_LIBM_DRIFT else 0.99)
    everywhere = np.ones_like(trusted)
    # the port's own unwidened value as a yardstick for the reference's
    # enclosure where it is within one ulp of numpy's (gelu_tanh's endpoint
    # formula is ill-conditioned in y: a few ulps apart at x ≈ -2)
    t_close = trusted & (np.abs(t_val - ref_np) <= spacing)
    for lo, hi, v, where in ((tlo, thi, ref_np, everywhere),
                             (tlo, thi, j_val, trusted),
                             (jlo, jhi, ref_np, trusted),
                             (jlo, jhi, t_val, t_close)):
        ok = ((lo <= v) & (v <= hi)) | ~where
        assert ok.all(), (name, x[~ok][:5], v[~ok][:5], lo[~ok][:5],
                          hi[~ok][:5])
    assert t_close.mean() > (0.5 if name in _REFERENCE_LIBM_DRIFT else 0.99)


def test_silu_gelu_interval_enclosure_at_sampled_points():
    rng = np.random.RandomState(8)
    lo, hi = _random_iv(rng, 400, scale=2.0, spread=np.array([0.1, 1, 3]))
    for name in ("silu", "gelu_tanh"):
        ti = getattr(T, name)(T.Interval(_t(lo), _t(hi)))
        ji = getattr(J, name)(J.Interval(jnp.asarray(lo), jnp.asarray(hi)))
        for _ in range(5):
            pts = lo + (hi - lo) * rng.rand(400)
            v = _np_fn(name)(pts)
            assert ((ti.lo.numpy() <= v) & (v <= ti.hi.numpy())).all()
        # where the reference's endpoint values are accurate (x ≥ -3), to
        # a few ulps of 1: its 1 + tanh(y) rounds to one (2⁻⁵² absolute)
        keep = lo >= -3.0
        np.testing.assert_allclose(ti.lo.numpy()[keep],
                                   np.asarray(ji.lo)[keep], rtol=1e-14,
                                   atol=8 * 2.0 ** -52)
        np.testing.assert_allclose(ti.hi.numpy()[keep],
                                   np.asarray(ji.hi)[keep], rtol=1e-14,
                                   atol=8 * 2.0 ** -52)


def _close_with_order(a_j, a_t, mag, n):
    """Within 4 ulps plus n·2⁻⁵³·mag (another summation order)."""
    a_j = np.asarray(a_j, np.float64)
    a_t = a_t.numpy()
    tol = 4 * np.spacing(np.abs(a_j)) + n * 2.0 ** -53 * mag
    assert (np.abs(a_j - a_t) <= tol).all(), float(np.abs(a_j - a_t).max())


@pytest.mark.parametrize("shape", [(5, 17, 9), (3, 64, 40)])
def test_matmul_const_and_ball_matmul(shape):
    M, K, N = shape
    rng = np.random.RandomState(K)
    lo, hi = _random_iv(rng, M * K, spread=np.array([0.1, 1.0]))
    lo, hi = lo.reshape(M, K), hi.reshape(M, K)
    w = rng.randn(K, N)
    ja, ta = _ivs(lo, hi)
    j = J.matmul_const(ja, jnp.asarray(w))
    t = T.matmul_const(ta, _t(w))
    mag = np.maximum(np.abs(lo), np.abs(hi)) @ np.abs(w)
    _close_with_order(j.lo, t.lo, mag, 2 * K + 2)
    _close_with_order(j.hi, t.hi, mag, 2 * K + 2)
    wl, wh = w - 0.01, w + 0.01
    jw, tw = _ivs(wl, wh)
    jm, tm = J.matmul(ja, jw), T.matmul(ta, tw)
    mag2 = np.maximum(np.abs(lo), np.abs(hi)) @ np.maximum(np.abs(wl),
                                                           np.abs(wh))
    _close_with_order(jm.lo, tm.lo, mag2, 4 * K + 4)
    _close_with_order(jm.hi, tm.hi, mag2, 4 * K + 4)
    for _ in range(5):
        x = lo + (hi - lo) * rng.rand(M, K)
        y = x @ w
        assert ((t.lo.numpy() <= y) & (y <= t.hi.numpy())).all()
        y2 = x @ (wl + (wh - wl) * rng.rand(K, N))
        assert ((tm.lo.numpy() <= y2) & (y2 <= tm.hi.numpy())).all()


@pytest.mark.parametrize("n", [3, 10, 50])
def test_softmax_range(n):
    rng = np.random.RandomState(n)
    mid = rng.randn(4, n) * 3
    r = np.abs(rng.randn(4, n)) * 0.1
    ja, ta = _ivs(mid - r, mid + r)
    j, t = J.softmax_range(ja), T.softmax_range(ta)
    _close_with_order(j.lo, t.lo, np.ones_like(mid), n + 8)
    _close_with_order(j.hi, t.hi, np.ones_like(mid), n + 8)
    for _ in range(10):
        x = mid - r + 2 * r * rng.rand(4, n)
        y = scipy.special.softmax(x, axis=-1)
        assert ((t.lo.numpy() <= y) & (y <= t.hi.numpy())).all()
