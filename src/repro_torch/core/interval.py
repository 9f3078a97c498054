"""Vectorised rigorous interval arithmetic (IA) in PyTorch, float64.

The counterpart of the JAX package's ``repro.core.interval``: the
``Interval`` half, and the affine forms (``AffineForm``, ``aff_*``) of the
affine range pass.
Bounds are computed in f64 round-to-nearest and then widened outward with
``torch.nextafter``: the enclosure property holds, one or two ulps looser,
and every operation vectorises over tensors on the CPU or the card.

Everything here is float64, set explicitly: the port never changes
PyTorch's default dtype (the reference gets f64 from ``jax_enable_x64``).
Python floats and tensors mix freely; a tensor argument fixes the device.

Transcendentals are not correctly rounded in any libm; monotone bounds are
widened by ``LIBM_SLOP_ULPS`` ulps, and three functions carry an absolute
guard near saturation (tanh, sigmoid, erf). ``chip_smoke.py``'s
``interval_libm`` phase checks these enclosures on the card against the
CPU's f64 values over about 10⁶ points.

Intervals are a NamedTuple of (lo, hi) f64 tensors; an empty interval is
never produced (division by an interval containing 0 gives [-inf, inf]).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

LIBM_SLOP_ULPS = 4
_F64 = torch.float64
_INF = math.inf

#: Smallest positive normal f64. Directed rounding floors there: a computed
#: endpoint in the subnormal range stands for any value in (−DBL_MIN,
#: DBL_MIN) under the reference's flush-to-zero arithmetic, and the port
#: keeps the same floor so both give the same bounds.
_MINN = 2.2250738585072014e-308


class Interval(NamedTuple):
    lo: torch.Tensor
    hi: torch.Tensor

    @property
    def shape(self):
        return tuple(self.lo.shape)

    def astuple(self):
        return (self.lo, self.hi)


def _f(x, device=None) -> torch.Tensor:
    """``x`` as an f64 tensor (a tensor keeps its device)."""
    if isinstance(x, torch.Tensor):
        return x.to(_F64)
    return torch.as_tensor(x, dtype=_F64, device=device)


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d f64 constant on ``like``'s device (``torch.where`` of two
    Python floats would give float32)."""
    return torch.tensor(v, dtype=_F64, device=like.device)


def _dims(x: torch.Tensor, axis):
    """Reduction dims for a reference ``axis`` (None = all)."""
    return tuple(range(x.dim())) if axis is None else axis


def _is_subnormal(x):
    bits = x.view(torch.int64)
    expo = (bits >> 52) & 0x7FF
    mant = bits & ((1 << 52) - 1)
    return (expo == 0) & (mant != 0)


def _desub_lo(lo):
    """Snap subnormal lower endpoints outward (the reference's flush-to-
    zero arithmetic would zero them, shrinking the interval)."""
    neg = lo.view(torch.int64) < 0
    return torch.where(_is_subnormal(lo),
                       torch.where(neg, _const(-_MINN, lo), 0.0), lo)


def _desub_hi(hi):
    neg = hi.view(torch.int64) < 0
    return torch.where(_is_subnormal(hi),
                       torch.where(neg, 0.0, _const(_MINN, hi)), hi)


def make(lo, hi=None) -> Interval:
    lo = _f(lo)
    hi = lo if hi is None else _f(hi, lo.device)
    lo, hi = torch.broadcast_tensors(lo, hi)
    return Interval(_desub_lo(lo), _desub_hi(hi))


def point(x) -> Interval:
    x = _f(x)
    return Interval(_desub_lo(x), _desub_hi(x))


def _down(x):
    """Next float64 toward -inf (no-op on -inf; preserves NaN), floored at
    -DBL_MIN inside (-DBL_MIN, DBL_MIN)."""
    x = _f(x)
    y = torch.where(torch.isfinite(x),
                    torch.nextafter(x, torch.full_like(x, -_INF)), x)
    return torch.where(x.abs() < _MINN, -_MINN, y)


def _up(x):
    x = _f(x)
    y = torch.where(torch.isfinite(x),
                    torch.nextafter(x, torch.full_like(x, _INF)), x)
    return torch.where(x.abs() < _MINN, _MINN, y)


def _down_n(x, n):
    for _ in range(n):
        x = _down(x)
    return x


def _up_n(x, n):
    for _ in range(n):
        x = _up(x)
    return x


def widen(iv: Interval, ulps: int = 1) -> Interval:
    return Interval(_down_n(iv.lo, ulps), _up_n(iv.hi, ulps))


def widen_abs(iv: Interval, slack) -> Interval:
    """Widen both ends outward by an absolute amount (itself rounded up)."""
    s = _up(_f(slack, iv.lo.device))
    return Interval(_down(iv.lo - s), _up(iv.hi + s))


# --- structural helpers ----------------------------------------------------

def mag(iv: Interval) -> torch.Tensor:
    """sup |x| over the interval."""
    return torch.maximum(iv.lo.abs(), iv.hi.abs())


def mig(iv: Interval) -> torch.Tensor:
    """inf |x| over the interval (0 if the interval contains 0)."""
    contains0 = (iv.lo <= 0) & (iv.hi >= 0)
    return torch.where(contains0, 0.0,
                       torch.minimum(iv.lo.abs(), iv.hi.abs()))


def width(iv: Interval) -> torch.Tensor:
    return _up(iv.hi - iv.lo)


def midpoint(iv: Interval) -> torch.Tensor:
    return 0.5 * (iv.lo + iv.hi)


def radius(iv: Interval) -> torch.Tensor:
    m = midpoint(iv)
    return _up(torch.maximum(iv.hi - m, m - iv.lo))


def contains(iv: Interval, x) -> torch.Tensor:
    x = _f(x, iv.lo.device)
    return (iv.lo <= x) & (x <= iv.hi)


def subset(a: Interval, b: Interval) -> torch.Tensor:
    return (b.lo <= a.lo) & (a.hi <= b.hi)


def hull(a: Interval, b: Interval) -> Interval:
    return Interval(torch.minimum(a.lo, b.lo), torch.maximum(a.hi, b.hi))


def intersect_nonempty(a: Interval, b: Interval) -> torch.Tensor:
    return (a.lo <= b.hi) & (b.lo <= a.hi)


# --- arithmetic -------------------------------------------------------------

def neg(a: Interval) -> Interval:
    return Interval(-a.hi, -a.lo)


def add(a: Interval, b: Interval) -> Interval:
    return Interval(_down(a.lo + b.lo), _up(a.hi + b.hi))


def sub(a: Interval, b: Interval) -> Interval:
    return Interval(_down(a.lo - b.hi), _up(a.hi - b.lo))


def scale(a: Interval, c) -> Interval:
    """Multiply by an exact scalar/array constant."""
    c = _f(c, a.lo.device)
    p1, p2 = a.lo * c, a.hi * c
    return Interval(_down(torch.minimum(p1, p2)), _up(torch.maximum(p1, p2)))


def shift(a: Interval, c) -> Interval:
    c = _f(c, a.lo.device)
    return Interval(_down(a.lo + c), _up(a.hi + c))


def mul(a: Interval, b: Interval) -> Interval:
    p = [a.lo * b.lo, a.lo * b.hi, a.hi * b.lo, a.hi * b.hi]
    lo = torch.minimum(torch.minimum(p[0], p[1]), torch.minimum(p[2], p[3]))
    hi = torch.maximum(torch.maximum(p[0], p[1]), torch.maximum(p[2], p[3]))
    # 0 * inf protection: an interval with a 0 endpoint times an infinite one
    nan = torch.isnan(lo) | torch.isnan(hi)
    lo = torch.where(nan, -_INF, lo)
    hi = torch.where(nan, _INF, hi)
    return Interval(_down(lo), _up(hi))


def recip(a: Interval) -> Interval:
    contains0 = (a.lo <= 0) & (a.hi >= 0)
    lo = torch.where(contains0, -_INF, _down(1.0 / a.hi))
    hi = torch.where(contains0, _INF, _up(1.0 / a.lo))
    return Interval(lo, hi)


def div(a: Interval, b: Interval) -> Interval:
    return mul(a, recip(b))


def abs_(a: Interval) -> Interval:
    return Interval(mig(a), _up(mag(a)))


def square(a: Interval) -> Interval:
    m, M = mig(a), mag(a)
    return Interval(_down(m * m), _up(M * M))


def sqrt(a: Interval) -> Interval:
    lo = torch.sqrt(torch.clamp(a.lo, min=0.0))
    hi = torch.sqrt(torch.clamp(a.hi, min=0.0))
    return widen(Interval(lo, hi), 1)


def maximum(a: Interval, b: Interval) -> Interval:
    return Interval(torch.maximum(a.lo, b.lo), torch.maximum(a.hi, b.hi))


def minimum(a: Interval, b: Interval) -> Interval:
    return Interval(torch.minimum(a.lo, b.lo), torch.minimum(a.hi, b.hi))


def clamp_min(a: Interval, c) -> Interval:  # e.g. ReLU with c=0
    c = _f(c, a.lo.device)
    return Interval(torch.maximum(a.lo, c), torch.maximum(a.hi, c))


# --- monotone transcendentals ----------------------------------------------

def _monotone(f, a: Interval, slop: int = LIBM_SLOP_ULPS) -> Interval:
    return widen(Interval(f(a.lo), f(a.hi)), slop)


def exp(a: Interval) -> Interval:
    iv = _monotone(torch.exp, a)
    return Interval(torch.clamp(iv.lo, min=0.0), iv.hi)


def expm1(a: Interval) -> Interval:
    iv = _monotone(torch.expm1, a)
    return Interval(torch.clamp(iv.lo, min=-1.0), iv.hi)


def log(a: Interval) -> Interval:
    lo = torch.where(a.lo <= 0, -_INF, torch.log(a.lo))
    hi = torch.where(a.hi <= 0, -_INF, torch.log(a.hi))
    return widen(Interval(lo, hi), LIBM_SLOP_ULPS)


def tanh(a: Interval) -> Interval:
    iv = _monotone(torch.tanh, a)
    # an absolute guard near saturation, where a libm's tanh may drift by
    # more than the ulp slop (found on XLA's CPU tanh at 19): 1e-12, sound
    sat_lo = torch.where(a.lo < -12.0, _const(1e-12, a.lo), 0.0)
    sat_hi = torch.where(a.hi > 12.0, _const(1e-12, a.hi), 0.0)
    lo = torch.clamp(iv.lo - sat_lo, min=-1.0)
    hi = torch.clamp(iv.hi + sat_hi, max=1.0)
    return Interval(lo, hi)


def sigmoid(a: Interval) -> Interval:
    iv = _monotone(torch.sigmoid, a)
    sat_lo = torch.where(a.lo < -25.0, _const(1e-12, a.lo), 0.0)
    sat_hi = torch.where(a.hi > 25.0, _const(1e-12, a.hi), 0.0)
    return Interval(torch.clamp(iv.lo - sat_lo, 0.0, 1.0),
                    torch.clamp(iv.hi + sat_hi, 0.0, 1.0))


def erf(a: Interval) -> Interval:
    iv = _monotone(torch.erf, a)
    sat_lo = torch.where(a.lo < -4.0, _const(1e-12, a.lo), 0.0)
    sat_hi = torch.where(a.hi > 4.0, _const(1e-12, a.hi), 0.0)
    return Interval(torch.clamp(iv.lo - sat_lo, min=-1.0),
                    torch.clamp(iv.hi + sat_hi, max=1.0))


def silu(a: Interval) -> Interval:
    """x*sigmoid(x). Decreasing on (-∞, x*], increasing on [x*, ∞) with
    x* ≈ -1.27846 (global min ≈ -0.27846); split on the enclosure."""
    xstar = -1.2784645427610738
    fmin = -0.2784645427610738  # silu(x*) rounded down a touch below
    f = lambda x: x * torch.sigmoid(x)
    cand_lo = torch.minimum(f(a.lo), f(a.hi))
    cand_hi = torch.maximum(f(a.lo), f(a.hi))
    crosses = (a.lo <= xstar) & (a.hi >= xstar)
    lo = torch.where(crosses, fmin, cand_lo)
    # deep-underflow zone: x·sigmoid(x) loses all relative accuracy; add an
    # absolute slack far below any representable activation scale
    return widen_abs(widen(Interval(lo, cand_hi), LIBM_SLOP_ULPS), 1e-290)


def gelu_tanh(a: Interval) -> Interval:
    """tanh-approximated GELU; same treatment as silu (min ≈ -0.17).
    Decreasing left of x* ≈ -0.7517916, increasing right of it.

    The endpoint values are computed as x·σ(2y), y = √(2/π)(x + 0.044715x³):
    the same function as 0.5·x·(1 + tanh(y)), which the reference evaluates,
    but without its cancellation in 1 + tanh(y) for negative x. Where σ(2y)
    is small its relative error is |2y|·(1 − σ(2y)) times the relative
    rounding of 2y itself (any evaluation's), so the endpoints are widened
    by that conditioning as well as by the libm slop — the reference's 4
    ulps alone miss the true value there (``tools/libm_audit.py``)."""
    xstar = -0.7517916243494656
    fmin = -0.1700425
    c = math.sqrt(2.0 / math.pi)

    def f(x):
        y2 = 2.0 * c * (x + 0.044715 * x * x * x)
        v = x * torch.sigmoid(y2)
        t = torch.sigmoid(-y2)
        cond = 16.0 + 16.0 * torch.where(t > 0, y2.abs() * t, 0.0)
        # v == 0 (underflow, or x = 0) is covered by the absolute 1e-290
        return v, torch.where(v == 0, 0.0, cond * 2.0 ** -53 * v.abs())

    (f_lo, s_lo), (f_hi, s_hi) = f(a.lo), f(a.hi)
    cand_lo = torch.minimum(f_lo, f_hi)
    cand_hi = torch.maximum(f_lo, f_hi)
    crosses = (a.lo <= xstar) & (a.hi >= xstar)
    lo = torch.where(crosses, fmin, cand_lo)
    slack = torch.maximum(s_lo, s_hi) + 1e-290
    return widen_abs(widen(Interval(lo, cand_hi), LIBM_SLOP_ULPS), slack)


# --- reductions / linear algebra --------------------------------------------

def _gamma_f64(n: int) -> float:
    """Higham's γ_n for float64 — the slop our own f64 bound computation
    incurs."""
    un = n * 2.0 ** -53
    return un / (1.0 - un)


def sum_(a: Interval, axis=None, keepdims: bool = False) -> Interval:
    n = (a.lo.numel() if axis is None
         else int(a.lo.shape[axis] if isinstance(axis, int) else 1))
    dims = _dims(a.lo, axis)
    lo = torch.sum(a.lo, dim=dims, keepdim=keepdims)
    hi = torch.sum(a.hi, dim=dims, keepdim=keepdims)
    slop = _gamma_f64(max(n, 1))
    # each endpoint's own f64 summation error is bounded by γ·Σ|terms of
    # that endpoint|
    m_lo = torch.sum(a.lo.abs(), dim=dims, keepdim=keepdims)
    m_hi = torch.sum(a.hi.abs(), dim=dims, keepdim=keepdims)
    # all-zero endpoints sum exactly — keep ±0 exact
    lo_w = torch.where(m_lo == 0, lo, _down(lo - slop * m_lo))
    hi_w = torch.where(m_hi == 0, hi, _up(hi + slop * m_hi))
    return Interval(lo_w, hi_w)


def max_(a: Interval, axis=None, keepdims: bool = False) -> Interval:
    dims = _dims(a.lo, axis)
    return Interval(torch.amax(a.lo, dim=dims, keepdim=keepdims),
                    torch.amax(a.hi, dim=dims, keepdim=keepdims))


def min_(a: Interval, axis=None, keepdims: bool = False) -> Interval:
    dims = _dims(a.lo, axis)
    return Interval(torch.amin(a.lo, dim=dims, keepdim=keepdims),
                    torch.amin(a.hi, dim=dims, keepdim=keepdims))


def mean(a: Interval, axis=None, keepdims: bool = False) -> Interval:
    n = a.lo.numel() if axis is None else int(a.lo.shape[axis])
    s = sum_(a, axis=axis, keepdims=keepdims)
    return scale(s, 1.0 / n)


def matmul_const(a: Interval, w) -> Interval:
    """Interval @ exact-constant matrix, by sign-splitting W:
    lo = lo@W⁺ + hi@W⁻ ; hi = hi@W⁺ + lo@W⁻, widened by the f64 GEMM's
    own γ_{2n+2} slop against |a|@|W|."""
    w = _f(w, a.lo.device)
    wp = torch.clamp(w, min=0.0)
    wm = torch.clamp(w, max=0.0)
    lo = a.lo @ wp + a.hi @ wm
    hi = a.hi @ wp + a.lo @ wm
    n = w.shape[-2]
    slop = _gamma_f64(2 * n + 2)
    m = torch.maximum(a.lo.abs(), a.hi.abs()) @ w.abs()
    return Interval(_down(lo - slop * m), _up(hi + slop * m))


def ball(iv: Interval):
    """Midpoint-radius form; radius rounded up. Unbounded intervals get
    (0, inf) instead of the NaN (−inf+inf)/2 would produce."""
    m = midpoint(iv)
    r = radius(iv)
    bad = ~torch.isfinite(m)
    return torch.where(bad, 0.0, m), torch.where(bad, _INF, r)


def from_ball(m: torch.Tensor, r: torch.Tensor) -> Interval:
    lo = _down(m - r)
    hi = _up(m + r)
    # NaN arises only from inf·0 / inf−inf on unbounded operands; [-inf,
    # inf] is the sound enclosure then
    lo = torch.where(torch.isnan(lo), -_INF, lo)
    hi = torch.where(torch.isnan(hi), _INF, hi)
    return Interval(lo, hi)


def einsum_ball(subscripts: str, a: Interval, b: Interval) -> Interval:
    """Interval einsum via ball arithmetic: (ma±ra)·(mb±rb), with
    |result − ma·mb| ≤ |ma|·rb + ra·|mb| + ra·rb through the same einsum,
    plus the f64 slop of the einsum itself."""
    ma, ra = ball(a)
    mb, rb = ball(b)
    es = lambda x, y: torch.einsum(subscripts, x, y)
    mid = es(ma, mb)
    rad = es(ma.abs(), rb) + es(ra, mb.abs()) + es(ra, rb)
    n = max(1, ma.numel() // max(1, mid.numel()))
    slop = _gamma_f64(4 * n + 4)
    mag_term = es(ma.abs() + ra, mb.abs() + rb)
    rad = _up(_up(rad) + slop * mag_term)
    rad = torch.where(torch.isnan(rad), _INF, rad)
    mid = torch.where(torch.isnan(mid), 0.0, mid)
    return from_ball(mid, rad)


def matmul(a: Interval, b: Interval) -> Interval:
    return einsum_ball("...ij,jk->...ik", a, b)


# --- stable softmax range ----------------------------------------------------

def softmax_range(x: Interval, axis: int = -1) -> Interval:
    """Rigorous enclosure of softmax(x) along ``axis``:
    y_i ∈ [ e^{lo_i} / (e^{lo_i} + Σ_{j≠i} e^{hi_j}),
            e^{hi_i} / (e^{hi_i} + Σ_{j≠i} e^{lo_j}) ]
    in a max-shifted frame."""
    m = torch.amax(x.hi, dim=axis, keepdim=True)
    elo = exp(shift(Interval(x.lo, x.lo), -m))  # enclosure of e^{lo_i - m}
    ehi = exp(shift(Interval(x.hi, x.hi), -m))  # enclosure of e^{hi_i - m}
    n = x.lo.shape[axis]
    slop = 1.0 + _gamma_f64(n + 4)
    s_hi_up = torch.sum(ehi.hi, dim=axis, keepdim=True) * slop
    s_lo_dn = torch.sum(elo.lo, dim=axis, keepdim=True) / slop
    denom_lo_i = _up(elo.hi + torch.clamp(s_hi_up - ehi.lo, min=0.0))
    denom_hi_i = _down(ehi.lo + torch.clamp(s_lo_dn - elo.hi, min=0.0))
    tiny = torch.finfo(_F64).tiny
    lo = elo.lo / torch.clamp(denom_lo_i, min=tiny)
    hi = ehi.hi / torch.clamp(denom_hi_i, min=tiny)
    lo = torch.clamp(_down(lo), 0.0, 1.0)
    hi = torch.clamp(_up(hi), 0.0, 1.0)
    return Interval(lo, hi)


# ---------------------------------------------------------------------------
# affine forms (zonotopes) — the paper's antidote to IA decorrelation
# ---------------------------------------------------------------------------
#
# An AffineForm encloses a tensor of real values as
#
#     v ∈ center + Σ_b terms[b]·ε_b + rad·ε̂,     ε_b, ε̂ ∈ [-1, 1]
#
# where every (slot b, element) pair carries an INDEPENDENT noise symbol
# identified by ids[b] (0 marks an empty slot — its coefficients are zero by
# invariant). Linear ops propagate the terms exactly, so correlated paths
# (residual adds, x - mean(x)) cancel instead of compounding the way plain
# IA does; everything nonlinear and every f64 slop of the bound computation
# itself folds into the interval remainder ``rad``. The slot budget is
# fixed, so :func:`aff_condense` soundly folds the smallest slots into
# ``rad`` when ops overflow it.
#
# Symbols are per-element: ids identify tensors' rounding/creation events,
# and two forms sharing id b mean their elements' symbols agree elementwise.
# Contractions (matmul/einsum/sum) mix symbols of different elements, which
# no single coefficient can represent — callers collapse terms through
# :func:`aff_tot` there (see repro_torch.core.backend.AffineRangeCaaOps).
#
# ``terms`` and ``rad`` may be stored broadcastable to the form's shape
# (``terms`` [B, 1, ..., 1], ``rad`` 0-d): :func:`aff_make` stores a point
# form so, which keeps a full-width weight's zero terms out of memory (8
# slots of Qwen2-7B's embedding table would be 35 GB in f64). Every
# function gives the values it would give on the broadcast-out form; those
# that combine slots broadcast first.

#: default noise-symbol slot budget per tensor
AFF_DEFAULT_BUDGET = 8

#: condensation rankings: which slots survive when a form overflows its
#: budget. "sensitivity" keeps the symbols holding the largest SHARE of some
#: element's total deviation, whose future cancellations the form channel
#: still needs; "magnitude" is the total-coefficient-mass order. Both are
#: sound: the ranking only picks WHICH dropped slots fold into ``rad``.
AFF_RANK_SENSITIVITY = "sensitivity"
AFF_RANK_MAGNITUDE = "magnitude"
AFF_DEFAULT_RANK = AFF_RANK_SENSITIVITY

_I32 = torch.int32


class AffineForm(NamedTuple):
    center: torch.Tensor   # [*S] f64
    terms: torch.Tensor    # [B, *S] f64 (or broadcastable) — coefficient
    #                        of noise symbol ids[b]
    ids: torch.Tensor      # [B] int32; 0 = empty slot (zero coefficients)
    rad: torch.Tensor      # [*S] f64 ≥ 0 (or broadcastable) — remainder

    @property
    def shape(self):
        return tuple(self.center.shape)

    @property
    def budget(self) -> int:
        return int(self.terms.shape[0])


def aff_make(center, budget: int = AFF_DEFAULT_BUDGET) -> AffineForm:
    """Point form (exactly-known values; e.g. weights under weights_exact),
    its zero terms and remainder stored broadcastable."""
    c = _f(center)
    return AffineForm(
        c, torch.zeros((budget,) + (1,) * c.dim(), dtype=_F64,
                       device=c.device),
        torch.zeros((budget,), dtype=_I32, device=c.device),
        torch.zeros((), dtype=_F64, device=c.device))


def aff_from_interval(ivl: Interval, budget: int = AFF_DEFAULT_BUDGET,
                      center=None) -> AffineForm:
    """Terms-free form from an enclosure; ``center`` defaults to the
    midpoint, and may lie anywhere (rad covers both endpoints)."""
    c = midpoint(ivl) if center is None else _f(center, ivl.lo.device)
    r = _up(torch.maximum((c - ivl.lo).abs(), (ivl.hi - c).abs()))
    r = torch.where(torch.isnan(r) | ~torch.isfinite(ivl.lo)
                    | ~torch.isfinite(ivl.hi), _INF, r)
    c, r = torch.broadcast_tensors(c, r)
    return AffineForm(torch.where(torch.isfinite(c), c, 0.0),
                      torch.zeros((budget,) + tuple(c.shape), dtype=_F64,
                                  device=c.device),
                      torch.zeros((budget,), dtype=_I32, device=c.device),
                      r)


def _slot_abs_sum(a: AffineForm) -> torch.Tensor:
    """Σ_b |terms[b]| per element (broadcastable)."""
    return torch.sum(a.terms.abs(), dim=0)


def aff_tot(a: AffineForm) -> torch.Tensor:
    """Per-element upper bound on the total deviation Σ_b|terms| + rad."""
    s = _slot_abs_sum(a) + a.rad
    t = _up(s * (1.0 + _gamma_f64(a.budget + 2)))
    return torch.where(torch.isnan(t), _INF, t)


def aff_interval(a: AffineForm) -> Interval:
    """Sound enclosure center ± tot (nan-guarded to [-inf, inf])."""
    t = aff_tot(a)
    lo = _down(a.center - t)
    hi = _up(a.center + t)
    bad = torch.isnan(lo) | torch.isnan(hi) | torch.isnan(a.center)
    return Interval(torch.where(bad, -_INF, lo), torch.where(bad, _INF, hi))


def _aff_slop(a: AffineForm, n_ops: int = 4) -> AffineForm:
    """Charge the f64 round-to-nearest error of the bound computation
    itself: every produced quantity comes from a chain of ≤ B + n_ops f64
    ops on magnitudes bounded by |center| + tot, so γ_{B+n}·(|center| +
    tot) rounded outward covers it."""
    g = _gamma_f64(a.budget + n_ops)
    tot = _slot_abs_sum(a) + a.rad
    rad = _up(a.rad + g * (a.center.abs() + tot))
    rad = torch.where(torch.isnan(rad) | torch.isnan(a.center), _INF, rad)
    return AffineForm(a.center, a.terms, a.ids, rad)


def _condense_counters(dropped: int) -> None:
    from repro_torch import obs

    obs.counter("affine.condense_calls")
    obs.counter("affine.condense_drops", dropped)
    tr = obs.get_tracer()
    if tr is not None:
        obs.gauge("affine.condense_drops",
                  tr.counters.get("affine.condense_drops", 0))


def aff_condense(a: AffineForm, budget: int,
                 rank: str = AFF_DEFAULT_RANK) -> AffineForm:
    """Fold slots into ``rad`` until ≤ ``budget`` remain.

    ``rank`` picks the survivors (empty slots always rank last):

    * :data:`AFF_RANK_SENSITIVITY` — keep the slots carrying the largest
      share of some element's total deviation; a mass tiebreak keeps the
      order total among non-dominant slots.
    * :data:`AFF_RANK_MAGNITUDE` — total coefficient mass.

    Ties keep the lower slot first (a stable sort, as the reference's
    ``argsort``). Either way the dropped mass enters rad via the triangle
    inequality — a pure widening, hence sound under every ranking."""
    if rank not in (AFF_RANK_SENSITIVITY, AFF_RANK_MAGNITUDE):
        raise ValueError(f"unknown affine condensation rank {rank!r}")
    B = a.budget
    if B <= budget:
        return a
    _condense_counters(B - budget)
    terms = a.terms.expand((B,) + a.shape)
    red = tuple(range(1, terms.dim()))
    mass = terms.abs()
    sums = torch.sum(mass, dim=red) if red else mass
    if rank == AFF_RANK_MAGNITUDE:
        norms = sums
    else:
        # share of each element's total deviation held by each slot; a
        # saturated element (tot = inf) gives finite coefficients share 0,
        # an infinite coefficient keeps share 1 (it IS that element's
        # enclosure)
        tot = torch.sum(mass, dim=0) + a.rad
        denom = torch.where((tot > 0.0) & torch.isfinite(tot), tot, _INF)
        share = torch.where(torch.isfinite(mass), mass / denom, 1.0)
        peak = torch.amax(share.reshape(B, -1), dim=1)
        msum = torch.amax(torch.where(torch.isfinite(sums), sums, 0.0))
        msum = torch.where(msum > 0.0, msum, 1.0)
        tie = torch.where(torch.isfinite(sums), sums, msum) / msum
        norms = peak + 1e-3 * tie
    norms = torch.where(a.ids == 0, -1.0, norms)
    order = torch.argsort(-norms, stable=True)
    keep, drop = order[:budget], order[budget:]
    dropped = terms.index_select(0, drop).abs()
    extra = torch.sum(dropped, dim=0) * (1.0 + _gamma_f64(B - budget + 2))
    rad = _up(a.rad + extra)
    rad = torch.where(torch.isnan(rad), _INF, rad)
    return AffineForm(a.center, terms.index_select(0, keep),
                      a.ids.index_select(0, keep), rad)


def aff_append_symbol(a: AffineForm, coeff, sym_id: int, budget: int,
                      rank: str = AFF_DEFAULT_RANK) -> AffineForm:
    """Add a FRESH independent per-element unknown of half-width ``coeff``
    (≥ 0) — the shape a rounding error charge takes."""
    c = torch.broadcast_to(_up(_f(coeff, a.center.device)), a.shape)
    t = torch.cat([a.terms.expand((a.budget,) + a.shape), c[None]], dim=0)
    i = torch.cat([a.ids, torch.tensor([int(sym_id)], dtype=_I32,
                                       device=a.ids.device)])
    return aff_condense(AffineForm(a.center, t, i, a.rad), budget, rank)


def _aff_broadcast(a: AffineForm, shape) -> AffineForm:
    B = a.budget
    shape = tuple(shape)
    t = a.terms
    el = tuple(t.shape[1:])
    if len(el) < len(shape):
        # grow the element rank behind the slot dim before broadcasting
        t = t.reshape((B,) + (1,) * (len(shape) - len(el)) + el)
    return AffineForm(torch.broadcast_to(a.center, shape),
                      torch.broadcast_to(t, (B,) + shape), a.ids,
                      torch.broadcast_to(a.rad, shape))


def _aff_common(a: AffineForm, b: AffineForm):
    """Rewrite both forms over one shared id layout [Ba+Bb].

    ids are unique per form (creation is a strictly increasing counter and
    merges preserve uniqueness), so the match matrix has at most one hit
    per row/column and matched coefficients move with ONE addition. Each
    side keeps its own element shape (a concatenation joins forms of other
    shapes; the reference pads ``a`` with zeros of ``b``'s shape, which
    fails from a concatenation's third part on)."""
    eq = (a.ids[:, None] == b.ids[None, :]) & (a.ids[:, None] != 0)
    matched = eq.any(dim=0)                                  # [Bb]
    b_on_a = torch.tensordot(eq.to(_F64), b.terms, dims=([1], [0]))
    mshape = (b.ids.shape[0],) + (1,) * (b.terms.dim() - 1)
    b_un = torch.where(matched.reshape(mshape), 0.0, b.terms)
    ids = torch.cat([a.ids, torch.where(matched, 0, b.ids).to(_I32)])
    ta = torch.cat([a.terms, a.terms.new_zeros(
        (b_un.shape[0],) + tuple(a.terms.shape[1:]))], dim=0)
    tb = torch.cat([b_on_a, b_un], dim=0)
    return ids, ta, tb


def _bshape(*xs):
    return torch.broadcast_shapes(*(tuple(x.shape) for x in xs))


def _aff_linear(a: AffineForm, b: AffineForm, ca, cb, budget: int,
                rank: str = AFF_DEFAULT_RANK) -> AffineForm:
    """ca·a + cb·b for exact per-element multipliers ca/cb (the one affine
    combinator: add, sub and where-blends route through it)."""
    dev = a.center.device
    ca, cb = _f(ca, dev), _f(cb, dev)
    shape = _bshape(a.center, b.center, ca, cb)
    a, b = _aff_broadcast(a, shape), _aff_broadcast(b, shape)
    ids, ta, tb = _aff_common(a, b)
    center = ca * a.center + cb * b.center
    terms = ca * ta + cb * tb
    rad = ca.abs() * a.rad + cb.abs() * b.rad
    out = _aff_slop(AffineForm(center, terms, ids, rad), n_ops=6)
    return aff_condense(out, budget, rank)


def aff_add(a: AffineForm, b: AffineForm, budget: int,
            rank: str = AFF_DEFAULT_RANK) -> AffineForm:
    return _aff_linear(a, b, 1.0, 1.0, budget, rank)


def aff_sub(a: AffineForm, b: AffineForm, budget: int,
            rank: str = AFF_DEFAULT_RANK) -> AffineForm:
    return _aff_linear(a, b, 1.0, -1.0, budget, rank)


def aff_neg(a: AffineForm) -> AffineForm:
    return AffineForm(-a.center, -a.terms, a.ids, a.rad)


def aff_scale(a: AffineForm, c) -> AffineForm:
    """Multiply by an exact constant (scalar or array)."""
    c = _f(c, a.center.device)
    a = _aff_broadcast(a, _bshape(a.center, c))
    out = AffineForm(a.center * c, a.terms * c, a.ids, a.rad * c.abs())
    return _aff_slop(out, n_ops=4)


def aff_shift(a: AffineForm, c) -> AffineForm:
    c = _f(c, a.center.device)
    a = _aff_broadcast(a, _bshape(a.center, c))
    return _aff_slop(AffineForm(a.center + c, a.terms, a.ids, a.rad),
                     n_ops=4)


def aff_mul(a: AffineForm, b: AffineForm, budget: int,
            rank: str = AFF_DEFAULT_RANK) -> AffineForm:
    """Bilinear product: linear parts keep their symbols, the quadratic
    cross term (deviation × deviation) and each center × remainder term
    fold into rad."""
    shape = _bshape(a.center, b.center)
    a, b = _aff_broadcast(a, shape), _aff_broadcast(b, shape)
    ta_tot, tb_tot = aff_tot(a), aff_tot(b)
    ids, ta, tb = _aff_common(a, b)
    center = a.center * b.center
    terms = b.center * ta + a.center * tb
    rad = (a.center.abs() * b.rad + b.center.abs() * a.rad
           + ta_tot * tb_tot)
    out = _aff_slop(AffineForm(center, terms, ids, rad), n_ops=8)
    return aff_condense(out, budget, rank)


def aff_where(mask, a: AffineForm, b: AffineForm, budget: int,
              rank: str = AFF_DEFAULT_RANK) -> AffineForm:
    """Element-wise select — exact (comparisons don't round). The common
    id layout keeps each element's coefficients attached to its own
    symbols."""
    m = torch.as_tensor(mask, device=a.center.device)
    shape = _bshape(a.center, b.center, m)
    a, b = _aff_broadcast(a, shape), _aff_broadcast(b, shape)
    ids, ta, tb = _aff_common(a, b)
    out = AffineForm(torch.where(m, a.center, b.center),
                     torch.where(m[None], ta, tb),
                     ids, torch.where(m, a.rad, b.rad))
    return aff_condense(out, budget, rank)


def aff_intersect(a: AffineForm, ivl: Interval) -> AffineForm:
    """Intersect with an externally-proven bound (clamp_range): keep the
    center (it is the reference value) and terms only when the affine
    enclosure was already at least as tight; otherwise recenter on the
    intersection. Never empty (a wrong external bound keeps the original —
    mirroring caa.clamp_exact's guard)."""
    own = aff_interval(a)
    lo = torch.maximum(own.lo, ivl.lo)
    hi = torch.minimum(own.hi, ivl.hi)
    bad = lo > hi
    lo = torch.where(bad, own.lo, lo)
    hi = torch.where(bad, own.hi, hi)
    tighter = (lo <= own.lo) & (own.hi <= hi)
    rec = aff_from_interval(Interval(lo, hi), a.budget, center=a.center)
    keep = torch.broadcast_to(tighter, a.shape)
    return AffineForm(a.center,
                      torch.where(keep[None], a.terms, rec.terms),
                      a.ids, torch.where(keep, a.rad, rec.rad))
