"""CAA — Combined (absolute + relative) Affine Arithmetic, tensorised (PyTorch).

The counterpart of the JAX package's ``repro.core.caa``: the paper's
Section III rules in tensor form, on

  CaaTensor(val, exact, dbar, ebar)

  val    reference evaluation in f64 (the paper's FP value computed
         "without the enhanced arithmetic"; rounded to k bits when the
         config emulates a target format)
  exact  Interval enclosure of the ideal, error-free quantity
  dbar   absolute error bound, units of u:  |q̂ − q| ≤ dbar·u
  ebar   relative error bound, units of u:  q̂ = q(1+εu), |ε| ≤ ebar·u
         (+inf in either bound = "no bound of this kind")

Reductions (dot products, sums) use closed forms (Higham-style γ_n per
accumulation order) or, in trajectory mode, the actual partial-sum
magnitudes. Everything is f64 on the device of the inputs; bounds stay
sound under f64 evaluation by an upward-slop multiplier (``_ru``) and
ranges by the outward rounding of :mod:`repro_torch.core.interval`. The
op order of every rule is the reference's, so on the CPU the bounds agree
with the JAX package's to the last few ulps.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import torch

from repro_torch.core import formats, interval as iv
from repro_torch.core import quantize as qz
from repro_torch.core.interval import Interval, _f

_F64 = torch.float64
_INF = math.inf
# Upward slop for bound expressions of <= ~2^10 f64 flops.
_SLOP = 1.0 + 2.0 ** -40


def _ru(x):
    """Round a non-negative bound expression upward (sound in f64)."""
    return x * _SLOP


def _san(x):
    """inf−inf / 0·inf artefacts mean 'no information' → +inf."""
    if isinstance(x, torch.Tensor):
        return torch.where(torch.isnan(x), _INF, x)
    return _INF if math.isnan(x) else x


def _emul(val, cfg):
    """Round a freshly computed reference value into the emulated format."""
    if cfg.emulate_k is None:
        return val
    return qz._quantize_normal(val.to(_F64), cfg.emulate_k)


@dataclasses.dataclass(frozen=True)
class CaaConfig:
    """Analysis-wide parameters (the reference's fields and defaults).

    u_max: upper bound on u; second-order terms are bounded with it.
    acc_order: reduction order analysed ("sequential", "pairwise", "kahan").
    libm_rel: relative rounding bound (units of u) of one transcendental.
    round_scale: scales every fresh rounding (0 = propagation only; the
      sensitivity analysis gates it per scope).
    round_abs: absolute error per fresh rounding, units of u (underflow).
    use_trajectory / traj_max_elems: trajectory-mode dot products while the
      per-term product tensor fits under the budget.
    emulate_k / emulate_accum: round ``val`` to k bits, matmuls step by
      step in the target format.

    PyTorch runs eagerly, so ``u_max`` and ``round_scale`` are Python
    floats (the reference also accepts jit tracers there).
    """

    u_max: float = 2.0 ** -7
    acc_order: str = "sequential"
    libm_rel: float = 0.5
    round_scale: float = 1.0
    round_abs: float = 0.0
    use_trajectory: bool = True
    traj_max_elems: int = 2 ** 24
    emulate_k: int | None = None
    emulate_accum: bool = True

    @property
    def half(self) -> float:
        """One elementary rounding, in units of u (×round_scale)."""
        return 0.5 * self.round_scale

    @property
    def libm(self) -> float:
        return self.libm_rel * self.round_scale

    def gamma(self, n_terms: int) -> float:
        """γ factor in units of u for reducing ``n_terms`` values:
        (m/2)/(1 − m·u/2) with m set by the accumulation order."""
        n = max(int(n_terms), 1)
        if self.acc_order == "sequential":
            m = n
        elif self.acc_order == "pairwise":
            m = max(1, math.ceil(math.log2(n))) + 1
        elif self.acc_order == "kahan":
            m = 3 + n * n * self.u_max
        else:
            raise ValueError(f"unknown acc_order {self.acc_order!r}")
        denom = 1.0 - 0.5 * m * self.u_max
        if denom <= 0:
            return _INF
        return (0.5 * m) / denom * _SLOP * self.round_scale


DEFAULT_CONFIG = CaaConfig()


@dataclasses.dataclass(frozen=True)
class CaaTensor:
    val: torch.Tensor
    exact: Interval
    dbar: torch.Tensor
    ebar: torch.Tensor

    @property
    def shape(self):
        return tuple(self.val.shape)

    @property
    def ndim(self):
        return self.val.dim()

    @property
    def device(self):
        return self.val.device

    def fp_range(self, u: float) -> Interval:
        """Enclosure of the value as computed in FP with unit u ≤ u_max."""
        d = torch.where(torch.isfinite(self.dbar), self.dbar, _INF)
        by_abs = iv.widen_abs(self.exact, _ru(d * u))
        f = torch.where(torch.isfinite(self.ebar), self.ebar * u, _INF)
        lo, hi = self.exact
        by_rel = Interval(torch.minimum(lo * (1 + f), lo * (1 - f)),
                          torch.maximum(hi * (1 + f), hi * (1 - f)))
        lo = torch.maximum(_san(by_abs.lo * -1) * -1, _san(-by_rel.lo) * -1)
        hi = torch.minimum(_san(by_abs.hi), _san(by_rel.hi))
        return Interval(lo, hi)


# ---------------------------------------------------------------------------
# construction & normalisation
# ---------------------------------------------------------------------------

def _normalize(c: CaaTensor) -> CaaTensor:
    """Cross-improve the two bounds (the paper's 'CAA improves the one
    bound using the other whenever possible')."""
    m = iv.mag(c.exact)
    g = iv.mig(c.exact)
    d_from_e = _san(torch.where(torch.isfinite(c.ebar), _ru(c.ebar * m),
                                _INF))
    e_from_d = _san(torch.where(g > 0, _ru(c.dbar / torch.where(g > 0, g,
                                                                1.0)),
                                _INF))
    dbar = torch.minimum(_san(c.dbar), d_from_e)
    ebar = torch.minimum(_san(c.ebar), e_from_d)
    return CaaTensor(c.val, c.exact, dbar, ebar)


def _finish(cfg: CaaConfig, c: CaaTensor, rounds=1) -> CaaTensor:
    """Normalise an op result, then charge its finite-range underflow term
    (``cfg.round_abs`` per fresh rounding into δ̄, and η/mig(exact) into
    ε̄). With round_abs = 0 this is exactly :func:`_normalize`."""
    c = _normalize(c)
    ra = cfg.round_abs
    if ra == 0.0:
        return c
    add = _ru(float(rounds) * ra)
    g = iv.mig(c.exact)
    rel = _san(torch.where(g > 0, add / torch.where(g > 0, g, 1.0), _INF))
    return CaaTensor(c.val, c.exact, _san(c.dbar + add), _san(c.ebar + rel))


def make(val, exact: Optional[Interval] = None, dbar=0.0,
         ebar=0.0) -> CaaTensor:
    val = _f(val)
    if exact is None:
        exact = iv.point(val)
        if isinstance(dbar, float) and isinstance(ebar, float) \
                and dbar == 0.0 and ebar == 0.0:
            # a point with no error normalises to δ̄ = ε̄ = 0 everywhere:
            # keep them as one broadcast zero, not two [*S] tensors (a
            # full-width embedding table is 4.4 GB in f64)
            zero = torch.zeros((), dtype=_F64, device=val.device)
            return CaaTensor(val, exact, zero.expand(val.shape),
                             zero.expand(val.shape))
    dbar = torch.broadcast_to(_f(dbar, val.device), val.shape)
    ebar = torch.broadcast_to(_f(ebar, val.device), val.shape)
    return _normalize(CaaTensor(val, exact, dbar, ebar))


def const_exact(val) -> CaaTensor:
    """A constant exactly representable in the target format (δ̄=ε̄=0)."""
    return make(val)


def const_rounded(val, cfg: CaaConfig = DEFAULT_CONFIG) -> CaaTensor:
    """A real constant stored rounded-to-nearest in the target format."""
    return make(val, dbar=_INF, ebar=cfg.half)


def weight(w, cfg: CaaConfig = DEFAULT_CONFIG, exact: bool = True) -> CaaTensor:
    """A parameter tensor under the analysis/emulation config. exact=True
    (the paper's default): the stored weight is the reference (δ̄=ε̄=0);
    exact=False: storage costs one rounding (ε̄ = ½)."""
    w = _f(w)
    wq = _emul(w, cfg)
    if exact:
        return make(wq)
    return _normalize(CaaTensor(wq, iv.point(w), torch.full_like(w, _INF),
                                torch.full_like(w, cfg.half)))


def from_range(lo, hi, dbar=0.0, ebar=0.0) -> CaaTensor:
    """Input data known only by an interval (paper §V: images in [0;255])."""
    lo = _f(lo)
    hi = _f(hi, lo.device)
    mid = 0.5 * (lo + hi)
    return make(mid, Interval(*torch.broadcast_tensors(lo, hi)), dbar, ebar)


# ---------------------------------------------------------------------------
# rel-bound combinators
# ---------------------------------------------------------------------------

def _combine_rel(cfg: CaaConfig, *es):
    """Bound (Π(1+θ_i u) − 1)/u for |θ_i| ≤ e_i u, at u_max."""
    total = 0.0
    for e in es:
        total = total + e + total * e * cfg.u_max
    return _san(_ru(total))


def _eff_dbar(c: CaaTensor) -> torch.Tensor:
    """The sharpest absolute bound derivable from both fields."""
    m = iv.mag(c.exact)
    alt = _san(torch.where(torch.isfinite(c.ebar), c.ebar * m, _INF))
    return torch.minimum(_san(c.dbar), _ru(alt))


def _eff_ebar(c: CaaTensor) -> torch.Tensor:
    g = iv.mig(c.exact)
    alt = _san(torch.where(g > 0, c.dbar / torch.where(g > 0, g, 1.0), _INF))
    return torch.minimum(_san(c.ebar), _ru(alt))


def _mig_fp(c: CaaTensor, cfg: CaaConfig) -> torch.Tensor:
    """inf |x̂| over the FP-perturbed range (0 if it may cross 0)."""
    d = _eff_dbar(c)
    pad = _san(d * cfg.u_max)
    return iv.mig(Interval(c.exact.lo - pad, c.exact.hi + pad))


def _amp(num, g):
    """num/g where g > 0, +inf elsewhere (an IA-bounded amplification)."""
    return _san(torch.where(g > 0, num / torch.where(g > 0, g, 1.0), _INF))


# ---------------------------------------------------------------------------
# basic arithmetic
# ---------------------------------------------------------------------------

def add(a: CaaTensor, b: CaaTensor, cfg: CaaConfig = DEFAULT_CONFIG) -> CaaTensor:
    exact = iv.add(a.exact, b.exact)
    da, db = _eff_dbar(a), _eff_dbar(b)
    # |fl(â+b̂) − (a+b)| ≤ (δa+δb)u + ½u·|â+b̂|
    mag_fp = iv.mag(exact) + (da + db) * cfg.u_max
    dbar = _ru(da + db + cfg.half * mag_fp)
    # relative path with IA-bounded amplification (paper eq. (8))
    g = iv.mig(exact)
    alpha_a = _amp(iv.mag(a.exact), g)
    alpha_b = _amp(iv.mag(b.exact), g)
    e_prop = _san(_eff_ebar(a) * alpha_a) + _san(_eff_ebar(b) * alpha_b)
    ebar = _combine_rel(cfg, e_prop, cfg.half)
    return _finish(cfg, CaaTensor(_emul(a.val + b.val, cfg), exact,
                                  _san(dbar), ebar))


def sub(a: CaaTensor, b: CaaTensor, cfg: CaaConfig = DEFAULT_CONFIG) -> CaaTensor:
    return add(a, neg(b), cfg)


def neg(a: CaaTensor) -> CaaTensor:
    return CaaTensor(-a.val, iv.neg(a.exact), a.dbar, a.ebar)


def mul(a: CaaTensor, b: CaaTensor, cfg: CaaConfig = DEFAULT_CONFIG) -> CaaTensor:
    exact = iv.mul(a.exact, b.exact)
    ebar = _combine_rel(cfg, _eff_ebar(a), _eff_ebar(b), cfg.half)
    # |âb̂ − ab| ≤ |a|δb u + |b|δa u + δaδb u² + ½u|âb̂|
    da, db = _eff_dbar(a), _eff_dbar(b)
    ma, mb = iv.mag(a.exact), iv.mag(b.exact)
    direct = (ma * db + mb * da + da * db * cfg.u_max
              + cfg.half * (ma + da * cfg.u_max) * (mb + db * cfg.u_max))
    dbar = _san(_ru(direct))
    return _finish(cfg, CaaTensor(_emul(a.val * b.val, cfg), exact, dbar,
                                  ebar))


def div(a: CaaTensor, b: CaaTensor, cfg: CaaConfig = DEFAULT_CONFIG) -> CaaTensor:
    exact = iv.div(a.exact, b.exact)
    eb = _eff_ebar(b)
    inv_e = _san(torch.where(eb * cfg.u_max < 1, eb / (1 - eb * cfg.u_max),
                             _INF))
    ebar = _combine_rel(cfg, _eff_ebar(a), inv_e, cfg.half)
    # |â/b̂ − a/b| ≤ δ_a u/|b̂| + |a| δ_b u/(|b||b̂|) + the division's own
    # rounding, on the FP-inflated denominator range
    mig_b = iv.mig(b.exact)
    mfp_b = _mig_fp(b, cfg)
    ok = (mfp_b > 0) & (mig_b > 0)
    inv_fp = torch.where(ok, 1.0 / torch.where(ok, mfp_b, 1.0), _INF)
    inv_bb = torch.where(ok, 1.0 / torch.where(ok, mig_b * mfp_b, 1.0), _INF)
    dbar = _san(_ru(
        _eff_dbar(a) * inv_fp
        + iv.mag(a.exact) * _eff_dbar(b) * inv_bb
        + cfg.half * _san(iv.mag(exact) + (_eff_dbar(a) * inv_fp) * cfg.u_max)
    ))
    val = _emul(a.val / b.val, cfg)
    return _finish(cfg, CaaTensor(val, exact, dbar, ebar))


def sqrt(a: CaaTensor, cfg: CaaConfig = DEFAULT_CONFIG) -> CaaTensor:
    exact = iv.sqrt(a.exact)
    ea = _eff_ebar(a)
    x = ea * cfg.u_max
    # relative path: |sqrt(1+x)−1| ≤ |x| / (1 + sqrt(max(0,1−|x|)))
    amp = _san(torch.where(x < 1, ea / (1 + torch.sqrt(torch.clamp(
        1 - x, min=0.0))), _INF))
    ebar = _combine_rel(cfg, amp, cfg.half)
    # absolute path: sqrt is 1/(2√t)-Lipschitz on t ≥ mig_fp > 0
    mfp = _mig_fp(a, cfg)
    L = _san(torch.where(mfp > 0, 0.5 / torch.sqrt(torch.where(mfp > 0, mfp,
                                                               1.0)), _INF))
    dbar = _san(_ru(_eff_dbar(a) * L + cfg.half * iv.mag(exact)))
    val = _emul(torch.sqrt(a.val), cfg)
    return _finish(cfg, CaaTensor(val, exact, dbar, ebar))


def rsqrt(a: CaaTensor, cfg: CaaConfig = DEFAULT_CONFIG) -> CaaTensor:
    one = make(torch.ones((), dtype=_F64, device=a.device))
    return div(one, sqrt(a, cfg), cfg)


def square(a: CaaTensor, cfg: CaaConfig = DEFAULT_CONFIG) -> CaaTensor:
    # x·x is perfectly correlated: exact range via iv.square, rel error 2ε
    # + rounding
    exact = iv.square(a.exact)
    ebar = _combine_rel(cfg, _eff_ebar(a), _eff_ebar(a), cfg.half)
    da = _eff_dbar(a)
    ma = iv.mag(a.exact)
    direct = (2 * ma * da + da * da * cfg.u_max
              + cfg.half * (ma + da * cfg.u_max) ** 2)
    return _finish(cfg, CaaTensor(_emul(a.val * a.val, cfg), exact,
                                  _san(_ru(direct)), ebar))


def scale_const(a: CaaTensor, c, exact_const: bool = False,
                cfg: CaaConfig = DEFAULT_CONFIG) -> CaaTensor:
    """Multiply by a scalar/array constant. exact_const=True → the constant
    is exactly representable in the target format (e.g. a power of two)."""
    exact = iv.scale(a.exact, c)
    extra = () if exact_const else (1.2 * cfg.half,)
    ebar = _combine_rel(cfg, _eff_ebar(a), cfg.half, *extra)
    c = _f(c, a.device)
    da = _eff_dbar(a)
    dir_d = (c.abs() * da * (1 + cfg.u_max)
             + (cfg.half + (0 if exact_const else 1.2 * cfg.half))
             * iv.mag(exact))
    return _finish(cfg, CaaTensor(_emul(a.val * c, cfg), exact,
                                  _san(_ru(dir_d)), ebar),
                   rounds=1 if exact_const else 2)


def shift_const(a: CaaTensor, c, cfg: CaaConfig = DEFAULT_CONFIG) -> CaaTensor:
    return add(a, const_exact(_f(c, a.device)), cfg)


# ---------------------------------------------------------------------------
# elementwise nonlinearities
# ---------------------------------------------------------------------------

def exp(a: CaaTensor, cfg: CaaConfig = DEFAULT_CONFIG) -> CaaTensor:
    """exp converts an absolute input bound into a relative output bound:
    e^{q+δu} = e^q·(1 + (e^{δu}−1))."""
    exact = iv.exp(a.exact)
    x = _eff_dbar(a) * cfg.u_max
    conv = _san(torch.where(torch.isfinite(x), torch.expm1(x) / cfg.u_max,
                            _INF))
    ebar = _combine_rel(cfg, conv, cfg.libm)
    val = _emul(torch.exp(a.val), cfg)
    return _finish(cfg, CaaTensor(val, exact, torch.full_like(val, _INF),
                                  ebar))


def log(a: CaaTensor, cfg: CaaConfig = DEFAULT_CONFIG) -> CaaTensor:
    """log converts relative into absolute; an abs-in path (1/mig_fp
    Lipschitz) covers ε̄·u ≥ 1 when the value stays off 0."""
    exact = iv.log(a.exact)
    e = _eff_ebar(a)
    x = e * cfg.u_max
    conv = _san(torch.where(x < 1, e / (1 - x), _INF))
    mfp = _mig_fp(a, cfg)
    lips = _amp(_eff_dbar(a), mfp)
    dbar = _ru(torch.minimum(_san(conv), lips) + cfg.libm * iv.mag(exact))
    val = _emul(torch.log(a.val), cfg)
    return _finish(cfg, CaaTensor(val, exact, _san(dbar),
                                  torch.full_like(val, _INF)))


TANH_REL_FACTOR = 2.63  # paper §III, valid while ε̄·u ≤ 1/4
TANH_REL_GATE = 0.25


def tanh(a: CaaTensor, cfg: CaaConfig = DEFAULT_CONFIG) -> CaaTensor:
    exact = iv.tanh(a.exact)
    # abs → abs with the local Lipschitz bound L = sup sech² = 1 − mig(tanh)²
    t_mig = iv.mig(exact)
    L = torch.clamp(_ru(1.0 - t_mig * t_mig) + 2.0 ** -50, max=1.0)
    d = _eff_dbar(a)
    own_abs = cfg.libm * iv.mag(exact)
    dbar = _san(_ru(d * L + own_abs))
    # rel → rel with the paper's constant, gated as in the paper
    e = _eff_ebar(a)
    prop = torch.where(e * cfg.u_max <= TANH_REL_GATE, TANH_REL_FACTOR * e,
                       _INF)
    ebar = _combine_rel(cfg, _san(prop), cfg.libm)
    val = _emul(torch.tanh(a.val), cfg)
    return _finish(cfg, CaaTensor(val, exact, dbar, ebar))


def sigmoid(a: CaaTensor, cfg: CaaConfig = DEFAULT_CONFIG) -> CaaTensor:
    exact = iv.sigmoid(a.exact)
    # L = sup σ(1−σ) over the output range
    slo, shi = exact.lo, exact.hi
    f = lambda s: s * (1 - s)
    L = torch.where((slo <= 0.5) & (shi >= 0.5), 0.25,
                    torch.maximum(f(slo), f(shi)))
    d = _eff_dbar(a)
    dbar = _san(_ru(d * L + cfg.libm * iv.mag(exact)))
    # κ = sup |x·(1−σ(x))| over the input range
    xlo, xhi = a.exact.lo, a.exact.hi
    kpos = torch.where(xhi > 0, iv._const(0.2785, xhi), 0.0)
    kneg = torch.where(xlo < 0, _ru(xlo.abs() * (1 - torch.sigmoid(xlo))
                                    + 2e-16), 0.0)
    kappa = torch.maximum(kpos, kneg)
    e = _eff_ebar(a)
    ebar = _combine_rel(cfg, _san(e * kappa), cfg.libm)
    val = _emul(torch.sigmoid(a.val), cfg)
    return _finish(cfg, CaaTensor(val, exact, dbar, ebar))


def relu(a: CaaTensor, cfg: CaaConfig = DEFAULT_CONFIG) -> CaaTensor:
    """Comparison+selection is exact in FP: no fresh rounding."""
    exact = iv.clamp_min(a.exact, 0.0)
    e = _eff_ebar(a)
    ebar = torch.where(e * cfg.u_max < 1.0, e, _INF)
    return _normalize(CaaTensor(torch.clamp(a.val, min=0.0), exact,
                                _eff_dbar(a), _san(ebar)))


def silu(a: CaaTensor, cfg: CaaConfig = DEFAULT_CONFIG) -> CaaTensor:
    return mul(a, sigmoid(a, cfg), cfg)


def gelu(a: CaaTensor, cfg: CaaConfig = DEFAULT_CONFIG) -> CaaTensor:
    """tanh-approximated GELU, composed from CAA primitives."""
    c = math.sqrt(2.0 / math.pi)
    x3 = mul(square(a, cfg), a, cfg)
    inner = add(a, scale_const(x3, 0.044715, cfg=cfg), cfg)
    t = tanh(scale_const(inner, c, cfg=cfg), cfg)
    one_plus = shift_const(t, 1.0, cfg)
    return scale_const(mul(a, one_plus, cfg), 0.5, exact_const=True, cfg=cfg)


def maximum(a: CaaTensor, b: CaaTensor, cfg: CaaConfig = DEFAULT_CONFIG) -> CaaTensor:
    """max is 1-Lipschitz in each arg and selection is exact."""
    exact = iv.maximum(a.exact, b.exact)
    dbar = torch.maximum(_eff_dbar(a), _eff_dbar(b))
    ebar = torch.maximum(_eff_ebar(a), _eff_ebar(b))
    return _normalize(CaaTensor(torch.maximum(a.val, b.val), exact, dbar,
                                ebar))


def minimum(a: CaaTensor, b: CaaTensor, cfg: CaaConfig = DEFAULT_CONFIG) -> CaaTensor:
    return neg(maximum(neg(a), neg(b), cfg))


def where(mask, a: CaaTensor, b: CaaTensor) -> CaaTensor:
    """Selection by an exact (non-FP-derived) predicate — error-free."""
    mask = torch.as_tensor(mask, dtype=torch.bool, device=a.device)
    pick = lambda x, y: torch.where(mask, x, y)
    return CaaTensor(pick(a.val, b.val),
                     Interval(pick(a.exact.lo, b.exact.lo),
                              pick(a.exact.hi, b.exact.hi)),
                     pick(a.dbar, b.dbar), pick(a.ebar, b.ebar))


# ---------------------------------------------------------------------------
# reductions & contractions
# ---------------------------------------------------------------------------

def reduce_sum(a: CaaTensor, axis, keepdims: bool = False,
               cfg: CaaConfig = DEFAULT_CONFIG) -> CaaTensor:
    n = int(a.val.shape[axis])
    exact = iv.sum_(a.exact, axis=axis, keepdims=keepdims)
    da = _eff_dbar(a)
    mag_fp = iv.mag(a.exact) + da * cfg.u_max
    g = cfg.gamma(max(n - 1, 1))
    dbar = _ru(torch.sum(da, dim=axis, keepdim=keepdims)
               + g * torch.sum(mag_fp, dim=axis, keepdim=keepdims))
    val = _emul(torch.sum(a.val, dim=axis, keepdim=keepdims), cfg)
    return _finish(cfg, CaaTensor(val, exact, _san(dbar),
                                  torch.full_like(val, _INF)),
                   rounds=max(n - 1, 1))


def reduce_mean(a: CaaTensor, axis, keepdims: bool = False,
                cfg: CaaConfig = DEFAULT_CONFIG) -> CaaTensor:
    n = int(a.val.shape[axis])
    s = reduce_sum(a, axis, keepdims, cfg)
    return scale_const(s, 1.0 / n, exact_const=(n & (n - 1) == 0), cfg=cfg)


def reduce_max(a: CaaTensor, axis, keepdims: bool = False,
               cfg: CaaConfig = DEFAULT_CONFIG) -> CaaTensor:
    exact = iv.max_(a.exact, axis=axis, keepdims=keepdims)
    dbar = torch.amax(_eff_dbar(a), dim=axis, keepdim=keepdims)
    ebar = torch.amax(_eff_ebar(a), dim=axis, keepdim=keepdims)
    val = torch.amax(a.val, dim=axis, keepdim=keepdims)
    # pure selection — no fresh rounding, no underflow charge
    return _normalize(CaaTensor(val, exact, dbar, ebar))


def contract(bilinear: Callable, n_contract: int, a: CaaTensor, b: CaaTensor,
             cfg: CaaConfig = DEFAULT_CONFIG) -> CaaTensor:
    """General rigorous bilinear contraction (matmul/einsum/conv).

    ``bilinear(x, y)`` must map non-negative arrays to the elementwise-|·|
    majorant of itself; ``n_contract`` is the reduction length of one
    output element. Error model (units of u):

      δ_out ≤ B(|a|, δ_b) + B(δ_a, |b|) + u·B(δ_a, δ_b)      [operand errors]
              + γ(n)·B(|â|, |b̂|)                              [roundings]

    With exact weights (δ_b = 0) the dbar term is exactly
    (δ_a + γ(n)·|â|) @ |b| — the function of the ``caa_matmul`` kernel.
    """
    val = _emul(bilinear(a.val, b.val), cfg)
    exact = _einsum_exact(bilinear, a.exact, b.exact)
    da, db = _eff_dbar(a), _eff_dbar(b)
    ma, mb = iv.mag(a.exact), iv.mag(b.exact)
    ma_fp = ma + da * cfg.u_max
    mb_fp = mb + db * cfg.u_max
    g = cfg.gamma(n_contract)
    dbar = _ru(bilinear(ma, db) + bilinear(da, mb)
               + cfg.u_max * bilinear(da, db) + g * bilinear(ma_fp, mb_fp))
    # n products + n−1 partial sums ≤ 2n fresh roundings per output element
    return _finish(cfg, CaaTensor(val, exact, _san(dbar),
                                  torch.full_like(val, _INF)),
                   rounds=2 * n_contract)


def _einsum_exact(bilinear: Callable, a: Interval, b: Interval) -> Interval:
    """Ball-arithmetic enclosure of a bilinear map on two intervals."""
    ma, ra = iv.ball(a)
    mb, rb = iv.ball(b)
    mid = bilinear(ma, mb)
    rad = (bilinear(ma.abs(), rb) + bilinear(ra, mb.abs())
           + bilinear(ra, rb))
    rad = _ru(rad) + 1e-14 * _ru(bilinear(ma.abs() + ra, mb.abs() + rb))
    rad = torch.where(torch.isnan(rad), _INF, rad)
    mid = torch.where(torch.isnan(mid), 0.0, mid)
    return iv.from_ball(mid, _ru(rad))


def _traj_rounding_bound(a: CaaTensor, b: CaaTensor,
                         cfg: CaaConfig) -> torch.Tensor:
    """Fresh-rounding bound for fl(x·W) from the actual partial-sum
    magnitudes: ½u·|p̂_i| per product and ½u·|ŝ_t| per partial sum, summed
    (sequential or pairwise order). a: [..., n], b: [n, m] → [..., m]."""
    ma, ra = iv.ball(a.exact)
    mb, rb = iv.ball(b.exact)
    ra = ra + _eff_dbar(a) * cfg.u_max          # FP-inflated radii
    rb = rb + _eff_dbar(b) * cfg.u_max
    # per-term product midpoint/radius: [..., n, m]
    p_mid = ma[..., :, None] * mb
    p_rad = (ma.abs()[..., :, None] * rb + ra[..., :, None] * mb.abs()
             + ra[..., :, None] * rb)
    prod_mag = p_mid.abs() + p_rad
    half = cfg.half
    t_prod = half * torch.sum(prod_mag, dim=-2)
    if cfg.acc_order == "pairwise":
        t_sum = torch.zeros_like(t_prod)
        mid, rad = p_mid, p_rad
        while mid.shape[-2] > 1:
            if mid.shape[-2] % 2:  # odd: carry the last term
                carry_m, carry_r = mid[..., -1:, :], rad[..., -1:, :]
                mid, rad = mid[..., :-1, :], rad[..., :-1, :]
            else:
                carry_m = carry_r = None
            mid = mid[..., 0::2, :] + mid[..., 1::2, :]
            rad = rad[..., 0::2, :] + rad[..., 1::2, :]
            t_sum = t_sum + half * torch.sum(mid.abs() + rad, dim=-2)
            if carry_m is not None:
                mid = torch.cat([mid, carry_m], dim=-2)
                rad = torch.cat([rad, carry_r], dim=-2)
    else:  # sequential (also a sound over-estimate for kahan)
        s_mid = torch.cumsum(p_mid, dim=-2)
        s_rad = torch.cumsum(p_rad, dim=-2)
        # partial sums s_2..s_n round (s_1 is just the first product)
        t_sum = half * torch.sum((s_mid.abs() + s_rad)[..., 1:, :], dim=-2)
    return _ru(t_prod + t_sum)


def _matmul_val(av, bv, cfg: CaaConfig):
    """Reference value of x@W under the configured emulation."""
    if cfg.emulate_k is None:
        return av @ bv
    if cfg.emulate_accum and bv.dim() == 2:
        fmt = formats.custom(cfg.emulate_k)
        if cfg.acc_order == "pairwise":
            return qz.pairwise_dot(av, bv, fmt)
        return qz.seq_dot(av, bv, fmt)
    return _emul(av @ bv, cfg)


def _matmul(x, y):
    return x @ y


def matmul(a: CaaTensor, b: CaaTensor, cfg: CaaConfig = DEFAULT_CONFIG) -> CaaTensor:
    n = int(a.val.shape[-1])
    out_elems = math.prod(a.val.shape[:-1]) * b.val.shape[-1]
    if (cfg.use_trajectory and b.val.dim() == 2
            and out_elems * n <= cfg.traj_max_elems
            and cfg.acc_order in ("sequential", "pairwise")):
        val = _matmul_val(a.val, b.val, cfg)
        exact = _einsum_exact(_matmul, a.exact, b.exact)
        da, db = _eff_dbar(a), _eff_dbar(b)
        ma, mb = iv.mag(a.exact), iv.mag(b.exact)
        fresh = _traj_rounding_bound(a, b, cfg)
        dbar = _ru(ma @ db + da @ mb + cfg.u_max * (da @ db) + fresh)
        return _finish(cfg, CaaTensor(val, exact, _san(dbar),
                                      torch.full_like(val, _INF)),
                       rounds=2 * n)
    return contract(_matmul, n, a, b, cfg)


def einsum(subscripts: str, a: CaaTensor, b: CaaTensor,
           cfg: CaaConfig = DEFAULT_CONFIG) -> CaaTensor:
    n = _contraction_length(subscripts, a.shape, b.shape)
    return contract(lambda x, y: torch.einsum(subscripts, x, y), n, a, b, cfg)


def _contraction_length(subscripts: str, sa, sb) -> int:
    ins, out = subscripts.replace(" ", "").split("->")
    la, lb = ins.split(",")
    dims = {}
    for labels, shape in ((la, sa), (lb, sb)):
        core = labels.replace("...", "")
        trail = shape[len(shape) - len(core):]
        for ch, d in zip(core, trail):
            dims[ch] = d
    n = 1
    for ch, d in dims.items():
        if ch not in out:
            n *= int(d)
    return max(n, 1)


def dense(x: CaaTensor, w: CaaTensor, b: Optional[CaaTensor] = None,
          cfg: CaaConfig = DEFAULT_CONFIG) -> CaaTensor:
    """y = x @ W (+ b): the paper's Dense layer rule."""
    y = matmul(x, w, cfg)
    if b is not None:
        y = add(y, b, cfg)
    return y


# ---------------------------------------------------------------------------
# softmax — the paper's Section IV analysis, as a composite rule
# ---------------------------------------------------------------------------

def softmax(a: CaaTensor, axis: int = -1, cfg: CaaConfig = DEFAULT_CONFIG) -> CaaTensor:
    """Absolute-in → relative-out (paper eq. (10)–(11)), with the softmax
    weights kept: |η_i| ≤ e^{δ̄_i u}·Σ_k w_k e^{δ̄_k u} − Σ_k w_k, w_k =
    sup softmax_k over the exact ranges; then the layer's own roundings
    (exp, positive sum, div). The max-shift x − max(x) ≤ 0 uses the ordering
    side-information as the paper prescribes."""
    n = int(a.val.shape[axis])
    d_in = _eff_dbar(a)
    d_in_max = torch.amax(d_in, dim=axis, keepdim=True)
    hi_max = torch.amax(a.exact.hi, dim=axis, keepdim=True)
    shifted = Interval(torch.clamp(a.exact.lo - hi_max, max=0.0),
                       torch.zeros_like(a.exact.hi))
    shift_round = cfg.half * iv.mag(shifted)
    d_tot = _ru(d_in + d_in_max + shift_round)        # δ̄_k, per element

    exact = iv.softmax_range(a.exact, axis=axis)
    w_hi = exact.hi
    edu = torch.exp(d_tot * cfg.u_max)                # may overflow → inf
    term = _san(torch.where(w_hi > 0, w_hi * edu, 0.0))  # w=0 ⇒ 0
    S1 = _ru(torch.sum(term, dim=axis, keepdim=True))
    W = torch.sum(w_hi, dim=axis, keepdim=True)
    eta = _san(torch.clamp(edu * S1 - W, min=0.0))   # per output element
    prop = _san(torch.where(eta < 1.0, (eta / (1.0 - eta)) / cfg.u_max, _INF))

    own = _combine_rel(cfg, cfg.libm, cfg.gamma(max(n - 1, 1)), cfg.half)
    ebar = _combine_rel(cfg, prop, own)
    ebar = torch.broadcast_to(ebar, a.val.shape)

    # |ŷ_i − y_i| ≤ w_hi_i · ε̄_i u; exactly-0 weights have zero error
    dbar = _san(torch.where(w_hi > 0, w_hi * ebar, 0.0))
    val = _emul(torch.softmax(a.val, dim=axis), cfg)
    # shift-sub + exp + (n−1)-sum + div: ≤ n+3 roundings feed one output
    return _finish(cfg, CaaTensor(val, exact, _ru(dbar), ebar), rounds=n + 3)


# ---------------------------------------------------------------------------
# recurrences (SSM layers) — beyond the paper, as in the reference
# ---------------------------------------------------------------------------

def scan_affine_fixpoint(decay: CaaTensor, drive: CaaTensor, n_steps: int,
                         cfg: CaaConfig = DEFAULT_CONFIG,
                         decay_le_one: bool = True) -> CaaTensor:
    """Sound bound for h_T from h_{t+1} = decay ⊙ h_t + drive, h_0 = 0.

    With m = sup|decay| (FP-inflated) and per-step absolute error δ_step
    (one mul + one add at the current magnitude), the accumulated error is
    ≤ δ_step·Σ m^t = δ_step·min(T, (1−m^T)/(1−m)) — geometric for
    contraction (m<1), linear otherwise. Ranges get the same treatment.
    This is the closed form of the CAA fold over the scan; the paper has no
    recurrent layers, so the rule is the reference's own.
    """
    m = _ru(iv.mag(decay.exact) + _eff_dbar(decay) * cfg.u_max)
    if decay_le_one:
        # Decays of the form exp(−exp(·)) / exp(−dt·A) are ≤ 1 both ideally
        # and as FP values (RNE of exp(negative) never exceeds 1), so the
        # error-recurrence multiplier is soundly clamped — this keeps
        # 500k-step bounds finite (linear worst case instead of blow-up).
        m = torch.minimum(m, torch.ones_like(m))
    mag_b = _ru(iv.mag(drive.exact) + _eff_dbar(drive) * cfg.u_max)
    # Σ_{t<T} m^t, soundly (upper)
    T = float(n_steps)
    grow = torch.exp(torch.log(torch.clamp(m, min=1.0)) * T) \
        / torch.clamp(m - 1.0, min=1e-300)
    geo = torch.where(
        m < 1.0,
        torch.clamp(1.0 / torch.clamp(1.0 - m, min=1e-300), max=T),
        _san(torch.where(m == 1.0, torch.full_like(m, T), grow)))
    geo = _ru(geo)
    mag_h = _ru(mag_b * geo)
    # one-step error recurrence δ_{t+1} ≤ m·δ_t + c with
    # c = δ_drive + mag_h·δ_decay + (½+½)·mag_h   (mul + add roundings)
    # whose solution is δ_T ≤ c·Σ m^t = c·geo.
    c = _ru(_eff_dbar(drive) + mag_h * _eff_dbar(decay) + 2 * cfg.half * mag_h
            + 2 * float(cfg.round_abs))
    dbar = _san(_ru(c * geo))
    exact = Interval(-mag_h, mag_h)
    # reference value: the steady-state fixpoint of the val fields
    val = drive.val / torch.clamp(1.0 - decay.val.abs(), min=1e-6)
    return _normalize(CaaTensor(val, exact, dbar, torch.full_like(val, _INF)))


# ---------------------------------------------------------------------------
# shape ops — error-free data movement
# ---------------------------------------------------------------------------

def _shape_op(fn: Callable, a: CaaTensor) -> CaaTensor:
    return CaaTensor(fn(a.val), Interval(fn(a.exact.lo), fn(a.exact.hi)),
                     fn(torch.broadcast_to(a.dbar, a.shape)),
                     fn(torch.broadcast_to(a.ebar, a.shape)))


def reshape(a: CaaTensor, shape) -> CaaTensor:
    return _shape_op(lambda x: x.reshape(shape), a)


def transpose(a: CaaTensor, axes) -> CaaTensor:
    return _shape_op(lambda x: x.permute(*axes), a)


def broadcast_to(a: CaaTensor, shape) -> CaaTensor:
    return _shape_op(lambda x: torch.broadcast_to(x, shape), a)


def concatenate(parts: Sequence[CaaTensor], axis: int) -> CaaTensor:
    cat = lambda get: torch.cat([get(p) for p in parts], dim=axis)
    return CaaTensor(
        cat(lambda p: p.val),
        Interval(cat(lambda p: p.exact.lo), cat(lambda p: p.exact.hi)),
        cat(lambda p: torch.broadcast_to(p.dbar, p.shape)),
        cat(lambda p: torch.broadcast_to(p.ebar, p.shape)))


def take_along(x: torch.Tensor, idx, axis: int) -> torch.Tensor:
    """``jnp.take(x, idx, axis)`` for an integer index tensor of any
    shape: the index dims replace ``axis``."""
    idx = torch.as_tensor(idx, device=x.device)
    axis = axis % x.dim()
    y = x.movedim(axis, 0)[idx]
    k = idx.dim()
    return y.movedim(tuple(range(k)), tuple(range(axis, axis + k)))


def take(a: CaaTensor, idx, axis: int) -> CaaTensor:
    return _shape_op(lambda x: take_along(x, idx, axis), a)


def slice_(a: CaaTensor, slices) -> CaaTensor:
    return _shape_op(lambda x: x[slices], a)


def worst(a: CaaTensor) -> tuple[float, float]:
    """(max δ̄, max ε̄) over the tensor — the Table-I-style summary."""
    return float(torch.max(a.dbar)), float(torch.max(a.ebar))


def clamp_exact(c: CaaTensor, lo, hi) -> CaaTensor:
    """Intersect the ideal-value enclosure with an externally-proven bound
    (the paper's 'just enough global insight'); error bounds untouched,
    the normalisation tightens them from the sharper range. An empty
    intersection (a wrong external bound) keeps the original."""
    lo = _f(lo, c.device)
    hi = _f(hi, c.device)
    new_lo = torch.maximum(c.exact.lo, lo)
    new_hi = torch.minimum(c.exact.hi, hi)
    bad = new_lo > new_hi
    new_lo = torch.where(bad, c.exact.lo, new_lo)
    new_hi = torch.where(bad, c.exact.hi, new_hi)
    return _normalize(CaaTensor(c.val, Interval(new_lo, new_hi), c.dbar,
                                c.ebar))


def actual_error_in_u(c: CaaTensor, u: float):
    """Rigorous enclosure of the *actual* error of the emulated run:
    sup_{q ∈ exact} |val − q|, as (absolute, relative) in units of u (the
    quantity Table I tabulates)."""
    dist = torch.maximum((c.val - c.exact.lo).abs(),
                         (c.val - c.exact.hi).abs())
    abs_u = _ru(dist) / u
    g = iv.mig(c.exact)
    rel_u = _amp(abs_u, g)
    return abs_u, rel_u
