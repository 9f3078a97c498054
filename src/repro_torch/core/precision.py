"""Precision tailoring: from CAA bounds + top-1 margin to a format choice.

A copy of the JAX package's ``repro.core.precision`` (pure Python;
the port imports nothing of that package).

Implements the paper's Section IV end-game: given the analysis output (final
absolute/relative bounds in units of u) and external knowledge p* > 0.5 (the
guaranteed top-1 probability — from SafeAI-style tools or simply specified,
accepting some misclassification rate), choose the smallest precision k such
that rounding can never flip the argmax. Beyond the paper: per-layer
mixed-precision assignment from the layer trace.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

from repro_torch.core import formats, theory


@dataclasses.dataclass(frozen=True)
class PrecisionDecision:
    p_star: float
    abs_margin: float
    rel_margin: float
    final_abs_bound_u: float   # δ̄ of the output vector (max over classes)
    final_rel_bound_u: float   # ε̄ of the output vector
    required_k: int            # smallest k preventing misclassification
    satisfied_by: List[str]    # standard formats that satisfy it

    def explain(self) -> str:
        return (
            f"p*={self.p_star}: margins μ={self.abs_margin:.4g}, "
            f"ν={self.rel_margin:.4g}; output bounds δ̄={self.final_abs_bound_u:.4g}u, "
            f"ε̄={self.final_rel_bound_u:.4g}u ⇒ required precision k={self.required_k} "
            f"(u=2^{1-self.required_k}); satisfied by: {', '.join(self.satisfied_by) or 'none'}"
        )


def decide(final_abs_u: float, final_rel_u: float, p_star: float) -> PrecisionDecision:
    """Smallest k such that either bound fits inside its margin.

    Misclassification is prevented if each output element moves by less than
    half the top-1/top-2 gap: absolute route needs δ̄·u ≤ μ; relative route
    needs ε̄·u ≤ ν. Either suffices (the paper uses whichever bound is
    finite/tighter).
    """
    mu = theory.abs_margin(p_star)
    nu = theory.rel_margin(p_star)
    ks = []
    if math.isfinite(final_abs_u) and final_abs_u > 0:
        ks.append(formats.required_k_from_bound(final_abs_u, mu))
    elif final_abs_u == 0:
        ks.append(1)
    if math.isfinite(final_rel_u) and final_rel_u > 0:
        ks.append(formats.required_k_from_bound(final_rel_u, nu))
    elif final_rel_u == 0:
        ks.append(1)
    if not ks:
        raise ValueError("no finite output bound — cannot pick a precision")
    k = min(ks)
    sat = [f.name for f in formats.REGISTRY.values() if f.k >= k]
    return PrecisionDecision(p_star, mu, nu, final_abs_u, final_rel_u, k, sorted(sat))


def decide_iterative(
    bounds_at_umax, p_star: float, k_min: int = 2, k_max: int = 53
) -> PrecisionDecision:
    """Smallest k that prevents misclassification, re-analysing per candidate.

    CAA bounds are *parameterised* by u but contain u_max-dependent terms
    (second-order products; the softmax abs→rel conversion saturates when
    δ̄·u_max is large). ``bounds_at_umax(u_max) -> (abs_u, rel_u)`` re-runs
    the analysis; feasibility is monotone in k, so we binary-search.
    """
    mu = theory.abs_margin(p_star)
    nu = theory.rel_margin(p_star)

    def feasible(k: int):
        u = 2.0 ** (1 - k)
        abs_u, rel_u = bounds_at_umax(u)
        ok = (abs_u * u <= mu) or (rel_u * u <= nu)
        return ok, abs_u, rel_u

    ok_hi, abs_hi, rel_hi = feasible(k_max)
    if not ok_hi:
        raise ValueError(
            f"even k={k_max} cannot guarantee top-1 with p*={p_star} "
            f"(bounds {abs_hi:.3g}u abs / {rel_hi:.3g}u rel)"
        )
    lo, hi = k_min, k_max          # invariant: hi feasible
    best = (k_max, abs_hi, rel_hi)
    while lo < hi:
        mid = (lo + hi) // 2
        ok, a, r = feasible(mid)
        if ok:
            hi = mid
            best = (mid, a, r)
        else:
            lo = mid + 1
    k, abs_u, rel_u = best
    sat = [f.name for f in formats.REGISTRY.values() if f.k >= k]
    return PrecisionDecision(p_star, mu, nu, abs_u, rel_u, k, sorted(sat))


@dataclasses.dataclass(frozen=True)
class LayerPrecision:
    layer: str
    k: int
    format: str


def mixed_precision_plan(
    layer_slack_u: Dict[str, float],
    target_margin: float,
    share: Optional[Dict[str, float]] = None,
) -> List[LayerPrecision]:
    """Beyond-paper: distribute the end-to-end error budget across layers.

    ``layer_slack_u[name]`` is the sensitivity of the final bound to one unit
    of u spent at that layer (obtained by re-running the analysis with a
    probe, see analyze.sensitivity). We budget margin_i = target_margin ·
    share_i (default equal shares) and pick per-layer k_i accordingly —
    the "removing the global u" extension the paper names as future work.
    """
    names = list(layer_slack_u)
    share = share or {n: 1.0 / len(names) for n in names}
    plan = []
    for n in names:
        budget = target_margin * share[n]
        sens = layer_slack_u[n]
        if sens <= 0:
            k = 1
        else:
            k = formats.required_k_from_bound(sens, budget)
        fmt = next(
            (f.name for f in sorted(formats.REGISTRY.values(), key=lambda f: f.k)
             if f.k >= k),
            f"custom_k{k}",
        )
        plan.append(LayerPrecision(n, k, fmt))
    return plan


def classification_safe(probs_lo, probs_hi, predicted: int) -> bool:
    """Rigorous argmax check: class `predicted` is guaranteed top-1 iff its
    lower probability bound beats every other class's upper bound."""
    import numpy as np

    lo = np.asarray(probs_lo)
    hi = np.asarray(probs_hi)
    others = np.delete(hi, predicted)
    return bool(lo[predicted] > others.max())
