"""Closed forms from the paper's Section IV — kept verbatim for validation.

A copy of the JAX package's ``repro.core.theory`` (pure Python;
the port imports nothing of that package).

These are the *paper's* constants and margin formulas; the engine in
:mod:`repro.core.caa` computes tighter rigorous bounds, and the property
tests check `empirical ≤ engine ≤ paper` in the regimes where the paper's
assumptions hold.
"""
from __future__ import annotations

import math

SOFTMAX_ABS_TO_REL_FACTOR = 11.0 / 2.0  # eq. (11): |ε_i| ≤ (11/2)·max_k|δ_k|
TANH_REL_FACTOR = 2.63                  # §III, valid while ε̄·u ≤ 1/4
TANH_REL_GATE = 0.25


def softmax_rel_bound_paper(max_abs_in_u: float) -> float:
    """Paper eq. (11): relative output error ≤ 5.5 × max absolute input error."""
    return SOFTMAX_ABS_TO_REL_FACTOR * max_abs_in_u


def tanh_rel_bound_paper(rel_in_u: float, u: float) -> float:
    """Paper §III tanh rule (gated)."""
    if rel_in_u * u <= TANH_REL_GATE:
        return TANH_REL_FACTOR * rel_in_u
    return math.inf


def abs_margin(p_star: float) -> float:
    """μ = p* − 1/2 — absolute error margin per output element (Section IV)."""
    if not 0.5 < p_star <= 1.0:
        raise ValueError("p* must be in (0.5, 1]")
    return p_star - 0.5


def rel_margin(p_star: float) -> float:
    """ν = (2p* − 1)/(2p* + 1) — relative error margin (Section IV)."""
    if not 0.5 < p_star <= 1.0:
        raise ValueError("p* must be in (0.5, 1]")
    return (2.0 * p_star - 1.0) / (2.0 * p_star + 1.0)


def paper_example_check() -> dict:
    """The worked example of Section IV: p* = 0.60 ⇒ ν > 0.0909 > 2^-3.45;
    tolerated softmax-input absolute error ν/5.5 > 1.65e-2 ≈ 2^-6."""
    nu = rel_margin(0.60)
    tol_in = nu / SOFTMAX_ABS_TO_REL_FACTOR
    return {
        "nu": nu,
        "nu_gt_0_0909": nu > 0.0909,
        "nu_bits": -math.log2(nu),
        "tolerated_softmax_input_abs": tol_in,
        "tol_gt_1_65e_2": tol_in > 1.65e-2,
    }
