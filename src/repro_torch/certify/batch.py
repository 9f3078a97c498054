"""Batched certificate analysis: one analysis for all classes at once.

The counterpart of the JAX package's ``repro.certify.batch``. The paper's
workflow is "one analysis run per class"; every CAA rule of
:mod:`repro_torch.core.caa` is row-independent along a leading batch axis,
so the C runs collapse into ONE evaluation over class-stacked inputs
(:func:`repro_torch.core.analyze.analyze_batched`). This module adds the
pieces that turn that into a certificate pipeline:

* :func:`stack_class_ranges` — per-class (lo, hi) envelopes → one CaaTensor;
* :func:`required_k_batched` — per-class smallest safe precision k by a
  vectorised binary search whose every probe is one batched analysis
  shared by all still-unresolved classes (feasibility is monotone in k);
* :func:`make_reverifier` — re-checks argmax safety of concrete inputs at
  a FIXED certified format, the call a serving path makes per batch.

PyTorch runs eagerly: the reference's ``ProbeLadder`` traces the analysis
once with u_max as a traced argument; here :class:`ProbeLadder` is the
eager analysis as a function of u, with the same probe bookkeeping. There
is no compilation, so ``compiles`` is 0.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import analyze, caa, formats, theory
from repro_torch.core.backend import CaaOps
from repro_torch.core.caa import CaaConfig, CaaTensor


def stack_class_ranges(los: Sequence, his: Sequence, dbar=0.0, ebar=0.0,
                       device=None) -> CaaTensor:
    """Per-class input envelopes → one class-stacked interval CaaTensor on
    ``device`` (the CPU by default). ``los[c]``/``his[c]`` is the paper's
    §V input annotation for class c; the result has leading axis C."""
    lo = np.stack([np.asarray(l, np.float64) for l in los])
    hi = np.stack([np.asarray(h, np.float64) for h in his])
    if np.any(lo > hi):
        raise ValueError("class range with lo > hi")
    return caa.from_range(torch.from_numpy(lo).to(device),
                          torch.from_numpy(hi).to(device),
                          dbar=dbar, ebar=ebar)


def batched_bounds(forward, params, x: CaaTensor, cfg: CaaConfig,
                   weights_exact: bool = True
                   ) -> analyze.BatchedErrorReport:
    """One joint pass → per-class (δ̄, ε̄). Thin alias of the core entry."""
    return analyze.analyze_batched(
        forward, params, x, cfg=cfg, weights_exact=weights_exact)


def class_bounds(out: CaaTensor) -> Tuple[np.ndarray, np.ndarray]:
    """Per-class (max δ̄, max ε̄) of an analysis output, as host arrays:
    what every probe keeps (never the device tensors)."""
    red = tuple(range(1, out.ndim))
    dbar = torch.broadcast_to(out.dbar, out.shape)
    ebar = torch.broadcast_to(out.ebar, out.shape)
    if red:
        dbar, ebar = torch.amax(dbar, dim=red), torch.amax(ebar, dim=red)
    return (dbar.to(torch.float64).cpu().numpy(),
            ebar.to(torch.float64).cpu().numpy())


class ProbeLadder:
    """Per-class (δ̄, ε̄) at any probed precision k: the batched analysis
    at u_max = 2^(1-k), eagerly. ``ks_probed`` lists every probe in call
    order, as the reference's does; ``compiles`` is 0 (nothing compiles
    in eager PyTorch)."""

    compiles = 0

    def __init__(self, forward, params, x: CaaTensor,
                 cfg: CaaConfig = caa.DEFAULT_CONFIG,
                 weights_exact: bool = True):
        self._base = analyze.batch_config(cfg, int(x.val.shape[0]))
        self._forward = forward
        self._params = params
        self._x = x
        self._weights_exact = weights_exact
        self.ks_probed: list = []

    def __call__(self, k: int) -> Tuple[np.ndarray, np.ndarray]:
        self.ks_probed.append(int(k))
        kcfg = dataclasses.replace(self._base, u_max=2.0 ** (1 - int(k)))
        with obs.span("ladder_probe", ladder="uniform", k=int(k)):
            ops = CaaOps(kcfg, weights_exact=self._weights_exact)
            return class_bounds(self._forward(ops, self._params, self._x))


# ---------------------------------------------------------------------------
# per-class required-k: vectorised binary search over shared batched probes
# ---------------------------------------------------------------------------

FeasibleFn = Callable[[np.ndarray, np.ndarray, int], np.ndarray]


def margin_feasibility(p_star: float) -> FeasibleFn:
    """Classifier feasibility: class c is safe at precision k iff either
    output bound fits its top-1 margin — δ̄·u ≤ μ(p*) or ε̄·u ≤ ν(p*)
    (paper Section IV)."""
    mu = theory.abs_margin(p_star)
    nu = theory.rel_margin(p_star)

    def feasible(abs_u: np.ndarray, rel_u: np.ndarray, k: int) -> np.ndarray:
        u = 2.0 ** (1 - k)
        with np.errstate(invalid="ignore"):
            return (abs_u * u <= mu) | (rel_u * u <= nu)

    return feasible


def tolerance_feasibility(abs_tol: float) -> FeasibleFn:
    """Regression feasibility: absolute output error δ̄·u ≤ abs_tol (the
    pendulum/Lyapunov certificate a formal verifier consumes)."""

    def feasible(abs_u: np.ndarray, rel_u: np.ndarray, k: int) -> np.ndarray:
        del rel_u
        with np.errstate(invalid="ignore"):
            return abs_u * 2.0 ** (1 - k) <= abs_tol

    return feasible


def required_k_batched(
    forward, params, x: CaaTensor,
    feasible: FeasibleFn,
    cfg: CaaConfig = caa.DEFAULT_CONFIG,
    k_min: int = 2,
    k_max: int = 53,
    weights_exact: bool = True,
    ladder: Optional[ProbeLadder] = None,
) -> Tuple[np.ndarray, Dict[int, analyze.BatchedErrorReport]]:
    """Smallest per-class k with ``feasible``, probing all classes jointly.

    Each candidate k needs a re-analysis at u_max = 2^(1-k) (the bounds
    carry u_max-dependent second-order terms); feasibility is monotone in
    k. One probe is ONE batched analysis that advances the (lo, hi)
    bracket of every unresolved class. With a :class:`ProbeLadder` the
    search probes go through it, and the reports at each class's final k
    are then confirmed by eager reports, stepping a class up until report
    and decision agree (the reference's confirm-or-bump fixpoint; a class
    still infeasible at k_max becomes uncertifiable).

    Returns (per-class k array, NaN for uncertifiable classes; the eager
    reports keyed by k)."""
    n = int(x.val.shape[0])
    reports: Dict[int, analyze.BatchedErrorReport] = {}

    def eager_report(k: int) -> analyze.BatchedErrorReport:
        if k not in reports:
            kcfg = dataclasses.replace(cfg, u_max=2.0 ** (1 - k))
            reports[k] = batched_bounds(
                forward, params, x, kcfg, weights_exact=weights_exact)
        return reports[k]

    probe_cache: Dict[int, np.ndarray] = {}

    def probe(k: int) -> np.ndarray:
        if k not in probe_cache:
            if ladder is not None:
                abs_u, rel_u = ladder(k)
            else:
                r = eager_report(k)
                abs_u, rel_u = r.abs_u, r.rel_u
            probe_cache[k] = np.asarray(feasible(abs_u, rel_u, k), bool)
        return probe_cache[k]

    ok_max = probe(k_max)
    lo = np.full(n, k_min, np.int64)
    hi = np.full(n, k_max, np.int64)          # invariant: hi feasible (where ok)
    certifiable = ok_max.copy()
    while True:
        open_ = certifiable & (lo < hi)
        if not open_.any():
            break
        # one shared probe per round: the midpoint of the first open class;
        # every other class's bracket advances wherever monotonicity lets it
        c = int(np.argmax(open_))
        k = int((lo[c] + hi[c]) // 2)
        ok = probe(k)
        hi = np.where(certifiable & ok & (k < hi) & (k >= lo), k, hi)
        lo = np.where(certifiable & ~ok & (k >= lo) & (k < hi), k + 1, lo)
    ks = hi.astype(np.float64)
    ks[~certifiable] = np.nan
    if ladder is not None:
        # confirm-or-bump fixpoint: every surviving class ends with an eager
        # report at its final k that confirms feasibility
        while True:
            changed = False
            for k in sorted({int(v) for v in ks[certifiable]}):
                r = eager_report(k)
                ok_eager = np.asarray(feasible(r.abs_u, r.rel_u, k), bool)
                need_bump = certifiable & (ks == k) & ~ok_eager
                if not need_bump.any():
                    continue
                if k < k_max:
                    ks[need_bump] += 1
                else:
                    certifiable &= ~need_bump
                    ks[need_bump] = np.nan
                changed = True
            if not changed:
                break
        if (~certifiable).any():
            eager_report(k_max)   # the diagnostic report uncertifiable classes use
    return ks, reports


# ---------------------------------------------------------------------------
# serving: re-verification at a fixed certified format
# ---------------------------------------------------------------------------

def _argmax_safe(lo: torch.Tensor, hi: torch.Tensor,
                 pred: torch.Tensor) -> torch.Tensor:
    """Per row: the predicted entry's lower end above every rival's upper
    end (precision.classification_safe, batched over rows)."""
    onehot = torch.nn.functional.one_hot(pred, lo.shape[-1]).bool()
    others_hi = torch.amax(torch.where(onehot, -torch.inf, hi), dim=-1)
    own_lo = torch.gather(lo, -1, pred[..., None])[..., 0]
    return own_lo > others_hi


def make_reverifier(forward, params, fmt, cfg: Optional[CaaConfig] = None,
                    weights_exact: bool = True):
    """Per-request re-verification at the certified format:
    ``verify(x) -> (pred, safe)`` runs one CAA pass on the concrete inputs
    ``x`` (a tensor on the params' device), inflates the output enclosure
    to the format's u and tests top-1 — the paper's per-input Table-I
    mode. Eager: every call is one analysis."""
    fmt = formats.get(fmt)
    cfg = cfg or CaaConfig(u_max=fmt.u)
    if fmt.u > cfg.u_max:
        raise ValueError("format's u exceeds the analysed u_max — re-analyse")

    def verify(x):
        ops = CaaOps(cfg, weights_exact=weights_exact)
        out = forward(ops, params, caa.make(x))
        rng = out.fp_range(fmt.u)
        pred = torch.argmax(out.val, dim=-1)
        return pred, _argmax_safe(rng.lo, rng.hi, pred)

    return verify
