"""Full-format synthesis: certify per-scope (k, emin, emax) custom formats.

The counterpart of the JAX package's ``repro.certify.formats.synth``.

The mantissa pipeline (PR 1/2) answers "how many mantissa bits"; this module
answers the rest of the paper's claim — DNNs also tolerate narrow *exponent
ranges* — rigorously, per scope:

  1. **Range analysis** — one eager format-aware pass accumulates per-scope
     IA magnitude enclosures (:class:`repro_torch.core.backend.RangeCaaOps`); a
     scope's smallest overflow-free ``emax`` is the one whose
     ``max_finite(k, emax)`` clears the scope's proven ``max_abs``.
  2. **Underflow soundness** — a finite ``emin`` makes roundings absorb an
     absolute η = 2^{emin-(k-1)} each (flush-to-zero: 2^{emin}); the
     analysis charges λ·η into δ̄/ε̄ via ``CaaConfig.round_abs``
     (:func:`repro_torch.core.caa._finish`), so the certified bounds stay sound
     for the *actual* finite-range format, not just unbounded-range
     rounding.
  3. **Search** — a greedy per-scope descent over the exponent-bit lattice
     (the (k, emax) lattice: k fixed per scope by the mixed-precision map,
     emax stepping down IEEE exponent widths), every probe running through
     :class:`.ladder.FormatProbeLadder`; the final map is
     EAGERLY re-confirmed (bounds within the class margins AND no overflow
     at the chosen emax under the map's own underflow terms), stepping back
     up until confirmation holds — certificates never ship unconfirmed
     lattice points.

The result prices out as total storage bits (sign + exponent field + stored
mantissa), reported FLOP-weighted against the uniform-k + binary32-range
baseline the mantissa-only pipeline would serve.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.core import analyze, caa
from repro_torch.core import formats as F
from repro_torch.core import interval as iv
from repro_torch.core.backend import RangeStat
from repro_torch.core.caa import CaaConfig, CaaTensor
from ..batch import FeasibleFn
from .ladder import FormatProbeLadder, eager_format_report

DEFAULT_KEY = ""        # map key for ops outside every named scope


@dataclasses.dataclass
class FormatPlan:
    """Result of the format synthesis.

    ``layer_format`` maps every scope key — plus the ``""`` default — to
    its certified :class:`repro_torch.core.formats.FpFormat`; ``abs_u``/``rel_u``
    are the per-class bounds of the final map in units of
    ``u_ref = 2^{1-k_ref}``, confirmed by an eager re-analysis WITH the
    map's underflow terms; ``scope_ranges`` are that pass's magnitude
    enclosures (the no-overflow evidence); ``history`` records every probed
    lattice point (the Pareto sweep trail).
    """

    layer_format: Dict[str, F.FpFormat]
    layer_k: Dict[str, int]
    uniform_k: int
    baseline_bits: int
    abs_u: np.ndarray
    rel_u: np.ndarray
    k_ref: int
    scope_ranges: Dict[str, RangeStat]
    emax_floor: Dict[str, int]
    history: List[dict]
    probes: int
    compiles: int
    feasible: bool

    def formats_dict(self) -> Dict[str, dict]:
        """JSON-ready {scope: descriptor} — what schema-v3 certificates
        carry in ``layer_format``."""
        return {s: f.to_dict() for s, f in self.layer_format.items()}

    def mean_bits(self, layer_flops: Optional[Dict[str, float]] = None
                  ) -> float:
        """FLOP-weighted mean total storage bits of the mapped scopes."""
        from ..mixed import flop_weighted_mean_k

        bits = {s: float(f.total_bits)
                for s, f in self.layer_format.items() if s != DEFAULT_KEY}
        return flop_weighted_mean_k(bits, layer_flops)

    def savings_bits(self, layer_flops: Optional[Dict[str, float]] = None
                     ) -> float:
        """Bits/value saved vs the uniform-k + binary32-range baseline."""
        return self.baseline_bits - self.mean_bits(layer_flops)


def min_exponent_bits_for_range(k: int, max_abs: float,
                                e_min: int, e_max: int) -> int:
    """Smallest IEEE exponent width e whose emax = 2^{e-1}−1 makes every
    value of magnitude ≤ max_abs representable at precision k (i.e.
    max_finite(k, emax) ≥ max_abs — the overflow-freedom floor). Saturates
    at ``e_max`` when even that cannot hold (inf ranges)."""
    if not math.isfinite(max_abs):
        return e_max
    for e in range(e_min, e_max):
        if F.from_bits(k, e).max_finite >= max_abs:
            return e
    return e_max


def _emax_floors(scope_keys: Sequence[str], layer_k: Dict[str, int],
                 ranges: Dict[str, RangeStat],
                 e_min_bits: int, e_max_bits: int) -> Dict[str, int]:
    out = {}
    for s in scope_keys:
        r = ranges.get(s)
        if r is None or r.n_ops == 0:
            # no value was ever observed under this scope: there is no
            # range evidence to narrow on — keep the widest exponent
            out[s] = e_max_bits
        else:
            out[s] = min_exponent_bits_for_range(
                layer_k[s], r.max_abs, e_min_bits, e_max_bits)
    return out


def synthesize_formats(
    forward, params, x: CaaTensor,
    feasible: FeasibleFn,
    uniform_k: int,
    layer_k: Optional[Dict[str, int]] = None,
    scope_keys: Optional[Sequence[str]] = None,
    cfg: CaaConfig = caa.DEFAULT_CONFIG,
    weights_exact: bool = True,
    e_min_bits: int = 2,
    e_max_bits: int = 8,
    has_subnormals: bool = True,
    saturating: bool = True,
    ladder: Optional[FormatProbeLadder] = None,
    stacked: bool = False,
    extra_ranges_fn=None,
    tighten_ranges_fn=None,
    affine: bool = False,
    affine_budget: Optional[int] = None,
    affine_rank: Optional[str] = None,
) -> FormatPlan:
    """Greedy certified descent over the per-scope (k, emax) lattice.

    ``uniform_k`` is the certified uniform mantissa precision (the class-max
    of the batched search); ``layer_k`` an optional per-scope refinement
    (PR 2's mixed map) — k per scope is FIXED by these, the exponent width
    descends. Start every scope at ``e_max_bits`` (binary32-range baseline,
    where η ≈ 0 and the map provably reproduces the mantissa-only
    certificate), then per scope step the exponent width down while (a) the
    scope's range-analysis floor keeps the format overflow-free and (b) the
    joint feasibility check — every class's (δ̄, ε̄) at u_ref against its
    decision margins, WITH every scope's underflow term charged — stays
    green; backtrack one step on failure. Feasibility is monotone in each
    scope's exponent width (shrinking emin only grows η), so the endpoint
    is a certified lattice point; a final eager pass re-confirms it (and
    re-checks overflow under the final η-inflated ranges), undoing descent
    steps until confirmation holds.

    ``stacked`` routes the ladder probes through the layer-stacked analysis
    (LM architectures); the eager confirmations stay on the unrolled
    per-layer reference either way. ``extra_ranges_fn(lf, df)
    -> {key: RangeStat}`` injects additional range evidence — e.g. range
    passes over several sequence-length input profiles — which is merged
    into every floors/overflow decision, so the certified ``emax`` covers
    those profiles too.

    ``tighten_ranges_fn(lf, df) -> {key: RangeStat}`` injects a second
    sound range map over the SAME profile (e.g. the affine pass of
    :func:`repro_torch.core.analyze.analyze_ranges_affine`) that is min-combined
    with the eager IA evidence BEFORE profile widening — this is what
    keeps the emax floors finite when the IA pass saturates at coarse
    mixed-map k. ``extra_ranges_fn`` maps must already be tightened per
    profile by the caller; tightening after the cross-profile max would be
    unsound.

    ``affine`` / ``affine_budget`` / ``affine_rank`` build that tighten
    pass here (an EAGER :class:`repro_torch.core.backend.AffineRangeCaaOps`
    pass) when the caller did not supply ``tighten_ranges_fn`` — this is
    how the eager (non-LM) pipelines honor ``--affine-budget`` through
    ``format_opts`` instead of silently diverging from the LM path.
    Passing any of them alongside an explicit ``tighten_ranges_fn`` is an
    error (the caller's pass already fixed its own budget/ranking).
    """
    if scope_keys is None:
        scope_keys = analyze.discover_scopes(forward, params, x, cfg)
    scope_keys = list(scope_keys)
    if affine or affine_budget is not None or affine_rank is not None:
        if tighten_ranges_fn is not None:
            raise ValueError(
                "pass either tighten_ranges_fn or the affine/affine_budget/"
                "affine_rank knobs, not both")
        aff_budget = int(affine_budget if affine_budget is not None
                         else iv.AFF_DEFAULT_BUDGET)
        aff_rank = str(affine_rank or iv.AFF_DEFAULT_RANK)
        obs.gauge("affine.budget", aff_budget)
        aff_cache: Dict[tuple, Dict[str, RangeStat]] = {}

        def tighten_ranges_fn(lf, df):
            ck = (tuple(sorted((s, f.name) for s, f in lf.items())),
                  df.name)
            if ck not in aff_cache:
                with obs.span("affine_ranges", scopes=len(lf),
                              budget=aff_budget, rank=aff_rank):
                    aff_cache[ck] = analyze.analyze_ranges_affine(
                        forward, params, x, lf, df, keys=scope_keys,
                        stacked=stacked, budget=aff_budget,
                        weights_exact=weights_exact,
                        condense_rank=aff_rank)
            return aff_cache[ck]
    uniform_k = int(uniform_k)
    ks = {s: int((layer_k or {}).get(s, uniform_k)) for s in scope_keys}
    ks[DEFAULT_KEY] = uniform_k
    all_keys = scope_keys + [DEFAULT_KEY]
    flags = {"has_subnormals": has_subnormals, "saturating": saturating}

    def fmt_map(e: Dict[str, int]) -> Dict[str, F.FpFormat]:
        return {s: F.from_bits(ks[s], e[s], **flags) for s in all_keys}

    def split(m: Dict[str, F.FpFormat]):
        return {s: m[s] for s in scope_keys}, m[DEFAULT_KEY]

    def widen(ranges: Dict[str, RangeStat],
              m: Dict[str, F.FpFormat]) -> Dict[str, RangeStat]:
        lf, df = split(m)
        if tighten_ranges_fn is not None:
            ranges = analyze.tighten_range_maps(
                ranges, tighten_ranges_fn(lf, df))
        if extra_ranges_fn is None:
            return ranges
        return analyze.merge_range_maps(
            [ranges, extra_ranges_fn(lf, df)], scope_keys)

    if ladder is None:
        ladder = FormatProbeLadder(forward, params, x, scope_keys, cfg=cfg,
                                   weights_exact=weights_exact,
                                   stacked=stacked)

    history: List[dict] = []

    def ok_ladder(e: Dict[str, int], tag: str) -> bool:
        lf, df = split(fmt_map(e))
        abs_u, rel_u, k_ref = ladder(lf, df)
        good = bool(np.all(feasible(abs_u, rel_u, k_ref)))
        history.append({"e": dict(e), "feasible": good, "probe": tag})
        return good

    # -- baseline: widest exponent everywhere, eagerly confirmed ------------
    e = {s: int(e_max_bits) for s in all_keys}
    lf, df = split(fmt_map(e))
    with obs.span("format_baseline"):
        abs_u, rel_u, k_ref, ranges = eager_format_report(
            forward, params, x, lf, df, scope_keys, cfg=cfg,
            weights_exact=weights_exact)
    ranges = widen(ranges, fmt_map(e))
    floors = _emax_floors(all_keys, ks, ranges, e_min_bits, e_max_bits)
    base_ok = bool(np.all(feasible(abs_u, rel_u, k_ref)))
    base_overflow = any(
        ranges[s].max_abs > fmt_map(e)[s].max_finite for s in all_keys)
    if not base_ok or base_overflow:
        return FormatPlan(
            layer_format=fmt_map(e), layer_k=ks, uniform_k=uniform_k,
            baseline_bits=F.from_bits(uniform_k, e_max_bits).total_bits,
            abs_u=abs_u, rel_u=rel_u, k_ref=k_ref, scope_ranges=ranges,
            emax_floor=floors, history=history, probes=ladder.probes,
            compiles=ladder.compiles, feasible=False)

    # -- greedy exponent descent through the ladder --------------------------
    descended: List[str] = []       # successful steps, for confirmed undo
    with obs.span("exponent_descent", scopes=len(all_keys)) as _sp:
        for s in all_keys:
            while e[s] > max(floors[s], e_min_bits):
                e[s] -= 1
                if ok_ladder(e, f"descend:{s}"):
                    descended.append(s)
                else:
                    e[s] += 1           # backtrack one step
                    break
        _sp.set(steps=len(descended))

    # -- eager confirmation fixpoint ---------------------------------------
    # The persisted bounds must come from an eager pass (ladder bounds can
    # differ in the last ulp), and the overflow floors must hold under the
    # FINAL map's own η-inflated ranges. Undo descent steps until both
    # confirm; terminates at the (eagerly confirmed) baseline at worst.
    while True:
        lf, df = split(fmt_map(e))
        with obs.span("eager_confirm"):
            abs_u, rel_u, k_ref, ranges = eager_format_report(
                forward, params, x, lf, df, scope_keys, cfg=cfg,
                weights_exact=weights_exact)
        ranges = widen(ranges, fmt_map(e))
        over = [s for s in all_keys
                if ranges[s].max_abs > fmt_map(e)[s].max_finite]
        bounds_ok = bool(np.all(feasible(abs_u, rel_u, k_ref)))
        if bounds_ok and not over:
            break
        if over:
            bumped = False
            for s in over:
                if e[s] < e_max_bits:
                    e[s] += 1
                    bumped = True
            if bumped:
                history.append({"e": dict(e), "feasible": None,
                                "probe": "overflow-bump"})
                continue
        if descended:
            s = descended.pop()
            e[s] = min(e[s] + 1, e_max_bits)
            history.append({"e": dict(e), "feasible": None,
                            "probe": f"confirm-undo:{s}"})
            continue
        # nothing left to undo and still failing: report infeasible
        return FormatPlan(
            layer_format=fmt_map(e), layer_k=ks, uniform_k=uniform_k,
            baseline_bits=F.from_bits(uniform_k, e_max_bits).total_bits,
            abs_u=abs_u, rel_u=rel_u, k_ref=k_ref, scope_ranges=ranges,
            emax_floor=floors, history=history, probes=ladder.probes,
            compiles=ladder.compiles, feasible=False)

    floors = _emax_floors(all_keys, ks, ranges, e_min_bits, e_max_bits)
    return FormatPlan(
        layer_format=fmt_map(e), layer_k=ks, uniform_k=uniform_k,
        baseline_bits=F.from_bits(uniform_k, e_max_bits).total_bits,
        abs_u=abs_u, rel_u=rel_u, k_ref=k_ref, scope_ranges=ranges,
        emax_floor=floors, history=history, probes=ladder.probes,
        compiles=ladder.compiles, feasible=True)
