"""Semi-automatic precision/accuracy analysis driver (paper Section V).

The counterpart of the JAX package's ``repro.core.analyze``: the eager
analysis, and the range, affine and layer-stacked drivers behind format
certificates (``analyze_ranges``, ``analyze_ranges_stacked``,
``analyze_ranges_affine``, ``tighten_range_maps``, ``merge_range_maps``,
``discover_scopes_stacked``, ``sensitivity_stacked``). The paper's workflow — load a trained model,
annotate the input with interval ranges, run it once per class under the
enhanced arithmetic, read off absolute/relative output bounds in units of
u, then tailor the precision:

    report = analyze(forward, params, x, p_star=0.6)
    report.decision.required_k        # Table-I style answer
    report.layers                     # per-layer trace
    plan = mixed_precision(forward, params, x, 0.6, ["dense1", ...])

``forward(backend, params, x)`` is written against
:class:`repro_torch.core.backend.Backend` and returns the output (for
classifiers, the softmax probabilities). The analysis runs on the device
of ``x`` and the parameters; ``analysis_seconds`` waits for the card.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import caa, formats, precision, theory
from repro_torch.core import interval as iv
from repro_torch.core.backend import (AffineRangeCaaOps, Backend, CaaOps,
                                      RangeCaaOps, RangeStat,
                                      StackedAffineRangeCaaOps,
                                      StackedCaaOps, StackedRangeCaaOps,
                                      TraceRecord)
from repro_torch.core.caa import CaaConfig, CaaTensor
from repro_torch.core.scopes import (expand_stacked, resolve_scope_value,
                                     scope_active, scope_prefixes)


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


@dataclasses.dataclass
class ErrorReport:
    """The analyser's output — everything Table I reports, plus the trace."""

    final_abs_u: float
    final_rel_u: float
    output_range: tuple  # (lo, hi) tensors
    layers: List[TraceRecord]
    analysis_seconds: float
    cfg: CaaConfig
    decision: Optional[precision.PrecisionDecision] = None
    router_records: List[TraceRecord] = dataclasses.field(default_factory=list)

    def summary(self) -> str:
        lines = [
            f"max absolute error: {self.final_abs_u:.4g} u",
            f"max relative error: {self.final_rel_u:.4g} u",
            f"analysis time: {self.analysis_seconds:.3f} s",
        ]
        if self.decision is not None:
            lines.append(self.decision.explain())
        return "\n".join(lines)

    def dominant_layer(self) -> Optional[TraceRecord]:
        finite = [r for r in self.layers if math.isfinite(r.max_dbar)]
        return max(finite, key=lambda r: r.max_dbar, default=None)


def _decide(abs_u: float, rel_u: float, p_star: float):
    try:
        return precision.decide(abs_u, rel_u, p_star)
    except ValueError:
        return None  # bounds saturated at this u_max — re-run smaller


def analyze(
    forward: Callable[[Backend, dict, CaaTensor], CaaTensor],
    params: dict,
    x: CaaTensor,
    p_star: Optional[float] = None,
    cfg: CaaConfig = caa.DEFAULT_CONFIG,
    weights_exact: bool = True,
) -> ErrorReport:
    """One analysis pass (the paper's 'one representative per class' run:
    the interval input covers the whole class)."""
    ops = CaaOps(cfg, weights_exact=weights_exact)
    _sync(x.val)
    t0 = time.perf_counter()
    out = forward(ops, params, x)
    abs_u, rel_u = caa.worst(out)
    dt = time.perf_counter() - t0
    return ErrorReport(
        final_abs_u=abs_u, final_rel_u=rel_u,
        output_range=(out.exact.lo, out.exact.hi),
        layers=[r for r in ops.trace if r.kind != "router"],
        analysis_seconds=dt, cfg=cfg,
        decision=None if p_star is None else _decide(abs_u, rel_u, p_star),
        router_records=[r for r in ops.trace if r.kind == "router"],
    )


@dataclasses.dataclass
class BatchedErrorReport:
    """Per-class bounds from ONE joint CAA pass over stacked class inputs:
    every rule is row-independent along a leading batch axis, so stacking
    the per-class inputs collapses the paper's C runs into one evaluation
    with the same per-class bounds."""

    abs_u: np.ndarray            # [C] max δ̄ per class, units of u
    rel_u: np.ndarray            # [C] max ε̄ per class, units of u
    output_range: tuple          # (lo, hi) tensors, leading axis = class
    layers: List[TraceRecord]    # trace of the joint pass
    analysis_seconds: float
    cfg: CaaConfig               # the caller's per-class-equivalent config
    decisions: Optional[List[Optional[precision.PrecisionDecision]]] = None
    scopes: List[str] = dataclasses.field(default_factory=list)

    @property
    def n_classes(self) -> int:
        return int(self.abs_u.shape[0])

    def per_class(self, c: int) -> tuple:
        return float(self.abs_u[c]), float(self.rel_u[c])


def batch_config(cfg: CaaConfig, n_classes: int) -> CaaConfig:
    """Per-class-equivalent config for a stacked run: the trajectory gate
    of :func:`caa.matmul` counts output elements across the whole stack, so
    its budget scales by C to take the same branch per class as C
    sequential passes."""
    return dataclasses.replace(
        cfg, traj_max_elems=cfg.traj_max_elems * max(int(n_classes), 1))


def _max_except(t: torch.Tensor, axis: int) -> np.ndarray:
    red = tuple(i for i in range(t.dim()) if i != axis)
    m = torch.amax(t, dim=red) if red else t
    return m.to(torch.float64).cpu().numpy()


def analyze_batched(
    forward: Callable[[Backend, dict, CaaTensor], CaaTensor],
    params: dict,
    x: CaaTensor,
    p_star: Optional[float] = None,
    cfg: CaaConfig = caa.DEFAULT_CONFIG,
    weights_exact: bool = True,
    class_axis: int = 0,
) -> BatchedErrorReport:
    """All classes at once: ``x`` stacks the per-class interval inputs
    along ``class_axis``; bounds per class match :func:`analyze` on the
    corresponding slice."""
    n = int(x.val.shape[class_axis])
    ops = CaaOps(batch_config(cfg, n), weights_exact=weights_exact)
    _sync(x.val)
    t0 = time.perf_counter()
    out = forward(ops, params, x)
    axis = class_axis % out.ndim
    abs_u = _max_except(torch.broadcast_to(out.dbar, out.shape), axis)
    rel_u = _max_except(torch.broadcast_to(out.ebar, out.shape), axis)
    dt = time.perf_counter() - t0
    decisions = None
    if p_star is not None:
        decisions = [_decide(float(abs_u[c]), float(rel_u[c]), p_star)
                     for c in range(n)]
    return BatchedErrorReport(
        abs_u=abs_u, rel_u=rel_u,
        output_range=(out.exact.lo, out.exact.hi),
        layers=[r for r in ops.trace if r.kind != "router"],
        analysis_seconds=dt, cfg=cfg, decisions=decisions,
        scopes=list(ops.seen_scopes),
    )


def verify_classification(
    forward, params, x: CaaTensor, fmt, predicted: int,
    cfg: Optional[CaaConfig] = None,
) -> bool:
    """Rigorous per-input argmax check at a concrete format: inflate the
    output enclosure by the error bounds at u = fmt.u and test top-1."""
    fmt = formats.get(fmt)
    cfg = cfg or CaaConfig(u_max=fmt.u)
    if fmt.u > cfg.u_max:
        raise ValueError("format's u exceeds the analysed u_max — re-analyse")
    out = forward(CaaOps(cfg), params, x)
    rng = out.fp_range(fmt.u)
    return precision.classification_safe(rng.lo.cpu(), rng.hi.cpu(),
                                         predicted)


def sensitivity(
    forward, params, x: CaaTensor,
    layer_names: Sequence[str],
    cfg: CaaConfig = caa.DEFAULT_CONFIG,
) -> Dict[str, float]:
    """Per-layer contribution to the final absolute bound: one analysis
    per layer with fresh roundings enabled only inside that layer's scope
    (round_scale gating)."""
    out: Dict[str, float] = {}
    for name in layer_names:
        y = forward(_GatedCaaOps(cfg, active_scope=name), params, x)
        out[name] = caa.worst(y)[0]
    return out


class _GatedCaaOps(CaaOps):
    """CaaOps whose fresh roundings are active only inside one scope
    (matched by path segment, not substring)."""

    def __init__(self, cfg: CaaConfig, active_scope: str):
        super().__init__(cfg)
        self._active = active_scope
        self._base_cfg = cfg
        self._off_cfg = dataclasses.replace(cfg, round_scale=0.0)
        self.cfg = self._off_cfg

    def _scope_changed(self):
        super()._scope_changed()
        self.cfg = (self._base_cfg
                    if scope_active(self._active, self._scope)
                    else self._off_cfg)


def discover_scopes(
    forward, params, x: CaaTensor,
    cfg: CaaConfig = caa.DEFAULT_CONFIG,
    depth: int = 1,
) -> List[str]:
    """The scope names one analysis pass enters, truncated to ``depth``
    path segments, unique, in first-seen order — the granularity
    mixed-precision certificates assign k at."""
    ops = CaaOps(cfg)
    forward(ops, params, x)
    return scope_prefixes(ops.seen_scopes, depth)


def aggregate_ranges(path_stats: Dict[str, RangeStat],
                     keys: Sequence[str]) -> Dict[str, RangeStat]:
    """Fold per-path RangeStats onto a chosen scope granularity.

    Each recorded scope path is assigned to the most specific matching key
    (the rule of :func:`resolve_scope_value`, so the aggregation mirrors
    how serving resolves a per-scope format map); paths outside every key
    fold into the ``""`` default entry. Every key is present in the result
    (an empty RangeStat if its scope produced no values)."""
    out: Dict[str, RangeStat] = {k: RangeStat() for k in list(keys) + [""]}
    ident = {k: k for k in keys}
    for path, stat in path_stats.items():
        segs = [s for s in path.split("/") if s]
        key = resolve_scope_value(segs, ident, "")
        out[key] = out[key].merge(stat)
    return out


def analyze_ranges(
    forward, params, x: CaaTensor,
    cfg: CaaConfig = caa.DEFAULT_CONFIG,
    weights_exact: bool = True,
    keys: Optional[Sequence[str]] = None,
    depth: int = 1,
) -> Dict[str, RangeStat]:
    """Per-scope IA magnitude enclosures [min_nonzero, max_abs] from one
    eager pass (the range analysis behind (k, emin, emax) format
    certification).

    Returns {scope_key: RangeStat} at the granularity mixed-precision maps
    use (``keys``, or the depth-``depth`` prefixes of the discovered
    scopes), plus the ``""`` entry covering ops outside every key."""
    ops = RangeCaaOps(cfg, weights_exact=weights_exact)
    forward(ops, params, x)
    if keys is None:
        keys = scope_prefixes(ops.seen_scopes, depth)
    return aggregate_ranges(ops.scope_ranges, keys)


def mixed_precision(
    forward, params, x: CaaTensor, p_star: float,
    layer_names: Sequence[str],
    cfg: CaaConfig = caa.DEFAULT_CONFIG,
):
    """Mixed-precision plan (the paper's future-work item): attribute the
    bound per layer, then split the margin budget."""
    slack = sensitivity(forward, params, x, layer_names, cfg)
    return precision.mixed_precision_plan(slack, theory.abs_margin(p_star))


# ---------------------------------------------------------------------------
# layer-stacked variants: the stack analysed as one wildcard scope whose
# per-layer knobs and range evidence live in [L] lanes
# ---------------------------------------------------------------------------

def discover_scopes_stacked(
    forward, params, x: CaaTensor, n_layers: int,
    cfg: CaaConfig = caa.DEFAULT_CONFIG,
    depth: int = 1,
) -> List[str]:
    """The scope keys one stacked pass enters, with the ``layer*`` stack
    wildcard expanded to concrete ``layer{i}`` names — what
    :func:`discover_scopes` gives on an eager unrolled pass."""
    ops = StackedCaaOps(cfg)
    forward(ops, params, x)
    return expand_stacked(scope_prefixes(ops.seen_scopes, depth), n_layers)


def onehot_scale_vector(scope_keys: Sequence[str],
                        scope_key: str) -> np.ndarray:
    """Scale vector enabling fresh roundings ONLY in one scope (the
    trailing default slot stays 0) — the sensitivity probe's input."""
    scales = np.zeros(len(scope_keys) + 1, np.float64)
    scales[list(scope_keys).index(scope_key)] = 1.0
    return scales


def sensitivity_stacked(
    forward, params, x: CaaTensor,
    scope_keys: Sequence[str],
    cfg: CaaConfig = caa.DEFAULT_CONFIG,
    weights_exact: bool = True,
) -> Dict[str, float]:
    """Per-scope contribution to the final absolute bound through the
    stacked analysis: fresh roundings are enabled one scope at a time by
    the one-hot entries of a scale vector (``layer{i}`` keys reach the
    stack through its [L] lanes). One stacked pass per key; PyTorch runs
    eagerly, so there is no compilation to share between them."""
    keys = tuple(scope_keys)
    out: Dict[str, float] = {}
    for key in keys:
        scales = onehot_scale_vector(keys, key)
        sm = {k: float(scales[i]) for i, k in enumerate(keys)}
        ops = StackedCaaOps(cfg, sm, default_scale=float(scales[len(keys)]),
                            weights_exact=weights_exact)
        y = forward(ops, params, x)
        out[key] = float(torch.max(y.dbar))
    return out


def analyze_ranges_stacked(
    forward, params, x: CaaTensor,
    cfg: CaaConfig = caa.DEFAULT_CONFIG,
    weights_exact: bool = True,
    keys: Optional[Sequence[str]] = None,
    sublanes: Sequence[str] = (),
) -> Dict[str, RangeStat]:
    """Stacked sibling of :func:`analyze_ranges`: per-layer IA magnitude
    enclosures accumulate in [L, S, 4] device lanes
    (:class:`repro_torch.core.backend.StackedRangeCaaOps`), read back once
    at the end. Returns {scope_key: RangeStat} with the ``""`` entry
    covering every op outside the layer stack. ``sublanes`` names
    sub-layer scopes (e.g. ``("attn", "mlp")``) that get their own lane, so
    the evidence lands at ``layer{i}/attn`` granularity."""
    ops = StackedRangeCaaOps(cfg, weights_exact=weights_exact,
                             sublanes=sublanes)
    forward(ops, params, x)
    stats = ops.collect_ranges()
    if keys is None:
        keys = [k for k in stats if k]
    return aggregate_ranges(stats, keys)


def analyze_ranges_affine(
    forward, params, x: CaaTensor,
    scope_fmts: Dict[str, Any],
    default_fmt,
    keys: Optional[Sequence[str]] = None,
    stacked: bool = True,
    sublanes: Sequence[str] = (),
    budget: int = iv.AFF_DEFAULT_BUDGET,
    weights_exact: bool = True,
    condense_rank: str = iv.AFF_DEFAULT_RANK,
) -> Dict[str, RangeStat]:
    """Affine/zonotope range pass: per-scope magnitude enclosures of the
    ROUNDED values under a per-scope format map, through the two-channel
    forward propagation of :class:`repro_torch.core.backend.
    AffineRangeCaaOps` (``stacked``: its layer-stacked form).

    Unlike the IA passes above — which bound |v̂| through the CAA error
    terms and saturate once the parametric γ bounds blow up at coarse k —
    this pass's enclosures are finite at every precision (its rounding
    model is the operational (1+u/2)^n growth). It proves nothing about
    (δ̄, ε̄); its RangeStats exist to be min-combined with the IA evidence
    by :func:`tighten_range_maps`. ``budget`` caps the live noise symbols
    per tensor; ``condense_rank`` picks which symbols a condensation
    keeps."""
    if stacked:
        ops = StackedAffineRangeCaaOps(scope_fmts, default_fmt,
                                       budget=budget,
                                       weights_exact=weights_exact,
                                       sublanes=sublanes,
                                       condense_rank=condense_rank)
        forward(ops, params, x)
        stats = ops.collect_ranges()
    else:
        ops = AffineRangeCaaOps(scope_fmts, default_fmt, budget=budget,
                                weights_exact=weights_exact,
                                condense_rank=condense_rank)
        forward(ops, params, x)
        stats = dict(ops.scope_ranges)
    if keys is None:
        keys = [k for k in stats if k]
    return aggregate_ranges(stats, keys)


def tighten_range_maps(base: Dict[str, RangeStat],
                       tight: Dict[str, RangeStat]) -> Dict[str, RangeStat]:
    """Min-combine two sound range maps over the same values and format
    map (e.g. the IA evidence with the affine pass's): both ``max_abs`` are
    upper bounds on the same |v̂|, so their min is a sound, tighter bound.
    Underflow evidence stays conservative — ``min_nonzero`` keeps the
    weaker (smaller) claim and ``crosses_zero`` ORs. Keys missing from
    ``tight`` pass through unchanged.

    Both maps must describe the SAME input profile and format map —
    tighten per profile first, then widen across profiles with
    :func:`merge_range_maps`, never the other way around."""
    out: Dict[str, RangeStat] = {}
    for key, b in base.items():
        t = tight.get(key)
        if t is None or t.n_ops == 0 or b.n_ops == 0:
            out[key] = b
            continue
        out[key] = RangeStat(
            max_abs=min(b.max_abs, t.max_abs),
            min_nonzero=min(b.min_nonzero, t.min_nonzero),
            crosses_zero=b.crosses_zero or t.crosses_zero,
            n_ops=max(b.n_ops, t.n_ops),
        )
    return out


def merge_range_maps(maps: Sequence[Dict[str, RangeStat]],
                     keys: Sequence[str]) -> Dict[str, RangeStat]:
    """Fold several {scope: RangeStat} maps (e.g. one per input profile)
    onto one key set through :func:`aggregate_ranges`, so the per-path →
    key assignment is that of single-profile aggregation. The profile
    prefix keeps colliding paths distinct; it matches no key, so each path
    still lands where its own segments say."""
    combined: Dict[str, RangeStat] = {}
    for p, m in enumerate(maps):
        for path, stat in m.items():
            combined[f"profile{p}/{path}" if path else f"profile{p}"] = stat
    return aggregate_ranges(combined, keys)
