"""Per-layer mixed-precision certificates: sensitivity-driven layer→k maps.

The counterpart of the JAX package's ``repro.certify.mixed``. Precision
demand is per layer: well-conditioned activations recover the relative
accuracy the matmul-heavy layers lose. This module certifies a rigorous
per-layer map ``{layer_scope: k}``.

Soundness model (how one analysis covers heterogeneous precisions):

* all bounds stay in units of ONE reference ``u_ref = 2^(1-k_ref)``, where
  ``k_ref`` is the smallest k of the map (the coarsest format);
* a layer at precision ``k_l`` has unit ``u_l ≤ u_ref``, so its fresh
  roundings cost ``½·u_l/u_ref`` units of u_ref — what
  :class:`MixedCaaOps` charges by scaling ``round_scale`` inside that
  layer's scope;
* every second-order / γ-denominator term is bounded at ``u_max = u_ref``,
  an upper bound on every layer's unit.

With all scales 1 this is the uniform batched analysis, the invariant the
greedy descent starts from. The reference traces the probe ladder once
over (u_ref, scale vector); here :class:`MixedProbeLadder` is the eager
analysis as a function of those numbers, with the same ``probes`` count.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core import analyze, caa
from repro_torch.core.backend import CaaOps, StackedCaaOps
from repro_torch.core.caa import CaaConfig, CaaTensor
from repro_torch.core.scopes import resolve_scope_value
from .batch import FeasibleFn, class_bounds


class MixedCaaOps(CaaOps):
    """CaaOps whose fresh-rounding scale follows the current scope.

    ``scope_scales[scope] = u_scope / u_ref``; ``default_scale`` applies
    outside every mapped scope. Propagation terms are untouched — only the
    fresh roundings an op introduces are charged at the scope's own unit.
    """

    def __init__(self, cfg: CaaConfig, scope_scales: Dict[str, object],
                 default_scale=1.0, weights_exact: bool = True):
        super().__init__(cfg, weights_exact=weights_exact)
        self._scales = dict(scope_scales)
        self._default = default_scale
        self._base_cfg = cfg
        self._apply_scale(default_scale)

    def _apply_scale(self, s):
        self.cfg = dataclasses.replace(
            self._base_cfg, round_scale=self._base_cfg.round_scale * s)

    def _scope_changed(self):
        super()._scope_changed()
        self._apply_scale(
            resolve_scope_value(self._scope, self._scales, self._default))


def mixed_scale_vectors(scope_keys: Sequence[str],
                        layer_k: Dict[str, int],
                        default_k: int) -> Tuple[float, np.ndarray, int]:
    """(u_ref, scales, k_ref) encoding a concrete {scope: k} map: entry i
    of ``scales`` is scope_keys[i]'s ``u/u_ref``, the last entry the
    default's; ``u_ref = 2^(1-k_ref)`` with ``k_ref`` the coarsest k in
    play. Every probe interface encodes through here."""
    ks = [int(layer_k[s]) for s in scope_keys] + [int(default_k)]
    k_ref = min(ks)
    u_ref = 2.0 ** (1 - k_ref)
    scales = np.asarray([2.0 ** (1 - k) / u_ref for k in ks], np.float64)
    return u_ref, scales, k_ref


# the one-hot sensitivity-probe convention lives next to the stacked
# analysis it feeds; re-exported here for the ladder interfaces
onehot_scale_vector = analyze.onehot_scale_vector


class MixedProbeLadder:
    """Per-class (δ̄, ε̄) under a per-layer k map: the batched analysis at
    ``u_ref`` with one fresh-rounding scale per scope key (plus the
    default), run eagerly per probe. ``stacked=True`` runs it through
    :class:`repro_torch.core.backend.StackedCaaOps` (the layer stack as one
    scope whose per-layer scales are ``[L]`` lanes; ``scope_keys`` then
    name concrete ``layer{i}`` lanes plus scopes outside the stack).
    ``probes`` counts analyses; ``compiles`` is 0."""

    compiles = 0

    def __init__(self, forward, params, x: CaaTensor,
                 scope_keys: Sequence[str],
                 cfg: CaaConfig = caa.DEFAULT_CONFIG,
                 weights_exact: bool = True,
                 stacked: bool = False):
        self.scope_keys: Tuple[str, ...] = tuple(scope_keys)
        if not self.scope_keys:
            raise ValueError("no scope keys — the model must enter named "
                             "bk.scope(...) blocks to get per-layer k")
        self._base = analyze.batch_config(cfg, int(x.val.shape[0]))
        self._forward = forward
        self._params = params
        self._x = x
        self._weights_exact = weights_exact
        self._stacked = stacked
        self.probes = 0

    def _run(self, u_ref: float, scales: np.ndarray):
        self.probes += 1
        keys = self.scope_keys
        sm = {key: float(scales[i]) for i, key in enumerate(keys)}
        kcfg = dataclasses.replace(self._base, u_max=float(u_ref))
        with obs.span("ladder_probe", ladder="mixed"):
            if self._stacked:
                ops = StackedCaaOps(kcfg, sm,
                                    default_scale=float(scales[len(keys)]),
                                    weights_exact=self._weights_exact)
            else:
                ops = MixedCaaOps(kcfg, sm,
                                  default_scale=float(scales[len(keys)]),
                                  weights_exact=self._weights_exact)
            return class_bounds(self._forward(ops, self._params, self._x))

    def __call__(self, layer_k: Dict[str, int], default_k: int):
        """Bounds for a concrete map: (abs_u, rel_u, k_ref), per-class
        bounds in units of u_ref = 2^(1-k_ref)."""
        u_ref, scales, k_ref = mixed_scale_vectors(
            self.scope_keys, layer_k, default_k)
        abs_u, rel_u = self._run(u_ref, scales)
        return abs_u, rel_u, k_ref

    def sensitivity(self, scope_key: str, at_k: int) -> float:
        """A layer's isolated contribution to the final absolute bound:
        fresh roundings enabled ONLY in this scope (one-hot scale vector)
        at precision ``at_k``."""
        scales = onehot_scale_vector(self.scope_keys, scope_key)
        abs_u, _ = self._run(2.0 ** (1 - int(at_k)), scales)
        return float(np.max(abs_u))


@dataclasses.dataclass
class MixedPlan:
    """Result of the greedy per-layer descent.

    ``layer_k`` is the certified map; ``abs_u``/``rel_u`` are the per-class
    bounds of the final map in units of ``u_ref = 2^(1-k_ref)``. The map
    is valid for serving that quantises each mapped scope's matmuls to its
    k and everything else to ``default_k``."""

    layer_k: Dict[str, int]
    uniform_k: int
    default_k: int
    k_ref: int
    abs_u: np.ndarray
    rel_u: np.ndarray
    sensitivity: Dict[str, float]
    probes: int
    compiles: int
    feasible: bool

    def mean_k(self, layer_flops: Optional[Dict[str, float]] = None) -> float:
        return flop_weighted_mean_k(self.layer_k, layer_flops)

    def savings(self, layer_flops: Optional[Dict[str, float]] = None) -> float:
        """FLOP-weighted mean-k reduction against the uniform certificate."""
        return self.uniform_k - self.mean_k(layer_flops)


def flop_weighted_mean_k(layer_k: Dict[str, int],
                         layer_flops: Optional[Dict[str, float]] = None
                         ) -> float:
    """Σ flops_l·k_l / Σ flops_l — the serving-cost view of a mixed map
    (unweighted mean when no FLOP counts are given)."""
    if not layer_k:
        raise ValueError("empty layer_k map")
    w = {s: float((layer_flops or {}).get(s, 1.0)) for s in layer_k}
    tot = sum(w.values())
    if tot <= 0:
        raise ValueError("layer_flops sum to zero")
    return sum(w[s] * layer_k[s] for s in layer_k) / tot


def greedy_mixed_assignment(
    forward, params, x: CaaTensor,
    feasible: FeasibleFn,
    uniform_k: int,
    scope_keys: Optional[Sequence[str]] = None,
    cfg: CaaConfig = caa.DEFAULT_CONFIG,
    k_min: int = 2,
    weights_exact: bool = True,
    ladder: Optional[MixedProbeLadder] = None,
    stacked: bool = False,
    stage=None,
) -> MixedPlan:
    """Greedy sensitivity-driven per-layer descent from a uniform k.

    Every layer starts at ``uniform_k``. Layers are ranked by their
    isolated error contribution, least sensitive first — ``sorted(keys,
    key=(sensitivity, name))``, so ties and +inf sensitivities fall back to
    the name, as in the reference — then each layer's k drops one step at
    a time until the joint feasibility check fails, and backs up one step.
    Feasibility is monotone in each layer's k, so the endpoint is a
    certified map with ``layer_k[s] ≤ uniform_k`` pointwise. ``stage``
    (a :class:`repro_torch.certify.lm.StageClock`) times the ranking and
    the descent as ``sensitivity_rank`` and ``greedy_descent``."""
    if scope_keys is None:
        scope_keys = analyze.discover_scopes(forward, params, x, cfg)
    if ladder is None:
        ladder = MixedProbeLadder(forward, params, x, scope_keys, cfg=cfg,
                                  weights_exact=weights_exact,
                                  stacked=stacked)
    uniform_k = int(uniform_k)

    if stage is None:
        stage = lambda name: contextlib.nullcontext()
    with obs.span("sensitivity_rank", scopes=len(ladder.scope_keys)), \
            stage("sensitivity_rank"):
        sens = {s: ladder.sensitivity(s, uniform_k)
                for s in ladder.scope_keys}
    order = sorted(ladder.scope_keys, key=lambda s: (sens[s], s))

    layer_k = {s: uniform_k for s in ladder.scope_keys}

    def ok(lk: Dict[str, int]) -> bool:
        abs_u, rel_u, k_ref = ladder(lk, uniform_k)
        return bool(np.all(feasible(abs_u, rel_u, k_ref)))

    with stage("greedy_descent"):
        base_ok = ok(layer_k)
    for s in order if base_ok else ():
        with stage("greedy_descent"):
            with obs.span("greedy_descent_step", scope=s,
                          start_k=layer_k[s]) as _sp:
                while layer_k[s] > k_min:
                    layer_k[s] -= 1
                    if not ok(layer_k):
                        layer_k[s] += 1   # backtrack one step
                        break
                _sp.set(final_k=layer_k[s])
    with stage("greedy_descent"):
        abs_u, rel_u, k_ref = ladder(layer_k, uniform_k)
    return MixedPlan(
        layer_k=dict(layer_k),
        uniform_k=uniform_k,
        default_k=uniform_k,
        k_ref=k_ref,
        abs_u=abs_u,
        rel_u=rel_u,
        sensitivity=sens,
        probes=ladder.probes,
        compiles=ladder.compiles,
        feasible=base_ok,
    )
