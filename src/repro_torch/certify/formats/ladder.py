"""Format-aware CAA execution and the (k, emin, emax) probe ladder.

The counterpart of the JAX package's ``repro.certify.formats.ladder``.
:class:`FormatCaaOps` generalises :class:`repro_torch.certify.mixed.
MixedCaaOps` from per-scope mantissa scales to per-scope FULL formats:
inside scope ``s`` every fresh rounding is charged at the scope's own unit
(``round_scale = u_s/u_ref``) and may additionally absorb the scope's
underflow term (``round_abs = η_s/u_ref``, η_s the format's subnormal grid
spacing; :attr:`repro_torch.core.formats.FpFormat.underflow_unit`).

:class:`FormatProbeLadder` is the batched analysis as a function of
``(u_ref, scale vector, underflow vector)``. The reference compiles it
once; PyTorch runs it eagerly per probe, with the same ``probes`` count,
and ``compiles`` is 0. :meth:`FormatProbeLadder.mixed_view` serves the
mantissa-only searches through the same ladder (underflow pinned to 0).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core import analyze, caa
from repro_torch.core import formats as F
from repro_torch.core.backend import CaaOps, RangeCaaOps, StackedCaaOps
from repro_torch.core.caa import CaaConfig, CaaTensor
from repro_torch.core.scopes import resolve_scope_value
from ..batch import class_bounds


class FormatCaaOps(CaaOps):
    """CaaOps whose fresh roundings follow per-scope custom FP formats.

    ``scope_scales[s] = u_s / u_ref`` and ``scope_abs[s] = η_s / u_ref``;
    the defaults apply outside every mapped scope. Propagation terms are
    untouched. With all scales 1 and all abs 0 this is the uniform batched
    analysis."""

    def __init__(self, cfg: CaaConfig, scope_scales: Dict[str, object],
                 scope_abs: Dict[str, object],
                 default_scale=1.0, default_abs=0.0,
                 weights_exact: bool = True):
        self._scales = dict(scope_scales)
        self._abs = dict(scope_abs)
        self._default_scale = default_scale
        self._default_abs = default_abs
        self._base_cfg = cfg
        super().__init__(cfg, weights_exact=weights_exact)
        self._apply()

    def _apply(self):
        s = resolve_scope_value(self._scope, self._scales,
                                self._default_scale)
        ra = resolve_scope_value(self._scope, self._abs, self._default_abs)
        self.cfg = dataclasses.replace(
            self._base_cfg,
            round_scale=self._base_cfg.round_scale * s,
            round_abs=ra)

    def _scope_changed(self):
        super()._scope_changed()
        self._apply()


class RangeFormatCaaOps(RangeCaaOps, FormatCaaOps):
    """Format-aware analysis that also accumulates per-scope IA magnitude
    enclosures — the synthesizer's eager confirmation backend (one pass
    yields the bounds AND the ranges the emax certificates re-check)."""


def scope_vectors(layer_fmt: Dict[str, F.FpFormat],
                  default_fmt: F.FpFormat,
                  scope_keys: Sequence[str]) -> Tuple[float, np.ndarray,
                                                      np.ndarray]:
    """(u_ref, scales, ras) encoding a concrete per-scope format map:
    ``u_ref = 2^(1-k_ref)`` with ``k_ref`` the coarsest mantissa precision
    in play; entry i of the vectors is scope_keys[i]'s format, the last
    entry the default's."""
    fmts = [layer_fmt[s] for s in scope_keys] + [default_fmt]
    k_ref = min(f.k for f in fmts)
    u_ref = 2.0 ** (1 - k_ref)
    scales = np.asarray([f.u / u_ref for f in fmts], np.float64)
    ras = np.asarray([f.underflow_unit / u_ref for f in fmts], np.float64)
    return u_ref, scales, ras


def _k_ref(u_ref: float) -> int:
    return 1 - int(np.round(np.log2(u_ref)))


class FormatProbeLadder:
    """Per-class (δ̄, ε̄) under a per-scope format map.

    Each probe is one eager batched analysis at ``u_ref`` with one
    (scale, underflow) pair per scope key plus the default.
    ``stacked=True`` runs it through :class:`repro_torch.core.backend.
    StackedCaaOps`: the layer stack as one scope whose per-layer pairs are
    ``[L]`` lanes — the form LM architectures certify through. ``probes``
    counts analyses, including those of :meth:`mixed_view`."""

    compiles = 0

    def __init__(self, forward, params, x: CaaTensor,
                 scope_keys: Sequence[str],
                 cfg: CaaConfig = caa.DEFAULT_CONFIG,
                 weights_exact: bool = True,
                 stacked: bool = False,
                 tag: str = "format"):
        self.tag = str(tag)
        self.scope_keys: Tuple[str, ...] = tuple(scope_keys)
        if not self.scope_keys:
            raise ValueError("no scope keys — the model must enter named "
                             "bk.scope(...) blocks to get per-scope formats")
        self._base = analyze.batch_config(cfg, int(x.val.shape[0]))
        self._forward = forward
        self._params = params
        self._x = x
        self._weights_exact = weights_exact
        self._stacked = stacked
        self.probes = 0

    def _bounds(self, u_ref: float, scales, ras):
        keys = self.scope_keys
        sm = {key: float(scales[i]) for i, key in enumerate(keys)}
        am = {key: float(ras[i]) for i, key in enumerate(keys)}
        kcfg = dataclasses.replace(self._base, u_max=float(u_ref))
        ops_cls = StackedCaaOps if self._stacked else FormatCaaOps
        ops = ops_cls(kcfg, sm, am, default_scale=float(scales[len(keys)]),
                      default_abs=float(ras[len(keys)]),
                      weights_exact=self._weights_exact)
        return class_bounds(self._forward(ops, self._params, self._x))

    def __call__(self, layer_fmt: Dict[str, F.FpFormat],
                 default_fmt: F.FpFormat):
        """Bounds for a concrete map: (abs_u, rel_u, k_ref), per-class
        bounds in units of u_ref = 2^(1-k_ref)."""
        u_ref, scales, ras = scope_vectors(layer_fmt, default_fmt,
                                           self.scope_keys)
        self.probes += 1
        with obs.span("ladder_probe", ladder=self.tag):
            a, e = self._bounds(u_ref, scales, ras)
        return a, e, _k_ref(u_ref)

    def mixed_view(self) -> "MixedLadderView":
        """A mantissa-only probe interface over this ladder."""
        return MixedLadderView(self)


class MixedLadderView:
    """:class:`repro_torch.certify.mixed.MixedProbeLadder`-shaped adapter
    that probes through a :class:`FormatProbeLadder` with the underflow
    vector pinned to 0: per-layer {scope: k} maps and one-hot sensitivity
    probes, counted in the shared ladder's ``probes``."""

    def __init__(self, ladder: FormatProbeLadder):
        self._ladder = ladder
        self.scope_keys = ladder.scope_keys

    def _run(self, u_ref: float, scales: np.ndarray):
        lad = self._ladder
        lad.probes += 1
        with obs.span("ladder_probe", ladder=f"{lad.tag}.mixed_view"):
            return lad._bounds(u_ref, scales, np.zeros(len(scales)))

    def __call__(self, layer_k: Dict[str, int], default_k: int):
        from ..mixed import mixed_scale_vectors

        u_ref, scales, k_ref = mixed_scale_vectors(
            self.scope_keys, layer_k, default_k)
        abs_u, rel_u = self._run(u_ref, scales)
        return abs_u, rel_u, k_ref

    def sensitivity(self, scope_key: str, at_k: int) -> float:
        from ..mixed import onehot_scale_vector

        scales = onehot_scale_vector(self.scope_keys, scope_key)
        abs_u, _ = self._run(2.0 ** (1 - int(at_k)), scales)
        return float(np.max(abs_u))

    @property
    def probes(self) -> int:
        return self._ladder.probes

    @property
    def compiles(self) -> int:
        return self._ladder.compiles


def eager_format_report(forward, params, x: CaaTensor,
                        layer_fmt: Dict[str, F.FpFormat],
                        default_fmt: F.FpFormat,
                        scope_keys: Sequence[str],
                        cfg: CaaConfig = caa.DEFAULT_CONFIG,
                        weights_exact: bool = True):
    """One eager format-aware pass: per-class bounds at u_ref and the
    per-scope range enclosures under the map's own underflow terms — the
    confirmation the persisted certificate is built from.

    Returns (abs_u[C], rel_u[C], k_ref, ranges: {key: RangeStat})."""
    n = int(x.val.shape[0])
    u_ref, scales, ras = scope_vectors(layer_fmt, default_fmt, scope_keys)
    sm = {key: float(scales[i]) for i, key in enumerate(scope_keys)}
    am = {key: float(ras[i]) for i, key in enumerate(scope_keys)}
    base = analyze.batch_config(
        dataclasses.replace(cfg, u_max=u_ref), n)
    ops = RangeFormatCaaOps(base, sm, am,
                            default_scale=float(scales[-1]),
                            default_abs=float(ras[-1]),
                            weights_exact=weights_exact)
    with obs.span("range_pass", scopes=len(scope_keys)):
        out = forward(ops, params, x)
    abs_u, rel_u = class_bounds(out)
    del out
    ranges = analyze.aggregate_ranges(ops.scope_ranges, scope_keys)
    return abs_u, rel_u, _k_ref(u_ref), ranges
