"""Full custom-FP format synthesis: from rigorous range analysis to a
certified per-scope {scope: (k, emin, emax)} map.

The counterpart of the JAX package's ``repro.certify.formats``:
:mod:`repro_torch.certify.formats.synth` (search + confirmation) and
:mod:`repro_torch.certify.formats.ladder` (format-aware CAA execution and
the probe ladder). The pipeline entry is
``repro_torch.certify.certify(..., formats=True)`` /
``python -m repro_torch.certify --formats``.
"""
from .ladder import (FormatCaaOps, FormatProbeLadder, MixedLadderView,
                     RangeFormatCaaOps, eager_format_report, scope_vectors)
from .synth import (DEFAULT_KEY, FormatPlan, min_exponent_bits_for_range,
                    synthesize_formats)

__all__ = [
    "DEFAULT_KEY",
    "FormatCaaOps",
    "FormatPlan",
    "FormatProbeLadder",
    "MixedLadderView",
    "RangeFormatCaaOps",
    "eager_format_report",
    "min_exponent_bits_for_range",
    "scope_vectors",
    "synthesize_formats",
]
