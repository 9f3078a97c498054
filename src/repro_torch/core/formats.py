"""Floating-point format zoo (a plain-Python copy of the JAX package's
``repro.core.formats``; the port imports nothing of that package).

The paper parameterises its whole analysis by the *precision* ``k`` — the number
of mantissa bits held by the format, counting the implicit bit — through the
unit ``u = 2^{1-k}`` (eq. (5): ``fl(a∘b) = (a∘b)(1+ε u)`` with ``|ε| ≤ 1/2``).
All CAA error bounds are expressed in units of this ``u`` so a single analysis
serves every candidate format; a format is then chosen by comparing its ``u``
against the bound (Section IV of the paper).

We additionally carry the exponent range so the empirical oracle
(:mod:`repro_torch.core.quantize`) can emulate overflow/underflow behaviour, and so
range checks against IA enclosures can flag formats whose dynamic range is the
real problem (the paper's observation that DNNs also behave well under *low
exponent range* is checkable this way).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional


@dataclasses.dataclass(frozen=True)
class FpFormat:
    """A binary floating-point format.

    Attributes:
      name: human-readable identifier.
      k: precision — mantissa bits *including* the implicit leading bit
         (IEEE binary32 → 24, binary64 → 53, bfloat16 → 8).
      emax: maximum unbiased exponent of a normal number.
      emin: minimum unbiased exponent of a normal number.
      has_subnormals: whether gradual underflow is supported.
      saturating: if True, overflow clamps to ±max_finite (common for fp8
         inference datapaths); otherwise overflow produces ±inf.
      max_finite_override: explicit largest finite value, for formats whose
         top binade is clipped by an encoding trick (OCP e4m3 spends the
         all-ones exponent+mantissa code on NaN, so its max is 1.75·2^8 =
         448, not the formula's 1.875·2^8 = 480).
    """

    name: str
    k: int
    emax: int
    emin: int
    has_subnormals: bool = True
    saturating: bool = False
    max_finite_override: Optional[float] = None

    @property
    def u(self) -> float:
        """The paper's unit: u = 2^{1-k}. One elementary rounding is ≤ (1/2)u."""
        return 2.0 ** (1 - self.k)

    @property
    def unit_roundoff(self) -> float:
        """Standard unit roundoff = u/2 = 2^{-k}."""
        return 2.0 ** (-self.k)

    @property
    def max_finite(self) -> float:
        if self.max_finite_override is not None:
            return self.max_finite_override
        # (2 - 2^{1-k}) * 2^{emax}
        return (2.0 - 2.0 ** (1 - self.k)) * (2.0 ** self.emax)

    @property
    def min_normal(self) -> float:
        return 2.0 ** self.emin

    @property
    def min_subnormal(self) -> float:
        if not self.has_subnormals:
            return self.min_normal
        return 2.0 ** (self.emin - (self.k - 1))

    @property
    def underflow_unit(self) -> float:
        """Per-rounding underflow absorption bound η, in value terms.

        One result rounding into this format may — beyond the relative
        (1+εu) part of eq. (5) — displace the result absolutely by the
        subnormal grid spacing ``2^{emin-(k-1)}``; without gradual
        underflow the whole flushed value is lost, charged at ``2^{emin}``.
        This is the η of the full standard model fl(x) = x(1+ε) + η, and
        the absolute term the format-certifying analysis folds into δ̄
        (CaaConfig.round_abs, in units of u)."""
        if self.has_subnormals:
            return 2.0 ** (self.emin - (self.k - 1))
        return 2.0 ** self.emin

    @property
    def exponent_bits(self) -> int:
        """Smallest IEEE-style exponent field width covering [emin, emax]
        (e bits encode emax = 2^{e-1}−1, emin = 2−2^{e-1}). Formats that
        stretch emax by an encoding trick (e4m3) report the IEEE width."""
        return exponent_bits(self.emax, self.emin)

    @property
    def total_bits(self) -> int:
        """Storage cost: sign + exponent field + stored mantissa (k counts
        the implicit bit, so k−1 bits are stored)."""
        return 1 + self.exponent_bits + (self.k - 1)

    def to_dict(self) -> Dict[str, Any]:
        """JSON-ready descriptor (the schema-v3 ``layer_format`` entry)."""
        d = dataclasses.asdict(self)
        if d["max_finite_override"] is None:
            del d["max_finite_override"]
        return d

    def describe(self) -> str:
        return (
            f"{self.name}: k={self.k} (u=2^{1 - self.k}), "
            f"emax={self.emax}, emin={self.emin}, "
            f"max={self.max_finite:.3e}"
        )


def from_dict(d: Dict[str, Any]) -> FpFormat:
    known = {f.name for f in dataclasses.fields(FpFormat)}
    return FpFormat(**{k: v for k, v in d.items() if k in known})


def exponent_bits(emax: int, emin: int) -> int:
    """Smallest IEEE-style exponent field width e with 2^{e-1}−1 ≥ emax and
    2−2^{e-1} ≤ emin."""
    e = 2
    while (2 ** (e - 1) - 1 < emax) or (2 - 2 ** (e - 1) > emin):
        e += 1
    return e


def custom(k: int, emax: int = 127, name: str | None = None, **kw) -> FpFormat:
    """A custom format with k-bit precision; default binary32 exponent range.

    This is the knob the paper turns: 'required precision to prevent
    misclassification' (Table I) is a statement about k alone.
    """
    return FpFormat(name or f"custom_k{k}", k=k, emax=emax, emin=-(emax - 1), **kw)


def from_bits(k: int, e: int, name: str | None = None, **kw) -> FpFormat:
    """The IEEE-style format with k-bit precision and an e-bit exponent
    field: emax = 2^{e-1}−1, emin = 2−2^{e-1}. This is the lattice the
    format synthesizer of the JAX package (``repro.certify.formats``)
    searches over."""
    emax = 2 ** (e - 1) - 1
    return FpFormat(name or f"custom_k{k}e{e}", k=k, emax=emax,
                    emin=1 - emax, **kw)


# --- The format zoo -------------------------------------------------------
BINARY64 = FpFormat("binary64", k=53, emax=1023, emin=-1022)
BINARY32 = FpFormat("binary32", k=24, emax=127, emin=-126)
TF32 = FpFormat("tf32", k=11, emax=127, emin=-126)
FP16 = FpFormat("float16", k=11, emax=15, emin=-14)
BFLOAT16 = FpFormat("bfloat16", k=8, emax=127, emin=-126)
# IBM DLfloat: 16 bits, 6 exponent, 9 stored mantissa bits (k=10), no subnormals.
DLFLOAT16 = FpFormat("dlfloat16", k=10, emax=31, emin=-30, has_subnormals=False)
# OCP 8-bit formats (e4m3 has emax=8 with the all-ones-exponent trick;
# saturating). Its top binade is clipped: the all-ones code is NaN, so the
# max is 1.75·2^8 = 448 (== jnp.finfo(float8_e4m3fn).max), not the formula's
# 480 — pinned by the finfo cross-check in tests/test_formats_zoo.py.
FP8_E4M3 = FpFormat("fp8_e4m3", k=4, emax=8, emin=-6, saturating=True,
                    max_finite_override=448.0)
FP8_E5M2 = FpFormat("fp8_e5m2", k=3, emax=15, emin=-14, saturating=True)

REGISTRY: Dict[str, FpFormat] = {
    f.name: f
    for f in (
        BINARY64,
        BINARY32,
        TF32,
        FP16,
        BFLOAT16,
        DLFLOAT16,
        FP8_E4M3,
        FP8_E5M2,
    )
}


def get(name_or_k) -> FpFormat:
    """Look a format up by name, or build ``custom(k)`` from an int."""
    if isinstance(name_or_k, FpFormat):
        return name_or_k
    if isinstance(name_or_k, int):
        return custom(name_or_k)
    if name_or_k in REGISTRY:
        return REGISTRY[name_or_k]
    if name_or_k.startswith("custom_k"):
        spec = name_or_k[len("custom_k"):]
        if "e" in spec:      # "custom_k{k}e{e}" — synthesized lattice formats
            kk, ee = spec.split("e", 1)
            return from_bits(int(kk), int(ee))
        return custom(int(spec))
    raise KeyError(f"unknown FP format {name_or_k!r}; known: {sorted(REGISTRY)}")


def required_k_from_bound(bound_in_u: float, margin: float) -> int:
    """Smallest precision k such that ``bound_in_u * 2^{1-k} <= margin``.

    This is the paper's final step (Section IV): the analysis yields a bound
    B in units of u; a margin μ (absolute) or ν (relative) comes from the
    top-1/top-2 separation; the format must satisfy B·u ≤ margin.
    """
    if bound_in_u <= 0:
        return 1
    if not math.isfinite(bound_in_u) or margin <= 0:
        raise ValueError(
            f"no finite precision achieves bound={bound_in_u} within margin={margin}"
        )
    # B * 2^{1-k} <= m  <=>  k >= 1 + log2(B/m)
    return max(1, math.ceil(1.0 + math.log2(bound_in_u / margin)))
