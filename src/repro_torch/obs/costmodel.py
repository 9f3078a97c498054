"""Measured cost model: {scope_class × (k, emax)} → predicted serving latency.

The PyTorch port's copy of the fitting half of the JAX package's
``repro.obs.costmodel``: it FITS a two-term roofline cost model to measured
kernel timings (:mod:`repro_torch.obs.profile`) and predicts per-scope
serving latency as

    latency(scope, fmt) = max( flops / α_kernel ,  bytes(fmt) / β_kernel )

with α (achieved FLOP/s) and β (achieved bytes/s) taken per kernel class
from the medians of the measured profile — not the data sheet. Hardware
peaks live here too: :data:`H100_SXM` is the port's device, and
:data:`TPU_POD_CHIP` is kept as data so the port's terms can be held
against the reference's on the same inputs. The reference's certificate
re-scoring (``cost_report``, ``certificate_cost_report``) is not ported yet.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.core import formats as F

#: serving cost of a bare mantissa-k map in a binary32 carrier:
#: 1 sign + 8 exponent + (k-1) stored mantissa bits
CARRIER_EXP_BITS = 8
BINARY32_BITS = 32


@dataclasses.dataclass(frozen=True)
class Hardware:
    """Peak terms of the roofline (per chip). ``ridge_intensity`` is the
    FLOP/byte above which a kernel is compute-bound at these peaks."""

    name: str
    peak_flops: float          # FLOP/s
    hbm_bytes_per_s: float
    link_bytes_per_s: float

    @property
    def ridge_intensity(self) -> float:
        return self.peak_flops / self.hbm_bytes_per_s

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


#: the reference's single-pod TPU chip (197 TFLOP/s bf16 MXU, 819 GB/s HBM,
#: 50 GB/s/link ICI), kept as data for the parity tests only
TPU_POD_CHIP = Hardware("tpu-pod-chip", 197e12, 819e9, 50e9)

#: NVIDIA H100 SXM, the 700 W part (NVIDIA H100 data sheet, dense rates):
#: 67 TFLOP/s f32 on the CUDA cores — the port's kernels accumulate in f32
#: outside the tensor cores — 3.35 TB/s HBM3, NVLink 900 GB/s = 450 GB/s
#: per direction. A card set below 700 W runs slower under load.
H100_SXM = Hardware("h100-sxm-700w-f32", 67e12, 3.35e12, 450e9)


def format_bits(k: int, emax: Optional[int] = None,
                emin: Optional[int] = None) -> float:
    """Total storage bits/value of a certified format: sign + exponent field
    + stored mantissa. A mantissa-only (mixed) map rides a binary32-carrier
    exponent field of 8 bits."""
    if emax is None or emin is None:
        return 1 + CARRIER_EXP_BITS + (int(k) - 1)
    return 1 + F.exponent_bits(int(emax), int(emin)) + (int(k) - 1)


def scope_class(scope: str) -> str:
    """Fold a certificate scope key into its kernel-facing class:
    ``layer3/attn`` and ``layer*/attn`` are the same class; dense
    paper-model scopes fold to ``dense``."""
    s = str(scope)
    if not s:
        return "default"
    if "/" in s:
        return "layer/" + s.rsplit("/", 1)[1]
    if s.startswith("layer"):
        return "layer"
    if s.startswith("dense"):
        return "dense"
    return s  # head, embed, softmax, ...


#: which measured kernel's achieved (α, β) prices each scope class; first
#: present in the fitted model wins
CLASS_KERNELS: Dict[str, Sequence[str]] = {
    "layer/attn": ("flash_decode", "quant_matmul_format",
                   "quant_matmul_dynamic_k", "matmul_baseline"),
}
DEFAULT_KERNELS: Sequence[str] = ("quant_matmul_format",
                                  "quant_matmul_dynamic_k",
                                  "matmul_baseline", "flash_decode")


@dataclasses.dataclass
class CostModel:
    """Per-kernel achieved-throughput coefficients fitted from measurement.

    ``alpha[kernel]`` = achieved FLOP/s (median over the profiled points),
    ``beta[kernel]`` = achieved bytes/s. ``predict`` combines them with a
    scope's analytic flops and format-dependent bytes into the measured
    two-term roofline above.
    """

    alpha: Dict[str, float]
    beta: Dict[str, float]
    hardware: Hardware = H100_SXM
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def kernel_for(self, scope: str) -> str:
        cls = scope_class(scope)
        for k in CLASS_KERNELS.get(cls, DEFAULT_KERNELS):
            if k in self.alpha:
                return k
        if not self.alpha:
            raise ValueError("empty cost model (no fitted kernels)")
        return sorted(self.alpha)[0]

    def predict(self, scope: str, flops_per_token: float,
                k: int, emax: Optional[int] = None,
                emin: Optional[int] = None,
                tokens: int = 1) -> Dict[str, Any]:
        """Predicted latency contribution of one scope for one serving step.

        ``flops_per_token`` is the scope's matmul work per token; the
        scope's weight traffic is ``flops/2`` values streamed once per step
        at the format's storage width — the decode-wall model, where weights
        dominate bytes and activations ride in cache.
        """
        kernel = self.kernel_for(scope)
        bits = format_bits(k, emax, emin)
        flops = float(flops_per_token) * max(int(tokens), 1)
        weights = float(flops_per_token) / 2.0
        bytes_moved = weights * bits / 8.0
        compute_s = flops / self.alpha[kernel]
        memory_s = bytes_moved / self.beta[kernel]
        bound = "memory" if memory_s >= compute_s else "compute"
        return {
            "kernel": kernel, "bits": bits,
            "flops": flops, "bytes": bytes_moved,
            "compute_s": compute_s, "memory_s": memory_s,
            "latency_s": max(compute_s, memory_s), "bound": bound,
        }

    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema": 1,
            "alpha_flops_per_s": dict(self.alpha),
            "beta_bytes_per_s": dict(self.beta),
            "hardware": self.hardware.to_dict(),
            "meta": dict(self.meta),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CostModel":
        hw = d.get("hardware") or {}
        return cls(alpha=dict(d["alpha_flops_per_s"]),
                   beta=dict(d["beta_bytes_per_s"]),
                   hardware=Hardware(**hw) if hw else H100_SXM,
                   meta=dict(d.get("meta") or {}))


def _median(xs: Sequence[float]) -> float:
    xs = sorted(xs)
    n = len(xs)
    if n == 0:
        raise ValueError("median of empty sequence")
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def fit_cost_model(records: Sequence[Dict[str, Any]],
                   hardware: Hardware = H100_SXM) -> CostModel:
    """Fit (α, β) per kernel from measured profile records.

    Each record needs ``kernel``, ``median_s``, ``flops``, ``bytes`` — the
    shape :func:`repro_torch.obs.profile.profile_kernels` emits. The fit is
    the median achieved throughput across that kernel's measured points.

    Rows that timed a plain PyTorch version on the CPU (``route ==
    "plain"``, the port's counterpart of the reference's interpret-mode
    rows) time the host, not the card: they are dropped whenever any card
    row exists. A fit from plain rows only still succeeds but is flagged
    ``meta["plain_only"]`` and warned about."""
    usable = [r for r in records
              if r.get("median_s", 0) and r["median_s"] > 0]
    real = [r for r in usable if r.get("route") != "plain"]
    plain_only = bool(usable) and not real
    if plain_only:
        warnings.warn(
            "fit_cost_model: every measurement row timed a plain PyTorch "
            "version on the host — the fitted rates model the host, not the "
            "card; treat predictions as relative only",
            RuntimeWarning, stacklevel=2)
    else:
        usable = real
    per: Dict[str, List[Dict[str, Any]]] = {}
    for r in usable:
        per.setdefault(str(r["kernel"]), []).append(r)
    if not per:
        raise ValueError("no usable measurement records to fit")
    alpha = {k: _median([r["flops"] / r["median_s"] for r in rs])
             for k, rs in per.items()}
    beta = {k: _median([r["bytes"] / r["median_s"] for r in rs])
            for k, rs in per.items()}
    meta: Dict[str, Any] = {"fit_points": {k: len(rs)
                                           for k, rs in per.items()}}
    dropped = 0 if plain_only else sum(
        1 for r in records if r.get("median_s", 0) and r["median_s"] > 0
        and r.get("route") == "plain")
    if dropped:
        meta["plain_rows_dropped"] = dropped
    if plain_only:
        meta["plain_only"] = True
    return CostModel(alpha=alpha, beta=beta, hardware=hardware, meta=meta)
