"""Measured cost model: {scope_class × (k, emax)} → predicted serving latency.

The PyTorch port's copy of the JAX package's ``repro.obs.costmodel``: it
FITS a two-term roofline cost model to measured
kernel timings (:mod:`repro_torch.obs.profile`) and predicts per-scope
serving latency as

    latency(scope, fmt) = max( flops / α_kernel ,  bytes(fmt) / β_kernel )

with α (achieved FLOP/s) and β (achieved bytes/s) taken per kernel class
from the medians of the measured profile — not the data sheet. Hardware
peaks live here too: :data:`H100_SXM` is the port's device, and
:data:`TPU_POD_CHIP` is kept as data so the port's terms can be held
against the reference's on the same inputs. :func:`cost_report` and
:func:`certificate_cost_report` re-score a certified serving map under both
objectives (FLOP-weighted bits and predicted latency) per scope;
:func:`render_cost_report` prints the comparison.
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


# ---------------------------------------------------------------------------
# certificate re-scoring: FLOP-weighted bits vs predicted latency
# ---------------------------------------------------------------------------

def _resolve_fmt(scope: str, layer_format: Optional[Dict[str, Dict]],
                 layer_k: Optional[Dict[str, int]],
                 uniform_k: Optional[int]):
    """(k, emax, emin) a scope would serve under — format map first, then
    mixed map (binary32 carrier), then the uniform k."""
    if layer_format:
        f = layer_format.get(scope, layer_format.get(""))
        if f is not None:
            return int(f["k"]), int(f["emax"]), int(f["emin"])
    if layer_k and scope in layer_k:
        return int(layer_k[scope]), None, None
    if uniform_k is not None:
        return int(uniform_k), None, None
    return 24, None, None  # binary32 carrier, full mantissa


def cost_report(model: CostModel,
                layer_flops: Dict[str, float],
                layer_format: Optional[Dict[str, Dict]] = None,
                layer_k: Optional[Dict[str, int]] = None,
                uniform_k: Optional[int] = None,
                tokens: int = 1) -> Dict[str, Any]:
    """Score a certified serving map under BOTH objectives, per scope.

    For every scope with a FLOP weight: its serving format, the
    FLOP-weighted-bits objective share, the measured-model predicted
    latency share, the savings each objective credits vs a uniform
    binary32 baseline, and the rank each objective assigns the scope.
    ``disagreements`` lists scopes the two objectives order differently —
    exactly where swapping the greedy descent's objective would change the
    map. The full objective swap stays a follow-up; this report is the
    evidence for it.
    """
    rows: List[Dict[str, Any]] = []
    for scope in sorted(layer_flops):
        fl = float(layer_flops[scope])
        k, emax, emin = _resolve_fmt(scope, layer_format, layer_k, uniform_k)
        pred = model.predict(scope, fl, k, emax, emin, tokens=tokens)
        base = model.predict(scope, fl, 24, None, None, tokens=tokens)
        rows.append({
            "scope": scope, "class": scope_class(scope),
            "k": k, "emax": emax, "emin": emin,
            "bits": pred["bits"], "flops_per_token": fl,
            "kernel": pred["kernel"], "bound": pred["bound"],
            "predicted_s": pred["latency_s"],
            "compute_s": pred["compute_s"], "memory_s": pred["memory_s"],
            # what each objective says this scope's narrowing was worth:
            "bits_saved_weighted": fl * (BINARY32_BITS - pred["bits"]),
            "latency_saved_s": base["latency_s"] - pred["latency_s"],
        })
    tot_fl = sum(r["flops_per_token"] for r in rows) or 1.0
    tot_lat = sum(r["predicted_s"] for r in rows) or 1.0
    for r in rows:
        r["bits_objective_share"] = (r["flops_per_token"] * r["bits"]
                                     / (tot_fl * BINARY32_BITS))
        r["latency_share"] = r["predicted_s"] / tot_lat

    def _rank(key):
        order = sorted(range(len(rows)), key=lambda i: -rows[i][key])
        rk = [0] * len(rows)
        for pos, i in enumerate(order):
            rk[i] = pos
        return rk

    rank_bits = _rank("bits_saved_weighted")
    rank_lat = _rank("latency_saved_s")
    disagreements = []
    for i, r in enumerate(rows):
        r["rank_by_bits_saved"] = rank_bits[i]
        r["rank_by_latency_saved"] = rank_lat[i]
        r["rank_disagreement"] = rank_bits[i] - rank_lat[i]
        if rank_bits[i] != rank_lat[i] or (
                r["bound"] == "compute" and r["bits"] < BINARY32_BITS):
            disagreements.append({
                "scope": r["scope"], "bound": r["bound"],
                "rank_by_bits_saved": rank_bits[i],
                "rank_by_latency_saved": rank_lat[i],
                "note": ("compute-bound: narrower storage buys ~no latency "
                         "here, but the bits objective still credits it"
                         if r["bound"] == "compute"
                         else "objectives rank this scope differently"),
            })
    mean_bits = sum(r["flops_per_token"] * r["bits"] for r in rows) / tot_fl
    agree = sum(1 for i in range(len(rows)) if rank_bits[i] == rank_lat[i])
    return {
        "schema": 1,
        "tokens": int(tokens),
        "scopes": rows,
        "mean_bits_flop_weighted": mean_bits,
        "predicted_step_latency_s": tot_lat,
        "rank_agreement": agree / max(len(rows), 1),
        "disagreements": sorted(
            disagreements,
            key=lambda d: -abs(d["rank_by_bits_saved"]
                               - d["rank_by_latency_saved"])),
    }


def certificate_cost_report(certset, layer_flops: Dict[str, float],
                            model: CostModel, tokens: int = 1
                            ) -> Dict[str, Any]:
    """`cost_report` over what a :class:`repro_torch.certify.spec.CertificateSet`
    would actually serve (format map ≻ mixed map ≻ uniform k)."""
    lf = certset.serving_layer_format
    lk = certset.serving_layer_k
    rep = cost_report(model, layer_flops, layer_format=lf, layer_k=lk,
                      uniform_k=certset.serving_k, tokens=tokens)
    rep["model_id"] = certset.model_id
    rep["params_digest"] = certset.params_digest
    rep["serving_map"] = ("format" if lf else
                          "mixed" if lk else "uniform")
    return rep


def render_cost_report(rep: Dict[str, Any]) -> str:
    """Human-readable bits-vs-predicted-latency table."""
    lines = [
        f"cost model what-if — {rep.get('serving_map', '?')} map, "
        f"mean bits {rep['mean_bits_flop_weighted']:.2f}, predicted step "
        f"latency {rep['predicted_step_latency_s'] * 1e6:.2f}us, "
        f"objective rank agreement {rep['rank_agreement']:.0%}",
        f"{'scope':<18} {'bits':>5} {'bound':>8} {'pred_us':>10} "
        f"{'lat%':>6} {'bits_rank':>9} {'lat_rank':>8}",
    ]
    for r in rep["scopes"]:
        lines.append(
            f"{(r['scope'] or '<default>'):<18} {r['bits']:>5.0f} "
            f"{r['bound']:>8} {r['predicted_s'] * 1e6:>10.3f} "
            f"{r['latency_share']:>6.1%} {r['rank_by_bits_saved']:>9} "
            f"{r['rank_by_latency_saved']:>8}")
    if rep["disagreements"]:
        lines.append("objective disagreements (bits-objective blind spots):")
        for d in rep["disagreements"]:
            lines.append(f"  {d['scope'] or '<default>'}: {d['note']}")
    else:
        lines.append("objectives agree on every scope's ranking")
    return "\n".join(lines)
