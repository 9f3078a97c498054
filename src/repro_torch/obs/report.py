"""Render a JSONL trace into per-stage / per-scope summary tables (the
PyTorch port's copy of the JAX package's ``repro.obs.report``, which
imports no JAX: the same tables from the same trace).

``python -m repro_torch.obs report trace.jsonl`` aggregates span lines by
name (count, total/mean/max wall time, share of the root span), groups
spans by their ``scope`` attribute, and appends the final counter/gauge
aggregates. ``report --kernels`` renders the port's measured kernel
trajectory (``BENCH_torch_kernels.json``, :mod:`repro_torch.obs.bench`)
as a roofline table with a serving percentile digest
(:func:`render_kernel_table`).
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional


def _agg_spans(events: Iterable[Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    agg: Dict[str, Dict[str, Any]] = {}
    for ev in events:
        if ev.get("type") != "span":
            continue
        a = agg.setdefault(ev["name"], {
            "count": 0, "total_s": 0.0, "max_s": 0.0, "depth": ev["depth"],
            "scopes": {},
        })
        a["count"] += 1
        a["total_s"] += ev["dur_s"]
        a["max_s"] = max(a["max_s"], ev["dur_s"])
        a["depth"] = min(a["depth"], ev["depth"])
        scope = (ev.get("attrs") or {}).get("scope")
        if scope is not None:
            sc = a["scopes"].setdefault(str(scope),
                                        {"count": 0, "total_s": 0.0})
            sc["count"] += 1
            sc["total_s"] += ev["dur_s"]
    return agg


def _last_values(events: Iterable[Dict[str, Any]], kind: str
                 ) -> Dict[str, Any]:
    """Final aggregate line wins (flush may have run more than once)."""
    out: Dict[str, Any] = {}
    for ev in events:
        if ev.get("type") == kind:
            out = dict(ev.get("values") or {})
    return out


def summarize(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Machine-readable summary (the tests and the bench hook consume it)."""
    spans = _agg_spans(events)
    total = max((a["total_s"] for a in spans.values()
                 if a["depth"] == 0), default=0.0)
    meta = next((ev for ev in events if ev.get("type") == "meta"), {})
    return {
        "program": meta.get("program", ""),
        "argv": meta.get("argv", []),
        "spans": spans,
        "counters": _last_values(events, "counters"),
        "gauges": _last_values(events, "gauges"),
        "root_total_s": total,
        "n_events": len(events),
    }


def render(events: List[Dict[str, Any]], per_scope: bool = True) -> str:
    """Human-readable table over one trace's events."""
    s = summarize(events)
    spans, total = s["spans"], s["root_total_s"]
    lines: List[str] = []
    if s["program"]:
        lines.append(f"trace: {s['program']} {' '.join(s['argv'])}")
    lines.append(f"{'stage':<28} {'count':>6} {'total_s':>10} "
                 f"{'mean_s':>10} {'max_s':>10} {'share':>7}")
    order = sorted(spans.items(),
                   key=lambda kv: (kv[1]["depth"], -kv[1]["total_s"]))
    for name, a in order:
        share = (a["total_s"] / total) if total > 0 else 0.0
        indent = "  " * a["depth"]
        label = (indent + name)[:28]
        lines.append(
            f"{label:<28} {a['count']:>6} {a['total_s']:>10.4f} "
            f"{a['total_s'] / a['count']:>10.4f} {a['max_s']:>10.4f} "
            f"{share:>6.1%}")
        if per_scope and a["scopes"]:
            for scope, sc in sorted(a["scopes"].items(),
                                    key=lambda kv: -kv[1]["total_s"]):
                lab = (indent + "  · " + scope)[:28]
                lines.append(
                    f"{lab:<28} {sc['count']:>6} {sc['total_s']:>10.4f} "
                    f"{sc['total_s'] / sc['count']:>10.4f} {'':>10} {'':>7}")
    if s["counters"]:
        lines.append("")
        lines.append("counters:")
        for k in sorted(s["counters"]):
            lines.append(f"  {k:<40} {s['counters'][k]}")
    if s["gauges"]:
        lines.append("")
        lines.append("gauges:")
        for k in sorted(s["gauges"]):
            lines.append(f"  {k:<40} {s['gauges'][k]:.6g}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# measured-kernel trajectory view (BENCH_kernels.json)
# ---------------------------------------------------------------------------

def _fmt_label(r: Dict[str, Any]) -> str:
    if r.get("emax") is not None:
        return f"k{r['k']}e{r['emax']}"
    if r.get("k") is not None:
        return f"k{r['k']}"
    return "f32"


def _block_label(r: Dict[str, Any]) -> str:
    b = r.get("block")
    if not b:
        return "-"
    return "x".join(str(v) for v in b)


def render_kernel_table(entries: List[Dict[str, Any]],
                        baseline: Optional[Dict[str, Any]] = None) -> str:
    """Roofline table over the LAST kernel-bench trajectory entry, with a
    Δ column against ``baseline`` (default: the previous entry) so a PR's
    perf movement is visible in the same view.

    Columns: measured median, achieved GFLOP/s, achieved intensity
    (flops/byte) vs the analytic roofline time at the modelled hardware
    peaks, the bound classification, and median change vs baseline."""
    if not entries:
        return ("no kernel trajectory yet (BENCH_torch_kernels.json): the "
                "port records none until it has a kernel bench")
    last = entries[-1]
    if baseline is None and len(entries) >= 2:
        baseline = entries[-2]
    base_rows: Dict[str, Dict[str, Any]] = {}
    if baseline:
        for r in baseline.get("rows", []):
            base_rows[(r.get("kernel"), r.get("shape"), _fmt_label(r),
                       _block_label(r))] = r

    lines = [
        f"kernel bench — backend={last.get('backend', '?')} "
        f"interpret={last.get('interpret', '?')} "
        f"hw={last.get('hardware', '?')} rows={len(last.get('rows', []))}",
        f"{'kernel':<24} {'shape':<14} {'fmt':>7} {'block':>12} "
        f"{'median_us':>10} {'GFLOP/s':>9} {'int.':>7} {'roof_us':>9} "
        f"{'bound':>7} {'Δprev':>7}",
    ]
    for r in last.get("rows", []):
        key = (r.get("kernel"), r.get("shape"), _fmt_label(r),
               _block_label(r))
        prev = base_rows.get(key)
        if prev and prev.get("median_s"):
            delta = f"{(r['median_s'] / prev['median_s'] - 1.0):+.0%}"
        else:
            delta = "-"
        lines.append(
            f"{r.get('kernel', '?'):<24} {r.get('shape', '?'):<14} "
            f"{_fmt_label(r):>7} {_block_label(r):>12} "
            f"{r['median_s'] * 1e6:>10.1f} "
            f"{r.get('achieved_flops_per_s', 0) / 1e9:>9.2f} "
            f"{r.get('intensity', 0):>7.2f} "
            f"{r.get('roofline_s', 0) * 1e6:>9.3f} "
            f"{r.get('bound', '?'):>7} {delta:>7}")
    serving = last.get("serving")
    if serving:
        lines.append("")
        lines.append("serving latency (measured, "
                     f"{serving.get('arch', '?')} SMOKE "
                     f"L={serving.get('n_layers', '?')} "
                     f"B={serving.get('batch', '?')}):")
        pre = serving.get("prefill", {})
        if pre:
            lines.append(
                f"  prefill: {pre.get('latency_s', 0) * 1e3:.1f}ms "
                f"(compile {pre.get('compile_s', 0):.2f}s, "
                f"jaxpr {pre.get('jaxpr_eqns', '?')} eqns)")
        dec = serving.get("decode", {})
        pct = dec.get("percentiles", {})
        if pct:
            lines.append(
                f"  decode:  p50 {pct.get('p50', 0) * 1e3:.1f}ms  "
                f"p95 {pct.get('p95', 0) * 1e3:.1f}ms  "
                f"p99 {pct.get('p99', 0) * 1e3:.1f}ms  "
                f"({dec.get('count', 0)} steps, compile "
                f"{dec.get('compile_s', 0):.2f}s, "
                f"jaxpr {dec.get('jaxpr_eqns', '?')} eqns)")
    return "\n".join(lines)
