"""Serving-side metrics: latency histograms, counters, gauges (the
PyTorch port's copy of the JAX package's ``repro.obs.metrics``, which
imports no JAX; same buckets, same quantiles, same snapshot).

Pure-Python accumulators (no server, no dependency); a registry's
snapshot is one ``{"type": "metrics", ...}`` object
(:meth:`MetricsRegistry.to_dict`), appended to a JSONL file by
:meth:`MetricsRegistry.write_jsonl` or rendered in the Prometheus text
exposition format by :meth:`MetricsRegistry.render_prometheus` (the
continuous-batching CLI's ``--metrics`` / ``--prom``).

Histograms use fixed log-spaced latency buckets (100µs … ~100s) which
cover both a prefill over long context and a single decode step; sum and
count make the mean exact, and quantiles are read from the buckets.
"""
from __future__ import annotations

import json
import math
import os
import time
from typing import Any, Dict, List, Optional

# 100µs → ~100s, 4 buckets per decade (log-spaced).
_DEFAULT_BUCKETS = tuple(10.0 ** (-4 + i / 4.0) for i in range(25))


class Histogram:
    """Fixed-bucket latency histogram with Prometheus-style cumulation."""

    def __init__(self, name: str, buckets=_DEFAULT_BUCKETS,
                 help_text: str = ""):
        self.name = name
        self.help_text = help_text
        self.buckets: List[float] = sorted(buckets)
        self.counts: List[int] = [0] * (len(self.buckets) + 1)  # +inf tail
        self.sum = 0.0
        self.count = 0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, value: float):
        value = float(value)
        self.sum += value
        self.count += 1
        self.min = value if self.min is None else min(self.min, value)
        self.max = value if self.max is None else max(self.max, value)
        # first bucket whose upper bound admits the value
        lo, hi = 0, len(self.buckets)
        while lo < hi:
            mid = (lo + hi) // 2
            if value <= self.buckets[mid]:
                hi = mid
            else:
                lo = mid + 1
        self.counts[lo] += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Approximate quantile from bucket boundaries (upper bound),
        clamped into the recorded [min, max] — a bucket's upper edge can
        overshoot the largest value actually observed, and a digest that
        reports p99 above the recorded max is a lie detector's finding,
        not a digest."""
        if not self.count:
            return 0.0
        target = q * self.count
        acc = 0
        val = self.max if self.max is not None else math.inf
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= target:
                if i < len(self.buckets):
                    val = self.buckets[i]
                break
        if self.min is not None:
            val = max(val, self.min)
        if self.max is not None:
            val = min(val, self.max)
        return val

    def percentiles(self) -> Dict[str, float]:
        """The serving-latency digest: p50/p95/p99 (clamped, monotone)."""
        return {"p50": self.quantile(0.5), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name, "count": self.count, "sum": self.sum,
            "min": self.min, "max": self.max, "mean": self.mean,
            "p50": self.quantile(0.5), "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
            "buckets": [{"le": b, "n": n}
                        for b, n in zip(self.buckets, self.counts)
                        if n] + ([{"le": "inf", "n": self.counts[-1]}]
                                 if self.counts[-1] else []),
        }


class MetricsRegistry:
    """Named counters / gauges / histograms, with a snapshot."""

    def __init__(self):
        self.counters: Dict[str, int] = {}
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, Histogram] = {}
        self.meta: Dict[str, Any] = {}

    # -- recording ----------------------------------------------------------
    def counter(self, name: str, inc: int = 1):
        self.counters[name] = self.counters.get(name, 0) + int(inc)

    def gauge(self, name: str, value: float):
        self.gauges[name] = float(value)

    def histogram(self, name: str, help_text: str = "") -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(name, help_text=help_text)
        return h

    def observe(self, name: str, value: float):
        self.histogram(name).observe(value)

    # -- export -------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "type": "metrics", "t": time.time(), "meta": dict(self.meta),
            "counters": dict(self.counters), "gauges": dict(self.gauges),
            "histograms": {k: h.to_dict()
                           for k, h in self.histograms.items()},
        }

    def write_jsonl(self, path: str):
        """Append the snapshot to ``path`` as one JSON line."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(self.to_dict()) + "\n")

    def render_prometheus(self) -> str:
        """Prometheus text exposition format (scrape-file shaped).

        Registry keys may carry labels inline — ``base{key=value,k2=v2}``
        — which render as Prometheus labels with the exposition format's
        escaping (``\\``, ``"``, newline) applied to values; label-less
        keys render bare."""
        lines: List[str] = []
        typed: set = set()

        def _name(n: str) -> str:
            return "".join(ch if (ch.isalnum() or ch in "_:") else "_"
                           for ch in n)

        def _esc(v: str) -> str:
            return (str(v).replace("\\", "\\\\").replace('"', '\\"')
                    .replace("\n", "\\n"))

        def _split(key: str):
            """``base{k=v,k2=v2}`` → (base, [(k, v), ...])."""
            if key.endswith("}") and "{" in key:
                base, _, body = key[:-1].partition("{")
                pairs = []
                for part in body.split(","):
                    if not part:
                        continue
                    lk, eq, lv = part.partition("=")
                    pairs.append((lk.strip(), lv if eq else ""))
                return base, pairs
            return key, []

        def _labels(pairs) -> str:
            return ",".join(f'{_name(lk)}="{_esc(lv)}"' for lk, lv in pairs)

        def _series(key: str):
            base, pairs = _split(key)
            n = _name(base)
            body = _labels(pairs)
            return n, (f"{n}{{{body}}}" if body else n)

        def _type_line(n: str, kind: str):
            if n not in typed:
                typed.add(n)
                lines.append(f"# TYPE {n} {kind}")

        for k in sorted(self.counters):
            n, series = _series(k)
            _type_line(n, "counter")
            lines.append(f"{series} {self.counters[k]}")
        for k in sorted(self.gauges):
            n, series = _series(k)
            _type_line(n, "gauge")
            lines.append(f"{series} {self.gauges[k]:.9g}")
        for k in sorted(self.histograms):
            h = self.histograms[k]
            base, pairs = _split(k)
            n = _name(base)
            lbody = _labels(pairs)
            own = f"{{{lbody}}}" if lbody else ""

            def _bucket(le: str) -> str:
                body = (lbody + "," if lbody else "") + f'le="{le}"'
                return f"{n}_bucket{{{body}}}"

            _type_line(n, "histogram")
            if h.help_text:
                lines.append(f"# HELP {n} {h.help_text}")
            acc = 0
            for b, c in zip(h.buckets, h.counts):
                acc += c
                if acc:
                    lines.append(f"{_bucket(f'{b:.9g}')} {acc}")
            acc += h.counts[-1]
            lines.append(f"{_bucket('+Inf')} {acc}")
            lines.append(f"{n}_sum{own} {h.sum:.9g}")
            lines.append(f"{n}_count{own} {h.count}")
        return "\n".join(lines) + "\n"

    def write_prometheus(self, path: str):
        """Write :meth:`render_prometheus` to ``path`` atomically."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.render_prometheus())
        os.replace(tmp, path)
