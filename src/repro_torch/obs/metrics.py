"""Serving-side metrics: latency histograms, counters, gauges (the
PyTorch port's copy of the JAX package's ``repro.obs.metrics``, which
imports no JAX; same buckets, same quantiles, same snapshot).

Pure-Python accumulators (no server, no dependency); a registry's
snapshot is one ``{"type": "metrics", ...}`` object
(:meth:`MetricsRegistry.to_dict`). The reference's JSONL and Prometheus
file exports come with the serve CLI's ``--metrics``/``--prom`` flags,
which the port does not have yet.

Histograms use fixed log-spaced latency buckets (100µs … ~100s) which
cover both a prefill over long context and a single decode step; sum and
count make the mean exact, and quantiles are read from the buckets.
"""
from __future__ import annotations

import math
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

    # -- snapshot -----------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "type": "metrics", "t": time.time(), "meta": dict(self.meta),
            "counters": dict(self.counters), "gauges": dict(self.gauges),
            "histograms": {k: h.to_dict()
                           for k, h in self.histograms.items()},
        }
