"""Certificate-violation monitors: check live traffic against proven bounds
(the PyTorch port's copy of the JAX package's ``repro.obs.monitors``).

A certificate is an *a-priori* promise: per-scope IA magnitude enclosures
(schema-v3 ``scope_ranges``) and output error bounds (δ̄, ε̄ in units of u).
Live traffic that leaves the annotation they were proven under voids them
silently; a :class:`ViolationMonitor` makes that visible:

* **enclosure checks** — :meth:`ViolationMonitor.observe_scope` folds one
  scope's :func:`repro_torch.core.quantize.numeric_health` stats; an
  observed ``max_abs`` above the certified enclosure bumps
  ``obs.enclosure_violations`` and the scope's ``bound_margin`` —
  log2(certified / observed) — goes negative;
* **overflow / underflow / non-finite counters** against the scope's
  certified format (an overflow under a certificate that proved none is a
  violation by itself);
* **error checks** — :meth:`ViolationMonitor.observe_error` takes a sampled
  empirical output error (units of u) against the certified δ̄.

The fold is host-side Python over floats, as in the reference. What the
port adds is the way the stats reach it: the reference calls back to the
host once per matmul, the port writes each observation into one row of a
device log (:class:`HealthLog`, through the ``numeric_health`` kernel of
:mod:`repro_torch.kernels.health`) and :meth:`ViolationMonitor.flush`
reads the log back once per serving step and folds its rows through
:meth:`ViolationMonitor.observe_scope` in the order they were written —
counts summed, margins minimised, enclosure violations counted per
observation, as the reference folds them.
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch.core.scopes import STACK_SCOPE, resolve_scope_value
from repro_torch.kernels import health

_LAYER_KEY = re.compile(r"^layer\d+$")

# Multiplicative slack on enclosure comparisons. The certified max_abs is an
# upper bound computed in f64 IA; the observed stat is an f32 max of the
# *quantized* tensor, which rounding may carry up to one ulp past the bound
# without anything being wrong. 1 + 2^-10 covers every certified k ≥ 11.
DEFAULT_SLACK = 1.0 + 2.0 ** -10


def stacked_label(path: Sequence[str]) -> List[str]:
    """A scope path with every concrete ``layer<i>`` segment replaced by
    the stacked wildcard ``layer*``: the path the reference's scanned
    serving body observes under (one traced body serves every layer)."""
    return [STACK_SCOPE if _LAYER_KEY.match(s) else s for s in path]


class HealthLog:
    """Per-step device log of numeric-health observations.

    One int64 row of :data:`repro_torch.kernels.health.ROW_WORDS` words an
    observation (its counts, then max_abs / min_nonzero as f32), on the
    device of the observed tensors; the scope label of each row stays in a
    host list. :meth:`record` launches the health kernel into the next row
    and never synchronises — when the log is full the host doubles it (a
    device copy). :meth:`drain` copies the written rows to the host once,
    re-initialises them for the next step and returns (label, stats) pairs
    in row order."""

    def __init__(self, capacity: int = 256):
        self.capacity = int(capacity)
        self.buf: Optional[torch.Tensor] = None
        self._init: Optional[torch.Tensor] = None   # one initial row
        self.labels: List[List[str]] = []

    @property
    def pending(self) -> int:
        """Rows written since the last :meth:`drain`."""
        return len(self.labels)

    def _row_for(self, device) -> int:
        n = len(self.labels)
        if self.buf is None:
            self.buf = health.init_rows(self.capacity, device)
            self._init = health.init_rows(1, device)
        elif self.buf.device != device:
            raise ValueError(f"health log on {self.buf.device}, "
                             f"observation on {device}")
        elif n == self.buf.shape[0]:
            grown = health.init_rows(2 * n, device)
            grown[:n].copy_(self.buf)
            self.buf = grown
        return n

    def record(self, label: Sequence[str], x: torch.Tensor, k: int,
               emax: int, emin: int) -> None:
        row = self._row_for(x.device)
        health.numeric_health_dispatch(x, int(k), int(emax), int(emin),
                                       self.buf, row)
        self.labels.append(list(label))

    def drain(self):
        n = len(self.labels)
        if n == 0:
            return []
        rows = self.buf[:n]
        host = rows.to("cpu", copy=True)   # the step's one read-back
        rows.copy_(self._init.expand(n, -1))   # one launch
        labels, self.labels = self.labels, []
        return list(zip(labels, health.unpack_rows(host)))


class ViolationMonitor:
    """Compares observed numeric health against one certificate set."""

    def __init__(self, envelopes: Dict[str, Dict[str, float]],
                 dbar_u: float = math.inf, u: Optional[float] = None,
                 slack: float = DEFAULT_SLACK):
        # envelopes: {scope_key: {"max_abs": float, ...}} — certified
        # per-scope magnitude enclosures (concrete layer names, resolved
        # against observed paths with the scopes module's matcher).
        self.envelopes = dict(envelopes)
        self.dbar_u = float(dbar_u)
        self.u = u
        self.slack = float(slack)
        self.counters: Dict[str, int] = {
            "obs.scope_observations": 0,
            "obs.enclosure_violations": 0,
            "obs.overflow_events": 0,
            "obs.underflow_events": 0,
            "obs.nonfinite_events": 0,
            "obs.error_samples": 0,
            "obs.bound_violations": 0,
        }
        # scope → log2(certified max_abs / observed max_abs); > 0 = headroom
        self.scope_margin: Dict[str, float] = {}
        # worst observed empirical error in units of u (−inf until sampled)
        self.worst_err_u = -math.inf
        self.log = HealthLog()

    # -- construction from certificates -------------------------------------
    @classmethod
    def from_certificate_set(cls, cs, slack: float = DEFAULT_SLACK
                             ) -> "ViolationMonitor":
        """Build a monitor from one certificate set.

        Per-scope magnitude envelopes come ONLY from the format pipeline's
        ``scope_ranges`` (set-level meta, schema v3): rigorous IA
        enclosures over every op in the scope. v1/v2 sets carry no such
        enclosures, so for those the monitor tracks overflow / underflow /
        non-finite events and the sampled δ̄ check only.

        Concrete ``layer<i>`` envelopes also fold into a ``layer*`` key
        (the max over layers: serving observes every layer under the
        stacked path), merge-maxed with an explicit ``layer*`` entry;
        sub-layer keys (``layer3/attn``) fold into their own
        ``layer*/attn`` group, and concrete keys stay as they are."""
        envelopes: Dict[str, Dict[str, float]] = {}
        fm = (cs.meta or {}).get("formats") or {}
        if fm.get("applied") and fm.get("scope_ranges"):
            for s, r in fm["scope_ranges"].items():
                ma = r.get("max_abs")
                if s and ma is not None and math.isfinite(ma):
                    envelopes[s] = {"max_abs": float(ma)}
        folds: Dict[str, float] = {}
        for s, v in envelopes.items():
            head, _, rest = s.partition("/")
            if _LAYER_KEY.match(head):
                wild = STACK_SCOPE + (("/" + rest) if rest else "")
                folds[wild] = max(folds.get(wild, -math.inf), v["max_abs"])
        for wild, ma in folds.items():
            prev = envelopes.get(wild)
            if prev is None or prev["max_abs"] < ma:
                envelopes[wild] = {"max_abs": ma}
        bars = cs.error_bars()
        return cls(envelopes, dbar_u=bars.get("dbar_u", math.inf),
                   u=bars.get("u"), slack=slack)

    # -- observation ---------------------------------------------------------
    def record(self, scope: Sequence[str], x: torch.Tensor, k: int,
               emax: int = 127, emin: int = -126) -> None:
        """Log the numeric health of ``x`` against (k, emax, emin) under
        the scope path ``scope``: one row of the device log, no host sync.
        Folded by the next :meth:`flush`."""
        self.log.record(scope, x, k, emax, emin)

    @property
    def pending(self) -> int:
        """Observations logged and not folded yet."""
        return self.log.pending

    def flush(self) -> int:
        """Read the device log back (one copy) and fold its rows through
        :meth:`observe_scope` in the order they were written. Returns the
        number of rows folded."""
        rows = self.log.drain()
        for label, stats in rows:
            self.observe_scope(label, stats)
        return len(rows)

    def observe_scope(self, scope, stats: Dict[str, Any]):
        """Fold one scope's numeric-health stats (plain floats/ints).

        ``scope`` is a scope-path list or a single scope string; envelope
        keys resolve against it with the scopes module's matcher."""
        path = (list(scope) if isinstance(scope, (list, tuple))
                else [str(scope)])
        label = "/".join(path) or "<root>"
        self.counters["obs.scope_observations"] += 1
        n_over = int(stats.get("n_over", 0))
        n_under = int(stats.get("n_under", 0))
        n_nonfin = int(stats.get("n_nonfinite", 0))
        self.counters["obs.overflow_events"] += n_over
        self.counters["obs.underflow_events"] += n_under
        self.counters["obs.nonfinite_events"] += n_nonfin
        max_abs = float(stats.get("max_abs", 0.0))
        env = resolve_scope_value(path, self.envelopes, None)
        if env is not None:
            cert_max = float(env["max_abs"])
            violated = max_abs > cert_max * self.slack
            if violated or n_over > 0 or n_nonfin > 0:
                self.counters["obs.enclosure_violations"] += 1
            if max_abs > 0 and cert_max > 0:
                margin = math.log2(cert_max / max_abs)
            elif cert_max > 0:
                margin = math.inf  # nothing observed yet: full headroom
            else:
                margin = -math.inf
            prev = self.scope_margin.get(label)
            self.scope_margin[label] = (margin if prev is None
                                        else min(prev, margin))

    def observe_error(self, abs_err_u: float):
        """Fold one sampled empirical output error (units of u)."""
        self.counters["obs.error_samples"] += 1
        abs_err_u = float(abs_err_u)
        self.worst_err_u = max(self.worst_err_u, abs_err_u)
        if math.isfinite(self.dbar_u) and abs_err_u > self.dbar_u:
            self.counters["obs.bound_violations"] += 1

    # -- reporting -----------------------------------------------------------
    @property
    def violations(self) -> int:
        return (self.counters["obs.enclosure_violations"]
                + self.counters["obs.bound_violations"])

    def error_margin_u(self) -> float:
        """Certified δ̄ minus worst observed error (units of u); +inf when
        nothing sampled or no finite bound, negative = bound exceeded."""
        if not math.isfinite(self.dbar_u) or self.worst_err_u == -math.inf:
            return math.inf
        return self.dbar_u - self.worst_err_u

    def export(self, registry):
        """Write counters and bound-margin gauges into a MetricsRegistry."""
        for name, v in self.counters.items():
            registry.counter(name, v - registry.counters.get(name, 0))
        for scope, margin in self.scope_margin.items():
            if math.isfinite(margin):
                registry.gauge(f"obs.bound_margin_log2{{scope={scope}}}",
                               margin)
        em = self.error_margin_u()
        if math.isfinite(em):
            registry.gauge("obs.error_margin_u", em)
        if self.worst_err_u != -math.inf:
            registry.gauge("obs.worst_err_u", self.worst_err_u)

    def summary(self) -> Dict[str, Any]:
        return {
            "counters": dict(self.counters),
            "scope_margin_log2": {s: m for s, m in
                                  sorted(self.scope_margin.items())},
            "worst_err_u": (None if self.worst_err_u == -math.inf
                            else self.worst_err_u),
            "dbar_u": self.dbar_u,
            "violations": self.violations,
        }
