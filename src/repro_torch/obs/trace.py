"""Span tracing with a JSONL event sink (the PyTorch port's copy).

The port's own copy of the JAX package's ``repro.obs.trace``, which imports
no JAX: the same API and the same event schema, so
``repro.obs.validate_events`` accepts a trace the port writes and the
port's :func:`validate_events` one the reference writes.

One :class:`Tracer` owns an ordered event stream. Spans measure wall time
with ``time.perf_counter()`` (monotonic — nested spans can never report a
child longer than its parent from clock steps), carry a name, a nesting
depth, a parent span name and free-form JSON attributes, and are written as
one JSONL line each when they close. Counters and gauges accumulate
in-memory and are written as single aggregate lines by :meth:`Tracer.flush`
(span lines stream immediately; counter increments would otherwise dominate
the file).

Event schema (one JSON object per line; ``validate_events`` pins it):

  {"type": "meta",     "schema": 1, "program": ..., "argv": [...], "t": ...}
  {"type": "span",     "name": ..., "t": ..., "dur_s": ..., "depth": ...,
                       "parent": ..., "seq": ..., "attrs": {...}}
  {"type": "event",    "name": ..., "t": ..., "fields": {...}}
  {"type": "counters", "values": {name: int, ...}, "t": ...}
  {"type": "gauges",   "values": {name: float, ...}, "t": ...}

``t`` is epoch seconds of the *start* (spans) or emission (everything
else); ``seq`` is a process-wide monotone sequence number so a reader can
reconstruct interleavings without trusting the clock. The global tracer is
disabled by default: every obs call is then a cheap no-op, so instrumented
library code (the certify pipeline, the store, the serving path) pays
nothing unless a CLI opted in via :func:`configure`.
"""
from __future__ import annotations

import io
import json
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional

SCHEMA = 1

_EVENT_TYPES = ("meta", "span", "event", "counters", "gauges")


class _NullSpan:
    """Context manager returned when tracing is off — near-zero cost."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self

    def rename(self, name: str):
        return self


_NULL_SPAN = _NullSpan()


class _Span:
    """An open span; writes its line on ``__exit__``."""

    __slots__ = ("_tracer", "name", "attrs", "_t0", "_wall", "_depth",
                 "_parent")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        tr = self._tracer
        with tr._lock:
            stack = tr._stack
            self._depth = len(stack)
            self._parent = stack[-1].name if stack else None
            stack.append(self)
        self._wall = time.time()
        self._t0 = time.perf_counter()
        return self

    def set(self, **attrs):
        """Attach attributes discovered mid-span (e.g. a search's result)."""
        self.attrs.update(attrs)
        return self

    def rename(self, name: str):
        """Change the span's name before it closes (e.g. a probe that
        turned out to be the one paying the compile)."""
        self.name = str(name)
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        tr = self._tracer
        with tr._lock:
            if tr._stack and tr._stack[-1] is self:
                tr._stack.pop()
        tr._emit({
            "type": "span", "name": self.name, "t": self._wall,
            "dur_s": dur, "depth": self._depth, "parent": self._parent,
            "attrs": self.attrs,
        })
        return False


class Tracer:
    """JSONL event recorder behind the module-level obs API.

    ``path=None`` keeps everything in-memory (``events`` — the test and
    report-rendering mode); with a path, lines are appended as they happen
    and the in-memory list is kept too (it is the cheap source for
    ``flush``-time summaries). Thread-safe: one lock guards the span stack,
    the aggregates, and the sink.
    """

    def __init__(self, path: Optional[str] = None,
                 program: str = "", argv: Optional[List[str]] = None):
        self.path = path
        self._file: Optional[io.TextIOBase] = None
        self._lock = threading.RLock()
        self._stack: List["_Span"] = []
        self._seq = 0
        self.events: List[Dict[str, Any]] = []
        self.counters: Dict[str, int] = {}
        self.gauges: Dict[str, float] = {}
        if path:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            self._file = open(path, "a")
        self._emit({"type": "meta", "schema": SCHEMA, "program": program,
                    "argv": list(argv or []), "t": time.time()})

    # -- sink ---------------------------------------------------------------
    def _emit(self, ev: Dict[str, Any]):
        with self._lock:
            ev["seq"] = self._seq
            self._seq += 1
            self.events.append(ev)
            if self._file is not None:
                self._file.write(json.dumps(ev) + "\n")
                self._file.flush()

    # -- API ----------------------------------------------------------------
    def span(self, name: str, **attrs) -> _Span:
        return _Span(self, str(name), attrs)

    def event(self, name: str, **fields):
        self._emit({"type": "event", "name": str(name), "t": time.time(),
                    "fields": fields})

    def counter(self, name: str, inc: int = 1):
        with self._lock:
            self.counters[str(name)] = self.counters.get(str(name), 0) + int(inc)

    def gauge(self, name: str, value: float):
        with self._lock:
            self.gauges[str(name)] = float(value)

    def flush(self):
        """Write the aggregate counter/gauge lines (idempotent per state)."""
        if self.counters:
            self._emit({"type": "counters", "values": dict(self.counters),
                        "t": time.time()})
        if self.gauges:
            self._emit({"type": "gauges", "values": dict(self.gauges),
                        "t": time.time()})

    def close(self):
        self.flush()
        if self._file is not None:
            self._file.close()
            self._file = None


# ---------------------------------------------------------------------------
# module-level current tracer (what the instrumented library code calls)
# ---------------------------------------------------------------------------

_TRACER: Optional[Tracer] = None


def configure(path: Optional[str] = None, program: str = "",
              argv: Optional[List[str]] = None) -> Tracer:
    """Install (and return) the global tracer. ``path=None`` → in-memory."""
    global _TRACER
    if _TRACER is not None:
        _TRACER.close()
    _TRACER = Tracer(path, program=program, argv=argv)
    return _TRACER


def shutdown():
    """Flush and uninstall the global tracer (subsequent calls are no-ops)."""
    global _TRACER
    if _TRACER is not None:
        _TRACER.close()
        _TRACER = None


def get_tracer() -> Optional[Tracer]:
    return _TRACER


def enabled() -> bool:
    return _TRACER is not None


def span(name: str, **attrs):
    """Open a span on the global tracer; a no-op context when disabled."""
    if _TRACER is None:
        return _NULL_SPAN
    return _TRACER.span(name, **attrs)


def event(name: str, **fields):
    if _TRACER is not None:
        _TRACER.event(name, **fields)


def counter(name: str, inc: int = 1):
    if _TRACER is not None:
        _TRACER.counter(name, inc)


def gauge(name: str, value: float):
    if _TRACER is not None:
        _TRACER.gauge(name, value)


def flush():
    if _TRACER is not None:
        _TRACER.flush()


# ---------------------------------------------------------------------------
# schema validation + file loading (report CLI, CI smoke)
# ---------------------------------------------------------------------------

def validate_events(events: Iterable[Dict[str, Any]]) -> List[str]:
    """Schema check; returns a list of human-readable problems (empty = ok)."""
    errors: List[str] = []
    n = 0
    for i, ev in enumerate(events):
        n += 1
        if not isinstance(ev, dict):
            errors.append(f"line {i}: not a JSON object")
            continue
        t = ev.get("type")
        if t not in _EVENT_TYPES:
            errors.append(f"line {i}: unknown type {t!r}")
            continue
        if "seq" not in ev or not isinstance(ev["seq"], int):
            errors.append(f"line {i}: missing integer 'seq'")
        if t == "meta" and ev.get("schema") != SCHEMA:
            errors.append(f"line {i}: meta schema {ev.get('schema')!r} != "
                          f"{SCHEMA}")
        if t == "span":
            for field, typ in (("name", str), ("t", (int, float)),
                               ("dur_s", (int, float)), ("depth", int),
                               ("attrs", dict)):
                if not isinstance(ev.get(field), typ):
                    errors.append(f"line {i}: span missing/typed "
                                  f"{field!r}")
            if isinstance(ev.get("dur_s"), (int, float)) and ev["dur_s"] < 0:
                errors.append(f"line {i}: negative span duration")
        if t == "event" and not isinstance(ev.get("name"), str):
            errors.append(f"line {i}: event missing 'name'")
        if t in ("counters", "gauges") and not isinstance(
                ev.get("values"), dict):
            errors.append(f"line {i}: {t} missing 'values'")
    if n == 0:
        errors.append("empty trace (no events)")
    return errors


def load_events(path: str) -> List[Dict[str, Any]]:
    """Parse a JSONL trace file (raises on malformed JSON lines)."""
    events = []
    with open(path) as f:
        for ln, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{ln + 1}: malformed JSONL: {e}")
    return events
