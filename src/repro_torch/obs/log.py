"""Structured logging with a human-readable default sink (the PyTorch
port's copy of the JAX package's ``repro.obs.log``, which imports no JAX).

A thin layer over ``logging`` so library and CLI code emits key=value
structured records instead of bare ``print``. The default sink renders

    [batching] served requests=8 steps=41

to stderr; when the port's tracer is active (:func:`repro_torch.obs.
configure`), every record is also recorded as a trace event, so one trace
file holds the narrative beside the spans.

Use :func:`get_logger` (namespaced under ``repro_torch``) and call
``.info`` etc. with a message plus keyword fields::

    log = get_logger("batching")
    log.info("certificate resolved", k=12)
"""
from __future__ import annotations

import logging
import sys
from typing import Any, Dict

from . import trace as _trace

_ROOT = "repro_torch"
_CONFIGURED = False


def _fmt_fields(fields: Dict[str, Any]) -> str:
    if not fields:
        return ""
    return " " + " ".join(f"{k}={v:.6g}" if isinstance(v, float)
                          else f"{k}={v}" for k, v in fields.items())


class _Handler(logging.Handler):
    """Renders ``[component] msg k=v`` lines.

    The stream is resolved when a record is emitted (``sys.stderr`` unless
    a fixed stream was given): the handler is installed once per process,
    and binding the stream then would pin whatever object was installed at
    that moment (a test's capture, a redirected pipe)."""

    def __init__(self, stream=None):
        super().__init__()
        self._stream = stream

    def format(self, record: logging.LogRecord) -> str:
        name = record.name
        if name.startswith(_ROOT + "."):
            name = name[len(_ROOT) + 1:]
        fields = getattr(record, "fields", None) or {}
        return f"[{name}] {record.getMessage()}{_fmt_fields(fields)}"

    def emit(self, record: logging.LogRecord):
        try:
            stream = self._stream if self._stream is not None else sys.stderr
            stream.write(self.format(record) + "\n")
            stream.flush()
        except Exception:
            self.handleError(record)


class StructuredLogger:
    """Wraps a stdlib logger; forwards fields to both sink and tracer."""

    def __init__(self, logger: logging.Logger, component: str):
        self._logger = logger
        self._component = component

    def _log(self, level: int, msg: str, fields: Dict[str, Any]):
        self._logger.log(level, msg, extra={"fields": fields})
        _trace.event(f"log.{self._component}", msg=msg,
                     level=logging.getLevelName(level), **fields)

    def debug(self, msg: str, **fields):
        self._log(logging.DEBUG, msg, fields)

    def info(self, msg: str, **fields):
        self._log(logging.INFO, msg, fields)

    def warning(self, msg: str, **fields):
        self._log(logging.WARNING, msg, fields)

    def error(self, msg: str, **fields):
        self._log(logging.ERROR, msg, fields)


def setup(level: int = logging.INFO, stream=None):
    """Install the human-readable handler on the ``repro_torch`` root
    (once)."""
    global _CONFIGURED
    root = logging.getLogger(_ROOT)
    if not _CONFIGURED:
        root.addHandler(_Handler(stream))
        root.propagate = False
        _CONFIGURED = True
    root.setLevel(level)


def get_logger(component: str) -> StructuredLogger:
    """Namespaced structured logger; installs the default sink."""
    setup()
    return StructuredLogger(logging.getLogger(f"{_ROOT}.{component}"),
                            component)
