"""Numeric-health stats of a served product on the card, into a device log.

A violation monitor (:mod:`repro_torch.obs.monitors`) observes every
matmul product the certified serving backends compute: its largest finite
magnitude, smallest nonzero magnitude and the counts of elements beyond the
certified format's max_finite, below its min_normal and non-finite — the
stats of :func:`repro_torch.core.quantize.numeric_health`, which is this
module's plain version. The JAX package hands them to the host through one
callback per matmul; here they go into one row of a device log, and the
host reads the log back once per serving step.

* :func:`numeric_health` (``csrc/numeric_health.cu``): the CUDA kernel;
  reads the f32 product once and folds the five stats into row ``r`` of the
  log with integer atomics only (the same bits on every run).
* :func:`numeric_health_dispatch`: what the monitor calls — the plain
  version for tensors on the CPU, the kernel for tensors on the card, or an
  exception. No fallback.

A log row is four int64 words (:data:`ROW_WORDS`): ``n_over``, ``n_under``,
``n_nonfinite``, then ``max_abs`` and ``min_nonzero`` as two f32 in the
last word (low half first). :func:`init_rows` is a row before any
observation (max_abs 0, min_nonzero +inf, counts 0); :func:`unpack_rows`
reads rows copied to the host.

A port-only kernel: the JAX package computes these stats with XLA, so it
replaces no TPU kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Tuple

import torch

from repro_torch.core.quantize import numeric_health as numeric_health_ref
from repro_torch.core.quantize import pow2
from repro_torch.kernels import _build

_P = ctypes.c_void_p

#: int64 words of one log row
ROW_WORDS = 4
_ROW_BYTES = 8 * ROW_WORDS
_COUNTS = ("n_over", "n_under", "n_nonfinite")


@functools.lru_cache(maxsize=None)
def threshold_bits(k: int, emax: int, emin: int) -> Tuple[int, int]:
    """The f32 bit patterns of max_finite = (2 - 2^(1-k))·2^emax and
    min_normal = 2^emin, computed as the plain version computes them (in
    f32: for k ≥ 26 max_finite is +inf)."""
    dt = torch.float32
    max_fin = (2.0 - pow2(1 - int(k), dt)) * pow2(int(emax), dt)
    min_norm = pow2(int(emin), dt)
    return (int(max_fin.view(torch.int32)) & 0xFFFFFFFF,
            int(min_norm.view(torch.int32)) & 0xFFFFFFFF)


def init_rows(n: int, device) -> torch.Tensor:
    """``n`` log rows before any observation: counts 0, max_abs 0,
    min_nonzero +inf."""
    rows = torch.zeros((n, ROW_WORDS), dtype=torch.int64, device=device)
    rows.view(torch.float32)[:, 2 * ROW_WORDS - 1] = float("inf")
    return rows


def pack_row(stats: Dict[str, torch.Tensor], row: torch.Tensor) -> None:
    """Write the plain version's stats (0-d tensors) into ``row``, an int64
    [ROW_WORDS] view of the log."""
    row[:3] = torch.stack([stats[c].to(torch.int64) for c in _COUNTS])
    row.view(torch.float32)[2 * ROW_WORDS - 2:] = torch.stack(
        [stats["max_abs"], stats["min_nonzero"]]).to(torch.float32)


def unpack_rows(rows: torch.Tensor) -> List[Dict[str, float]]:
    """Rows copied to the host → one stats dict each (Python floats and
    ints), in row order."""
    counts = rows[:, :3].tolist()
    vals = rows.view(torch.float32)[:, 2 * ROW_WORDS - 2:].tolist()
    return [{"max_abs": mx, "min_nonzero": mn, "n_over": c[0],
             "n_under": c[1], "n_nonfinite": c[2]}
            for c, (mx, mn) in zip(counts, vals)]


def _lib():
    lib = _build.load("numeric_health")
    if not getattr(lib, "_typed", False):
        lib.repro_numeric_health_f32.argtypes = [
            _P, ctypes.c_longlong, ctypes.c_uint, ctypes.c_uint, _P, _P]
        lib.repro_numeric_health_f32.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check_log(buf: torch.Tensor, row: int, device) -> None:
    if (buf.dtype != torch.int64 or buf.dim() != 2
            or buf.shape[1] != ROW_WORDS or not buf.is_contiguous()):
        raise ValueError(f"log: needs a contiguous int64 [rows, {ROW_WORDS}]"
                         f" tensor, got {buf.dtype} {tuple(buf.shape)}")
    if buf.device != device:
        raise ValueError(f"log on {buf.device}, tensor on {device}")
    if not 0 <= row < buf.shape[0]:
        raise IndexError(f"log row {row} outside [0, {buf.shape[0]})")


def numeric_health(x: torch.Tensor, k: int, emax: int, emin: int,
                   buf: torch.Tensor, row: int) -> None:
    """The CUDA kernel: the stats of the f32 tensor ``x`` (contiguous, on
    the card) against (k, emax, emin), folded into row ``row`` of ``buf``
    (int64 [rows, ROW_WORDS] on the same card, the row initialised as
    :func:`init_rows` makes it). Launches on the current stream; raises on a
    refused launch. ``numeric_health.launches`` counts launches."""
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise ValueError(f"numeric_health: needs a float32 CUDA tensor, got "
                         f"{x.dtype} on {x.device}")
    if not x.is_contiguous():
        raise ValueError("numeric_health: needs a contiguous tensor")
    _check_log(buf, row, x.device)
    max_bits, min_bits = threshold_bits(int(k), int(emax), int(emin))
    rc = _lib().repro_numeric_health_f32(
        x.data_ptr(), x.numel(), max_bits, min_bits,
        buf.data_ptr() + _ROW_BYTES * row, _build.stream_ptr(x.device))
    _build.check(rc, "numeric_health")
    numeric_health.launches += 1


numeric_health.launches = 0


def numeric_health_dispatch(x: torch.Tensor, k: int, emax: int, emin: int,
                            buf: torch.Tensor, row: int) -> None:
    """Row ``row`` of the log ``buf`` ← the stats of ``x`` against (k,
    emax, emin): the plain version for tensors on the CPU, the kernel for
    tensors on the card; raises otherwise."""
    if x.device.type == "cpu":
        _check_log(buf, row, x.device)
        if x.dtype != torch.float32:
            raise ValueError(f"numeric_health: the log holds f32 stats, got "
                             f"{x.dtype}")
        pack_row(numeric_health_ref(x, k, emax, emin), buf[row])
        return
    if x.device.type == "cuda":
        numeric_health(x.contiguous(), k, emax, emin, buf, row)
        return
    raise ValueError(f"numeric_health: no kernel for {x.device}")
