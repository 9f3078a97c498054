"""The paper's drivers on the port: Table I, the tightness of the CAA
bound and the speed of the analysis against model size.

The counterparts of the JAX package's ``benchmarks/`` scripts of the same
names, with the same rows, tables, arguments and defaults, plus
``--device`` (default ``cuda``; ``cpu`` runs them on the host):

    python -m repro_torch.benchmarks.table1 [--device cpu]
    python -m repro_torch.benchmarks.bound_tightness
    python -m repro_torch.benchmarks.analysis_speed
    python -m repro_torch.benchmarks.run      # all three, CSV + bench file

The reference times jitted functions at steady state; the port runs
eagerly, so a timed call follows one warm-up call of the same function and
ends in a device synchronise (:func:`steady`).
"""
from __future__ import annotations

import argparse
import time

import torch


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="run on this device (default cuda; cpu runs on "
                         "the host)")


def sync(dev) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def steady(fn, dev, reps: int = 1):
    """(result, seconds a call): one warm-up call of ``fn``, then ``reps``
    timed calls, each run ended by a synchronise on ``dev``."""
    out = fn()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    sync(dev)
    return out, (time.perf_counter() - t0) / reps
