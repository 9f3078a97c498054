"""Bound tightness: rigorous CAA bound vs measured error of real k-bit runs,
across precisions and accumulation orders — quantifies the engine's
conservatism (a rigorous bound is useful only if it is within a small
factor of reality).

The counterpart of the JAX package's ``benchmarks/bound_tightness.py``:
the same dot product (256 sparse inputs against a 256 × 64 matrix of
trained scale, from ``RandomState(0)``), k ∈ {6, 8, 12, 16} × {sequential,
pairwise}, the same table, on ``--device``.

Run:  python -m repro_torch.benchmarks.bound_tightness [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.benchmarks import add_device_arg
from repro_torch.core import caa, formats, quantize
from repro_torch.launch.serve import resolve_device

KS = (6, 8, 12, 16)
ORDERS = ("sequential", "pairwise")


def operands(n=256, m=64):
    """The reference's x [n] (about half of it zero), W [n, m] and the
    exact x @ W, all f64 numpy."""
    rng = np.random.RandomState(0)
    x = rng.rand(n) * (rng.rand(n) > 0.5)
    W = rng.randn(n, m) / np.sqrt(n)
    return x, W, x @ W


def measure(x, W, exact, k, order, dev):
    """(measured max error of the k-bit dot in the given order, CAA bound
    max δ̄), both in units of the format's u."""
    fmt = formats.custom(k)
    cfg = caa.CaaConfig(u_max=fmt.u, emulate_k=k, acc_order=order)
    xt = torch.from_numpy(x).to(dev)
    Wt = torch.from_numpy(W).to(dev)
    res = caa.matmul(caa.weight(xt, cfg), caa.weight(Wt, cfg), cfg)
    dot = quantize.seq_dot if order == "sequential" else quantize.pairwise_dot
    emp = dot(xt[None], Wt, fmt)[0]
    meas = float((emp - torch.from_numpy(exact).to(dev)).abs().max()) / fmt.u
    return meas, float(res.dbar.max())


def run(dev="cuda"):
    dev = resolve_device(str(dev))
    x, W, exact = operands()
    print("\n== dot-product bound tightness (trained-scale weights) ==")
    print(f"{'k':>3s} {'order':>10s} {'measured(u)':>12s} {'bound(u)':>10s} "
          f"{'ratio':>7s}")
    rows = []
    for k in KS:
        for order in ORDERS:
            meas, bound = measure(x, W, exact, k, order, dev)
            print(f"{k:3d} {order:>10s} {meas:12.3g} {bound:10.3g} "
                  f"{bound / max(meas, 1e-9):7.1f}")
            rows.append((f"tightness_k{k}_{order}", 0.0,
                         bound / max(meas, 1e-9)))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.bound_tightness")
    add_device_arg(ap)
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
