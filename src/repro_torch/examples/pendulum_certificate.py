"""Pendulum (paper §V-c): rigorous absolute error bound for a Lyapunov-
function network, ready to feed a formal verification pipeline.

The paper: two Dense + two tanh, input on [-6,6]²; their tool emits an
absolute bound in ~100 ms and no relative bound (the output range contains
zero). This reproduces exactly that, and additionally emits the bound as a
function of precision k — the certificate a verifier like [19] consumes.

The counterpart of the JAX package's ``examples/pendulum_certificate.py``;
the network is trained with PyTorch autograd from a ``torch.Generator``
seed, and the analysis time is one eager call after a warm-up call.

Run:  python -m repro_torch.examples.pendulum_certificate [--device cpu]
"""
from __future__ import annotations

import argparse
import math

import torch

from repro_torch.benchmarks import add_device_arg, steady
from repro_torch.benchmarks.table1 import train_pendulum
from repro_torch.core import caa
from repro_torch.core.backend import CaaOps
from repro_torch.launch.serve import resolve_device
from repro_torch.models import paper_models as PM

KS = (8, 11, 16, 24)


def certificate(params):
    """The analysis on trained ``params`` over [-6, 6]²: a dict with the
    absolute and relative bounds at u_max = 2^-7, the output range, the
    seconds of a steady call and δ(k) for each k of :data:`KS`."""
    dev = params["w1"].device
    cfg = caa.CaaConfig(u_max=2 ** -7)
    lo6 = torch.full((2,), -6.0, dtype=torch.float64, device=dev)
    hi6 = -lo6

    out, dt = steady(lambda: PM.pendulum_forward(
        CaaOps(cfg), params, caa.from_range(lo6, hi6)), dev)
    d, e = caa.worst(out)
    delta = {}
    for k in KS:
        c = caa.CaaConfig(u_max=2.0 ** (1 - k))
        o = PM.pendulum_forward(CaaOps(c), params, caa.from_range(lo6, hi6))
        delta[k] = caa.worst(o)[0] * 2.0 ** (1 - k)
    return {"dbar_u": d, "ebar_u": e, "seconds": dt,
            "range": (float(out.exact.lo[0]), float(out.exact.hi[0])),
            "delta": delta}


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.pendulum_certificate")
    add_device_arg(ap)
    dev = resolve_device(ap.parse_args(argv).device)
    # width 8: [19] does not state its width; the interval-input bound
    # scales ~linearly with it (64 -> ~1.8e3 u, 8 -> the paper's regime)
    params = PM.init_pendulum(torch.Generator().manual_seed(2), h=8,
                              device=dev)
    # a Lyapunov fit as in the paper's source [19]: trained weights are
    # small and smooth, which is what makes a ~1u absolute bound attainable
    params = train_pendulum(params)

    print("=== Pendulum Lyapunov network (trained), input range [-6, 6]² ===")
    res = certificate(params)
    print(f"absolute error bound: {res['dbar_u']:.4g} u  (paper: 1.7u; "
          f"{res['seconds']*1e3:.0f} ms, paper: 100 ms)")
    print(f"relative bound exists: {math.isfinite(res['ebar_u'])} "
          "(paper: no — output interval contains zero)")
    print(f"output range: [{res['range'][0]:.4g}, {res['range'][1]:.4g}]")

    print("\ncertificate |V̂(x) − V(x)| ≤ δ(k) for the verifier:")
    for k, dk in res["delta"].items():
        print(f"  k={k:2d}: δ = {dk:.3e}")
    return dict(res, device=str(dev))


if __name__ == "__main__":
    main()
