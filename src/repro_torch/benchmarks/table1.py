"""Table I reproduction: per-model max abs/rel error (units of u), analysis
time, and required precision k at p* = 0.60 — the paper's headline table.

The counterpart of the JAX package's ``benchmarks/table1.py``: the same
three rows, the same printed table and the same defaults, on ``--device``.

Paper reference values (u < 2^-7):
  Digits    1.1u abs / 3.4u rel / 12 s per class   / k = 8
  MobileNet 22.4u    / 11.5u    / 4.2 h per class  / k = 8
  Pendulum  1.7u     / (none)   / 100 ms           / (n/a)

Rows: a *trained* Digits model (synthetic glyphs, 784-128-64-10), a conv
classifier (MobileNet stand-in) and the Pendulum net (trained as a
Lyapunov fit, h = 8) — the paper's 'actual error of the FP value'
semantics (an emulated k = 8 run, rigorously enclosed) plus the parametric
required-k pipeline. Params come from ``torch.Generator`` seeds and are
trained with PyTorch autograd, so the numbers are the port's own; each
row's analysis is a function of its params (:func:`digits_row`,
:func:`convnet_row`, :func:`pendulum_row`), which is how the tests hold
them against the reference's on the same params.

Timing: the reference's per-class times are jitted steady state; here a
row's time is one eager analysis after one warm-up call, synchronised on
the device (:func:`repro_torch.benchmarks.steady`).

Run:  python -m repro_torch.benchmarks.table1 [--device cpu]
"""
from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from repro_torch.benchmarks import add_device_arg, steady
from repro_torch.certify.__main__ import train_digits
from repro_torch.core import caa, precision
from repro_torch.core.backend import CaaOps, TorchOps
from repro_torch.data import synthetic_digits
from repro_torch.launch.serve import resolve_device
from repro_torch.models import paper_models as PM

PAPER = {"Digits": "paper: 1.1u/3.4u/12s/k=8",
         "ConvNet": "paper MobileNet: 22.4u/11.5u/4.2h",
         "Pendulum": "paper: 1.7u abs, no rel, 100ms"}


def _f64(x, dev):
    return torch.as_tensor(np.asarray(x, np.float64)).to(dev)


def _analyze_point(forward, params, x, k=8):
    """One emulated k-bit analysis of input ``x`` (numpy, on the params'
    device): (max actual abs error in u, max finite actual rel error in u
    or -1, seconds of a steady call, the output CaaTensor)."""
    cfg = caa.CaaConfig(u_max=2.0 ** (1 - k), emulate_k=k)
    dev = next(iter(v for v in params.values()
                    if torch.is_tensor(v))).device
    xv = _f64(x, dev)

    def run():
        out = forward(CaaOps(cfg), params, caa.weight(xv, cfg))
        return out, caa.actual_error_in_u(out, cfg.u_max)

    (out, (a_abs, a_rel)), dt = steady(run, dev)
    rel = torch.where(torch.isfinite(a_rel), a_rel,
                      torch.full_like(a_rel, -1.0))
    return float(a_abs.max()), float(rel.max()), dt, out


def train_pendulum(params, steps=800, lr=0.05):
    """Fit V(θ,ω) ≈ a quadratic Lyapunov candidate on [-6,6]² (as [19]):
    SGD on the mean squared error, 256 points a step drawn by
    ``RandomState(i)``, in PyTorch autograd."""
    dev = params["w1"].device
    bk = TorchOps()
    for i in range(steps):
        x = torch.from_numpy(np.random.RandomState(i).uniform(
            -6, 6, (256, 2))).float().to(dev)
        th, om = x[..., 0], x[..., 1]
        target = 0.05 * (th * th + om * om + th * om)
        ps = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        v = PM.pendulum_forward(bk, ps, x)[..., 0]
        loss = torch.mean((v - target) ** 2)
        grads = torch.autograd.grad(loss, list(ps.values()))
        params = {k: (p - lr * g).detach()
                  for (k, p), g in zip(ps.items(), grads)}
    return params


def digits_row(params, imgs, labels):
    """The Digits row on trained ``params``: the k = 8 analysis of the
    first image of each class, and ``decide_iterative`` at p* = 0.6 on
    image 0. Returns (name, max abs u, max rel u, mean seconds a class,
    required k (-1 when undecidable), note)."""
    dev = params["w1"].device
    per_abs, per_rel, per_t, top1_rel = [], [], [], []
    for cls in range(10):
        idx = int(np.nonzero(labels == cls)[0][0])
        a, r, dt, out = _analyze_point(PM.digits_forward, params, imgs[idx])
        per_abs.append(a)
        per_rel.append(r)
        per_t.append(dt)
        # paper: "on the top-1 choice the relative error bounds are quite
        # tight, while on the other elements ... less good"
        _, a_rel = caa.actual_error_in_u(out, 2 ** -7)
        top1 = int(torch.argmax(out.val))
        top1_rel.append(float(a_rel[..., top1].max()))
    x0 = _f64(imgs[0], dev)

    def bounds_at(u):
        cfg = caa.CaaConfig(u_max=u)
        out = PM.digits_forward(CaaOps(cfg), params, caa.weight(x0, cfg))
        return caa.worst(out)

    try:
        req_k = precision.decide_iterative(bounds_at,
                                           p_star=0.60).required_k
    except ValueError:
        req_k = -1
    return ("Digits", max(per_abs), max(per_rel), float(np.mean(per_t)),
            req_k, f"top1-rel={max(top1_rel):.3g}u; {PAPER['Digits']}")


def convnet_row(params, imgs):
    """The ConvNet row: the k = 8 analysis of image 0 as a 28×28×1 map."""
    a, r, dt, _ = _analyze_point(PM.convnet_forward, params,
                                 imgs[0].reshape(1, 28, 28, 1))
    return ("ConvNet", a, r, dt, None, PAPER["ConvNet"])


def pendulum_row(params):
    """The Pendulum row: δ̄ and ε̄ over the input box [-6, 6]² at
    u_max = 2^-7 (no emulation), ε̄ NaN where it is not finite."""
    cfg = caa.CaaConfig(u_max=2 ** -7)
    dev = params["w1"].device
    lo = torch.full((2,), -6.0, dtype=torch.float64, device=dev)

    def pend():
        out = PM.pendulum_forward(CaaOps(cfg), params,
                                  caa.from_range(lo, -lo))
        return caa.worst(out)

    (d, e), dt = steady(pend, dev)
    return ("Pendulum", d, float("nan") if not math.isfinite(e) else e,
            dt, None, PAPER["Pendulum"])


def print_table(rows):
    print("\n== Table I analog (u per 2^-7 unless noted) ==")
    print(f"{'model':10s} {'max_abs(u)':>12s} {'max_rel(u)':>12s} "
          f"{'time(s)':>9s} {'req_k':>6s}  note")
    for name, a, r, t, k, note in rows:
        print(f"{name:10s} {a:12.3g} {r:12.3g} {t:9.3f} "
              f"{str(k) if k else '-':>6s}  {note}")


def run(dev="cuda"):
    """The three rows on ``dev``: trains Digits (784-128-64-10, 600
    glyphs, 400 steps) and Pendulum (h = 8, 800 steps), inits the ConvNet
    (c1 8, c2 16), prints the table and returns the CSV rows
    (``table1_<model>``, µs a call, max abs u)."""
    dev = resolve_device(str(dev))
    imgs, labels = synthetic_digits.make_dataset(600, seed=0)
    params = PM.init_digits(torch.Generator().manual_seed(0), h1=128, h2=64,
                            device=dev)
    params = train_digits(params, imgs, labels, steps=400)
    cparams = PM.init_convnet(torch.Generator().manual_seed(1), img=28,
                              c1=8, c2=16, device=dev)
    # width 8: [19] does not state its width; the interval-input bound
    # scales ~linearly with it (64 -> ~1.8e3 u, 8 -> near the paper's regime)
    pparams = train_pendulum(PM.init_pendulum(
        torch.Generator().manual_seed(2), h=8, device=dev))
    rows = [digits_row(params, imgs, labels), convnet_row(cparams, imgs),
            pendulum_row(pparams)]
    print_table(rows)
    return [(f"table1_{name}", t * 1e6, a) for name, a, _, t, _, _ in rows]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.benchmarks."
                                 "table1")
    add_device_arg(ap)
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
