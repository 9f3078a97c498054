"""Quickstart — the paper's full workflow in one script, on the port.

1. Train the paper's Digits classifier (synthetic glyph MNIST stand-in) at
   its full width 784→700→256→10, with PyTorch autograd.
2. Run the CAA analysis (Table-I semantics): rigorous abs/rel error of the
   emulated k=8 run + the parametric required-k decision for p* = 0.60.
3. Serve at the certified precision and verify that every certified
   prediction matches the exact model — the paper's headline claim.

The counterpart of the JAX package's ``examples/quickstart.py``. Its 64
certified inferences run as one batched CAA pass (each input's bounds are
those of its own pass); the analysis time is one eager call after a
warm-up call, synchronised on the device.

Run:  python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.benchmarks import add_device_arg, steady, sync
from repro_torch.certify.__main__ import train_digits
from repro_torch.core import analyze, caa, precision
from repro_torch.core.backend import CaaOps, TorchOps
from repro_torch.data import synthetic_digits
from repro_torch.launch.serve import resolve_device
from repro_torch.models import paper_models as PM

P_STAR = 0.60
N_CERT = 64


def accuracy(params, imgs, labels) -> float:
    dev = params["w1"].device
    with torch.no_grad():
        pred = PM.digits_logits(TorchOps(), params,
                                torch.from_numpy(imgs).to(dev)).argmax(-1)
    return float((pred.cpu().numpy() == labels).mean())


def analyse(params, imgs):
    """Steps 2 and 3 on trained ``params`` (on their device): the k = 8
    analysis of image 0, ``decide_iterative`` at p* = 0.6, and the
    certified decisions of the first 64 images against the f64 model.
    Returns a dict of what the script prints."""
    dev = params["w1"].device
    x = torch.from_numpy(imgs[0].astype(np.float64)).to(dev)
    cfg = caa.CaaConfig(u_max=2 ** -7, emulate_k=8)

    def run():
        probs = PM.digits_forward(CaaOps(cfg), params, caa.weight(x, cfg))
        return caa.actual_error_in_u(probs, 2 ** -7)

    (a_abs, a_rel), dt = steady(run, dev)
    max_rel = torch.where(torch.isfinite(a_rel), a_rel,
                          torch.zeros_like(a_rel)).max()

    def bounds_at(u):
        c = caa.CaaConfig(u_max=u)
        out = PM.digits_forward(CaaOps(c), params, caa.weight(x, c))
        return caa.worst(out)

    decision = precision.decide_iterative(bounds_at, p_star=P_STAR)

    xs = torch.from_numpy(imgs[:N_CERT].astype(np.float64)).to(dev)
    c64 = analyze.batch_config(cfg, N_CERT)
    p8 = PM.digits_forward(CaaOps(c64), params, caa.weight(xs, c64))
    with torch.no_grad():
        ref = PM.digits_forward(TorchOps(torch.float64), params, xs)
    pred = p8.val.argmax(-1).cpu().numpy()
    exact = ref.argmax(-1).cpu().numpy()
    lo, hi = p8.exact.lo.cpu().numpy(), p8.exact.hi.cpu().numpy()
    certs = [precision.classification_safe(lo[i], hi[i], int(pred[i]))
             for i in range(N_CERT)]
    n_cert = sum(certs)
    n_ok = sum(int(exact[i] == pred[i]) for i in range(N_CERT) if certs[i])
    sync(dev)
    return {"max_abs_u": float(a_abs.max()), "max_rel_u": float(max_rel),
            "seconds": dt, "decision": decision,
            "required_k": decision.required_k, "n_cert": n_cert,
            "n_ok": n_ok, "certs": certs, "pred": pred.tolist()}


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.quickstart")
    add_device_arg(ap)
    dev = resolve_device(ap.parse_args(argv).device)

    print("=== 1. train Digits (paper: 0.7M params, 3 Dense + 2 ReLU + softmax)")
    imgs, labels = synthetic_digits.make_dataset(800, seed=0)
    params = PM.init_digits(torch.Generator().manual_seed(0), device=dev)
    n = sum(int(p.numel()) for p in params.values())
    # SGD on the mean cross-entropy, 400 batches of 64 (the reference's)
    params = train_digits(params, imgs, labels, steps=400)
    acc = accuracy(params, imgs, labels)
    print(f"    {n/1e6:.2f}M params, train accuracy {acc:.1%}")

    print("\n=== 2. CAA analysis at k=8 (Table-I semantics)")
    res = analyse(params, imgs)
    print(f"    max abs error {res['max_abs_u']:.3g}u, "
          f"max rel {res['max_rel_u']:.3g}u "
          f"(paper: 1.1u / 3.4u), analysis {res['seconds']*1e3:.0f} ms "
          f"(paper: 12 s/class)")
    print("    " + res["decision"].explain())

    print("\n=== 3. certified low-precision inference")
    n_cert, n_ok = res["n_cert"], res["n_ok"]
    print(f"    {n_cert}/{N_CERT} inputs certified at k=8; "
          f"{n_ok}/{n_cert} certified decisions match the exact model "
          f"({'OK' if n_ok == n_cert else 'VIOLATION'})")
    return dict(res, params=params, n_params=n, train_accuracy=acc,
                device=str(dev))


if __name__ == "__main__":
    main()
