#!/usr/bin/env python3
"""Audit of the f64 libms under the interval enclosures, on the CPU.

Reproduces the libm findings recorded in ROADMAP §3 (port faults against the
reference):

* where XLA's CPU ``tanh`` drifts beyond the reference's 4-ulp slop, and
  whether ``repro.core.interval.tanh`` / ``repro_torch.core.interval.tanh``
  enclose the true value (mpmath at 200 bits) there;
* how far the reference's ``gelu_tanh`` endpoint formula 0.5·x·(1+tanh y)
  is from the true value for x ≲ -3, and whether either package encloses;
* how often PyTorch's CPU f64 ``sqrt`` differs from numpy's correctly
  rounded one;
* whether PyTorch's first multi-threaded f64 ``exp`` on ``chip_smoke.py``'s
  10⁶ libm points agrees with numpy's, in fresh processes, with and
  without a single-threaded first call.

Run from the repository root:
``PYTHONPATH=src JAX_PLATFORMS=cpu python tools/libm_audit.py`` (add
``exp`` to run only the last audit). It imports both packages (like the
tests) and needs mpmath.
"""
from __future__ import annotations

import subprocess
import sys

import jax
import jax.numpy as jnp
import mpmath
import numpy as np
import torch

import repro  # noqa: F401  (f64 on)
from repro.core import interval as J
from repro_torch.core import interval as T

mpmath.mp.prec = 200


def _mp_inside(lo, hi, truth):
    return mpmath.mpf(float(lo)) <= truth <= mpmath.mpf(float(hi))


def tanh_audit():
    rng = np.random.RandomState(7)
    x = np.concatenate([rng.uniform(-40, 40, 15000), rng.randn(5000) * 3])
    xla = np.asarray(jnp.tanh(jnp.asarray(x)))
    ulps = np.abs(xla - np.tanh(x)) / np.spacing(np.abs(np.tanh(x)))
    ji = J.tanh(J.Interval(jnp.asarray(x), jnp.asarray(x)))
    ti = T.tanh(T.Interval(torch.from_numpy(x), torch.from_numpy(x)))
    jlo, jhi = np.asarray(ji.lo), np.asarray(ji.hi)
    misses, port_ok = [], 0
    check = list(rng.choice(x.size, 3000, replace=False))
    for i in range(x.size):
        if ulps[i] > 3:
            check.append(i)
    for i in sorted(set(check)):
        truth = mpmath.tanh(mpmath.mpf(x[i]))
        if not _mp_inside(jlo[i], jhi[i], truth):
            gap = max(mpmath.mpf(float(jlo[i])) - truth,
                      truth - mpmath.mpf(float(jhi[i])))
            misses.append((float(x[i]), float(gap)))
        port_ok += _mp_inside(ti.lo[i], ti.hi[i], truth)
    print(f"tanh: {x.size} points, XLA up to {ulps.max():.0f} ulps from "
          f"numpy; reference encloses the true value except at "
          f"{len(misses)} of {len(set(check))} checked: {misses}; the port "
          f"encloses it at {port_ok} of {len(set(check))}")


def gelu_audit():
    for x in (-2.0, -3.46288838, -5.0, -8.0):
        truth = 0.5 * mpmath.mpf(x) * (1 + mpmath.tanh(
            mpmath.sqrt(2 / mpmath.pi) * (x + mpmath.mpf(0.044715) * x ** 3)))
        ref = float(jax.nn.gelu(jnp.asarray(x), approximate=True))
        ulp = float(np.spacing(abs(float(truth))))
        ji = J.gelu_tanh(J.Interval(jnp.asarray([x]), jnp.asarray([x])))
        ti = T.gelu_tanh(T.Interval(torch.tensor([x], dtype=torch.float64),
                                    torch.tensor([x], dtype=torch.float64)))
        print(f"gelu_tanh({x}): reference value {abs(ref - float(truth)) / ulp:.0f}"
              f" ulps off; reference encloses "
              f"{_mp_inside(ji.lo[0], ji.hi[0], truth)}, port encloses "
              f"{_mp_inside(ti.lo[0], ti.hi[0], truth)}")


def sqrt_audit():
    x = np.random.RandomState(0).rand(100000) * 1000
    diff = torch.sqrt(torch.from_numpy(x)).numpy() != np.sqrt(x)
    print(f"sqrt: PyTorch's CPU f64 sqrt differs from numpy's at "
          f"{diff.mean():.2%} of 100000 values")


_EXP_CHILD = """
import sys, numpy as np, torch
sys.path.insert(0, ".")
from chip_smoke import libm_points
x = libm_points(torch)
x = x[x < 700]
if sys.argv[1] == "warm":
    torch.set_num_threads(1); torch.exp(x[:1000]); torch.set_num_threads(8)
e = torch.exp(x).numpy(); n = np.exp(x.numpy())
fin = n > 0
print(int((np.abs(e - n)[fin] / np.spacing(n[fin])).max()))
"""


def exp_race_audit(runs: int = 12):
    for mode in ("cold", "warm"):
        worst = [int(subprocess.run(
            [sys.executable, "-c", _EXP_CHILD, mode], check=True,
            capture_output=True, text=True).stdout) for _ in range(runs)]
        print(f"exp, {mode} first call, {runs} fresh processes: max ulps "
              f"from numpy per process {worst}")


if __name__ == "__main__":
    if sys.argv[1:] != ["exp"]:
        tanh_audit()
        gelu_audit()
        sqrt_audit()
    exp_race_audit()
