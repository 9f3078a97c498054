"""Rigorous precision analysis of a transformer LM (reduced config), on
the port.

Runs the CAA engine through a full LM (the same model code the port
serves) and reports:
  * per-layer error growth (the trace),
  * Table-I-style actual-error of an emulated k-bit run,
  * MoE router decision margins (the routing-flip analogue of the paper's
    top-1 analysis) for a model that has routers,
  * for RWKV6, its recurrence bounded by the fixpoint rule
    (``caa.scan_affine_fixpoint``).

The counterpart of the JAX package's ``examples/lm_precision_analysis.py``;
``main`` analyses the reference's three archs.

Run:  python -m repro_torch.examples.lm_precision_analysis [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import configs
from repro_torch.benchmarks import add_device_arg
from repro_torch.core import caa
from repro_torch.core.backend import CaaOps
from repro_torch.launch.serve import resolve_device
from repro_torch.models import transformer as T

#: the reference's archs: a dense GQA model, an MoE one (router margins)
#: and an RWKV one (the recurrence under the fixpoint rule)
ARCHS = ("qwen2_7b", "mixtral_8x22b", "rwkv6_1p6b")


def analyse(arch: str, k: int = 12, dev="cuda"):
    dev = resolve_device(str(dev))
    cfg = configs.get(arch).SMOKE
    params = T.init_params(cfg, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    ccfg = caa.CaaConfig(u_max=2.0 ** (1 - k), emulate_k=k)
    bk = CaaOps(ccfg)
    tokens = torch.randint(0, cfg.vocab, (1, 16),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    logits, _ = T.forward(bk, params, cfg, tokens)
    a_abs, a_rel = caa.actual_error_in_u(logits, ccfg.u_max)

    print(f"\n=== {arch} (reduced config), emulated k={k}")
    print(f"  logits: actual abs err ≤ {float(a_abs.max()):.4g}u "
          f"(u = 2^{1-k})")
    print(f"  per-layer trace ({len(bk.trace)} records):")
    for r in bk.trace[:6]:
        print(f"    {r.name:28s} kind={r.kind:8s} |range|≤{r.out_mag:9.3g} "
              f"δ̄={r.max_dbar:9.3g}u")
    routers = [r for r in bk.trace if r.kind == "router"]
    for r in routers[:4]:
        print(f"    router {r.name}: min margin {r.extra['min_margin']:.4f} "
              f"→ routing flip-safe for u ≤ {r.extra['flip_safe_if_u_le']:.3g}")
    return {"arch": arch, "k": k, "max_abs_u": float(a_abs.max()),
            "trace": len(bk.trace), "routers": len(routers)}


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.lm_precision_analysis")
    add_device_arg(ap)
    dev = ap.parse_args(argv).device
    return {"analysed": [analyse(a, dev=dev) for a in ARCHS]}


if __name__ == "__main__":
    main()
