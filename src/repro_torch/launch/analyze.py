"""CLI: rigorous precision analysis of an architecture (PyTorch).

The counterpart of the JAX package's ``python -m repro.launch.analyze``::

  PYTHONPATH=src python -m repro_torch.launch.analyze --arch qwen2_7b --k 12
  PYTHONPATH=src python -m repro_torch.launch.analyze --arch mixtral_8x22b \
      --k 10 --seq 16 --routers

Runs the arch's SMOKE configuration under :class:`repro_torch.core.backend.
CaaOps` with the target-format emulation and reports the per-layer trace,
the rigorous actual error of the emulated run, the parametric bounds and,
with ``--routers``, the MoE router decision margins (the route is fixed
from the emulated values; it is flip-safe for every u below the record's
``flip_safe_if_u_le``). The params are the port's seeded ``init_params``
(``torch.Generator`` seed 0), the tokens the reference's draw for seed 1
(:func:`repro_torch.certify.tokens.profile_tokens`), and a modality
frontend's inputs (Whisper's frames, PaliGemma's patches) the reference's
draw from ``np.random.RandomState(0)``. Runs on the card unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.certify.lm import frontend_kwargs
from repro_torch.certify.tokens import profile_tokens
from repro_torch.core import caa
from repro_torch.core.backend import CaaOps
from repro_torch.models import transformer as T


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.analyze")
    ap.add_argument("--arch", default="qwen2_7b")
    ap.add_argument("--k", type=int, default=12,
                    help="emulated mantissa bits (u = 2^{1-k})")
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--routers", action="store_true",
                    help="print MoE router flip-safety records")
    ap.add_argument("--trace", type=int, default=8,
                    help="how many trace records to print")
    ap.add_argument("--device", default="cuda",
                    help="where the analysis runs (cuda | cpu)")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to analyse on the CPU")
    cfg = configs.get(args.arch).SMOKE
    params = T.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    ccfg = caa.CaaConfig(u_max=2.0 ** (1 - args.k), emulate_k=args.k)
    bk = CaaOps(ccfg)
    tokens = profile_tokens(1, args.batch, args.seq, cfg.vocab, dev)
    kwargs = frontend_kwargs(cfg, args.batch, 0, dev)

    logits, _ = T.forward(bk, params, cfg, tokens, **kwargs)
    a_abs, a_rel = caa.actual_error_in_u(logits, ccfg.u_max)
    d, e = caa.worst(logits)

    print(f"=== {args.arch} (reduced config) — emulated k={args.k}, "
          f"u = 2^{1 - args.k} ===")
    print(f"logits: certified actual |error| ≤ {float(a_abs.max()):.4g} u")
    fin = torch.where(torch.isfinite(a_rel), a_rel, 0.0)
    print(f"        top-anything relative     ≤ {float(fin.max()):.4g} u "
          f"(where finite)")
    print(f"parametric bounds (units of u): δ̄ = {d:.4g}, ε̄ = {e:.4g} "
          f"{'(saturated — use the per-run mode above)' if not np.isfinite(d) else ''}")
    print(f"\nper-layer trace ({len(bk.trace)} records, first {args.trace}):")
    for r in bk.trace[: args.trace]:
        print(f"  {r.name:30s} {r.kind:8s} |range|≤{r.out_mag:9.3g}")
    routers = [r for r in bk.trace if r.kind == "router"]
    if args.routers:
        print(f"\nrouter records ({len(routers)}):")
        for r in routers:
            print(f"  {r.name}: min margin {r.extra['min_margin']:.4f}, "
                  f"flip-safe for u ≤ {r.extra['flip_safe_if_u_le']:.3g}")
    return {"abs_u": float(a_abs.max()), "rel_u": float(fin.max()),
            "dbar": d, "ebar": e, "trace": bk.trace, "routers": routers}


if __name__ == "__main__":
    main()
