#!/usr/bin/env python3
"""Where a training step's device time goes, on one card.

Builds the port's train step (``repro_torch.launch.train.build_train_step``)
for Qwen2-7B at full width cut to ``--layers`` layers (seq × batch tokens,
seed-0 weights, the stateless stream), runs ``--warmup`` steps as
``train.main`` runs them, then traces ``--steps`` more with
``torch.profiler`` and prints one JSON line: the host ms of a step, and the
device ms of a step split by the step's own profiler ranges
(``train::update``, ``train::compress``; every other kernel of the step is
its loss and gradients, whose backward runs on autograd's thread) and by
kind of kernel (GEMMs, elementwise, reductions, index and sort — the
embedding's deterministic backward —, copies, other), with the device's
idle share between the traced steps' first and last kernels. Run from the
repository root on a machine with a card::

    python3 tools/train_step_split.py --layers 2 --seq 512 --batch 4
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

KINDS = (("gemm", ("gemm", "sm90", "cutlass", "cublas", "sgemm", "xmma")),
         ("index_sort", ("index", "scatter", "gather", "sort", "radix",
                         "embedding", "cub::")),
         ("reduce", ("reduce", "softmax", "logsumexp", "norm")),
         ("elementwise", ("elementwise", "vectorized", "unrolled")),
         ("copy", ("memcpy", "memset", "copy")))
RANGES = ("train::update", "train::compress")   # else: loss and grads


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def phase_of(event) -> str:
    """The step phase whose range encloses the op that launched ``event``'s
    kernels."""
    e = event
    while e is not None:
        if e.name in RANGES:
            return e.name[7:]
        e = e.cpu_parent
    return "loss_and_grads"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.data import pipeline
    from repro_torch.launch import serve, train

    if not torch.cuda.is_available():
        print("train_step_split: no CUDA device", file=sys.stderr)
        return 3
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG",
                          train.CUBLAS_WORKSPACE_CONFIG)
    serve.configure_precision()
    cfg = dataclasses.replace(configs.get("qwen2_7b").FULL,
                              n_layers=args.layers)
    total = args.warmup + args.steps
    tc = train.TrainConfig(seq=args.seq, global_batch=args.batch,
                           steps=total)
    dev = torch.device("cuda")
    step_fn, init_fn = train.build_train_step(cfg, tc, dev)
    state = init_fn(torch.Generator(device=dev).manual_seed(0))
    dc = pipeline.DataConfig(vocab=cfg.vocab, seq=args.seq,
                             global_batch=args.batch)

    def step(i):
        nonlocal state
        state, loss = step_fn(state, train.batch_for(cfg, dc, i, dev))
        return float(loss)

    for i in range(args.warmup):
        step(i)
    torch.cuda.synchronize()
    host_ms = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(args.warmup, total):
            t0 = time.perf_counter()
            step(i)
            host_ms.append(1e3 * (time.perf_counter() - t0))
    events = prof.events()
    by_kind, by_phase, by_name = (collections.Counter() for _ in range(3))
    n_kernels = 0
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        phase = phase_of(e)
        for k in e.kernels:
            n_kernels += 1
            by_kind[kind_of(k.name)] += k.duration
            by_name[k.name[:80]] += k.duration
            by_phase[phase] += k.duration
    # the device's own spans, less the ranges' device-side annotations
    spans = [e.time_range for e in events if e.device_type == DeviceType.CUDA
             and not e.name.startswith("train::")]
    busy_us = sum(by_kind.values())
    window_us = (max(r.end for r in spans) - min(r.start for r in spans)
                 if spans else 0)
    n = args.steps
    per = lambda c: {k: v / 1e3 / n for k, v in c.most_common()}  # noqa
    out = {
        "what": f"Qwen2-7B full width, {args.layers} layers, seq "
                f"{args.seq} x batch {args.batch}, remat, f32 (no TF32), "
                "deterministic; build_train_step's step_fn",
        "host_ms_per_step": statistics.median(host_ms),
        "device_ms_per_step": busy_us / 1e3 / n,
        "idle_share": 1 - busy_us / window_us if window_us else None,
        "kernels_per_step": n_kernels / n,
        "by_phase_ms": per(by_phase),
        "by_kind_ms": per(by_kind),
        "top_kernels_ms": dict(list(per(by_name).items())[:10]),
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
