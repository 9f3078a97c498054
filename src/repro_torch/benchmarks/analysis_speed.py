"""Analysis throughput vs the paper's reported times.

The paper: 12 s/class (Digits, 0.7M params) and 4.2 h/class (MobileNet,
27M params), bottlenecked by per-scalar MPFI allocation. The tensorised
engine analyses *by layer*, not by scalar — this measures steady-state
analysis time vs parameter count, and the certificate pipeline, mixed
precision, format synthesis and layer-stacked analysis around it.

The counterpart of the JAX package's ``benchmarks/analysis_speed.py``, with
its sections, rows and defaults, on ``--device``. PyTorch runs eagerly, so
what the reference measures of a JAX compilation has no counterpart and is
left out: the size ladder's compile column, the recompile side of the
format sweep (``gemm_format_sweep_recompile_s``) and the jit-cache-size
assertions. Every other time is one eager call after one warm-up call,
synchronised on the device (the probe ladder's "steady" probes are its
calls after the first). The serving rows run ``QuantJOps`` /
``MixedQuantJOps`` (the ``quant_matmul`` kernel on the card) and the format
sweep ``quant_matmul_format`` with a runtime format.

Run:  python -m repro_torch.benchmarks.analysis_speed [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import shutil
import tempfile
import time

import numpy as np
import torch

from repro_torch.benchmarks import add_device_arg, steady, sync
from repro_torch.core import analyze, caa
from repro_torch.core.backend import CaaOps, StackedCaaOps
from repro_torch.launch.serve import resolve_device
from repro_torch.models import paper_models as PM

SIZES = ((128, 64), (700, 256), (2048, 1024))


def _digits(dev, d_in=784, h1=700, h2=256):
    return PM.init_digits(torch.Generator().manual_seed(0), d_in, h1, h2,
                          device=dev)


def _time_analysis(h1, h2, dev, d_in=784, reps=3):
    """(parameter count, steady seconds of one CAA pass of the Digits
    model at widths d_in-h1-h2-10 on one point input)."""
    params = _digits(dev, d_in, h1, h2)
    n_params = sum(int(p.numel()) for p in params.values())
    cfg = caa.CaaConfig(u_max=2 ** -7)
    xv = torch.from_numpy(np.random.RandomState(0).rand(d_in)).to(dev)

    def run():
        out = PM.digits_forward(CaaOps(cfg), params, caa.weight(xv, cfg))
        return out.dbar, out.ebar

    _, st = steady(run, dev, reps)
    return n_params, st


def _class_ranges(n_classes=10, d_in=784, pad=0.02, seed=0):
    """Per-class input boxes [lo, hi] (numpy f64 [C, d_in])."""
    rng = np.random.RandomState(seed)
    lo = np.clip(rng.rand(n_classes, d_in) - pad, 0.0, 1.0)
    return lo, np.clip(lo + 2 * pad, None, 1.0)


def _bench_batched_vs_sequential(dev, h1=64, h2=32, n_classes=10, reps=3):
    """The paper's 'one run per class' loop vs one class-stacked CAA pass
    (``analyze.analyze_batched``)."""
    params = _digits(dev, 784, h1, h2)
    cfg = caa.CaaConfig(u_max=2 ** -11)
    lo, hi = (torch.from_numpy(t).to(dev) for t in _class_ranges(n_classes))

    def sequential():
        for c in range(n_classes):
            out = PM.digits_forward(CaaOps(cfg), params,
                                    caa.from_range(lo[c], hi[c]))
        return out.dbar

    def batched():
        return analyze.analyze_batched(
            PM.digits_forward, params, caa.from_range(lo, hi), cfg=cfg)

    _, t_seq = steady(sequential, dev, reps)
    _, t_bat = steady(batched, dev, reps)
    return t_seq, t_bat


def _bench_certified_store(dev, d_in=64, h1=64, h2=32, n_classes=10):
    """Certified-vs-uncached: full certify (analysis + probes + persist) vs
    the same request served from the content-addressed store. d_in is kept
    small enough that the classes actually certify, so the cold path pays
    the full multi-probe required-k search."""
    from repro_torch import certify

    params = _digits(dev, d_in, h1, h2)
    lo, hi = _class_ranges(n_classes, d_in=d_in, pad=0.01)
    los, his = list(lo), list(hi)
    root = tempfile.mkdtemp(prefix="certbench_")
    try:
        store = certify.CertificateStore(root)
        t0 = time.perf_counter()
        certify.certify(PM.digits_forward, params, los, his, p_star=0.6,
                        model_id="bench/digits", store=store)
        t_cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        cs = certify.certify(PM.digits_forward, params, los, his, p_star=0.6,
                             model_id="bench/digits", store=store)
        t_hot = time.perf_counter() - t0
        if not cs.meta["from_store"]:
            raise AssertionError("store should have served the re-request")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return t_cold, t_hot


def _bench_probe_ladder(dev, d_in=64, h1=64, h2=32, n_classes=10,
                        ks=(24, 20, 16, 12, 10, 8, 6, 4)):
    """The per-k eager re-analysis loop vs the probe ladder over the same
    k grid: (seconds a k of the loop, seconds of the ladder's first probe,
    seconds a later probe)."""
    from repro_torch.certify import batch as B

    params = _digits(dev, d_in, h1, h2)
    lo, hi = _class_ranges(n_classes, d_in=d_in, pad=0.01)
    x = B.stack_class_ranges(list(lo), list(hi), device=dev)

    def eager(k):
        cfg = dataclasses.replace(caa.DEFAULT_CONFIG, u_max=2.0 ** (1 - k))
        analyze.analyze_batched(PM.digits_forward, params, x, cfg=cfg)

    eager(ks[0])                       # the warm-up call
    sync(dev)
    t0 = time.perf_counter()
    for k in ks:
        eager(k)
    sync(dev)
    t_eager = time.perf_counter() - t0

    ladder = B.ProbeLadder(PM.digits_forward, params, x)
    t0 = time.perf_counter()
    ladder(ks[0])
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for k in ks[1:]:
        ladder(k)
    t_steady = (time.perf_counter() - t0) / max(len(ks) - 1, 1)
    return t_eager / len(ks), t_first, t_steady


MIXED_LAYER_K = {"dense1": 21, "dense2": 18, "dense3": 14, "softmax": 10}


def _bench_mixed_vs_uniform_serving(dev, d_in=64, h1=256, h2=128, batch=256,
                                    reps=20):
    """Serving time a batch of the certified backends: uniform
    ``QuantJOps`` vs ``MixedQuantJOps`` (scope-resolved per-layer k), both
    through the k-bit GEMM (``quant_matmul`` on the card); the mixed map's
    FLOP-weighted mean k is the real-silicon cost it would save."""
    from repro_torch.certify.mixed import flop_weighted_mean_k
    from repro_torch.launch.serve import MixedQuantJOps, QuantJOps

    params = _digits(dev, d_in, h1, h2)
    x = torch.from_numpy(np.random.RandomState(0).rand(batch, d_in)
                         .astype(np.float32)).to(dev)
    uniform_k = 21

    def timed(bk):
        with torch.no_grad():
            _, t = steady(lambda: PM.digits_forward(bk, params, x), dev,
                          reps)
        return t

    t_uni = timed(QuantJOps(uniform_k))
    t_mix = timed(MixedQuantJOps(MIXED_LAYER_K, uniform_k))
    flops = {"dense1": 2.0 * d_in * h1, "dense2": 2.0 * h1 * h2,
             "dense3": 2.0 * h2 * 10, "softmax": 4.0 * 10}
    mean_k = flop_weighted_mean_k(MIXED_LAYER_K, flops)
    return t_uni, t_mix, uniform_k, mean_k


def _bench_format_sweep_vs_mantissa(dev, d_in=64, h1=64, h2=32,
                                    n_classes=10):
    """Format synthesis (range pass + exponent-lattice descent + eager
    confirmation) vs the mantissa-only certification it extends — the cost
    of certifying (k, emin, emax) instead of k alone, on the same model."""
    from repro_torch.certify import batch as B
    from repro_torch.certify import formats as FS

    params = _digits(dev, d_in, h1, h2)
    lo, hi = _class_ranges(n_classes, d_in=d_in, pad=0.01)
    x = B.stack_class_ranges(list(lo), list(hi), device=dev)
    feasible = B.margin_feasibility(0.6)

    t0 = time.perf_counter()
    ks, _reports = B.required_k_batched(
        PM.digits_forward, params, x, feasible, k_max=24,
        ladder=B.ProbeLadder(PM.digits_forward, params, x))
    t_mantissa = time.perf_counter() - t0
    uniform_k = int(np.nanmax(ks))

    t0 = time.perf_counter()
    plan = FS.synthesize_formats(
        PM.digits_forward, params, x, feasible, uniform_k)
    t_formats = time.perf_counter() - t0
    if not plan.feasible:
        raise AssertionError("format synthesis found no feasible map")
    return t_mantissa, t_formats, plan.savings_bits(), plan.probes


def format_sweep(n_formats=8):
    """The reference's sweep of formats (k, emax, emin): k = 8.., exponent
    widths cycling 3, 4, 5, 6 bits."""
    return [(k, 2 ** (e - 1) - 1, 2 - 2 ** (e - 1))
            for k, e in zip(range(8, 8 + n_formats),
                            [3, 4, 5, 6] * ((n_formats + 3) // 4))]


def _bench_format_sweep(dev, M=256, K=256, N=256, n_formats=8, reps=5):
    """Serving-format agility: one GEMM build serves every certified
    format (the format is a runtime argument of ``quant_matmul_format``),
    timed across a sweep of formats — what a format-map rollout pays.
    Returns (seconds a sweep, formats a sweep)."""
    from repro_torch.kernels.quant_matmul import quant_matmul_format_dispatch

    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(M, K).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.randn(K, N).astype(np.float32)).to(dev)
    fmts = format_sweep(n_formats)

    def sweep():
        return [quant_matmul_format_dispatch(x, w, f) for f in fmts]

    _, t = steady(sweep, dev, reps)
    return t, n_formats


def _bench_stacked_vs_unrolled(dev, depths=(2, 4, 8), reps=3):
    """Analysis cost vs model depth: the eager per-layer CAA pass vs
    ``StackedCaaOps`` probes (the stack as one ``layer*`` scope with [L]
    knob lanes) on a narrow qwen2-family transformer. Returns (L, eager
    seconds, stacked seconds a probe) per depth."""
    from repro_torch import configs
    from repro_torch.models import transformer as T

    smoke = configs.get("qwen2_7b").SMOKE
    cfg0 = dataclasses.replace(smoke, n_layers=1, d_model=32, n_heads=2,
                               n_kv_heads=2, d_head=16, d_ff=64, vocab=64)
    ccfg = caa.CaaConfig(u_max=2.0 ** -20)
    tokens = torch.randint(0, cfg0.vocab, (1, 4),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    rows = []
    for L in depths:
        arch = dataclasses.replace(cfg0, n_layers=L)
        params = T.init_params(arch, generator=torch.Generator(
            device=dev).manual_seed(0), device=dev)

        def eager():
            out, _ = T.forward(CaaOps(ccfg), params, arch, tokens)
            return out.dbar

        def bounds(u):
            ops = StackedCaaOps(dataclasses.replace(ccfg, u_max=u))
            o, _ = T.forward(ops, params, arch, tokens)
            return torch.max(o.dbar)

        _, t_eager = steady(eager, dev)
        bounds(2.0 ** -20)
        sync(dev)
        t0 = time.perf_counter()
        for r in range(reps):
            bounds(2.0 ** -(21 + r))
        sync(dev)
        t_steady = (time.perf_counter() - t0) / reps
        print(f"  L={L:2d}  eager unrolled: {t_eager:7.2f} s   stacked: "
              f"{t_steady * 1e3:7.1f} ms/probe")
        rows.append((L, t_eager, t_steady))
    return rows


def run_stacked(dev="cuda"):
    print("\n== layer-stacked CAA: stacked analysis vs per-layer unrolling ==")
    rows = _bench_stacked_vs_unrolled(resolve_device(str(dev)))
    (L0, e0, s0), (L1, e1, s1) = rows[0], rows[-1]
    print(f"depth {L0}→{L1}: eager wall grows ×{e1 / e0:.1f}, stacked "
          f"probe ×{s1 / s0:.1f}")
    return [
        (f"caa_eager_unrolled_L{L}_s", t_e * 1e6, t_e)
        for (L, t_e, _) in rows
    ] + [
        (f"caa_stacked_probe_L{L}_s", t_s * 1e6, t_s)
        for (L, _, t_s) in rows
    ]


def run_formats(dev="cuda"):
    dev = resolve_device(str(dev))
    print("\n== full-format certificates: synthesis cost + format agility ==")
    t_k, t_fmt, saved, probes = _bench_format_sweep_vs_mantissa(dev)
    print(f"certification      mantissa-only: {t_k:8.3f} s   "
          f"full (k, emin, emax) synthesis: {t_fmt:8.3f} s   "
          f"(+{t_fmt / t_k:.1f}× analysis → −{saved:.1f} bits/value, "
          f"{probes} lattice probes)")
    t_dyn, nf = _bench_format_sweep(dev)
    print(f"format sweep GEMM  runtime format (1 build): "
          f"{t_dyn*1e3:8.1f} ms/{nf} formats")
    return [
        ("certify_mantissa_only_s", t_k * 1e6, t_k),
        ("certify_full_formats_s", t_fmt * 1e6, t_fmt),
        ("gemm_format_sweep_prefetch_s", t_dyn * 1e6, t_dyn),
    ]


def run_mixed(dev="cuda"):
    dev = resolve_device(str(dev))
    print("\n== mixed-precision certificates: probe ladder + serving ==")
    t_eager, t_first, t_steady = _bench_probe_ladder(dev)
    print(f"probe cost/k       eager re-analysis: {t_eager*1e3:8.1f} ms   "
          f"ladder: {t_steady*1e3:8.2f} ms steady "
          f"({t_first*1e3:.1f} ms first probe, "
          f"×{t_eager / t_steady:,.1f})")
    t_uni, t_mix, uk, mk = _bench_mixed_vs_uniform_serving(dev)
    print(f"serving throughput uniform k={uk}: {t_uni*1e3:8.2f} ms/batch   "
          f"mixed (mean k={mk:.1f}): {t_mix*1e3:8.2f} ms/batch   "
          f"(emulated; real-silicon FLOP-cost ∝ k: "
          f"−{100*(uk-mk)/uk:.0f}% bits/FLOP)")
    return [
        ("probe_eager_per_k_s", t_eager * 1e6, t_eager),
        ("probe_ladder_steady_s", t_steady * 1e6, t_steady),
        ("serve_uniform_k_s", t_uni * 1e6, t_uni),
        ("serve_mixed_k_s", t_mix * 1e6, t_mix),
    ]


def run_certify(dev="cuda"):
    dev = resolve_device(str(dev))
    print("\n== certificate pipeline: batched classes + store ==")
    t_seq, t_bat = _bench_batched_vs_sequential(dev)
    print(f"10-class analysis  sequential loop: {t_seq:8.3f} s   "
          f"batched single pass: {t_bat:8.3f} s   (×{t_seq / t_bat:.2f})")
    t_cold, t_hot = _bench_certified_store(dev)
    print(f"certify request    cold (analyse+persist): {t_cold:8.3f} s   "
          f"store hit: {t_hot*1e3:8.2f} ms   (×{t_cold / t_hot:,.0f})")
    return [
        ("multiclass_sequential_s", t_seq * 1e6, t_seq),
        ("multiclass_batched_s", t_bat * 1e6, t_bat),
        ("certify_cold_s", t_cold * 1e6, t_cold),
        ("certify_store_hit_s", t_hot * 1e6, t_hot),
    ]


def run(dev="cuda"):
    dev = resolve_device(str(dev))
    print("\n== analysis speed vs model size (CAA engine, eager) ==")
    print(f"{'params':>12s} {'steady(s)':>10s} {'per-Mparam(ms)':>15s}")
    rows = []
    for h1, h2 in SIZES:
        n, st = _time_analysis(h1, h2, dev)
        print(f"{n:12d} {st:10.4f} {1e3 * st / (n / 1e6):15.2f}")
        rows.append((f"analysis_{n // 1000}k_params", st * 1e6,
                     st / (n / 1e6)))
    # paper comparison at the Digits scale (~0.7M): 12 s/class there
    n, st = _time_analysis(700, 256, dev)
    speedup = 12.0 / st
    print(f"paper Digits-scale: 12 s/class → ours {st * 1e3:.1f} ms/class "
          f"(speedup ×{speedup:,.0f})")
    rows.append(("digits_speedup_x", st * 1e6, speedup))
    rows.extend(run_certify(dev))
    rows.extend(run_mixed(dev))
    rows.extend(run_formats(dev))
    rows.extend(run_stacked(dev))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.analysis_speed")
    add_device_arg(ap)
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
