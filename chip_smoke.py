#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with ``python3 chip_smoke.py``. It builds the
port's eight CUDA kernels from ``src/repro_torch/csrc`` with nvcc (into
``build/repro_torch/``; the ``build`` line carries registers, shared memory
and spills of every kernel), holds the two certified GEMMs bit for bit
against their sequential-order plain versions on sampled columns of every
Qwen2-7B projection (``gemm_order``), checks each kernel against its plain
PyTorch version on the card (GEMM rows timed with the weights cold: rotated
through copies that exceed the L2; the decode-attention rows timed from a
profiler trace with the caches rotated likewise, the serve cache's shapes
and a 32K-position one among them; ``row_order``: the two port-only
kernels that give serving's rmsnorm mean and LM head one fixed order per
row, bit for bit against their plain versions), and drives the port's
paths through
the entry points a user calls, with every kernel's launch counter set to 0
just before each path and read just after (each serve line carries the
sha256 of its logits and a profiler trace of its decode steps):

* ``serve`` — full-width Qwen2-7B (random weights from a seed) through the
  certified custom-format path (kernels ``quant_matmul_format`` and
  ``flash_decode_certified``);
* ``serve_k`` / ``serve_mixed`` — the same model at a uniform certified
  k = 12, and from a v2 certificate set with a per-layer k map (kernel
  ``quant_matmul``);
* ``profile`` — the kernel profiler (every kernel, ``flash_decode_attention``
  among them) and the serving profile (at the reference's SMOKE defaults
  and at full width), under the port's JSONL tracer;
* ``decode_trace`` — the three serve paths' decode steps side by side
  (host-clock median; device time of the GEMM kernels, attention, the LM
  head, other kernels and idle gaps), and the full-width serving profile
  traced as the profile phase runs it and bare;
* ``batching`` — the continuous-batching engine at full width from a store
  entry: every request's tokens and logits, on the format path and on the
  k path (whose decode attention runs ``flash_decode_attention``), bit for
  bit ``reference_generate``'s (the request alone); every op of one ragged
  decode step, each lane against itself alone;
* ``interval_libm`` — the interval transcendentals on the card against the
  CPU's f64 values at about 10⁶ points, directed rounding bitwise;
* ``ranges`` — the range, affine and layer-stacked CAA passes on Qwen2-7B
  at full width (depth cut to 2 layers): stacked equals eager per scope,
  the affine enclosures are finite, the exact f64 forward lies inside every
  scope's max_abs; the card's maps equal the CPU port's at SMOKE and on
  the Digits and ConvNet models;
* ``certify`` — the certification pipeline: Digits at full width certified
  uniform, mixed and mixed + formats on the card and on the CPU (decisions
  equal, bounds within 1e-9), its format map served through
  ``quant_matmul_format`` bit for bit as its plain emulation, a store hit
  and ``gc``; Qwen2-7B at full width (depth cut to 2 layers) through
  ``certify_lm`` uniform and mixed + formats with seconds and peak memory
  per stage, served by ``launch/batching.py --certificates`` if it
  certifies; the nano LM certified on card and CPU and its own format and
  k maps served, logits bit for bit ``reference_generate``'s;
* ``analyze`` — the paper's Table-I flow (``examples/quickstart.py``) on
  the Digits model at its full width 784→700→256→10, trained on the card,
  with Pendulum and ConvNet at their defaults, then again on the CPU with
  the same weights: bounds, required k and certified decisions agree;
* ``analysis_ops`` / ``caa_matmul`` / ``interval_matmul`` — kernels 5 and 6
  through ``ops.caa_matmul_fused`` / ``ops.interval_matmul_rigorous`` on the
  analysis's own dense-layer operands, then at the seven Qwen2-7B
  projections, against their plain versions (rows timed with weights
  cold, the Digits rows from a profiler trace); between them
  ``interval_gemm_order`` holds both bit for bit against their
  sequential-order plain versions on sampled columns of the projections
  and on every Digits analysis shape.

Each phase prints one JSON object on a line of its own; a phase that fails
raises and the script exits non-zero. The last three lines are the kernels'
summary (``{"kernels": [...]}``), the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them, and ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the repository beside it, the script exits non-zero and prints no
result. It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

F32_TFLOPS = 67e12      # H100 SXM f32 outside the tensor cores (data sheet)
HBM_BYTES_S = 3.35e12   # H100 SXM HBM3 (data sheet)
FORMATS = {             # (k, emax, emin)
    "k24_e127": (24, 127, -126),
    "k12_e15": (12, 15, -14),
    "k8_e7": (8, 7, -6),
}
# Qwen2-7B's projections (K, N), d=3584, 28 q / 4 kv heads of 128, d_ff=18944
GEMM_SHAPES = {
    "wq": (3584, 3584), "wk": (3584, 512), "wv": (3584, 512),
    "wo": (3584, 3584), "w_gate": (3584, 18944), "w_up": (3584, 18944),
    "w_down": (18944, 3584),
}
SERVE_FORMAT = {
    "": {"k": 24, "emax": 127, "emin": -126},
    "layer*/attn": {"k": 12, "emax": 15, "emin": -14},
    "layer*/mlp": {"k": 10, "emax": 15, "emin": -14},
    "layer0/mlp": {"k": 16, "emax": 31, "emin": -30},
}
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 4, 128, 16
SERVE_K = 12                      # the uniform certified precision served
MIXED_K = 16                      # the v2 set's serving_k ...
MIXED_LAYER_K = {"layer*/attn": 12, "layer*/mlp": 10, "layer0/mlp": 14}
GEMM_KS = (8, 12, 24)
KERNELS = ("quant_matmul_format", "flash_decode_certified", "quant_matmul",
           "flash_decode_attention", "caa_matmul", "interval_matmul",
           "row_mean", "f32_matmul")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


L2_BYTES = 50e6          # H100 SXM L2 (data sheet)


def weight_copies(torch, w):
    """Copies of ``w`` whose total exceeds the L2 twice over (at least
    two), so that a launch that rotates through them finds its weights in
    HBM, as a serving step does (it reads 28 layers' weights in turn)."""
    n = max(2, math.ceil(2 * L2_BYTES / (4 * w.numel())))
    return [w.clone() for _ in range(n)]


def time_cold_ms(torch, fn, copies, iters: int) -> float:
    """Mean device time of ``fn(w)`` over ``iters`` launches (at least one
    pass over the copies), ``w`` rotating through ``copies`` (CUDA events,
    after one warm-up pass)."""
    for w in copies:
        fn(w)
    torch.cuda.synchronize()
    iters = max(iters, len(copies))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(copies[i % len(copies)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def trace_ms(torch, fn, copies, iters: int) -> float:
    """Mean device time of ``fn(w)`` a call, ``w`` rotating through
    ``copies`` (after one warm-up pass): the summed durations of the device
    activities (kernels, copies) in a ``torch.profiler`` trace of ``iters``
    calls. For calls shorter than their launch from the host, where CUDA
    events around a loop of calls time the host. The profiler now and then
    returns a trace without the device's activities: such a trace is taken
    again, up to three times in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for w in copies:
        fn(w)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(copies[i % len(copies)])
            torch.cuda.synchronize()
        spans = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if spans:
            return sum(spans) / 1e3 / iters
    raise AssertionError("three traces held no device activity")


def gemm_times(torch, kernel, plain, x, w, iters):
    """A GEMM row's times: the kernel, its plain version and one
    ``torch.matmul`` of the same shapes, each with weights cold (rotated
    through :func:`weight_copies`)."""
    copies = weight_copies(torch, w)
    out = {"ms": time_cold_ms(torch, lambda wc: kernel(x, wc), copies,
                              iters),
           "plain_ms": time_cold_ms(torch, lambda wc: plain(x, wc), copies,
                                    iters),
           "library_ms": time_cold_ms(torch, lambda wc: torch.matmul(x, wc),
                                      copies, iters),
           "weight_copies": len(copies)}
    del copies
    return out


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / F32_TFLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def ulp_at_k(torch, a, k: int, emin: int):
    """Spacing of the k-bit grid at |a| (f64), never below the format's
    subnormal spacing 2^(emin-(k-1))."""
    _, e = torch.frexp(a.abs().double())
    return torch.ldexp(torch.ones_like(a, dtype=torch.float64),
                       (torch.clamp(e - 1, min=emin) - (k - 1)).double())


def compare(torch, got, want, fmt, pre_tol):
    """The tolerance stated for a kernel against its plain version: equal
    (NaN/inf alike), or |Δ| ≤ one ulp at k + ``pre_tol`` — the most the two
    sums can differ before the final rounding because they add in another
    order. Returns (ok, stats)."""
    k, _, emin = fmt
    g, w = got.double(), want.double()
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    diff = (g - w).abs()
    ulp = ulp_at_k(torch, torch.maximum(g.abs(), w.abs()), k, emin)
    ok_el = same | (diff <= ulp + pre_tol)
    finite = torch.isfinite(diff)
    stats = {
        "max_abs_err": float(diff[finite].max()) if finite.any() else 0.0,
        "frac_equal": float(same.double().mean()),
        "frac_within_1ulp": float((same | (diff <= ulp)).double().mean()),
        "max_ulps": float((diff[finite] / ulp[finite]).max())
        if finite.any() else 0.0,
        "n_bad": int((~ok_el).sum()),
    }
    return bool(ok_el.all()), stats


def phase_env(torch, serve):
    serve.configure_precision()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=nvidia_smi_line(),
         tf32=False, float32_matmul_precision="highest")


PTXAS_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
PTXAS_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")
PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def ptxas_report(log: str):
    """{kernel symbol: {registers, static_smem_bytes, spill_store_bytes,
    spill_load_bytes}} from ``nvcc -Xptxas -v`` output."""
    out, cur = {}, None
    for line in log.splitlines():
        m = PTXAS_ENTRY.search(line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = PTXAS_SPILL.search(line)
        if m:
            cur["spill_store_bytes"] = int(m.group(1))
            cur["spill_load_bytes"] = int(m.group(2))
        m = PTXAS_USED.search(line)
        if m:
            cur["registers"] = int(m.group(1))
            cur["static_smem_bytes"] = int(m.group(2) or 0)
    return out


def phase_build(build):
    t0 = time.perf_counter()
    res = build.build(build.SOURCES, ptxas_verbose=True)
    for name, r in res.items():
        print(f"--- nvcc {name}\n{r['log']}", file=sys.stderr)
    emit("build", seconds=time.perf_counter() - t0,
         sources=list(build.SOURCES),
         per_source_s={n: r["seconds"] for n, r in res.items()},
         ptxas={n: ptxas_report(res[n]["log"]) for n in build.SOURCES})


def phase_rounding(torch, quantize, qmm):
    """quantize_to_format on the card (plain PyTorch and the kernels' device
    function) against the plain version on the CPU, bit for bit, over random
    f32 bit patterns with NaN, ±inf and carrier subnormals."""
    gen = torch.Generator().manual_seed(1)
    bits = torch.randint(-2 ** 31, 2 ** 31 - 1, (1 << 20,),
                         dtype=torch.int64, generator=gen).to(torch.int32)
    sub = torch.randint(0, 1 << 23, (4096,), dtype=torch.int32, generator=gen)
    x = torch.cat([bits.view(torch.float32), sub.view(torch.float32),
                   -sub.view(torch.float32),
                   torch.tensor([float("nan"), float("inf"), -float("inf"),
                                 0.0, -0.0, 3.4028235e38, -3.4028235e38,
                                 1.1754944e-38, 1e-45])])
    xg = x.cuda()
    fmts = list(FORMATS.values()) + [(10, 15, -14), (16, 31, -30),
                                     (3, 3, -2), (8, 127, -126)]
    n_checked = 0
    for fmt in fmts:
        for subn in (True, False):
            for sat in (True, False):
                cpu = quantize.quantize_to_format(x, *fmt, subn, sat)
                gpu = quantize.quantize_to_format(xg, *fmt, subn, sat).cpu()
                dev = qmm.quantize_format_cuda(
                    xg, fmt, has_subnormals=subn, saturating=sat).cpu()
                for name, got in (("torch_cuda", gpu), ("device_fn", dev)):
                    bad = int((got.view(torch.int32)
                               != cpu.view(torch.int32)).sum())
                    if bad:
                        raise AssertionError(
                            f"rounding {name} {fmt} subn={subn} sat={sat}: "
                            f"{bad} values differ from the CPU bits")
                n_checked += 2 * x.numel()
    emit("rounding", values=x.numel(), formats=len(fmts), flag_combos=4,
         compared=n_checked, bitwise_equal=True)


def gemm_order_tol(torch, xq, wq):
    """What two f32 sums of the same K products may differ by before the
    final rounding when they add in other orders: 2·√K·u·(|x̂|@|ŵ|), u =
    2⁻²⁴. The rounding errors of a sum have random signs, so their spread
    grows as √K; the worst case K·u·(|x̂|@|ŵ|) is ~√K times looser and
    would hide a dropped K-tile."""
    K = xq.shape[-1]
    return (2.0 * math.sqrt(K) * 2.0 ** -24
            * torch.matmul(xq.abs().double(), wq.abs().double()))


def gemm_agreement(torch, got, want, fmt, xq, wq, what):
    """A GEMM kernel's output against its plain version's under the ulp
    rule plus :func:`gemm_order_tol` of the rounded operands ``xq``/``wq``.
    Returns the stats, with ``order_spread`` = the largest |Δ| beyond one
    ulp in units of √K·u·Σ|x̂||ŵ|; raises on disagreement."""
    tol = gemm_order_tol(torch, xq, wq)
    ok, st = compare(torch, got, want, fmt, tol)
    beyond = (got.double() - want.double()).abs() - ulp_at_k(
        torch, torch.maximum(got.abs(), want.abs()), fmt[0], fmt[2])
    st["order_spread"] = float((beyond.clamp(min=0) / (tol / 2)).nan_to_num(
        0.0, posinf=0.0).max())
    if not ok:
        raise AssertionError(f"{what} {tuple(xq.shape)}@{tuple(wq.shape)} "
                             f"{fmt}: {st}")
    return st


def check_gemm(torch, qmm, x, w, fmt, flags=(True, True)):
    """The format kernel against its plain version on the same card
    inputs. Returns (kernel out, stats); raises on disagreement."""
    from repro_torch.core.quantize import quantize_to_format

    subn, sat = flags
    got = qmm.quant_matmul_format(x, w, fmt, has_subnormals=subn,
                                  saturating=sat)
    want = qmm.quant_matmul_format_ref(x, w, fmt, has_subnormals=subn,
                                       saturating=sat)
    st = gemm_agreement(torch, got, want, fmt,
                        quantize_to_format(x, *fmt, subn, sat),
                        quantize_to_format(w, *fmt, subn, sat),
                        "quant_matmul_format")
    return got, st


def check_gemm_k(torch, qmm, x, w, k):
    """The k-bit kernel against its plain version on the same card inputs
    (mantissa-only rounding: the f32 exponent range, emin = -126)."""
    from repro_torch.core.quantize import _quantize_normal

    got = qmm.quant_matmul(x, w, k=k)
    want = qmm.quant_matmul_ref(x, w, k)
    st = gemm_agreement(torch, got, want, (k, 127, -126),
                        _quantize_normal(x, k), _quantize_normal(w, k),
                        "quant_matmul")
    return got, st


def same_bits(torch, got, want) -> bool:
    """Equal bit for bit, except that any NaN equals any NaN."""
    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan)) and bool(torch.equal(
        got[~nan].view(torch.int32), want[~nan].view(torch.int32)))


def coarse_operands(torch, gen, M, K, N):
    """Integers in [-3, 3] times 2^-2 resp. 2^-3: exact in every format
    and precision checked here, and every partial sum of their products is
    an exact f32, so any summation order gives the same bits."""
    x = torch.randint(-3, 4, (M, K), device="cuda",
                      generator=gen).float() * 2.0 ** -2
    w = torch.randint(-3, 4, (K, N), device="cuda",
                      generator=gen).float() * 2.0 ** -3
    return x, w


ORDER_FORMATS = ("k12_e15", "k8_e7")
# a format without subnormals, overflowing to inf: kernel 1's other GEMM
# instantiation (has_subnormals is a template parameter of its functor)
ORDER_FLAGS_FORMAT = ("k8_e7", (False, False))
ORDER_KS = (8, 12)
ORDER_COLUMNS = 128


def phase_gemm_order(torch, qmm):
    """Kernels 1 and 3 against their sequential-order plain versions
    (``*_seq_ref``: f32 sums over k = 0..K-1 from +0, the kernels' fmaf
    order, exact products at k ≤ 12) on ORDER_COLUMNS sampled output
    columns of each Qwen2-7B projection, M = 4 and 512, random operands:
    equal bit for bit, or the kernels' order was not kept."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    cpu_gen = torch.Generator().manual_seed(14)
    n_cases, n_elems = 0, 0
    for proj, (K, N) in GEMM_SHAPES.items():
        w = torch.randn(K, N, device="cuda", generator=gen) / math.sqrt(K)
        cols = torch.randperm(N, generator=cpu_gen)[:ORDER_COLUMNS].sort()
        cols = cols.values.cuda()
        wc = w[:, cols].contiguous()
        for M in (4, 512):
            x = torch.randn(M, K, device="cuda", generator=gen)
            cases = [(f"format {f}", lambda a, b, f=f: qmm.quant_matmul_format(
                a, b, FORMATS[f]), lambda a, b, f=f:
                qmm.quant_matmul_format_seq_ref(a, b, FORMATS[f]))
                for f in ORDER_FORMATS]
            f, (subn, sat) = ORDER_FLAGS_FORMAT
            cases.append((
                f"format {f} has_subnormals={subn} saturating={sat}",
                lambda a, b: qmm.quant_matmul_format(
                    a, b, FORMATS[f], has_subnormals=subn, saturating=sat),
                lambda a, b: qmm.quant_matmul_format_seq_ref(
                    a, b, FORMATS[f], has_subnormals=subn, saturating=sat)))
            cases += [(f"k={k}", lambda a, b, k=k: qmm.quant_matmul(a, b, k=k),
                       lambda a, b, k=k: qmm.quant_matmul_seq_ref(a, b, k))
                      for k in ORDER_KS]
            for what, kernel, seq in cases:
                got = kernel(x, w)[:, cols]
                want = seq(x, wc)
                if not same_bits(torch, got, want):
                    n = int((got.view(torch.int32)
                             != want.view(torch.int32)).sum())
                    raise AssertionError(
                        f"gemm_order {proj} M={M} {what}: {n} of "
                        f"{got.numel()} elements differ from the "
                        "sequential order")
                n_cases += 1
                n_elems += got.numel()
            del x
        del w, wc
    emit("gemm_order", rule="bit for bit against the sequential-order "
         "plain versions (k ≤ 12: exact products, so each step is fmaf)",
         projections=list(GEMM_SHAPES), M=[4, 512],
         formats=list(ORDER_FORMATS),
         flags_format={"format": ORDER_FLAGS_FORMAT[0],
                       "has_subnormals": ORDER_FLAGS_FORMAT[1][0],
                       "saturating": ORDER_FLAGS_FORMAT[1][1]},
         ks=list(ORDER_KS),
         columns_per_projection=ORDER_COLUMNS, cases=n_cases,
         elements_compared=n_elems, bitwise_equal=True)


def phase_quant_matmul(torch, qmm):
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = 0.0
    rows = []
    n_exact = 0
    for proj, (K, N) in GEMM_SHAPES.items():
        for M in (4, 512):
            x, w = coarse_operands(torch, gen, M, K, N)
            for fname, fmt in FORMATS.items():
                got = qmm.quant_matmul_format(x, w, fmt)
                want = qmm.quant_matmul_format_ref(x, w, fmt)
                if not torch.equal(got.view(torch.int32),
                                   want.view(torch.int32)):
                    n = int((got.view(torch.int32)
                             != want.view(torch.int32)).sum())
                    raise AssertionError(
                        f"quant_matmul_format {proj} M={M} {fname}: {n} "
                        "elements differ on exact-sum operands")
                n_exact += 1
        del w, x
        w = torch.randn(K, N, device="cuda", generator=gen) / math.sqrt(K)
        for M in (4, 512):
            x = torch.randn(M, K, device="cuda", generator=gen)
            for fname, fmt in FORMATS.items():
                got, st = check_gemm(torch, qmm, x, w, fmt)
                worst = max(worst, st["max_abs_err"])
                row = {"proj": proj, "M": M, "K": K, "N": N,
                       "format": fname, **st}
                if M == 512 and fname == "k12_e15":
                    # row invariance: 7 rows alone == the same rows in 512
                    alone = qmm.quant_matmul_format(x[:7].contiguous(), w,
                                                    fmt)
                    if not torch.equal(alone.view(torch.int32),
                                       got[:7].view(torch.int32)):
                        raise AssertionError(
                            f"quant_matmul_format {proj}: 7 rows alone "
                            "differ from the same rows inside M=512")
                    row["row_invariant"] = True
                if fname == "k12_e15":
                    fmt12 = FORMATS["k12_e15"]
                    row.update(gemm_times(
                        torch,
                        lambda a, b: qmm.quant_matmul_format(a, b, fmt12),
                        lambda a, b: qmm.quant_matmul_format_ref(a, b, fmt12),
                        x, w, 20 if M == 4 else 5))
                    row["bound_ms"], row["bound_by"] = bound_ms(
                        4.0 * (M * K + K * N + M * N), 2.0 * M * N * K)
                rows.append(row)
            del x
        del w
    emit("quant_matmul_format", exact_checks=n_exact, checks=len(rows),
         max_abs_err=worst,
         max_order_spread=max(r["order_spread"] for r in rows), rows=rows)
    return rows, worst


HEAD_COLUMNS = 64                 # LM-head columns held to the fmaf chain
ROW_ORDER_REPLACES = {
    "row_mean": "none: port-only (XLA's mean in the reference's rmsnorm, "
                "src/repro/models/layers.py:46)",
    "f32_matmul": "none: port-only (XLA's einsum in the reference's "
                  "logits_head, src/repro/models/layers.py:84)"}


def phase_row_order(torch, cfg):
    """Serving's two fixed-order kernels at the shapes serving gives them
    (``cfg`` = qwen2_7b.FULL): ``row_mean`` over d_model for 4 rows
    (decode) and 512 (a 4 × 128 prefill), bit for bit against its plain
    version, a row alone equal to the same row in the batch; ``f32_matmul``
    as the LM head (x [M, d] against the transposed [d, V] table) at M = 4
    and 512, bit for bit against the fmaf chain on HEAD_COLUMNS sampled
    columns, rows alone equal. Times: ``row_mean`` from a profiler trace
    (its call is shorter than its launch), inputs rotated past the L2;
    ``f32_matmul`` by CUDA events (its 2.18 GB table is never in the L2);
    the library yardsticks are ``Tensor.mean`` and ``torch.einsum`` of the
    untransposed table."""
    from repro_torch.kernels import row_order as ro

    gen = torch.Generator(device="cuda").manual_seed(4)
    d, V = cfg.d_model, cfg.vocab
    out = {"row_mean": {}, "f32_matmul": {}}
    for what, R in (("decode", SERVE_BATCH), ("prefill", 512)):
        x = torch.randn(R, d, device="cuda", generator=gen) ** 2
        got = ro.row_mean(x)
        if not same_bits(torch, got, ro.row_mean_ref(x)[:, 0]):
            raise AssertionError(f"row_mean {what}: differs from its plain "
                                 "version")
        for r in (0, R - 1):
            if not same_bits(torch, ro.row_mean(x[r:r + 1].contiguous()),
                             got[r:r + 1]):
                raise AssertionError(f"row_mean {what}: row {r} alone "
                                     "differs")
        lib = x.mean(dim=-1)
        copies = weight_copies(torch, x)
        row = {"R": R, "n": d, "bitwise_vs_plain": True,
               "row_invariant": True,
               "max_abs_err": 0.0,
               "max_abs_vs_library": float((got - lib).abs().max()),
               "ms": trace_ms(torch, ro.row_mean, copies, 50),
               "plain_ms": trace_ms(torch, ro.row_mean_ref, copies, 5),
               "library_ms": trace_ms(
                   torch, lambda t: t.mean(dim=-1, keepdim=True), copies,
                   50), "input_copies": len(copies)}
        row["bound_ms"], row["bound_by"] = bound_ms(4.0 * (R * d + R),
                                                    float(R * d))
        out["row_mean"][what] = row
        del x, copies

    table = torch.randn(V, d, device="cuda", generator=gen) * 0.02
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    table_t = ro.transposed(table)
    end.record()
    end.synchronize()
    transposed = {"ms": start.elapsed_time(end),
                  "gb": (torch.cuda.memory_allocated() - m0) / 1e9}
    cols = torch.linspace(0, V - 1, HEAD_COLUMNS, device="cuda").long()
    for what, M in (("decode", SERVE_BATCH), ("prefill", 512)):
        x = torch.randn(M, d, device="cuda", generator=gen)
        got = ro.f32_matmul(x, table_t)
        want = ro.f32_matmul_seq_ref(x, table_t[:, cols])
        if not same_bits(torch, got[:, cols].contiguous(), want):
            raise AssertionError(f"f32_matmul {what}: differs from the "
                                 "fmaf chain")
        for r in (0, M - 1):
            if not same_bits(torch, ro.f32_matmul(x[r:r + 1].contiguous(),
                                                  table_t), got[r:r + 1]):
                raise AssertionError(f"f32_matmul {what}: row {r} alone "
                                     "differs")
        lib = torch.einsum("bsd,vd->bsv", x[None], table)[0]
        iters = 20 if M <= 8 else 3
        row = {"M": M, "K": d, "N": V, "bitwise_vs_plain_columns":
               HEAD_COLUMNS, "row_invariant": True, "max_abs_err": 0.0,
               "max_abs_vs_library": float((got - lib).abs().max()),
               "ms": time_cold_ms(torch, lambda w: ro.f32_matmul(x, w),
                                  [table_t], iters),
               "library_ms": time_cold_ms(
                   torch, lambda w: torch.einsum("bsd,vd->bsv", x[None], w),
                   [table], iters)}
        if M <= 8:
            # the whole fmaf chain once (K steps over the [M, V] rows)
            start.record()
            ro.f32_matmul_seq_ref(x, table_t)
            end.record()
            end.synchronize()
            row["plain_ms"] = start.elapsed_time(end)
        else:
            start.record()
            ro.f32_matmul_seq_ref(x, table_t[:, :1024])
            end.record()
            end.synchronize()
            row["plain_ms_1024_columns"] = start.elapsed_time(end)
        row["bound_ms"], row["bound_by"] = bound_ms(
            4.0 * (M * d + d * V + M * V), 2.0 * M * V * d)
        out["f32_matmul"][what] = row
        del x, lib
    del table, table_t
    emit("row_order", config="qwen2_7b.FULL", transposed_table=transposed,
         note="port-only kernels: one fixed order per row (row_mean: 256 "
              "strided sums, a butterfly a warp, 8 warp sums in order; "
              "f32_matmul: quant_gemm.cuh with a PassThrough functor, one "
              "fmaf chain a logit)", **out)
    return out


GEMM_K_TOLERANCE = ("equal, or |Δ| ≤ one ulp at k (emin -126) + "
                    "2·√K·2⁻²⁴·(|q_k(x)|@|q_k(w)|); exact-sum operands and "
                    "NaN/±inf/near-f32-max inputs bit for bit")


def phase_quant_matmul_k(torch, qmm):
    """Kernel 3 against its plain version at the seven Qwen2-7B
    projections, M = 4 (decode) and 512 (prefill), k ∈ GEMM_KS."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    big = 3.4028234663852886e38
    rows, worst, n_exact, n_special = [], 0.0, 0, 0
    for proj, (K, N) in GEMM_SHAPES.items():
        for M in (4, 512):
            x, w = coarse_operands(torch, gen, M, K, N)
            for k in GEMM_KS:
                if not same_bits(torch, qmm.quant_matmul(x, w, k=k),
                                 qmm.quant_matmul_ref(x, w, k)):
                    raise AssertionError(f"quant_matmul {proj} M={M} k={k}: "
                                         "differs on exact-sum operands")
                n_exact += 1
        # NaN, ±inf, ±f32 max (which carries into ±inf at k < 24) and
        # near-max values: they decide their rows in any summation order
        # (their weights are ±1/8, ±1/4 or 0, so their products are exact)
        x = x[:8].clone()
        w[[0, 1, 2, 9]] = w[[0, 1, 2, 9]].clamp(-0.25, 0.25)
        for r, (c, val) in enumerate([(3, float("nan")), (5, float("inf")),
                                      (7, -float("inf")), (0, big),
                                      (1, -big), (2, 3.3e38),
                                      (9, -1.5e38)]):
            x[r, c] = val
        for k in GEMM_KS:
            if not same_bits(torch, qmm.quant_matmul(x, w, k=k),
                             qmm.quant_matmul_ref(x, w, k)):
                raise AssertionError(f"quant_matmul {proj} k={k}: non-finite "
                                     "or near-max inputs differ")
            n_special += 1
        del x, w
        w = torch.randn(K, N, device="cuda", generator=gen) / math.sqrt(K)
        for M in (4, 512):
            x = torch.randn(M, K, device="cuda", generator=gen)
            for k in GEMM_KS:
                got, st = check_gemm_k(torch, qmm, x, w, k)
                worst = max(worst, st["max_abs_err"])
                row = {"proj": proj, "M": M, "K": K, "N": N, "k": k, **st}
                if k == SERVE_K:
                    if M == 512:
                        # row invariance: 7 rows alone == the same rows
                        alone = qmm.quant_matmul(x[:7].contiguous(), w, k=k)
                        if not torch.equal(alone.view(torch.int32),
                                           got[:7].view(torch.int32)):
                            raise AssertionError(
                                f"quant_matmul {proj}: 7 rows alone differ "
                                "from the same rows inside M=512")
                        row["row_invariant"] = True
                    row.update(gemm_times(
                        torch, lambda a, b: qmm.quant_matmul(a, b, k=k),
                        lambda a, b: qmm.quant_matmul_ref(a, b, k),
                        x, w, 20 if M == 4 else 5))
                    row["bound_ms"], row["bound_by"] = bound_ms(
                        4.0 * (M * K + K * N + M * N), 2.0 * M * N * K)
                rows.append(row)
            del x
        del w
    emit("quant_matmul", tolerance=GEMM_K_TOLERANCE, ks=list(GEMM_KS),
         exact_checks=n_exact, nonfinite_checks=n_special, checks=len(rows),
         max_abs_err=worst,
         max_order_spread=max(r["order_spread"] for r in rows), rows=rows)
    return rows, worst


FLASH_TOLERANCE = ("equal, or |Δ| ≤ one ulp (at k for the certified "
                   "kernel, of f32 for the plain one) + 2·(n + 16)·2⁻²⁴·"
                   "max|v| over the n positions a lane attends (all S for a "
                   "lane of length 0); and against the f64 split version, "
                   "one ulp + 8·√(n + 16)·2⁻²⁴·max|v|")


def attended(torch, lengths, S):
    """Positions each lane attends: its length, or all S for a lane of
    length 0 (every score is masked alike, so every weight is exp(0))."""
    return torch.where(lengths <= 0, S, lengths.clamp(max=S))


def flash_vmax(torch, v, lengths, fmt=None):
    """The n positions each lane attends, and the largest |v| there
    (rounded into ``fmt`` when given) per (b, kv-head)."""
    from repro_torch.core.quantize import quantize_to_format

    S = v.shape[1]
    n = attended(torch, lengths, S)
    valid = torch.arange(S, device=v.device)[None, :] < n[:, None]
    va = (v if fmt is None else quantize_to_format(v, *fmt)).abs()
    return n, torch.where(valid[:, :, None, None], va, 0).amax(dim=(1, 3))


def flash_tol(torch, v, lengths, fmt=None):
    """Sums over the n attended positions in another order, plus expf: a
    few f32 ulps of the largest |v| attended (rounded into ``fmt`` when
    given), 2·(n + 16)·2⁻²⁴·max|v|, per (b, kv-head)."""
    n, vmax = flash_vmax(torch, v, lengths, fmt)
    slack = 2.0 * (n.double() + 16)[:, None] * 2.0 ** -24
    return (slack * vmax.double())[:, :, None, None]


def flash_f64_tol(torch, v, lengths, fmt=None):
    """A kernel against the f64 split version: the probabilistic bound on
    the rounding errors of its f32 sums, λ·√(n + 16)·2⁻²⁴·max|v|, λ = 8
    (Higham and Mary, SIAM J. Sci. Comput. 41(5), 2019: exceeded with
    probability below 2·exp(-λ²/2) ≈ 3e-14 an element). At 32K it is 45
    times tighter than :func:`flash_tol`, below what one chunk of 64
    positions moves an output, so a chunk dropped or folded with a wrong
    weight fails it."""
    n, vmax = flash_vmax(torch, v, lengths, fmt)
    slack = 8.0 * (n.double() + 16).sqrt()[:, None] * 2.0 ** -24
    return (slack * vmax.double())[:, :, None, None]


def check_vs_f64(torch, fd, got, q, k, v, lengths, fmt, flags, what):
    """``got`` against the f64 split version under :func:`flash_f64_tol`
    plus one ulp at k (``fmt`` None: kernel 4, ulps of f32)."""
    subn, sat = flags
    exact = fd.flash_decode_split_ref(q, k, v, lengths, fmt,
                                      has_subnormals=subn, saturating=sat,
                                      dtype=torch.float64)
    tol = flash_f64_tol(torch, v, lengths, fmt)
    ok, st = compare(torch, got, exact, fmt or (24, 127, -126), tol)
    if not ok:
        raise AssertionError(f"{what} against the f64 split version: {st}")
    return {"f64_max_abs_err": st["max_abs_err"],
            "f64_max_tol": float(tol.max())}


def check_flash(torch, fd, q, k, v, lengths, fmt, flags=(True, True)):
    subn, sat = flags
    got = fd.flash_decode_certified(q, k, v, lengths, fmt,
                                    has_subnormals=subn, saturating=sat)
    want = fd.flash_decode_quantized_ref(q, k, v, lengths, fmt,
                                         has_subnormals=subn, saturating=sat)
    what = f"flash_decode_certified S={k.shape[1]} " \
        f"lengths={lengths.tolist()} {fmt}"
    ok, st = compare(torch, got, want, fmt, flash_tol(torch, v, lengths, fmt))
    if not ok:
        raise AssertionError(f"{what}: {st}")
    return {**st, **check_vs_f64(torch, fd, got, q, k, v, lengths, fmt,
                                 flags, what)}


# (Smax, lengths): ragged lengths, the serve phase's own cache (Smax =
# prompt + steps + 1) at its first and last decode step's lengths, a lane of
# length 0, and Qwen2-7B's 32K context (arXiv:2407.10671 §3) at batch 4,
# where k and v take 537 MB and the bound is the kernels' own, not a launch's
FLASH_CASES = {
    "ragged": (1024, [1, 255, 256, 1000]),
    "serve_first": (SERVE_PROMPT + SERVE_STEPS + 1, [SERVE_PROMPT + 1] * 4),
    "serve_last": (SERVE_PROMPT + SERVE_STEPS + 1,
                   [SERVE_PROMPT + SERVE_STEPS] * 4),
    "empty_lane": (SERVE_PROMPT + SERVE_STEPS + 1,
                   [0, SERVE_PROMPT + SERVE_STEPS, SERVE_PROMPT + 1, 1]),
    "long": (32768, [32768] * 4),
}


def cache_copies(torch, k, v):
    """Copies of the cache (k, v) whose total exceeds the L2 twice over (at
    least two), so that a call that rotates through them reads its cache
    from HBM, as a decode step does (it reads 28 layers' caches in turn)."""
    n = max(2, math.ceil(2 * L2_BYTES / (4 * (k.numel() + v.numel()))))
    return [(k.clone(), v.clone()) for _ in range(n)]


def flash_iters(S: int) -> int:
    """Traced calls of one decode-attention timing: 10 for a cache of more
    than 4,096 positions (the PR 15 body takes ~19 ms a call at 32K), else
    50. ``tools/quant_gemm_compare.py`` times with the same count."""
    return 10 if S > 4096 else 50


def flash_timing(torch, kernel, plain, q, k, v, lengths):
    """Device ms of ``kernel`` and ``plain`` on the same inputs and of the
    SDPA yardstick, each from a profiler trace (:func:`trace_ms`) with the
    cache rotated through :func:`cache_copies`; ``host_ms``: the kernel
    timed by CUDA events around back-to-back calls, which time the host's
    launch where that is longer. The bound: bytes (q in, out, and k/v over
    the attended positions) or operations (4·G·D per attended position and
    kv head)."""
    B, H, G, D = q.shape
    S = k.shape[1]
    lens = lengths.tolist()
    iters = flash_iters(S)
    copies = cache_copies(torch, k, v)
    timing = {
        "ms": trace_ms(torch, lambda c: kernel(q, *c, lengths), copies,
                       iters),
        "host_ms": time_cold_ms(torch, lambda c: kernel(q, *c, lengths),
                                copies, iters),
        "plain_ms": trace_ms(torch, lambda c: plain(q, *c, lengths), copies,
                             max(2, iters // 5)),
        "cache_copies": len(copies)}
    # the yardstick: SDPA with grouped heads on [B, H, S, D] (transposed
    # outside the timing); uniform lengths attend to the prefix with no
    # mask, ragged ones through a boolean mask
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs = q.reshape(B, H * G, 1, D)
    n = lens[0] if len(set(lens)) == 1 else S
    mask = None if len(set(lens)) == 1 else (
        torch.arange(S, device="cuda")[None, :]
        < lengths[:, None])[:, None, None, :]
    tcopies = [tuple(t[:, :n].permute(0, 2, 1, 3).contiguous() for t in c)
               for c in copies]
    del copies
    timing["library_ms"] = trace_ms(
        torch, lambda c: sdpa(qs, *c, attn_mask=mask, enable_gqa=True),
        tcopies, iters)
    del tcopies
    n_pos = int(attended(torch, lengths, S).sum())
    n_bytes = 4.0 * (2 * q.numel() + 2 * n_pos * H * D) + 4 * B
    timing["bound_ms"], timing["bound_by"] = bound_ms(
        n_bytes, 4.0 * G * D * H * n_pos)
    return timing


def phase_flash_decode(torch, fd):
    B, H, G, D = SERVE_BATCH, 4, 7, 128
    gen = torch.Generator(device="cuda").manual_seed(3)
    fmt12 = FORMATS["k12_e15"]
    worst, cases = 0.0, {}
    for case, (S, lens) in FLASH_CASES.items():
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = torch.randn(B, H, G, D, device="cuda", generator=gen)
        k = torch.randn(B, S, H, D, device="cuda", generator=gen)
        v = torch.randn(B, S, H, D, device="cuda", generator=gen)
        rows = []
        for fname, fmt in FORMATS.items():
            st = check_flash(torch, fd, q, k, v, lengths, fmt)
            worst = max(worst, st["max_abs_err"])
            rows.append({"format": fname, **st})
        timing = flash_timing(
            torch, lambda *a: fd.flash_decode_certified(*a, fmt12),
            lambda *a: fd.flash_decode_quantized_ref(*a, fmt12),
            q, k, v, lengths)
        cases[case] = {"Smax": S, "lengths": lens, **timing, "rows": rows}
        del q, k, v
    emit("flash_decode_certified",
         shape={"B": B, "K": H, "G": G, "D": D}, tolerance=FLASH_TOLERANCE,
         max_abs_err=worst, cases=cases)
    return cases, worst


def check_flash_attention(torch, fd, q, k, v, lengths, what):
    """Kernel 4 against its plain version and the f64 split version on the
    same card inputs, under FLASH_TOLERANCE at f32; raises on disagreement
    or a non-finite output."""
    got = fd.flash_decode_attention(q, k, v, lengths)
    want = fd.flash_decode_ref(q, k, v, lengths)
    ok, st = compare(torch, got, want, (24, 127, -126),
                     flash_tol(torch, v, lengths))
    if not ok or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"flash_decode_attention {what}: {st}")
    return {**st, **check_vs_f64(torch, fd, got, q, k, v, lengths, None,
                                 (True, True),
                                 f"flash_decode_attention {what}")}


def phase_flash_decode_attention(torch, fd):
    """Kernel 4 against its plain version in every FLASH_CASES case: the
    serve cache's shape, a ragged Smax=1024 cache, a cache with a lane of
    length 0 and the 32K one."""
    B, H, G, D = SERVE_BATCH, 4, 7, 128
    gen = torch.Generator(device="cuda").manual_seed(4)
    worst, cases = 0.0, {}
    for case, (S, lens) in FLASH_CASES.items():
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = torch.randn(B, H, G, D, device="cuda", generator=gen)
        k = torch.randn(B, S, H, D, device="cuda", generator=gen)
        v = torch.randn(B, S, H, D, device="cuda", generator=gen)
        st = check_flash_attention(torch, fd, q, k, v, lengths, case)
        worst = max(worst, st["max_abs_err"])
        timing = flash_timing(torch, fd.flash_decode_attention,
                              fd.flash_decode_ref, q, k, v, lengths)
        cases[case] = {"Smax": S, "lengths": lens, **st, **timing}
        del q, k, v
    emit("flash_decode_attention", shape={"B": B, "K": H, "G": G, "D": D},
         tolerance=FLASH_TOLERANCE, max_abs_err=worst, cases=cases)
    return cases, worst


def kernel_fns(qmm, fd):
    """The eight kernel wrappers by name; each counts its launches."""
    from repro_torch.kernels import caa_matmul as cm
    from repro_torch.kernels import interval_matmul as im
    from repro_torch.kernels import row_order as ro

    return {"quant_matmul_format": qmm.quant_matmul_format,
            "flash_decode_certified": fd.flash_decode_certified,
            "quant_matmul": qmm.quant_matmul,
            "flash_decode_attention": fd.flash_decode_attention,
            "caa_matmul": cm.caa_matmul,
            "interval_matmul": im.interval_matmul,
            "row_mean": ro.row_mean, "f32_matmul": ro.f32_matmul}


# the serving and profile paths launch neither analysis kernel
ANALYSIS_KERNELS_IDLE = {"caa_matmul": 0, "interval_matmul": 0}


def row_order_launches(forwards: int, n_layers: int = None):
    """Launches of the two fixed-order serving kernels over ``forwards``
    forwards of an f32 TorchOps backend on the card: one row_mean a
    rmsnorm (2 a layer and the final one), one f32_matmul (the LM head)."""
    n_layers = L_FULL if n_layers is None else n_layers
    return {"row_mean": (2 * n_layers + 1) * forwards,
            "f32_matmul": forwards}


@contextlib.contextmanager
def plain_row_order():
    """Serving's mean and LM head through their plain versions (the
    replays of a served run through the plain versions)."""
    from repro_torch.kernels import row_order as ro

    saved = ro.row_mean_dispatch, ro.lm_head_dispatch

    def head(x, table_t):
        rows = ro.f32_matmul_seq_ref(x.reshape(-1, x.shape[-1]), table_t)
        return rows.reshape(*x.shape[:-1], table_t.shape[-1])

    ro.row_mean_dispatch, ro.lm_head_dispatch = ro.row_mean_ref, head
    try:
        yield
    finally:
        ro.row_mean_dispatch, ro.lm_head_dispatch = saved


def reset_launches(fns):
    for fn in fns.values():
        fn.launches = 0


def read_launches(fns):
    return {name: fn.launches for name, fn in fns.items()}


def free_device_memory(torch):
    """Drop what an earlier full-width run left (its ~30.5 GB of weights
    are garbage once its phase returned) before the next one."""
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 1e9


L_FULL = 28                       # qwen2_7b.FULL's depth, not cut


def serve_argv(*extra):
    return ["--size", "full", "--batch", str(SERVE_BATCH),
            "--prefill-len", str(SERVE_PROMPT),
            "--decode-steps", str(SERVE_STEPS), "--device", "cuda",
            "--seed", "0", *extra]


def run_serve(torch, serve, fns, argv, expected):
    """``serve.main(argv)`` with every launch counter set to 0 just before
    and read just after; raises unless the counts are ``expected`` and the
    run served valid tokens with finite logits at full width."""
    torch.cuda.reset_peak_memory_stats()
    reset_launches(fns)
    res = serve.main(argv)
    launches = read_launches(fns)
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != {expected}")
    cfg = res.cfg
    if cfg != serve.configs.get("qwen2_7b").FULL or cfg.n_layers != L_FULL:
        raise AssertionError(f"not qwen2_7b.FULL: {cfg}")
    toks = res.tokens
    if toks.shape != (SERVE_BATCH, 1 + SERVE_STEPS) or not bool(
            ((toks >= 0) & (toks < cfg.vocab)).all()):
        raise AssertionError(f"bad tokens {toks.shape}")
    for lg in [res.prefill_logits] + res.decode_logits:
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError("non-finite logits")
    return res, launches


def serve_report(torch, res, launches, expected, ref_logits):
    """What every serve phase prints: the run's numbers, and request 0's
    prefill replayed through the plain versions against the served one."""
    served = res.prefill_logits[0, -1].double()
    ref = ref_logits[0, -1].double()
    top2 = torch.topk(served, 2).values
    digest = hashlib.sha256()
    for lg in [res.prefill_logits] + res.decode_logits:
        digest.update(lg.detach().float().cpu().numpy().tobytes())
    n_params = sum(t.numel() for t in _leaves(res.params))
    return dict(
        config="qwen2_7b.FULL", n_layers=res.cfg.n_layers,
        d_model=res.cfg.d_model, params=n_params,
        param_gb=4 * n_params / 1e9, batch=SERVE_BATCH,
        prompt_tokens=SERVE_PROMPT, decode_steps=SERVE_STEPS,
        launches=launches, expected_launches=expected,
        prefill_s=res.timing["prefill_s"],
        decode_ms_per_step=res.timing["decode_ms_per_step"],
        decode_tokens_per_s=res.timing["decode_tokens_per_s"],
        prefill_tokens_per_s=res.timing["prefill_tokens_per_s"],
        init_s=res.timing["init_s"],
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        sample_tokens=res.tokens[0].tolist(),
        logits_sha256=digest.hexdigest(),
        replay_vs_plain={
            "max_abs_dlogits": float((served - ref).abs().max()),
            "argmax_agrees": bool(served.argmax() == ref.argmax()),
            "top1_gap": float(top2[0] - top2[1]),
            "max_abs_logit": float(served.abs().max())})


def replay_prefill(torch, serve, T, res, bk):
    """Request 0's prefill through ``bk`` on the run's own weights."""
    cache = T.init_cache(res.cfg, 1, SERVE_PROMPT + SERVE_STEPS + 1,
                         device=res.prompt.device)
    with torch.no_grad():
        logits, _ = serve.prefill_step(bk, res.params, res.cfg, cache,
                                       res.prompt[:1])
    return logits


GEMM_KERNEL_NAMES = ("quant_gemv_kernel", "quant_sgemm_kernel")  # 1 and 3
HEAD_KERNEL_MARK = "PassThrough"  # the same body as the LM head (f32_matmul)
TRACE_STEPS = 8
STEP_MARK = "chip_smoke.decode_step"


def op_device_us(e):
    """Device µs of the kernels an op launched, its children's included."""
    return (sum(k.duration for k in e.kernels)
            + sum(op_device_us(c) for c in e.cpu_children))


def step_split(prof):
    """Per decode step of a profiler trace whose steps each open a
    ``record_function(STEP_MARK)``, over the window from one step's start
    to the next (so the last step only closes a window): its length, and
    the device ms of the GEMM kernels (1 and 3), of attention (kernel 2's
    chunk and combine kernels, or the composed path's einsum and softmax
    ops), of the LM head (the f32_matmul kernel: the GEMM body
    instantiated with its PassThrough functor), of the other kernels, and
    the gap in which the device was idle."""
    from torch.autograd import DeviceType

    evts = list(prof.events())
    # the marks' CPU ranges; on the device, the kernels and copies (the
    # marks' device-side copies are annotations, not activity)
    starts = sorted(e.time_range.start for e in evts if e.name == STEP_MARK
                    and e.device_type == DeviceType.CPU)
    kernels = [e for e in evts if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation and e.name != STEP_MARK]
    ops = [e for e in evts if e.device_type == DeviceType.CPU
           and e.name in ("aten::einsum", "aten::softmax")]
    rows = []
    for lo, hi in zip(starts, starts[1:]):
        inside = lambda e: lo <= e.time_range.start < hi
        ks = [e for e in kernels if inside(e)]
        busy = sum(e.time_range.elapsed_us() for e in ks)
        lm_head = sum(e.time_range.elapsed_us() for e in ks
                      if HEAD_KERNEL_MARK in e.name)
        gemm = sum(e.time_range.elapsed_us() for e in ks
                   if any(n in e.name for n in GEMM_KERNEL_NAMES)) - lm_head
        attn = sum(e.time_range.elapsed_us() for e in ks
                   if "flash_decode" in e.name)
        # the composed attention's einsum and softmax ops (the LM head is
        # no longer an einsum on the card)
        attn += sum(op_device_us(o) for o in filter(inside, ops))
        rows.append({"ms": (hi - lo) / 1e3, "gemm_ms": gemm / 1e3,
                     "attention_ms": attn / 1e3, "lm_head_ms": lm_head / 1e3,
                     "other_ms": (busy - gemm - attn - lm_head) / 1e3,
                     "idle_ms": (hi - lo - busy) / 1e3,
                     "kernels": len(ks)})
    if not rows:
        raise AssertionError("the trace holds no decode step")
    return {key: sorted(r[key] for r in rows)[len(rows) // 2]
            for key in rows[0]} | {"steps_traced": len(rows)}


def decode_trace(torch, serve, T, res):
    """Decode steps of a served run's own weights, backend and prompt from
    a fresh cache: TRACE_STEPS timed by the host clock (each ends in a
    synchronize; their median), then TRACE_STEPS + 1 under torch.profiler
    split by :func:`step_split` (medians over the steps)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    bk = serve._backend(res.config)
    cache = T.init_cache(res.cfg, res.prompt.shape[0],
                         SERVE_PROMPT + SERVE_STEPS + 1,
                         device=res.prompt.device)
    state = {"pos": SERVE_PROMPT}
    with torch.no_grad():
        logits, state["cache"] = serve.prefill_step(bk, res.params, res.cfg,
                                                    cache, res.prompt)
        state["tok"] = torch.argmax(logits[:, -1, :], dim=-1)

        def step():
            state["tok"], _, state["cache"] = serve.decode_step(
                bk, res.params, res.cfg, state["cache"],
                state["tok"][:, None], state["pos"])
            torch.cuda.synchronize()
            state["pos"] += 1

        host = []
        for _ in range(TRACE_STEPS):
            t0 = time.perf_counter()
            step()
            host.append(1e3 * (time.perf_counter() - t0))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(TRACE_STEPS + 1):
                with record_function(STEP_MARK):
                    step()
    return {"host_ms_median": sorted(host)[len(host) // 2],
            "host_ms": host, "traced": step_split(prof)}


def phase_serve(torch, serve, qmm, fd, T):
    """The certified custom-format path: kernels 1 and 2."""
    emit("free", before="serve", allocated_gb=free_device_memory(torch))
    fns = kernel_fns(qmm, fd)
    # keep the inputs the path gives each kernel, to hold them against the
    # plain versions after the run: each GEMM (M, K, N, format) at its first
    # launch (a copy of x; weights are not written), decode attention at its
    # first launch (copies) and its last (the cache is not written after).
    # The spies wrap serving's dispatches, which launch the kernels.
    dispatch_qmm = serve.quant_matmul_format_dispatch
    dispatch_fd = serve.certified_decode_attention
    gemm_in, flash_in = {}, {}

    def spy_qmm(x, w, fmt, **kw):
        x2 = x.reshape(-1, x.shape[-1])
        key = (*x2.shape, w.shape[1], tuple(fmt))
        if key not in gemm_in:
            gemm_in[key] = (x2.clone(), w.contiguous(), fmt, kw)
        return dispatch_qmm(x, w, fmt, **kw)

    def spy_fd(q, k, v, lengths, fmt, **kw):
        args = tuple(t.contiguous() for t in (q, k, v, lengths))
        if "first" not in flash_in:
            flash_in["first"] = (*(t.clone() for t in args), fmt, kw)
        flash_in["last"] = (*args, fmt, kw)
        return dispatch_fd(q, k, v, lengths, fmt, **kw)

    expected = {"quant_matmul_format": 7 * L_FULL * (1 + SERVE_STEPS),
                "flash_decode_certified": L_FULL * SERVE_STEPS,
                "quant_matmul": 0, "flash_decode_attention": 0,
                **ANALYSIS_KERNELS_IDLE,
                **row_order_launches(1 + SERVE_STEPS)}
    serve.quant_matmul_format_dispatch = spy_qmm
    serve.certified_decode_attention = spy_fd
    try:
        res, launches = run_serve(
            torch, serve, fns,
            serve_argv("--layer-format", json.dumps(SERVE_FORMAT)), expected)
    finally:
        serve.quant_matmul_format_dispatch = dispatch_qmm
        serve.certified_decode_attention = dispatch_fd

    # the kernels against their plain versions on the path's own inputs
    main_path = {"quant_matmul_format": [], "flash_decode_certified": []}
    for (M, K, N, fmt), (x, w, _, kw) in sorted(gemm_in.items()):
        _, st = check_gemm(torch, qmm, x, w, fmt,
                           (kw["has_subnormals"], kw["saturating"]))
        main_path["quant_matmul_format"].append(
            {"M": M, "K": K, "N": N, "format": list(fmt), **st})
    for when, (q, k, v, lengths, fmt, kw) in flash_in.items():
        st = check_flash(torch, fd, q, k, v, lengths, fmt,
                         (kw["has_subnormals"], kw["saturating"]))
        main_path["flash_decode_certified"].append(
            {"call": when, "Smax": k.shape[1], "lengths": lengths.tolist(),
             "format": list(fmt), **st})
    del gemm_in, flash_in

    # replay request 0's prefill through the plain versions
    class RefFormatOps(serve.FormatQuantJOps):
        def matmul(self, a, b):
            return qmm.quant_matmul_format_ref(
                a, b, self.format_for(self.scope_path),
                has_subnormals=self.has_subnormals,
                saturating=self.saturating)

        def decode_attention(self, q, k, v, lengths):
            return fd.flash_decode_quantized_ref(
                q, k, v, lengths, self.format_for(self.scope_path),
                has_subnormals=self.has_subnormals,
                saturating=self.saturating)

    before = read_launches(fns)
    with plain_row_order():
        ref_logits = replay_prefill(torch, serve, T, res,
                                    RefFormatOps(SERVE_FORMAT))
    if read_launches(fns) != before:
        raise AssertionError("the plain replay launched a kernel")
    trace = decode_trace(torch, serve, T, res)
    emit("serve", layer_format=SERVE_FORMAT,
         **serve_report(torch, res, launches, expected, ref_logits),
         main_path_inputs_vs_plain=main_path, decode_trace=trace)
    return launches, main_path, res.timing | {"decode_trace": trace}


PROJ_ORDER = tuple(GEMM_SHAPES)   # the order a layer launches its GEMMs


def write_v2_set(spec) -> Path:
    """A schema-v2 CertificateSet (one class, serving_k = MIXED_K, the
    per-layer map MIXED_LAYER_K) written with the port's certify/spec.py.
    Its bounds are +inf ("no bound of this kind"): no analysis ran, the set
    only drives the per-layer serving path."""
    cert = spec.Certificate(
        model_id="qwen2-7b/chip-smoke", params_digest="0" * 64,
        class_key="prompt128", cfg=spec.CaaConfig(),
        bounds_u_max=2.0 ** (1 - MIXED_K), final_abs_u=float("inf"),
        final_rel_u=float("inf"), required_k=MIXED_K, satisfied_by=[],
        layer_k=dict(MIXED_LAYER_K))
    cs = spec.CertificateSet(model_id=cert.model_id,
                             params_digest=cert.params_digest,
                             certificates=[cert])
    if cs.serving_k != MIXED_K or cs.serving_layer_k != MIXED_LAYER_K:
        raise AssertionError(f"set resolves to {cs.serving_k}, "
                             f"{cs.serving_layer_k}")
    path = ROOT / "build" / "chip_smoke_v2_certificate_set.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(cs.to_json())
    return path


def phase_serve_k(torch, serve, qmm, fd, T, name, extra, want_ks):
    """A mantissa-k serving path (uniform ``--precision-k`` or a v2
    ``--certificate-set``): kernel 3 on every GEMM, the composed unrounded
    decode attention. ``want_ks`` is the k each of the seven projections
    of layers 0 and 1 must resolve to."""
    emit("free", before=name, allocated_gb=free_device_memory(torch))
    fns = kernel_fns(qmm, fd)
    dispatch = serve.quant_matmul_dynamic_k
    gemm_in, ks_seen = {}, []

    def spy(x, w, k):
        x2 = x.reshape(-1, x.shape[-1])
        key = (*x2.shape, w.shape[1], int(k))
        if key not in gemm_in:
            gemm_in[key] = (x2.clone(), w.contiguous())
        ks_seen.append(int(k))
        return dispatch(x, w, k)

    expected = {"quant_matmul_format": 0, "flash_decode_certified": 0,
                "quant_matmul": 7 * L_FULL * (1 + SERVE_STEPS),
                "flash_decode_attention": L_FULL * SERVE_STEPS,
                **ANALYSIS_KERNELS_IDLE,
                **row_order_launches(1 + SERVE_STEPS)}
    # kernel 4 (TorchOps.decode_attention): its first and last launches
    fd_spy = FirstLastSpy(fd.flash_decode_attention)
    serve.quant_matmul_dynamic_k = spy
    fd.flash_decode_attention = fd_spy
    try:
        res, launches = run_serve(torch, serve, fns, serve_argv(*extra),
                                  expected)
    finally:
        serve.quant_matmul_dynamic_k = dispatch
        fd.flash_decode_attention = fd_spy.fn
    resolved = {f"layer{i}": dict(zip(PROJ_ORDER, ks_seen[7 * i:7 * i + 7]))
                for i in range(2)}
    if resolved != want_ks:
        raise AssertionError(f"{name}: projections resolved to {resolved}, "
                             f"not {want_ks}")

    main_path = []
    for (M, K, N, k), (x, w) in sorted(gemm_in.items()):
        _, st = check_gemm_k(torch, qmm, x, w, k)
        main_path.append({"M": M, "K": K, "N": N, "k": k, **st})
    del gemm_in
    attn_path = flash_attention_rows(torch, fd, fd_spy.seen)
    del fd_spy

    # replay request 0's prefill with the plain version on every GEMM
    before = read_launches(fns)
    serve.quant_matmul_dynamic_k = qmm.quant_matmul_ref
    try:
        with plain_row_order():
            ref_logits = replay_prefill(torch, serve, T, res,
                                        serve._backend(res.config))
    finally:
        serve.quant_matmul_dynamic_k = dispatch
    if read_launches(fns) != before:
        raise AssertionError("the plain replay launched a kernel")
    trace = decode_trace(torch, serve, T, res)
    emit(name, precision_k=res.config.precision_k,
         precision_layer_k=res.config.precision_layer_k,
         backend=type(serve._backend(res.config)).__name__,
         resolved_k_layers01=resolved,
         **serve_report(torch, res, launches, expected, ref_logits),
         main_path_inputs_vs_plain={"quant_matmul": main_path,
                                    "flash_decode_attention": attn_path},
         decode_trace=trace)
    return launches, main_path, attn_path, res.timing | {
        "decode_trace": trace}


def flash_attention_rows(torch, fd, seen):
    """Kernel 4 against its plain version (and the f64 split version) on
    the inputs a path gave it: {launch tag: (q, k, v, lengths)}."""
    rows = []
    for when, (q, k, v, lengths) in sorted(seen.items()):
        st = check_flash_attention(torch, fd, q, k, v, lengths, when)
        rows.append({"launch": when, "Smax": k.shape[1],
                     "lengths": lengths.tolist(), **st})
    return rows


def uniform_ks(k_attn, k_mlp):
    return {p: (k_attn if p in ("wq", "wk", "wv", "wo") else k_mlp)
            for p in PROJ_ORDER}


# ---------------------------------------------------------------------------
# continuous batching over a per-lane cache, served from the certificate store
# ---------------------------------------------------------------------------

BATCH_ENGINE = {"n_lanes": 4, "max_seq": 256, "page_size": 16,
                "total_pages": 24, "queue_depth": 8}
BATCH_REQUESTS, BATCH_K_REQUESTS = 8, 4
BATCH_PROMPT = (40, 120)          # prompt lengths drawn in this range
BATCH_MAX_NEW, BATCH_STRIDE = 16, 2
BATCH_LONG_PROMPT = 250           # + max_new > max_seq: rejected too_long
BATCH_EOS_FROM = (2, 3)           # eos = request 2's 4th reference token


def batching_requests(torch, batching, vocab):
    """BATCH_REQUESTS requests from seed 0 (prompt lengths in BATCH_PROMPT,
    one every BATCH_STRIDE steps) and the over-long one, arriving at step
    1."""
    gen = torch.Generator().manual_seed(0)
    draw = lambda lo, hi, n: torch.randint(lo, hi, (n,), generator=gen)
    reqs = []
    for i in range(BATCH_REQUESTS):
        P = int(draw(BATCH_PROMPT[0], BATCH_PROMPT[1] + 1, 1))
        reqs.append(batching.Request(
            rid=i, prompt=draw(0, vocab, P).tolist(),
            max_new_tokens=BATCH_MAX_NEW, arrival_step=BATCH_STRIDE * i))
    too_long = batching.Request(
        rid=BATCH_REQUESTS, prompt=draw(0, vocab, BATCH_LONG_PROMPT).tolist(),
        max_new_tokens=BATCH_MAX_NEW, arrival_step=1)
    return reqs, too_long


def write_format_entry(spec, formats, store, pipeline, root, cfg, digest):
    """A schema-v3 set whose format map is SERVE_FORMAT, written with the
    port's ``put`` under the port's key for these params (the format
    pipeline's request, k_max 53). Its bounds are +inf: no analysis ran,
    the entry only drives serving. Returns (key, path)."""
    key, request = pipeline.serving_request("qwen2_7b", cfg, digest,
                                            formats=True, k_max=53)
    layer_format = {
        s: formats.FpFormat(f"custom_k{f['k']}_e{f['emax']}_{f['emin']}",
                            k=f["k"], emax=f["emax"], emin=f["emin"],
                            has_subnormals=True, saturating=True).to_dict()
        for s, f in SERVE_FORMAT.items()}
    cert = spec.Certificate(
        model_id="lm/qwen2_7b", params_digest=digest,
        class_key=f"lm/{cfg.name}/tokens[1x8]seed1",
        cfg=spec.CaaConfig(u_max=2.0 ** -52), bounds_u_max=2.0 ** -52,
        final_abs_u=float("inf"), final_rel_u=float("inf"), required_k=None,
        satisfied_by=[], layer_format=layer_format)
    cs = spec.CertificateSet(model_id=cert.model_id, params_digest=digest,
                             certificates=[cert])
    return key, store.CertificateStore(str(root)).put(key, cs, request)


def lane_bits(torch, served, ref):
    """Per request: tokens equal, logit rows equal bit for bit (and the
    first row that is not: 0 is the prefill's), the largest |Δlogit|, and
    at the first differing token (if any) the top-1 gap of the reference's
    logits."""
    rows = []
    for r in served:
        want_toks, want_lg = ref[r["id"]]
        got_lg = r["logits"]
        n = min(len(got_lg), len(want_lg))
        row = {"id": r["id"], "tokens_equal": r["tokens"] == want_toks,
               "logits_bitwise": (got_lg.shape == want_lg.shape
                                  and same_bits(torch, got_lg, want_lg)),
               "first_row_differing": next(
                   (i for i in range(n)
                    if not same_bits(torch, got_lg[i], want_lg[i])), None),
               "max_abs_dlogit": float((got_lg[:n].double()
                                        - want_lg[:n].double()).abs().max())}
        if not row["tokens_equal"]:
            i = next(j for j, (a, b) in enumerate(zip(r["tokens"],
                                                      want_toks)) if a != b)
            top2 = torch.topk(want_lg[i], 2).values
            row.update(first_diff=i, ref_top1_gap=float(top2[0] - top2[1]))
        rows.append(row)
    return rows


def run_batching(torch, batching, fns, cfg, sc, params, reqs, certset,
                 eos_id, expected_of):
    """One engine run with every launch counter set to 0 just before and
    read just after; raises unless the counts are ``expected_of(engine,
    admitted)``. Returns (engine, responses, launches, registry, wall s)."""
    from repro_torch import obs

    registry = obs.MetricsRegistry()
    engine = batching.ContinuousBatchingEngine(
        cfg, sc, params, registry=registry, certset=certset, eos_id=eos_id,
        device="cuda", keep_logits=True, **BATCH_ENGINE)
    torch.cuda.synchronize()
    reset_launches(fns)
    t0 = time.perf_counter()
    responses = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(fns)
    admitted = registry.counters.get("serve.requests_admitted", 0)
    expected = expected_of(engine, admitted)
    if launches != expected:
        raise AssertionError(f"batching launch counts {launches} != "
                             f"{expected}")
    return engine, responses, launches, registry, wall


def batching_report(engine, responses, registry, wall):
    steps, lanes = engine.steps, engine.n_lanes
    return dict(
        steps=steps, decode_tokens=engine.decode_tokens,
        decode_tokens_per_s=engine.decode_tokens / engine.decode_s,
        decode_ms_per_step=1e3 * engine.decode_s / steps,
        mean_occupancy=engine.decode_tokens / (steps * lanes),
        wall_s=wall, page_waits=engine.page_waits,
        prefill_ms={r["id"]: 1e3 * r["prefill_s"] for r in responses},
        lanes={r["id"]: r["lane"] for r in responses},
        completion_order=[r["id"] for r in responses],
        counters=registry.counters,
        tokens={r["id"]: r["tokens"] for r in responses})


def library_lane_bits(torch, cfg, device="cuda", lanes=4, S=256, P=83,
                      page=16, seed=5):
    """Whether the library products on the batching engine's path keep a
    lane's bits, on seeded inputs at ``cfg``'s widths: each product over
    ``lanes`` lanes against each lane alone (decode), and over a prompt of
    ``P`` rows padded to whole pages against the unpadded one (prefill).
    Returns {product: {"bitwise": bool, "max_abs_diff": float}}. The
    products: the LM head (``einsum('bsd,vd->bsv')``), the plain
    backend's ``torch.matmul`` at each projection width, the composed
    attention's score and P·V einsums and its softmax, and the rmsnorm's
    mean of squares."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, device=device, generator=gen)
    d, Kh, D = cfg.d_model, cfg.n_kv_heads, cfg.head_dim
    G = cfg.n_heads // Kh
    p_pad = page * -(-P // page)
    out = {}

    def record(name, got, want):
        out[name] = {"bitwise": same_bits(torch, got, want),
                     "max_abs_diff": float((got.double() - want.double())
                                           .abs().max())}

    def decode(name, fn, *args):
        alone = torch.cat([fn(*(a[b:b + 1] if a.shape[0] == lanes else a
                                for a in args)) for b in range(lanes)])
        record(name, fn(*args), alone)

    def prefill(name, fn, x, rows_dim, *rest):
        full = fn(x, *rest).narrow(rows_dim, 0, P)
        record(name, full, fn(x.narrow(rows_dim - (x.dim() - full.dim()),
                                       0, P), *rest))

    head = rnd(cfg.vocab, d)
    lm_head = lambda x, w: torch.einsum("bsd,vd->bsv", x, w)
    decode("lm_head_decode", lm_head, rnd(lanes, 1, d), head)
    prefill("lm_head_prefill", lm_head, rnd(1, p_pad, d), 1, head)
    del head
    for n in sorted({cfg.n_heads * D, Kh * D, cfg.d_ff}):
        w = rnd(d, n)
        decode(f"matmul_decode_n{n}", torch.matmul, rnd(lanes, 1, d), w)
        prefill(f"matmul_prefill_n{n}", torch.matmul, rnd(1, p_pad, d), 1, w)
    scores = lambda q, k: torch.einsum("bqkgd,bskd->bkgqs", q, k)
    pv = lambda p, v: torch.einsum("bkgqs,bskd->bqkgd", p, v)
    decode("scores_decode", scores, rnd(lanes, 1, Kh, G, D),
           rnd(lanes, S, Kh, D))
    decode("pv_decode", pv, rnd(lanes, Kh, G, 1, S).softmax(-1),
           rnd(lanes, S, Kh, D))
    k1, v1 = rnd(1, S, Kh, D), rnd(1, S, Kh, D)
    q_pad = rnd(1, p_pad, Kh, G, D)
    record("scores_prefill", scores(q_pad, k1)[..., :P, :],
           scores(q_pad[:, :P], k1))
    p_pad_probs = rnd(1, Kh, G, p_pad, S).softmax(-1)
    record("pv_prefill", pv(p_pad_probs, v1)[:, :P],
           pv(p_pad_probs[..., :P, :], v1))
    soft = lambda s: torch.softmax(s, dim=-1)
    decode("softmax_decode", soft, rnd(lanes, Kh, G, 1, S))
    s_pad = rnd(1, Kh, G, p_pad, S)
    record("softmax_prefill", soft(s_pad)[..., :P, :], soft(s_pad[..., :P, :]))
    msq = lambda x: (x * x).mean(dim=-1, keepdim=True)
    decode("mean_square_decode", msq, rnd(lanes, 1, d))
    prefill("mean_square_prefill", msq, rnd(1, p_pad, d), 1)
    return out


# every TorchOps op the transformer runs (op_lane_bits, exact_maxima)
LANE_OPS = ("param", "input", "const", "add", "sub", "mul", "scale",
            "shift", "matmul", "einsum", "tanh", "rsqrt", "square", "relu",
            "silu", "softmax", "mean", "maximum", "where", "reshape",
            "broadcast_to", "concat", "take", "slice", "decode_attention")


def op_lane_bits(torch, serve, T, cfg, params, bk, lengths=(1, 17, 64, 65),
                 smax=96, seed=1):
    """Every backend op of one ragged decode step, each lane against the
    same lane run alone at B = 1: lane b sits at offset lengths[b] - 1 of a
    per-lane cache holding seeded values below it and NaN from lengths[b]
    on. ``bk`` is the serving backend under test (its class is wrapped, so
    every op it runs is recorded in order). Returns {"ops": n compared,
    "differing": [(i, op, scope, max |Δ|), ...] (at most 12), "by_op":
    {op: [compared, differing]}}."""
    dev = params["embed"].device
    B = len(lengths)
    records = []

    class Recorded(type(bk)):
        pass

    def wrap(name):
        def op(self, *a, **kw):
            out = getattr(super(Recorded, self), name)(*a, **kw)
            if isinstance(out, torch.Tensor):
                records[-1].append((name, "/".join(self.scope_path), out))
            return out
        return op

    for name in LANE_OPS:
        setattr(Recorded, name, wrap(name))
    rec = Recorded.__new__(Recorded)
    rec.__dict__.update(bk.__dict__)

    def cache_for(lanes):
        gen = torch.Generator(device=dev).manual_seed(seed)
        c = T.init_cache(cfg, B, smax, device=dev, per_lane_idx=True)
        for name in ("k", "v"):
            c[name].normal_(generator=gen)
            for b, n in enumerate(lengths):
                c[name][:, b, n:] = float("nan")
        if lanes is not None:
            c = {name: c[name][:, lanes].clone() for name in ("k", "v")} | {
                "idx": c["idx"][:, lanes].clone()}
        return c

    tokens = torch.arange(B, device=dev) * 7 + 3

    def step(lanes):
        sel = list(range(B)) if lanes is None else lanes
        c = cache_for(lanes)
        offs = torch.tensor([lengths[b] for b in sel], dtype=torch.int32,
                            device=dev) - 1
        c["idx"].copy_(offs[None, :].expand_as(c["idx"]))
        records.append([])
        with torch.no_grad():
            T.forward(rec, params, cfg, tokens[sel][:, None], cache=c,
                      q_offset=offs)
        return records[-1]

    batch = step(None)
    by_op, differing, n = {}, [], 0
    for b in range(B):
        alone = step([b])
        if [r[:2] for r in alone] != [r[:2] for r in batch]:
            raise AssertionError("a lane alone ran another op sequence")
        for i, ((name, scope, got), (_, _, want)) in enumerate(
                zip(batch, alone)):
            if got.dim() == 0 or got.shape[0] != B or want.shape[0] != 1:
                continue       # not lane-shaped (weights, constants)
            n += 1
            cnt = by_op.setdefault(name, [0, 0])
            cnt[0] += 1
            if not same_bits(torch, got[b:b + 1], want):
                cnt[1] += 1
                if len(differing) < 12:
                    ok = torch.isfinite(want)
                    d = (got[b:b + 1][ok].double() - want[ok].double())
                    differing.append((i, name, scope, float(d.abs().max())
                                      if d.numel() else math.nan))
    return {"ops": n, "differing": differing, "by_op": by_op}


def reference_runs(batching, cfg, sc, params, reqs, eos_id):
    """Every request alone through ``reference_generate`` (after the
    engine run's counts were read)."""
    return {req.rid: batching.reference_generate(
        cfg, sc, params, req.prompt, req.max_new_tokens,
        max_seq=BATCH_ENGINE["max_seq"], eos_id=eos_id, return_logits=True)
        for req in reqs}


def phase_batching(torch, serve, batching, qmm, fd, T):
    """Continuous batching at Qwen2-7B FULL (f32, random weights from seed
    0): 4 lanes over a per-lane cache of 256 positions in pages of 16, 28
    pages, 8 ragged requests (prompts 40-120, one every 2 steps) and one
    over-long one, an EOS that ends request 2 early; served under the
    format map read from a store entry written with the port's ``put``
    (kernels 1 and 2), then 4 requests at ``--precision-k 12`` (kernel 3).
    Every request's tokens must equal ``reference_generate``'s on the card;
    the launch counts are exact; kernel 2 must see ≥ 3 distinct lengths in
    one launch; kernels 1-3 are held against their plain versions on the
    inputs the phase gave them."""
    import shutil

    from repro_torch import configs
    from repro_torch.certify import pipeline, spec, store
    from repro_torch.core import formats

    emit("free", before="batching", allocated_gb=free_device_memory(torch))
    t_phase = time.perf_counter()
    fns = kernel_fns(qmm, fd)
    cfg = configs.get("qwen2_7b").FULL
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = T.init_params(cfg, generator=gen, device="cuda")
    torch.cuda.synchronize()

    # the store: an entry put under the port's key, then found by
    # apply_certificates, which digests the params again
    root = ROOT / "build" / "chip_smoke_store"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    digest = store.params_digest(params)
    digest_s = time.perf_counter() - t0
    key, path = write_format_entry(spec, formats, store, pipeline, root, cfg,
                                   digest)
    t0 = time.perf_counter()
    sc, certset = serve.apply_certificates(
        serve.ServeConfig(arch="qwen2_7b", batch=BATCH_ENGINE["n_lanes"],
                          max_seq=BATCH_ENGINE["max_seq"],
                          certificates=str(root)),
        cfg, params, formats=True, k_max=53)
    apply_s = time.perf_counter() - t0
    bk = serve._backend(sc)
    want_bk = serve.FormatQuantJOps(SERVE_FORMAT)
    paths = [["embed"], ["head"]] + [[f"layer{i}", s] for i in (0, 1, 27)
                                     for s in ("attn", "mlp")]
    if not isinstance(bk, serve.FormatQuantJOps) or any(
            bk.format_for(p) != want_bk.format_for(p) for p in paths):
        raise AssertionError(f"the store served {sc.precision_layer_format}")

    reqs, too_long = batching_requests(torch, batching, cfg.vocab)
    eos_req, eos_at = BATCH_EOS_FROM
    eos_id = batching.reference_generate(
        cfg, sc, params, reqs[eos_req].prompt, BATCH_MAX_NEW,
        max_seq=BATCH_ENGINE["max_seq"])[eos_at]

    # the format path, with kernel 1's inputs kept per (M, K, N, format)
    # (one prefill M and the decode M per shape) and kernel 2's lengths at
    # every launch, its q/k/v at layer 0's launches
    dispatch_qmm = serve.quant_matmul_format_dispatch
    dispatch_fd = serve.certified_decode_attention
    gemm_in, shapes_seen, flash_lengths, flash_in = {}, set(), [], {}

    def spy_qmm(x, w, fmt, **kw):
        x2 = x.reshape(-1, x.shape[-1])
        shape = (x2.shape[0] == BATCH_ENGINE["n_lanes"], *w.shape,
                 tuple(fmt))
        if shape not in shapes_seen:
            shapes_seen.add(shape)
            gemm_in[(*x2.shape, w.shape[1], tuple(fmt))] = (
                x2.clone(), w.contiguous(), fmt, kw)
        return dispatch_qmm(x, w, fmt, **kw)

    def spy_fd(q, k, v, lengths, fmt, **kw):
        if len(flash_lengths) % L_FULL == 0:
            flash_in[len(flash_lengths)] = (
                *(t.clone() for t in (q, k, v, lengths)), fmt, kw)
        flash_lengths.append(lengths.clone())
        return dispatch_fd(q, k, v, lengths, fmt, **kw)

    def expected_fmt(engine, admitted):
        return {"quant_matmul_format": 7 * L_FULL * (admitted + engine.steps),
                "flash_decode_certified": L_FULL * engine.steps,
                "quant_matmul": 0, "flash_decode_attention": 0,
                **ANALYSIS_KERNELS_IDLE,
                **row_order_launches(admitted + engine.steps)}

    # the fixed-order kernels' inputs, the first of each shape
    from repro_torch.kernels import row_order as ro
    ro_spies = [
        (ro, "row_mean", KernelSpy(ro.row_mean, lambda x: tuple(x.shape),
                                   lambda x: x.clone())),
        (ro, "f32_matmul", KernelSpy(
            ro.f32_matmul, lambda x, w: (*x.shape, w.shape[1]),
            lambda x, w: (x.clone(), w)))]
    serve.quant_matmul_format_dispatch = spy_qmm
    serve.certified_decode_attention = spy_fd
    for mod, name, spy in ro_spies:
        setattr(mod, name, spy)
    try:
        engine, responses, launches, registry, wall = run_batching(
            torch, batching, fns, cfg, sc, params, reqs + [too_long],
            certset, eos_id, expected_fmt)
    finally:
        serve.quant_matmul_format_dispatch = dispatch_qmm
        serve.certified_decode_attention = dispatch_fd
        for mod, name, spy in ro_spies:
            setattr(mod, name, spy.fn)
    fmt_report = batching_report(engine, responses, registry, wall)

    # the schedule's own gates
    if registry.counters.get("serve.requests_rejected{reason=too_long}") != 1:
        raise AssertionError(f"over-long request not rejected: "
                             f"{registry.counters}")
    if sorted(r["id"] for r in responses) != list(range(BATCH_REQUESTS)):
        raise AssertionError(f"served {fmt_report['completion_order']}")
    if engine.page_waits < 1:
        raise AssertionError("admission never waited for pages")
    eos_resp = next(r for r in responses if r["id"] == eos_req)
    order = fmt_report["completion_order"]
    recycled = [r["id"] for r in responses[order.index(eos_req) + 1:]
                if r["lane"] == eos_resp["lane"]]
    if eos_resp["tokens"][-1] != eos_id or len(eos_resp["tokens"]) >= \
            BATCH_MAX_NEW or not recycled:
        raise AssertionError(f"eos lane: {eos_resp['tokens']}, then "
                             f"{recycled}")
    distinct = [len(set(l.tolist())) for l in flash_lengths]
    if max(distinct) < 3:
        raise AssertionError(f"kernel 2 saw at most {max(distinct)} "
                             "distinct lengths in a launch")
    for r in responses:
        if r.get("certificate", {}).get("params_digest") != digest:
            raise AssertionError(f"request {r['id']} carries no certificate")

    # kernels 1 and 2 against their plain versions on the phase's inputs:
    # kernel 2 at the layer-0 launch with the most distinct lengths and at
    # the last layer-0 launch (check_flash also holds it to the f64 split
    # version)
    main_path = {"quant_matmul_format": [], "flash_decode_certified": []}
    for (M, K, N, fmt), (x, w, _, kw) in sorted(gemm_in.items()):
        _, st = check_gemm(torch, qmm, x, w, fmt,
                           (kw["has_subnormals"], kw["saturating"]))
        main_path["quant_matmul_format"].append(
            {"M": M, "K": K, "N": N, "format": list(fmt), **st})
    widest = max(flash_in, key=lambda i: (distinct[i], i))
    for when in sorted({widest, max(flash_in)}):
        q, k, v, lengths, fmt, kw = flash_in[when]
        st = check_flash(torch, fd, q, k, v, lengths, fmt,
                         (kw["has_subnormals"], kw["saturating"]))
        main_path["flash_decode_certified"].append(
            {"launch": when, "Smax": k.shape[1], "lengths": lengths.tolist(),
             "format": list(fmt), **st})
    del gemm_in, flash_in, flash_lengths
    main_path["row_mean"] = []
    for (R, n), x in sorted(ro_spies[0][2].seen.items()):
        main_path["row_mean"].append(
            {"R": R, "n": n, "bitwise_vs_plain": same_bits(
                torch, ro.row_mean(x), ro.row_mean_ref(x)[:, 0])})
    main_path["f32_matmul"] = []
    cols = torch.linspace(0, cfg.vocab - 1, HEAD_COLUMNS,
                          device="cuda").long()
    for (M, K, N), (x, w) in sorted(ro_spies[1][2].seen.items()):
        main_path["f32_matmul"].append(
            {"M": M, "K": K, "N": N, "columns": HEAD_COLUMNS,
             "bitwise_vs_plain": same_bits(
                 torch, ro.f32_matmul(x, w)[:, cols].contiguous(),
                 ro.f32_matmul_seq_ref(x, w[:, cols]))})
    del ro_spies
    bad = [r for k in ("row_mean", "f32_matmul") for r in main_path[k]
           if not r["bitwise_vs_plain"]]
    if bad:
        raise AssertionError(f"fixed-order kernels differ from their plain "
                             f"versions on the phase's inputs: {bad}")

    ref = reference_runs(batching, cfg, sc, params, reqs, eos_id)
    fmt_bits = lane_bits(torch, responses, ref)
    del ref, responses, engine
    # every op of one ragged decode step, each lane against itself alone
    fmt_ops = op_lane_bits(torch, serve, T, cfg, params,
                           serve.FormatQuantJOps(SERVE_FORMAT),
                           smax=BATCH_ENGINE["max_seq"])

    # the k path: kernel 3, the decode attention through kernel 4
    sc_k = serve.ServeConfig(arch="qwen2_7b", batch=BATCH_ENGINE["n_lanes"],
                             max_seq=BATCH_ENGINE["max_seq"],
                             precision_k=SERVE_K)
    dispatch_k = serve.quant_matmul_dynamic_k
    k_in, k_seen = {}, set()

    def spy_k(x, w, k):
        x2 = x.reshape(-1, x.shape[-1])
        shape = (x2.shape[0] == BATCH_ENGINE["n_lanes"], *w.shape, int(k))
        if shape not in k_seen:
            k_seen.add(shape)
            k_in[(*x2.shape, w.shape[1], int(k))] = (x2.clone(),
                                                     w.contiguous())
        return dispatch_k(x, w, k)

    def expected_k(engine, admitted):
        return {"quant_matmul_format": 0, "flash_decode_certified": 0,
                "quant_matmul": 7 * L_FULL * (admitted + engine.steps),
                "flash_decode_attention": L_FULL * engine.steps,
                **ANALYSIS_KERNELS_IDLE,
                **row_order_launches(admitted + engine.steps)}

    k_reqs = reqs[:BATCH_K_REQUESTS]
    fd_spy = FirstLastSpy(fd.flash_decode_attention)
    serve.quant_matmul_dynamic_k = spy_k
    fd.flash_decode_attention = fd_spy
    try:
        engine_k, responses_k, launches_k, registry_k, wall_k = run_batching(
            torch, batching, fns, cfg, sc_k, params, k_reqs, None, -1,
            expected_k)
    finally:
        serve.quant_matmul_dynamic_k = dispatch_k
        fd.flash_decode_attention = fd_spy.fn
    k_report = batching_report(engine_k, responses_k, registry_k, wall_k)
    k_path = {"quant_matmul": [],
              "flash_decode_attention": flash_attention_rows(
                  torch, fd, fd_spy.seen)}
    del fd_spy
    for (M, K, N, k), (x, w) in sorted(k_in.items()):
        _, st = check_gemm_k(torch, qmm, x, w, k)
        k_path["quant_matmul"].append({"M": M, "K": K, "N": N, "k": k, **st})
    del k_in
    ref_k = reference_runs(batching, cfg, sc_k, params, k_reqs, -1)
    k_bits = lane_bits(torch, responses_k, ref_k)
    del ref_k, responses_k, engine_k
    k_ops = op_lane_bits(torch, serve, T, cfg, params,
                         serve.QuantJOps(SERVE_K),
                         smax=BATCH_ENGINE["max_seq"])
    del params

    library = library_lane_bits(torch, cfg)
    launches_all = {name: launches[name] + launches_k[name]
                    for name in launches}
    emit("batching", config="qwen2_7b.FULL", engine=BATCH_ENGINE,
         requests=BATCH_REQUESTS, prompt_lengths=[len(r.prompt)
                                                  for r in reqs],
         max_new_tokens=BATCH_MAX_NEW, arrival_stride=BATCH_STRIDE,
         eos_id=eos_id, store={"key": key, "path": str(Path(path).relative_to(
             ROOT)), "params_digest": digest, "digest_s": digest_s,
             "apply_certificates_s": apply_s,
             "served_from_store": certset.meta.get("from_store")},
         format_path=fmt_report | {"launches": launches,
                                   "vs_reference": fmt_bits},
         k_path=k_report | {"precision_k": SERVE_K, "launches": launches_k,
                            "vs_reference": k_bits},
         kernel2_distinct_lengths_max=max(distinct),
         logits_bitwise_requests={
             "format": sum(b["logits_bitwise"] for b in fmt_bits),
             "k": sum(b["logits_bitwise"] for b in k_bits)},
         library_lane_bits=library,
         step_op_lane_bits={"format": fmt_ops, "k": k_ops},
         seconds=time.perf_counter() - t_phase,
         main_path_inputs_vs_plain={**main_path, **k_path})
    bad = [(p, b) for p, rows in (("format", fmt_bits), ("k", k_bits))
           for b in rows if not b["tokens_equal"]]
    if bad:
        raise AssertionError(f"tokens differ from reference_generate: {bad}")
    for path, rows in (("format", fmt_bits), ("k", k_bits)):
        bad = [b["id"] for b in rows if not b["logits_bitwise"]]
        if bad:
            raise AssertionError(f"{path} path: the logits of requests {bad} "
                                 "differ from reference_generate's bit for "
                                 "bit")
    for path, ops in (("format", fmt_ops), ("k", k_ops)):
        if ops["differing"]:
            raise AssertionError(f"{path} path: ops of a ragged step give a "
                                 f"lane other bits than alone: "
                                 f"{ops['differing']}")
    return launches_all, main_path, k_path, fmt_report | {"k": k_report}


class KernelSpy:
    """Stands in for a kernel wrapper in its module while a path runs:
    keeps the inputs of the first call of each ``key``, then calls the
    wrapper. A wrapper counts its launches under its own module-level name,
    which names the spy meanwhile, so ``launches`` reads and writes the
    wrapper's own count."""

    def __init__(self, fn, key, keep):
        self.fn, self.key, self.keep, self.seen = fn, key, keep, {}

    def __call__(self, *args, **kw):
        key = self.key(*args, **kw)
        if key not in self.seen:
            self.seen[key] = self.keep(*args, **kw)
        return self.fn(*args, **kw)

    launches = property(lambda self: self.fn.launches,
                        lambda self, n: setattr(self.fn, "launches", n))


class FirstLastSpy(KernelSpy):
    """A KernelSpy that keeps copies of the inputs of the first and of the
    last call, as ``seen["first"]`` / ``seen["last"]``."""

    def __init__(self, fn):
        super().__init__(fn, None, None)

    def __call__(self, *args):
        self.seen["last" if self.seen else "first"] = tuple(
            t.clone() for t in args)
        return self.fn(*args)


def profile_spies(qmm, fd):
    """(module, name, spy) for the three kernels the profile path launches;
    x and the flash inputs are copied, weights are not written."""
    def fmt_flags(has_subnormals=True, saturating=True):
        return has_subnormals, saturating

    return [
        (qmm, "quant_matmul", KernelSpy(
            qmm.quant_matmul,
            lambda x, w, *, k: (*x.shape, w.shape[1], int(k)),
            lambda x, w, *, k: (x.clone(), w))),
        (qmm, "quant_matmul_format", KernelSpy(
            qmm.quant_matmul_format,
            lambda x, w, fmt, **kw: (*x.shape, w.shape[1], tuple(fmt),
                                     fmt_flags(**kw)),
            lambda x, w, fmt, **kw: (x.clone(), w))),
        (fd, "flash_decode_attention", KernelSpy(
            fd.flash_decode_attention,
            lambda q, k, v, lengths: (*q.shape, k.shape[1]),
            lambda *args: tuple(t.clone() for t in args))),
    ]


def phase_profile(torch, obs, qmm, fd):
    """The kernel profiler at the serve shapes (every kernel name, the
    opt-in quant_matmul included), the serving profile at the reference's
    defaults (SMOKE, 2 layers) and at qwen2_7b.FULL (the serve phases'
    batch, prompt, steps and k), under the port's JSONL tracer. Each
    kernel is then held against its plain version on the inputs this
    path gave it, one per shape (and k or format)."""
    emit("free", before="profile", allocated_gb=free_device_memory(torch))
    fns = kernel_fns(qmm, fd)
    trace = ROOT / "build" / "chip_smoke_trace.jsonl"
    trace.parent.mkdir(parents=True, exist_ok=True)
    trace.unlink(missing_ok=True)
    shapes = [(M, K, N) for (K, N) in sorted(set(GEMM_SHAPES.values()))
              for M in (SERVE_BATCH, 512)]
    flash_shapes = [(SERVE_BATCH, SERVE_PROMPT + SERVE_STEPS + 1, 4, 7, 128),
                    (2, 256, 2, 2, 64)]
    reps, warmup = 5, 2
    spies = profile_spies(qmm, fd)
    for mod, name, spy in spies:
        setattr(mod, name, spy)
    reset_launches(fns)
    obs.configure(path=str(trace), program="chip_smoke.py")
    try:
        rows = obs.profile_kernels(
            gemm_shapes=shapes, ks=(SERVE_K,), formats=(FORMATS["k12_e15"],),
            flash_shapes=flash_shapes,
            include=obs.profile.ALL_KERNELS + ("quant_matmul",),
            reps=reps, warmup=warmup, device="cuda", hw=obs.H100_SXM)
        serving = obs.profile_serving(precision_k=SERVE_K, device="cuda")
        serving_full = obs.profile_serving(
            size="full", max_layers=None, batch=SERVE_BATCH,
            prefill_len=SERVE_PROMPT, decode_steps=SERVE_STEPS,
            precision_k=SERVE_K, device="cuda")
    finally:
        obs.shutdown()
        for mod, name, spy in spies:
            setattr(mod, name, spy.fn)
    launches = read_launches(fns)
    calls = reps + warmup
    n_serving = sum(7 * s["n_layers"] * (2 + s["decode_steps"])
                    for s in (serving, serving_full))
    row_order = [row_order_launches(2 + s["decode_steps"], s["n_layers"])
                 for s in (serving, serving_full)]
    # the serving profiles decode through TorchOps.decode_attention:
    # kernel 4 once a layer per decode forward (one untimed, then steps)
    n_attn = sum(s["n_layers"] * (1 + s["decode_steps"])
                 for s in (serving, serving_full))
    expected = {"quant_matmul_format": len(shapes) * calls,
                "flash_decode_certified": 0,
                "quant_matmul": 2 * len(shapes) * calls + n_serving,
                "flash_decode_attention": len(flash_shapes) * calls + n_attn,
                **ANALYSIS_KERNELS_IDLE,
                **{k: sum(r[k] for r in row_order) for k in row_order[0]}}
    if serving_full["n_layers"] != L_FULL:
        raise AssertionError(f"full-width profile ran "
                             f"{serving_full['n_layers']} layers")

    # the kernels against their plain versions on the path's own inputs
    qm_spy, fmt_spy, fd_spy = (spy.seen for _, _, spy in spies)
    main_path = {"quant_matmul": [], "quant_matmul_format": [],
                 "flash_decode_attention": []}
    for (M, K, N, k), (x, w) in sorted(qm_spy.items()):
        _, st = check_gemm_k(torch, qmm, x, w, k)
        main_path["quant_matmul"].append(
            {"M": M, "K": K, "N": N, "k": k, **st})
    for (M, K, N, fmt, flags), (x, w) in sorted(fmt_spy.items()):
        _, st = check_gemm(torch, qmm, x, w, fmt, flags)
        main_path["quant_matmul_format"].append(
            {"M": M, "K": K, "N": N, "format": list(fmt), **st})
    for (B, Kh, G, D, S), (q, k, v, lengths) in sorted(fd_spy.items()):
        st = check_flash_attention(torch, fd, q, k, v, lengths,
                                   f"B{B}S{S}K{Kh}G{G}D{D}")
        main_path["flash_decode_attention"].append(
            {"B": B, "S": S, "K": Kh, "G": G, "D": D,
             "lengths": lengths.tolist(), **st})
    del spies, qm_spy, fmt_spy, fd_spy

    events = obs.load_events(str(trace))
    problems = obs.validate_events(events)
    spans = {}
    for e in events:
        if e["type"] == "span":
            spans[e["name"]] = spans.get(e["name"], 0) + 1
    emit("profile", hardware=obs.H100_SXM.to_dict(),
         launches=launches, expected_launches=expected,
         rows=[{key: r.get(key) for key in (
             "kernel", "shape", "k", "median_s", "roofline_s", "bound",
             "roofline_frac", "achieved_flops_per_s",
             "achieved_bytes_per_s", "route")} for r in rows],
         serving=serving, serving_full=serving_full,
         trace=str(trace.relative_to(ROOT)),
         trace_events=len(events), span_counts=spans,
         validate_events=problems, tolerance={
             "quant_matmul": GEMM_K_TOLERANCE,
             "flash_decode_attention": FLASH_TOLERANCE},
         main_path_inputs_vs_plain=main_path)
    if problems:
        raise AssertionError(f"trace does not validate: {problems[:5]}")
    if {r["route"] for r in rows} != {"cuda"}:
        raise AssertionError("a profile row did not run on the card")
    if launches != expected:
        raise AssertionError(f"profile launch counts {launches} != "
                             f"{expected}")
    return launches, rows, main_path


# ---------------------------------------------------------------------------
# the range, affine and layer-stacked CAA passes (the evidence behind format
# certificates) at Qwen2-7B's width
# ---------------------------------------------------------------------------

RANGES_LAYERS, RANGES_TOKENS = 2, 8     # depth cut; one sequence of 8
RANGES_UMAX = 2.0 ** -20                # the IA passes' u_max
RANGES_FMTS = {"layer*": 12, "layer*/mlp": 10}   # custom(k) per scope
RANGES_FMT_DEFAULT = 14
RANGES_SUB = ("attn", "mlp")


def ranges_keys(n_layers):
    return ["embed", "head"] + [f"layer{i}{s}" for i in range(n_layers)
                                for s in ("", "/attn", "/mlp")]


def lm_forward(T, cfg, tokens):
    """The transformer as a classifier-shaped ``forward(bk, params, x)``
    (the reference's certify_lm adapter): the last position's logits; the
    dummy ``x`` is not read."""
    from repro_torch.core import caa

    def forward(bk, params, x):
        logits, _ = T.forward(bk, params, cfg, tokens)
        if not bk.is_analysis:
            return logits[:, -1:]
        return caa.slice_(logits, (slice(None), slice(-1, None)))

    return forward


def exact_maxima(torch, forward, params, x, keys):
    """max |v| per key over every tensor the exact f64 forward
    (TorchOps(f64)) produces or consumes, observed per scope path as the
    range passes observe, paths assigned to keys as aggregate_ranges
    assigns them."""
    from repro_torch.core.backend import TorchOps
    from repro_torch.core.scopes import resolve_scope_value

    seen = {}

    class Observed(TorchOps):
        pass

    def wrap(name):
        def op(self, *a, **kw):
            out = getattr(super(Observed, self), name)(*a, **kw)
            path = "/".join(self.scope_path)
            for t in (out,) + a:
                if torch.is_tensor(t) and t.is_floating_point() and t.numel():
                    m = t.abs().amax()
                    seen[path] = m if path not in seen else torch.maximum(
                        seen[path], m)
            return out
        return op

    for name in LANE_OPS:
        setattr(Observed, name, wrap(name))
    with torch.no_grad():
        forward(Observed(torch.float64), params, x)
    ident = {k: k for k in keys}
    out = {}
    for path, v in seen.items():
        k = resolve_scope_value([p for p in path.split("/") if p], ident, "")
        out[k] = max(out.get(k, 0.0), float(v))
    return out


def same_range_maps(a, b, what, rel=1e-9):
    """Raise unless two {key: RangeStat} maps have the same keys, n_ops and
    crosses_zero, and max_abs / min_nonzero within ``rel`` (inf equal)."""
    if set(a) != set(b):
        raise AssertionError(f"{what}: keys {sorted(set(a) ^ set(b))}")
    worst = 0.0
    for k in a:
        x, y = a[k], b[k]
        if (x.n_ops, x.crosses_zero) != (y.n_ops, y.crosses_zero):
            raise AssertionError(f"{what} {k!r}: {x} != {y}")
        for f in ("max_abs", "min_nonzero"):
            u, v = getattr(x, f), getattr(y, f)
            if math.isinf(u) or math.isinf(v):
                if u != v:
                    raise AssertionError(f"{what} {k!r} {f}: {u} != {v}")
                continue
            r = abs(u - v) / max(abs(v), 1e-300)
            if r > rel:
                raise AssertionError(f"{what} {k!r} {f}: {u} vs {v}")
            worst = max(worst, r)
    return worst


def range_map_json(m):
    return {k: v.to_dict() for k, v in sorted(m.items())}


def run_ranges(torch, A, forward, params, x, cfg, fmts, dflt, n_layers,
               timed=None):
    """The four drivers over one model: eager IA, stacked IA (sub-layer
    lanes), eager and stacked affine, then tighten; ``timed`` collects the
    seconds and peak device memory of each pass."""
    keys = ranges_keys(n_layers) if n_layers else None

    def run(name, fn):
        if timed is not None:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        if timed is not None:
            torch.cuda.synchronize()
            timed[name] = {
                "seconds": time.perf_counter() - t0,
                "max_memory_allocated_gb":
                    torch.cuda.max_memory_allocated() / 1e9}
        return out

    got = {"ia": run("analyze_ranges", lambda: A.analyze_ranges(
        forward, params, x, cfg, keys=keys))}
    got["aff"] = run("analyze_ranges_affine_eager",
                     lambda: A.analyze_ranges_affine(
                         forward, params, x, fmts, dflt, keys=keys,
                         stacked=False, sublanes=RANGES_SUB))
    if n_layers:
        got["ia_stacked"] = run(
            "analyze_ranges_stacked", lambda: A.analyze_ranges_stacked(
                forward, params, x, cfg, keys=keys, sublanes=RANGES_SUB))
        got["aff_stacked"] = run(
            "analyze_ranges_affine_stacked", lambda: A.analyze_ranges_affine(
                forward, params, x, fmts, dflt, keys=keys, stacked=True,
                sublanes=RANGES_SUB))
    got["tight"] = run("tighten_range_maps",
                       lambda: A.tighten_range_maps(got["ia"], got["aff"]))
    return got


def phase_ranges(torch, qmm, fd, cfg=None, dev="cuda"):
    """The range, affine and stacked CAA passes through the port's drivers
    at Qwen2-7B's full width (qwen2_7b.FULL, depth cut to 2 layers, f32
    random weights from seed 0, one sequence of 8 seeded tokens): eager
    and stacked IA, eager and stacked affine, tighten, scope discovery and
    the stacked sensitivity. Gates: stacked == eager per scope (1e-9
    relative, crosses_zero and n_ops equal), for IA and for affine; the
    tightened map below both; every affine enclosure finite; every value
    of the exact f64 forward inside its scope's max_abs in both maps; no
    kernel launched (the passes reach no kernel, as in the reference).
    Then the card's maps against the CPU port's at qwen2_7b.SMOKE and on
    the Digits and ConvNet models at full width."""
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.core import analyze as A
    from repro_torch.core import caa
    from repro_torch.core import formats as F
    from repro_torch.data import synthetic_digits
    from repro_torch.models import paper_models as PM
    from repro_torch.models import transformer as T

    emit("free", before="ranges", allocated_gb=free_device_memory(torch))
    t_phase = time.perf_counter()
    fns = kernel_fns(qmm, fd)
    cfg = cfg or dataclasses.replace(configs.get("qwen2_7b").FULL,
                                     n_layers=RANGES_LAYERS)
    params = T.init_params(cfg, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    tokens = torch.randint(0, cfg.vocab, (1, RANGES_TOKENS),
                           generator=torch.Generator().manual_seed(1))
    fw = lm_forward(T, cfg, tokens.to(dev))
    x = caa.make(torch.zeros((1, 1), dtype=torch.float64, device=dev))
    ccfg = caa.CaaConfig(u_max=RANGES_UMAX)
    fmts = {k: F.custom(v) for k, v in RANGES_FMTS.items()}
    dflt = F.custom(RANGES_FMT_DEFAULT)
    timed = {}
    torch.cuda.synchronize()
    reset_launches(fns)
    got = run_ranges(torch, A, fw, params, x, ccfg, fmts, dflt,
                     RANGES_LAYERS, timed)
    t0 = time.perf_counter()
    scopes = A.discover_scopes_stacked(fw, params, x, RANGES_LAYERS, ccfg)
    timed["discover_scopes_stacked"] = {"seconds": time.perf_counter() - t0}
    t0 = time.perf_counter()
    sens = A.sensitivity_stacked(fw, params, x, scopes, ccfg)
    timed["sensitivity_stacked"] = {"seconds": time.perf_counter() - t0}
    torch.cuda.synchronize()
    launches = read_launches(fns)
    keys = ranges_keys(RANGES_LAYERS)
    exact = exact_maxima(torch, fw, params, x, keys)
    del params

    # the gates at full width
    gates = {
        "ia_stacked_vs_eager": same_range_maps(
            got["ia_stacked"], got["ia"], "IA stacked vs eager"),
        "affine_stacked_vs_eager": same_range_maps(
            got["aff_stacked"], got["aff"], "affine stacked vs eager")}
    if scopes != ["embed"] + [f"layer{i}" for i in range(RANGES_LAYERS)] + [
            "head"]:
        raise AssertionError(f"discover_scopes_stacked: {scopes}")
    for k in keys:
        t, a, i = got["tight"][k], got["aff"][k], got["ia"][k]
        if not (t.max_abs <= i.max_abs and t.max_abs <= a.max_abs):
            raise AssertionError(f"tightened {k}: {t} above IA {i} or "
                                 f"affine {a}")
        if a.n_ops and not math.isfinite(a.max_abs):
            raise AssertionError(f"affine enclosure of {k} not finite: {a}")
    outside = {k: v for k, v in exact.items()
               if not (v <= got["ia"][k].max_abs
                       and v <= got["aff"][k].max_abs)}
    if outside:
        raise AssertionError(f"exact f64 values outside max_abs: {outside}")
    if any(launches.values()):
        raise AssertionError(f"the range passes launched kernels: "
                             f"{launches}")
    full = {"maps": {name: range_map_json(m) for name, m in got.items()},
            "sensitivity_stacked": sens, "scopes": scopes,
            "exact_f64_max_abs": exact, "passes": timed,
            "stacked_vs_eager_worst_rel": gates}
    free_device_memory(torch)

    # the card against the CPU port on the same seeded inputs
    cpu_vs_card = {}
    smoke = configs.get("qwen2_7b").SMOKE
    sp = T.init_params(smoke, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    stoks = torch.randint(0, smoke.vocab, (1, RANGES_TOKENS),
                          generator=torch.Generator().manual_seed(1))
    models = {"qwen2_7b.SMOKE": (
        lambda dev: lm_forward(T, smoke, stoks.to(dev)), sp,
        lambda dev: caa.make(torch.zeros((1, 1), dtype=torch.float64,
                                         device=dev)), smoke.n_layers)}
    imgs, _ = synthetic_digits.make_dataset(4, seed=0)
    img = torch.from_numpy(imgs[0].astype(np.float64)).reshape(1, 784)
    models["digits 784-700-256-10"] = (
        lambda dev: PM.digits_forward,
        PM.init_digits(torch.Generator().manual_seed(0), device="cpu"),
        lambda dev: caa.from_range((img - 0.01).to(dev),
                                   (img + 0.01).to(dev)), 0)
    models["convnet 28x28 c1 16 c2 32"] = (
        lambda dev: PM.convnet_forward,
        PM.init_convnet(torch.Generator().manual_seed(1), device="cpu"),
        lambda dev: caa.make(img.reshape(1, 28, 28, 1).to(dev)), 0)
    on = lambda p, dev: {k: (v.to(dev) if torch.is_tensor(v) else
                             (on(v, dev) if isinstance(v, dict) else v))
                         for k, v in p.items()}
    for name, (fwd, p, xin, L) in models.items():
        card = run_ranges(torch, A, fwd(dev), on(p, dev), xin(dev), ccfg,
                          fmts, dflt, L)
        with torch.no_grad():
            cpu = run_ranges(torch, A, fwd("cpu"), p, xin("cpu"), ccfg, fmts,
                             dflt, L)
        cpu_vs_card[name] = {m: same_range_maps(card[m], cpu[m],
                                                f"{name} {m} card vs CPU")
                             for m in card}
    emit("ranges", config=cfg.name, n_layers=cfg.n_layers,
         tokens=RANGES_TOKENS, u_max=RANGES_UMAX,
         formats={"map": RANGES_FMTS, "default": RANGES_FMT_DEFAULT},
         sublanes=list(RANGES_SUB), full_width=full, launches=launches,
         cpu_vs_card_worst_rel=cpu_vs_card, rel_tol=1e-9,
         nvidia_smi=nvidia_smi_line(),
         seconds=time.perf_counter() - t_phase)
    return launches


# ---------------------------------------------------------------------------
# the CAA analysis slice: interval libm, the Table-I flow, kernels 5 and 6
# ---------------------------------------------------------------------------

LIBM_FUNCS = ("exp", "expm1", "log", "tanh", "sigmoid", "erf", "silu",
              "gelu_tanh")
TABLE1_CFG = {"u_max": 2.0 ** -7, "emulate_k": 8}   # quickstart's k = 8 run
P_STAR = 0.6
N_CERT = 64
REL_TOL = 1e-9                    # card vs CPU port, bounds and margins


def sync_seconds(torch, t0):
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def libm_points(torch):
    """About 10⁶ f64 points: the working range, dense near 0, the
    saturation zones of tanh/sigmoid/erf (|x| in [8, 30]), the overflow
    and underflow edges of exp and twenty decades each way."""
    gen = torch.Generator().manual_seed(13)

    def u(n, a, b):
        return a + (b - a) * torch.rand(n, generator=gen, dtype=torch.float64)

    sign = torch.where(torch.rand(100_000, generator=gen) < 0.5, -1.0, 1.0)
    return torch.cat([
        u(400_000, -40.0, 40.0),
        torch.randn(200_000, generator=gen, dtype=torch.float64) * 3.0,
        u(100_000, -30.0, -8.0), u(100_000, 8.0, 30.0),
        u(100_000, -745.0, 710.0),
        sign.double() * torch.pow(10.0, u(100_000, -300.0, 300.0)),
        torch.tensor([0.0, -0.0, 1e-310, -1e-310, 709.78, -745.1, 12.0,
                      -12.0, 25.0, -25.0, 4.0, -4.0],
                     dtype=torch.float64)])


def libm_value(torch, name, x):
    """The f64 value each interval function encloses, as the port
    evaluates its endpoints (gelu_tanh as x·σ(2y))."""
    if name == "silu":
        return x * torch.sigmoid(x)
    if name == "gelu_tanh":
        y2 = 2.0 * math.sqrt(2.0 / math.pi) * (x + 0.044715 * x * x * x)
        return x * torch.sigmoid(y2)
    return getattr(torch, name)(x)


def phase_interval_libm(torch, iv):
    """Each interval transcendental computed on the card contains the
    CPU's f64 value at every point; directed rounding is bitwise the
    CPU's."""
    t0 = time.perf_counter()
    x = libm_points(torch)
    xg = x.cuda()
    rows = {}
    # the CPU's values from one thread: PyTorch 2.13's CPU build was seen to
    # return f64 exp values up to 3e7 ulps off from its first call on a
    # large tensor when that call ran multi-threaded
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cpu_vals = {name: libm_value(torch, name,
                                     x.abs() if name == "log" else x)
                    for name in LIBM_FUNCS}
    finally:
        torch.set_num_threads(threads)
    for name in LIBM_FUNCS:
        xs, xsg = (x.abs(), xg.abs()) if name == "log" else (x, xg)
        enc = getattr(iv, name)(iv.Interval(xsg, xsg))
        want = cpu_vals[name].cuda()
        inside = (enc.lo <= want) & (want <= enc.hi)
        if not bool(inside.all()):
            bad = (~inside).nonzero()[:5, 0]
            raise AssertionError(
                f"interval_libm {name}: {int((~inside).sum())} points "
                f"outside, e.g. x={xs[bad.cpu()].tolist()} "
                f"cpu={want[bad].tolist()} lo={enc.lo[bad].tolist()} "
                f"hi={enc.hi[bad].tolist()}")
        card = libm_value(torch, name, xsg)
        fin = torch.isfinite(want) & (want != 0)
        ulps = ((card - want).abs() / torch.nextafter(
            want.abs(), torch.full_like(want, math.inf)).sub(want.abs()))
        rows[name] = {"points": x.numel(), "outside": 0,
                      "card_vs_cpu_max_ulps": float(ulps[fin].max()),
                      "card_equal_frac": float((card == want).double()
                                               .mean())}
    for name in ("_down", "_up"):
        got = getattr(iv, name)(xg).cpu().view(torch.int64)
        if not torch.equal(got, getattr(iv, name)(x).view(torch.int64)):
            raise AssertionError(f"interval_libm {name} differs from the "
                                 "CPU's bits")
    emit("interval_libm", points=x.numel(), functions=rows,
         directed_rounding_bitwise=True,
         seconds=time.perf_counter() - t0)


def train_digits(torch, PM, TorchOps, params, imgs, labels, steps=400,
                 lr=0.2):
    """The certify CLI's training (quickstart's ``train`` in PyTorch
    autograd: SGD, batch 64 drawn by ``RandomState(i)``, mean cross-entropy
    of the logits); returns (params, training accuracy)."""
    from repro_torch.certify.__main__ import train_digits as train

    params = train(params, imgs, labels, steps, lr)
    dev = params["w1"].device
    with torch.no_grad():
        pred = PM.digits_logits(TorchOps(), params,
                                torch.from_numpy(imgs).to(dev)).argmax(-1)
    acc = float((pred == torch.from_numpy(labels).long().to(dev))
                .double().mean())
    return params, acc


def k_borderline(abs_u, rel_u, theory):
    """How close a required-k decision was to flipping: the smallest
    relative distance of bound/margin from a power of two over both
    routes (k changes where 1 + log2(B/m) crosses an integer)."""
    best = math.inf
    for b, m in ((abs_u, theory.abs_margin(P_STAR)),
                 (rel_u, theory.rel_margin(P_STAR))):
        if math.isfinite(b) and b > 0:
            r = b / m
            best = min(best, abs(r / 2.0 ** round(math.log2(r)) - 1.0))
    return best


def table1(torch, m, dev, digits, conv, pend, imgs, labels):
    """The Table-I flow on ``dev`` (steps 2–6 of the analyze phase):
    bounds, decisions with the margins that decided them, seconds."""
    import numpy as np

    caa, analyze, precision, PM = m["caa"], m["analyze"], m["precision"], \
        m["PM"]
    CaaOps, TorchOps = m["CaaOps"], m["TorchOps"]
    f64 = torch.float64
    cfg = caa.CaaConfig(**TABLE1_CFG)
    out = {"device": dev}

    x0 = torch.from_numpy(imgs[0].astype(np.float64)).to(dev)
    t0 = time.perf_counter()
    probs = PM.digits_forward(CaaOps(cfg), digits, caa.weight(x0, cfg))
    a_abs, a_rel = caa.actual_error_in_u(probs, cfg.u_max)
    dbar, ebar = caa.worst(probs)
    top2 = torch.topk(probs.val, 2).values
    rel_fin = a_rel[torch.isfinite(a_rel)]
    out["digits_k8"] = {
        "dbar": dbar, "ebar": ebar, "actual_abs_u": float(a_abs.max()),
        "actual_rel_u": float(rel_fin.max()) if rel_fin.numel() else math.inf,
        "pred": int(probs.val.argmax()),
        "pred_margin": float((top2[0] - top2[1]) / top2[0]),
        "seconds": sync_seconds(torch, t0)}

    trail = []

    def bounds_at(u):
        c = caa.CaaConfig(u_max=u)
        ab = caa.worst(PM.digits_forward(CaaOps(c), digits,
                                         caa.weight(x0, c)))
        trail.append([u, *ab])
        return ab

    t0 = time.perf_counter()
    dec = precision.decide_iterative(bounds_at, p_star=P_STAR)
    out["decide_iterative"] = {
        "required_k": dec.required_k, "dbar": dec.final_abs_bound_u,
        "ebar": dec.final_rel_bound_u, "satisfied_by": dec.satisfied_by,
        "trail": trail, "seconds": sync_seconds(torch, t0)}

    # one input of each class in one stacked pass, at the unit of the k
    # just decided (at k = 8 every bound of this model saturates to +inf)
    idx = [int(np.nonzero(labels == c)[0][0]) for c in range(10)]
    xs = torch.from_numpy(imgs[idx].astype(np.float64)).to(dev)
    cfg_k = caa.CaaConfig(u_max=2.0 ** (1 - dec.required_k))
    rep = analyze.analyze_batched(PM.digits_forward, digits,
                                  caa.weight(xs, cfg_k), p_star=P_STAR,
                                  cfg=cfg_k)
    out["batched"] = {
        "u_max": cfg_k.u_max,
        "abs_u": rep.abs_u.tolist(), "rel_u": rep.rel_u.tolist(),
        "required_k": [d.required_k if d else None for d in rep.decisions],
        "seconds": rep.analysis_seconds,
        "seconds_per_class": rep.analysis_seconds / rep.n_classes}

    x64 = torch.from_numpy(imgs[:N_CERT].astype(np.float64)).to(dev)
    c64 = analyze.batch_config(cfg, N_CERT)
    t0 = time.perf_counter()
    p8 = PM.digits_forward(CaaOps(c64), digits, caa.weight(x64, c64))
    exact_pred = PM.digits_forward(TorchOps(f64), digits, x64).argmax(-1)
    lo, hi = p8.exact.lo.cpu(), p8.exact.hi.cpu()
    top2 = torch.topk(p8.val, 2, dim=-1).values.cpu()
    pred = p8.val.argmax(-1).cpu()
    exact_pred = exact_pred.cpu()
    seconds = sync_seconds(torch, t0)
    certs, margins, n_cert, n_ok = [], [], 0, 0
    for i in range(N_CERT):
        p = int(pred[i])
        cert = precision.classification_safe(lo[i].numpy(), hi[i].numpy(),
                                             p)
        others = torch.cat([hi[i, :p], hi[i, p + 1:]])
        margins.append(float((lo[i, p] - others.max()) / lo[i, p].abs()))
        certs.append(bool(cert))
        if cert:
            n_cert += 1
            n_ok += int(int(exact_pred[i]) == p)
    out["certified"] = {
        "n": N_CERT, "n_cert": n_cert, "n_ok": n_ok, "certs": certs,
        "margins": margins, "pred": pred.tolist(),
        "pred_margins": ((top2[:, 0] - top2[:, 1]) / top2[:, 0]).tolist(),
        "seconds": seconds}

    lo6 = torch.full((2,), -6.0, dtype=f64, device=dev)
    rep = analyze.analyze(PM.pendulum_forward, pend,
                          caa.from_range(lo6, -lo6),
                          cfg=caa.CaaConfig(u_max=TABLE1_CFG["u_max"]))
    out["pendulum"] = {"dbar": rep.final_abs_u, "ebar": rep.final_rel_u,
                       "seconds": rep.analysis_seconds}

    xc = torch.from_numpy(imgs[:1].reshape(1, 28, 28, 1)
                          .astype(np.float64)).to(dev)
    rep = analyze.analyze(PM.convnet_forward, conv, caa.weight(xc, cfg),
                          p_star=P_STAR, cfg=cfg)
    out["convnet"] = {
        "dbar": rep.final_abs_u, "ebar": rep.final_rel_u,
        "required_k": rep.decision.required_k if rep.decision else None,
        "seconds": rep.analysis_seconds}
    return out


def compare_table1(card, cpu, theory):
    """Card against CPU port: bounds within REL_TOL; decisions equal, or
    the margin that decided them within REL_TOL of its threshold (printed
    either way). Returns (bound comparisons, differing decisions, faults)."""
    bounds, differing, faults = [], [], []

    def bound(label, a, b):
        same = (a == b) or (math.isfinite(a) and math.isfinite(b)
                            and abs(a - b) <= REL_TOL * abs(b))
        bounds.append({"what": label, "card": a, "cpu": b})
        if not same:
            faults.append(f"{label}: card {a!r} vs cpu {b!r}")

    def decision(label, a, b, margin):
        if a != b:
            ok = margin <= REL_TOL
            differing.append({"what": label, "card": a, "cpu": b,
                              "margin": margin, "borderline": ok})
            if not ok:
                faults.append(f"{label}: card {a!r} vs cpu {b!r}, margin "
                              f"{margin!r}")

    for key in ("digits_k8", "decide_iterative", "pendulum", "convnet"):
        bound(f"{key}.dbar", card[key]["dbar"], cpu[key]["dbar"])
        bound(f"{key}.ebar", card[key]["ebar"], cpu[key]["ebar"])
    decision("digits_k8.pred", card["digits_k8"]["pred"],
             cpu["digits_k8"]["pred"],
             min(abs(card["digits_k8"]["pred_margin"]),
                 abs(cpu["digits_k8"]["pred_margin"])))
    trail = min((k_borderline(a, r, theory)
                 for _, a, r in card["decide_iterative"]["trail"]),
                default=math.inf)
    decision("decide_iterative.required_k",
             card["decide_iterative"]["required_k"],
             cpu["decide_iterative"]["required_k"], trail)
    for c in range(10):
        a, r = card["batched"]["abs_u"][c], card["batched"]["rel_u"][c]
        bound(f"batched[{c}].abs_u", a, cpu["batched"]["abs_u"][c])
        bound(f"batched[{c}].rel_u", r, cpu["batched"]["rel_u"][c])
        decision(f"batched[{c}].required_k",
                 card["batched"]["required_k"][c],
                 cpu["batched"]["required_k"][c],
                 k_borderline(a, r, theory))
    for i in range(N_CERT):
        decision(f"certified[{i}]", card["certified"]["certs"][i],
                 cpu["certified"]["certs"][i],
                 min(abs(card["certified"]["margins"][i]),
                     abs(cpu["certified"]["margins"][i])))
        decision(f"certified[{i}].pred", card["certified"]["pred"][i],
                 cpu["certified"]["pred"][i],
                 min(card["certified"]["pred_margins"][i],
                     cpu["certified"]["pred_margins"][i]))
    d_conv = (card["convnet"]["required_k"], cpu["convnet"]["required_k"])
    decision("convnet.required_k", *d_conv, k_borderline(
        card["convnet"]["dbar"], card["convnet"]["ebar"], theory))
    for key in ("n_cert", "n_ok"):
        decision(f"certified.{key}", card["certified"][key],
                 cpu["certified"][key],
                 0.0 if not any(d["borderline"] for d in differing)
                 else REL_TOL)
    return bounds, differing, faults


class MatmulSpy:
    """Stands in for ``caa.matmul`` while an analysis runs: keeps the
    operands (CaaTensors) and config of the first call of each (M, K, N)."""

    def __init__(self, fn):
        self.fn, self.seen = fn, {}

    def __call__(self, a, b, cfg):
        key = (math.prod(a.shape[:-1]), a.shape[-1], b.shape[-1])
        self.seen.setdefault(key, (a, b, cfg))
        return self.fn(a, b, cfg)


def phase_analyze(torch):
    """quickstart's Table-I flow at the Digits model's full width on the
    card, then on the CPU with the same weights; Pendulum and ConvNet at
    their defaults. Returns the card's dense-layer operands of the
    10-class and the 64-input passes, {(M, K, N): (a, b, cfg)} (kernels 5
    and 6 are fed them)."""
    import numpy as np

    from repro_torch.core import analyze, caa, precision, theory
    from repro_torch.core.backend import CaaOps, TorchOps
    from repro_torch.data import synthetic_digits
    from repro_torch.models import paper_models as PM

    m = {"caa": caa, "analyze": analyze, "precision": precision, "PM": PM,
         "CaaOps": CaaOps, "TorchOps": TorchOps}
    t_phase = time.perf_counter()
    imgs, labels = synthetic_digits.make_dataset(800, seed=0)
    digits = PM.init_digits(torch.Generator().manual_seed(0), device="cuda")
    n_params = sum(t.numel() for t in digits.values())
    t0 = time.perf_counter()
    digits, acc = train_digits(torch, PM, TorchOps, digits, imgs, labels)
    train_s = sync_seconds(torch, t0)
    conv = PM.init_convnet(torch.Generator().manual_seed(1), device="cuda")
    pend = PM.init_pendulum(torch.Generator().manual_seed(2), device="cuda")

    spy = MatmulSpy(caa.matmul)
    caa.matmul = spy
    try:
        card = table1(torch, m, "cuda", digits, conv, pend, imgs, labels)
    finally:
        caa.matmul = spy.fn
    on_cpu = lambda p: {k: (v.cpu() if torch.is_tensor(v) else v)
                        for k, v in p.items()}
    cpu = table1(torch, m, "cpu", on_cpu(digits), on_cpu(conv),
                 on_cpu(pend), imgs, labels)
    bounds, differing, faults = compare_table1(card, cpu, theory)
    for tbl in (card, cpu):
        for key in ("certs", "margins", "pred", "pred_margins"):
            tbl["certified"].pop(key)
    emit("analyze", model="digits 784-700-256-10", params=n_params,
         train={"steps": 400, "lr": 0.2, "batch": 64, "samples": 800,
                "train_accuracy": acc, "seconds": train_s},
         config={**TABLE1_CFG, "p_star": P_STAR},
         convnet="28x28 c1 16 c2 32", pendulum="h 64, input [-6, 6]^2",
         card=card, cpu=cpu, rel_tol=REL_TOL, bounds_compared=len(bounds),
         differing_decisions=differing, faults=faults,
         seconds=time.perf_counter() - t_phase)
    if faults:
        raise AssertionError(f"analyze: card and CPU disagree: {faults[:5]}")
    c = card["certified"]
    if not (c["n_cert"] > 0 and c["n_ok"] == c["n_cert"]):
        raise AssertionError(f"analyze: certified {c['n_cert']}, "
                             f"matching the f64 model {c['n_ok']}")
    # the dense layers of the 10-class and the 64-input passes
    wanted = {(M, *digits[w].shape) for M in (10, N_CERT)
              for w in ("w1", "w2", "w3")}
    if not wanted <= set(spy.seen):
        raise AssertionError(f"dense operands seen {sorted(spy.seen)}")
    return {key: spy.seen[key] for key in sorted(wanted)}


def f32_outward(torch, t, up: bool):
    """f64 → the nearest f32 in one direction (up: ≥ t, else ≤ t)."""
    y = t.float()
    y64 = y.double()
    step = torch.full_like(y, math.inf if up else -math.inf)
    bump = (y64 < t) if up else (y64 > t)
    return torch.where(bump, torch.nextafter(y, step), y).contiguous()


def analysis_operands(torch, seen):
    """Kernel operands from the analysis's dense layers: x = mag(exact) +
    δ̄·u_max and δ̄ of the layer's input rounded up to f32, [lo, hi] = the
    input's exact enclosure rounded outward, W the layer's (exact, f32)
    weights, and g = γ(K) of the pass's accumulation order. At the k = 8
    passes (u_max = 2⁻⁷) γ(K) is +inf for every K ≥ 256 — the γ form
    saturates there, and the analysis takes its trajectory branch — so g is
    that order's γ(K) at u = 2⁻²³, binary32's."""
    import dataclasses

    from repro_torch.core import caa, interval as iv

    out = {}
    for (M, K, N), (a, b, cfg) in sorted(seen.items()):
        da = caa._eff_dbar(a).reshape(M, K)
        mag = iv.mag(a.exact).reshape(M, K)
        w = b.val.float().contiguous()
        if not torch.equal(w.double(), b.val):
            raise AssertionError(f"weights of {(M, K, N)} are not f32")
        out[(M, K, N)] = {
            "x": f32_outward(torch, mag + da * cfg.u_max, True),
            "d": f32_outward(torch, da, True),
            "lo": f32_outward(torch, a.exact.lo.reshape(M, K), False),
            "hi": f32_outward(torch, a.exact.hi.reshape(M, K), True),
            "w": w,
            "g": dataclasses.replace(cfg, u_max=2.0 ** -23).gamma(K)}
    return out


def phase_analysis_ops(torch, ops, qmm, fd, operands):
    """The slice's kernel path: ``ops.caa_matmul_fused`` and
    ``ops.interval_matmul_rigorous`` on the analysis's own dense-layer
    operands, every launch count set to 0 just before and read just
    after."""
    fns = kernel_fns(qmm, fd)
    reset_launches(fns)
    outs = {key: (ops.caa_matmul_fused(o["x"], o["d"], o["w"], g=o["g"]),
                  ops.interval_matmul_rigorous(o["lo"], o["hi"], o["w"]))
            for key, o in operands.items()}
    torch.cuda.synchronize()
    launches = read_launches(fns)
    expected = {name: 0 for name in fns}
    expected.update(caa_matmul=len(operands), interval_matmul=len(operands))
    emit("analysis_ops", shapes=[list(k) for k in operands],
         launches=launches, expected_launches=expected)
    if launches != expected:
        raise AssertionError(f"analysis_ops launch counts {launches} != "
                             f"{expected}")
    return launches, outs


IVL_ORDER_COLUMNS = 64


def ivl_order_check(torch, what, kernel_outs, seq_outs):
    for i, (got, want) in enumerate(zip(kernel_outs, seq_outs)):
        if not same_bits(torch, got, want):
            n = int((got.view(torch.int32) != want.view(torch.int32)).sum())
            raise AssertionError(
                f"interval_gemm_order {what} output {i}: {n} of "
                f"{got.numel()} elements differ from the sequential order")
    return sum(o.numel() for o in kernel_outs)


def phase_interval_gemm_order(torch, operands):
    """Kernels 5 and 6 against their sequential-order plain versions
    (``*_seq_ref``: k = 0..K-1 from +0, fmaf and __fmaf_ru emulated
    exactly) on IVL_ORDER_COLUMNS sampled output columns of each Qwen2-7B
    projection at M = 4 and 512 (the seq refs run once over both batches'
    rows, which are independent), and on every Digits analysis-path
    shape, all columns, with the analysis's own operands: equal bit for
    bit, or the kernels' order was not kept."""
    from repro_torch.core import caa
    from repro_torch.kernels import caa_matmul as cm
    from repro_torch.kernels import interval_matmul as im

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(15)
    cpu_gen = torch.Generator().manual_seed(15)
    n_cases, n_elems = 0, 0
    for proj, (K, N) in GEMM_SHAPES.items():
        g = caa.CaaConfig(u_max=2.0 ** -23).gamma(K)
        w = torch.randn(K, N, device="cuda", generator=gen) / math.sqrt(K)
        cols = torch.randperm(N, generator=cpu_gen)[:IVL_ORDER_COLUMNS]
        cols = cols.sort().values.cuda()
        wc = w[:, cols].contiguous()
        xs = [torch.randn(M, K, device="cuda", generator=gen)
              for M in (4, 512)]
        ds = [torch.rand(M, K, device="cuda", generator=gen) * 4.0
              for M in (4, 512)]
        x, d = torch.cat(xs), torch.cat(ds)
        lo, hi = x - 0.01 * d, x + 0.01 * d
        seq = {"caa_matmul": cm.caa_matmul_seq_ref(x, d, wc, g=g),
               "interval_matmul": im.interval_matmul_seq_ref(lo, hi, wc)}
        r0 = 0
        for xm, dm in zip(xs, ds):
            M = xm.shape[0]
            rows = slice(r0, r0 + M)
            outs = {"caa_matmul": cm.caa_matmul(xm, dm, w, g=g),
                    "interval_matmul": im.interval_matmul(
                        lo[rows].contiguous(), hi[rows].contiguous(), w)}
            for name, out in outs.items():
                n_elems += ivl_order_check(
                    torch, f"{name} {proj} M={M}", [o[:, cols] for o in out],
                    [o[rows] for o in seq[name]])
                n_cases += 1
            r0 += M
        del w, wc, x, d, lo, hi, xs, ds, seq, outs
    for (M, K, N), o in operands.items():
        what = f"digits {(M, K, N)}"
        n_elems += ivl_order_check(
            torch, f"caa_matmul {what}",
            cm.caa_matmul(o["x"], o["d"], o["w"], g=o["g"]),
            cm.caa_matmul_seq_ref(o["x"], o["d"], o["w"], g=o["g"]))
        n_elems += ivl_order_check(
            torch, f"interval_matmul {what}",
            im.interval_matmul(o["lo"], o["hi"], o["w"]),
            im.interval_matmul_seq_ref(o["lo"], o["hi"], o["w"]))
        n_cases += 2
    emit("interval_gemm_order", rule="bit for bit against the "
         "sequential-order plain versions (fmaf / __fmaf_ru emulated "
         "exactly: f64 product, two-sum, midpoint and residual checks)",
         projections=list(GEMM_SHAPES), M=[4, 512],
         columns_per_projection=IVL_ORDER_COLUMNS,
         digits_shapes=[list(k) for k in operands], cases=n_cases,
         elements_compared=n_elems, bitwise_equal=True,
         seconds=time.perf_counter() - t0)


def check_caa(torch, cm, x, d, w, g, val, err, what):
    """Kernel 5's rules: val within the GEMM rule of the plain version;
    E ≤ err ≤ E·(1 + (2K+2)·2⁻²³), E = (dbar + g·|x|)@|W| in f64 of the
    f32 operands (g the analysis's f64 γ)."""
    K = x.shape[1]
    pv, _ = cm.caa_matmul_plain(x, d, w, g=g)
    rule = gemm_order_tol(torch, x, w)
    dv = (val.double() - pv.double()).abs()
    E = (d.double() + g * x.double().abs()) @ w.double().abs()
    e64 = err.double()
    top = E * (1 + (2 * K + 2) * 2.0 ** -23)
    ok = bool((dv <= rule).all()) and bool((e64 >= E).all()) and bool(
        (e64 <= top).all())
    pos = (E > 0) & torch.isfinite(E)
    st = {"max_abs_err": float(dv.max()),
          "val_spread": float((dv / (rule / 2)).nan_to_num(0.0).max()),
          "err_over_E_ulps": float(((e64[pos] - E[pos]) / E[pos]).max()
                                   / 2.0 ** -23) if pos.any() else 0.0,
          "err_below_E": int((e64 < E).sum()),
          "err_above_cap": int((e64 > top).sum())}
    if not ok:
        raise AssertionError(f"caa_matmul {what}: {st}")
    return st


def check_interval(torch, im, ops, lo, hi, w, out, what, samples=2):
    """Kernel 6's rules, after the wrapper's widening: lo' ≤ L, hi' ≥ H
    (f64 sign-split of the f32 operands), the enclosure at sampled points,
    width ≤ the plain version's + 4·√K·2⁻²⁴·mag, mag' within the GEMM rule.
    Returns stats; ``excess`` is how far lo'/hi' fall inside L/H in units
    of mag (> 0 would be the reference's widening falling short)."""
    K = lo.shape[1]
    klo, khi, kmag = (t.double() for t in out)
    plo, phi, pmag = im.interval_matmul_plain(lo, hi, w)
    gw = ops.gamma_in_u(2 * K + 2, 2.0 ** -23) * 2.0 ** -23
    p_width = ((phi + gw * pmag) - (plo - gw * pmag)).double()
    L64, H64, W64 = lo.double(), hi.double(), w.double()
    wp, wm = W64.clamp(min=0), W64.clamp(max=0)
    L = L64 @ wp + H64 @ wm
    H = H64 @ wp + L64 @ wm
    del wp, wm
    mag = torch.maximum(L64.abs(), H64.abs()) @ W64.abs()
    scale = mag.clamp(min=1e-300)
    excess = float(torch.maximum((klo - L) / scale, (H - khi) / scale).max())
    inside = True
    for _ in range(samples):
        pts = (L64 + (H64 - L64) * torch.rand_like(L64)) @ W64
        inside &= bool(((klo <= pts) & (pts <= khi)).all())
    width_ok = bool(((khi - klo) <= p_width
                     + 4 * math.sqrt(K) * 2.0 ** -24 * mag).all())
    dm = (kmag - pmag.double()).abs()
    mag_ok = bool((dm <= 2 * math.sqrt(K) * 2.0 ** -24 * mag).all())
    st = {"max_abs_err": float(torch.maximum((klo - (plo - gw * pmag)
                                              .double()).abs(),
                                             (khi - (phi + gw * pmag)
                                              .double()).abs()).max()),
          "encloses_L_H": excess <= 0, "excess_over_mag": excess,
          "encloses_samples": inside, "width_ok": width_ok,
          "mag_ok": mag_ok, "mag_max_abs_err": float(dm.max())}
    if not (excess <= 0 and inside and width_ok and mag_ok):
        raise AssertionError(f"interval_matmul {what}: {st}")
    return st


def caa_coarse(torch, gen, M, K, N):
    """Exact-sum operands: integers times 2⁻², 2⁻³, 2⁻³ and g = 1/2 — every
    t, product and partial sum is an exact f32."""
    x, w = coarse_operands(torch, gen, M, K, N)
    d = torch.randint(0, 4, (M, K), device="cuda",
                      generator=gen).float() * 2.0 ** -3
    return x, d, w


def analysis_kernel_bound(M, K, N, kernel):
    n_out, fmas = (2, 2) if kernel == "caa_matmul" else (3, 3)
    return bound_ms(4.0 * (2 * M * K + K * N + n_out * M * N),
                    2.0 * fmas * M * K * N)


def bmm_operands(torch, kernel, a0, a1, w):
    """The yardstick's operands, stacked: one ``torch.bmm(A, B)`` computes
    the kernel's products (2 for caa_matmul: x@W, t@|W|, a1 = t; 5 for
    interval_matmul: lo@W⁺, hi@W⁻, hi@W⁺, lo@W⁻, mag@|W|)."""
    if kernel == "caa_matmul":
        return torch.stack([a0, a1]), torch.stack([w, w.abs()])
    wp, wm = w.clamp(min=0), w.clamp(max=0)
    return (torch.stack([a0, a1, a1, a0, torch.maximum(a0.abs(), a1.abs())]),
            torch.stack([wp, wm, wp, wm, w.abs()]))


def time_analysis_kernel(torch, kernel, fn, plain, a0, a1, w, iters,
                         traced=False):
    """ms of the kernel ``fn(w)`` and its plain version ``plain(w)``, the
    bound, and the yardstick: one ``torch.bmm`` over operands stacked
    beforehand (:func:`bmm_operands`). Each is timed with its weights cold,
    rotated through :func:`weight_copies` (of W, resp. of the stacked B):
    by CUDA events, or with ``traced`` from a profiler trace
    (:func:`trace_ms`; the Digits shapes, whose calls are shorter than
    their launch)."""
    M, K = a0.shape
    N = w.shape[1]
    timer = trace_ms if traced else time_cold_ms
    copies = weight_copies(torch, w)
    row = {"ms": timer(torch, fn, copies, iters),
           "plain_ms": timer(torch, plain, copies, iters),
           "weight_copies": len(copies),
           "timing": "trace" if traced else "cuda_events"}
    del copies
    A, B = bmm_operands(torch, kernel, a0, a1, w)
    copies = weight_copies(torch, B)
    del B
    row["library_ms"] = timer(torch, lambda b: torch.bmm(A, b), copies,
                              iters)
    del A, copies
    row["bound_ms"], row["bound_by"] = analysis_kernel_bound(M, K, N, kernel)
    return row


def layer_sum(rows, M):
    """One Qwen2-7B layer's seven projections at batch M, summed."""
    rows = [r for r in rows if r["M"] == M and "ms" in r]
    if len(rows) != len(GEMM_SHAPES):
        raise AssertionError(f"{len(rows)} timed rows at M={M}")
    out = {key: sum(r[key] for r in rows)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    out["bound_by"] = ("operations" if any(r["bound_by"] == "operations"
                                           for r in rows) else "bytes")
    return out


def phase_caa_kernel(torch, kernel, ops, operands, path_outs):
    """Kernel 5 (``caa_matmul``) or 6 (``interval_matmul``): on the
    analysis path's own outputs, then at the seven Qwen2-7B projections at
    M = 4 and 512 (seeded inputs): the rules, exact-sum operands bit for
    bit, row invariance, and times."""
    from repro_torch.core import caa
    from repro_torch.kernels import caa_matmul as cm
    from repro_torch.kernels import interval_matmul as im

    t0 = time.perf_counter()
    is_caa = kernel == "caa_matmul"
    raw = cm.caa_matmul if is_caa else im.interval_matmul
    worst, path_rows, rows = 0.0, [], []
    for key, o in operands.items():
        (val, err), ivl = path_outs[key]
        if is_caa:
            st = check_caa(torch, cm, o["x"], o["d"], o["w"], o["g"], val,
                           err, f"digits {key}")
            timing = time_analysis_kernel(
                torch, kernel,
                lambda wc: cm.caa_matmul(o["x"], o["d"], wc, g=o["g"]),
                lambda wc: cm.caa_matmul_plain(o["x"], o["d"], wc, g=o["g"]),
                o["x"], o["d"] + o["g"] * o["x"].abs(), o["w"], 200,
                traced=True)
        else:
            st = check_interval(torch, im, ops, o["lo"], o["hi"], o["w"],
                                ivl, f"digits {key}")
            timing = time_analysis_kernel(
                torch, kernel,
                lambda wc: im.interval_matmul(o["lo"], o["hi"], wc),
                lambda wc: im.interval_matmul_plain(o["lo"], o["hi"], wc),
                o["lo"], o["hi"], o["w"], 200, traced=True)
        worst = max(worst, st["max_abs_err"])
        path_rows.append({"M": key[0], "K": key[1], "N": key[2],
                          "g": o["g"] if is_caa else None, **st, **timing})

    gen = torch.Generator(device="cuda").manual_seed(5 if is_caa else 6)
    n_exact = 0
    for proj, (K, N) in GEMM_SHAPES.items():
        g = caa.CaaConfig(u_max=2.0 ** -23).gamma(K)
        for M in (4, 512):
            x, d, w = caa_coarse(torch, gen, M, K, N)
            if is_caa:
                pairs = zip(cm.caa_matmul(x, d, w, g=0.5),
                            cm.caa_matmul_plain(x, d, w, g=0.5))
            else:
                pairs = zip(im.interval_matmul(x - d, x + d, w),
                            im.interval_matmul_plain(x - d, x + d, w))
            for got, want in pairs:
                if not same_bits(torch, got, want):
                    raise AssertionError(f"{kernel} {proj} M={M}: differs "
                                         "on exact-sum operands")
            n_exact += 1
            del x, d, w
        w = torch.randn(K, N, device="cuda", generator=gen) / math.sqrt(K)
        for M in (4, 512):
            x = torch.randn(M, K, device="cuda", generator=gen)
            d = torch.rand(M, K, device="cuda", generator=gen) * 4.0
            if is_caa:
                out = cm.caa_matmul(x, d, w, g=g)
                st = check_caa(torch, cm, x, d, w, g, *out, f"{proj} M={M}")
                a0, a1 = x, d
                fn = lambda wc: cm.caa_matmul(x, d, wc, g=g)
                plain = lambda wc: cm.caa_matmul_plain(x, d, wc, g=g)
                t_a1 = g * x.abs() + d
            else:
                a0, a1 = x - 0.01 * d, x + 0.01 * d
                out = ops.interval_matmul_rigorous(a0, a1, w)
                st = check_interval(torch, im, ops, a0, a1, w, out,
                                    f"{proj} M={M}")
                fn = lambda wc: im.interval_matmul(a0, a1, wc)
                plain = lambda wc: im.interval_matmul_plain(a0, a1, wc)
                t_a1 = a1
            worst = max(worst, st["max_abs_err"])
            row = {"proj": proj, "M": M, "K": K, "N": N, **st}
            if M == 512:
                # row invariance: 7 rows alone == the same rows in 512
                full = raw(a0, a1, w, g=g) if is_caa else raw(a0, a1, w)
                alone = (raw(a0[:7].contiguous(), a1[:7].contiguous(), w,
                             g=g) if is_caa else
                         raw(a0[:7].contiguous(), a1[:7].contiguous(), w))
                for f, a in zip(full, alone):
                    if not torch.equal(a.view(torch.int32),
                                       f[:7].view(torch.int32)):
                        raise AssertionError(f"{kernel} {proj}: 7 rows "
                                             "alone differ inside M=512")
                row["row_invariant"] = True
                del full, alone
            row.update(time_analysis_kernel(torch, kernel, fn, plain, a0,
                                            t_a1 if is_caa else a1, w,
                                            20 if M == 4 else 3))
            rows.append(row)
            del x, d, out, a0, a1, t_a1
        del w
    emit(kernel, tolerance=ANALYSIS_TOLERANCE[kernel],
         analysis_path=path_rows, exact_checks=n_exact, checks=len(rows),
         max_abs_err=worst, rows=rows,
         decode_per_layer=layer_sum(rows, 4),
         prefill_per_layer=layer_sum(rows, 512),
         seconds=time.perf_counter() - t0)
    return path_rows, rows, worst


ANALYSIS_TOLERANCE = {
    "caa_matmul": "val within 2·√K·2⁻²⁴·(|x|@|W|) of the plain version; "
                  "E ≤ err ≤ E·(1+(2K+2)·2⁻²³), E = (dbar + g·|x|)@|W| in "
                  "f64 of the f32 operands; exact-sum operands bit for bit; "
                  "7 rows alone = the same rows in M=512",
    "interval_matmul": "after widening lo' ≤ L and hi' ≥ H (f64 sign-split "
                       "of the f32 operands) and the enclosure at sampled "
                       "points; width ≤ the plain version's + "
                       "4·√K·2⁻²⁴·mag; mag' within 2·√K·2⁻²⁴·mag; exact-sum "
                       "operands bit for bit; 7 rows alone = the same rows "
                       "in M=512",
}


# ---------------------------------------------------------------------------
# the certification pipeline: certify on the card, the same on the CPU,
# serve what was certified
# ---------------------------------------------------------------------------

CERT_P_STAR = 0.6
CERT_DIGITS_K_MAX = 53     # the certify CLI's default for Digits: at full
                           # width every class needs k = 27 (k_max 24
                           # certifies none)
CERT_DIGITS_RUNS = {"uniform": {}, "mixed": {"mixed": True},
                    "formats": {"mixed": True, "formats": True}}
CERT_LM_LAYERS = 2         # Qwen2-7B's depth cut, as in ``ranges``
CERT_NANO = {"seq": 6, "batch": 2, "seed": 0, "k_max": 53, "mixed": True,
             "formats": True, "profiles": (4,)}
CERT_NANO_STEPS, CERT_NANO_LR = 200, 0.5
CERT_REL_TOL = 1e-9        # card against CPU: δ̄ / ε̄, relative
# an LM's δ̄, card against CPU: f64 sums in other orders carried through
# two layers and the head (tests/test_torch_ranges.py's rule); its ε̄ is
# reported, not held (inf must still match inf): the relative bound of a
# logit divides by an enclosure endpoint the sums reach through
# cancellation (1.3e-4 apart on the nano), and no LM decision reads it —
# the argmax rule is 2·δ̄·u < gap
CERT_LM_REL_TOL = 1e-6


def cert_decisions(cs):
    """What a certificate set decides: per certificate its required k,
    formats satisfying it, k map, format map and map provenance, and the
    set's probes."""
    return {"required_k": [c.required_k for c in cs.certificates],
            "satisfied_by": [c.satisfied_by for c in cs.certificates],
            "layer_k": [c.layer_k for c in cs.certificates],
            "layer_format": [c.layer_format for c in cs.certificates],
            "map_provenance": [c.meta.get("map_provenance")
                               for c in cs.certificates],
            "probes": cs.meta.get("probes")}


def cert_bounds(cs):
    return [(c.final_abs_u, c.final_rel_u) for c in cs.certificates]


def same_bound(a, b, rel=CERT_REL_TOL) -> bool:
    """Equal (inf equal to inf), or within ``rel`` relative."""
    return a == b or (math.isfinite(a) and math.isfinite(b)
                      and abs(a - b) <= rel * max(abs(a), abs(b)))


def card_vs_cpu(what, card, cpu, rel=CERT_REL_TOL, rel_ebar=None):
    """Raises unless the two sets decide the same and their bounds agree:
    δ̄ within ``rel``, ε̄ within ``rel_ebar`` (default ``rel``; inf reports
    it, holding only inf to inf); returns the worst relative difference of
    each."""
    if cert_decisions(card) != cert_decisions(cpu):
        raise AssertionError(f"certify {what}: card decides "
                             f"{cert_decisions(card)}, CPU "
                             f"{cert_decisions(cpu)}")
    worst = {"dbar": 0.0, "ebar": 0.0}
    for (a, r), (a2, r2) in zip(cert_bounds(card), cert_bounds(cpu)):
        for key, x, y, tol in (("dbar", a, a2, rel),
                               ("ebar", r, r2, rel_ebar or rel)):
            if not same_bound(x, y, tol):
                raise AssertionError(f"certify {what}: {key} {x!r} on the "
                                     f"card, {y!r} on the CPU")
            if math.isfinite(x) and x != y:
                worst[key] = max(worst[key],
                                 abs(x - y) / max(abs(x), abs(y)))
    return worst


def timed_certify(torch, fn, *args, **kw):
    """(result, seconds, peak device GB) of one certification call."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    # a stacked certification resets the peak at its stage boundaries and
    # keeps each stage's own peak in its meta
    peak = max([torch.cuda.max_memory_allocated() / 1e9]
               + list(out.meta.get("stage_peak_gb", {}).values()))
    return out, secs, peak


def cert_summary(cs, seconds=None, peak_gb=None):
    c = cs.certificates[0]
    out = {"required_k": c.required_k, "final_abs_u": c.final_abs_u,
           "final_rel_u": c.final_rel_u, "layer_k": c.layer_k,
           "layer_format": c.layer_format,
           "map_provenance": c.meta.get("map_provenance"),
           "certificates": len(cs.certificates),
           "probes": cs.meta.get("probes"),
           "from_store": cs.meta.get("from_store"),
           "reason": cs.meta.get("reason"),
           "min_gap": c.meta.get("min_gap")}
    for key in ("stage_seconds", "stage_peak_gb"):
        if key in cs.meta:
            out[key] = cs.meta[key]
    for key in ("mixed", "formats"):
        m = cs.meta.get(key)
        if m:
            out[key] = {k: m.get(k) for k in (
                "applied", "attached", "reason", "mantissa_mode",
                "mean_k_flop_weighted", "mean_bits_flop_weighted",
                "baseline_bits", "probes")}
    if seconds is not None:
        out.update(seconds=seconds, peak_gb=peak_gb)
    return out


class ShapeSpy(KernelSpy):
    """A KernelSpy keeping copies of the tensor inputs (and the keyword
    arguments) of the first call of each input shape."""

    def __init__(self, fn):
        super().__init__(
            fn, lambda *a, **kw: tuple(tuple(t.shape) for t in a
                                       if hasattr(t, "shape")),
            lambda *a, **kw: (tuple(t.clone() if hasattr(t, "clone") else t
                                    for t in a), dict(kw)))


@contextlib.contextmanager
def serving_spies(qmm, fd):
    """ShapeSpies on the four serving kernels while a path runs; yields
    {name: spy}."""
    spies = {"quant_matmul_format": (qmm, ShapeSpy(qmm.quant_matmul_format)),
             "flash_decode_certified": (fd, ShapeSpy(
                 fd.flash_decode_certified)),
             "quant_matmul": (qmm, ShapeSpy(qmm.quant_matmul)),
             "flash_decode_attention": (fd, ShapeSpy(
                 fd.flash_decode_attention))}
    for name, (mod, spy) in spies.items():
        setattr(mod, name, spy)
    try:
        yield {name: spy for name, (_, spy) in spies.items()}
    finally:
        for name, (mod, spy) in spies.items():
            setattr(mod, name, spy.fn)


def spied_vs_plain(torch, qmm, fd, spies):
    """Each serving kernel against its plain version on the first inputs
    of each shape a path gave it (the rules of the kernel phases): rows of
    shapes and agreement stats per kernel; raises on disagreement."""
    rows = {name: [] for name in spies}
    for (x, w, fmt), kw in spies["quant_matmul_format"].seen.values():
        _, st = check_gemm(torch, qmm, x, w, fmt,
                           (kw["has_subnormals"], kw["saturating"]))
        rows["quant_matmul_format"].append(
            {"M": x.shape[0], "K": x.shape[1], "N": w.shape[1],
             "format": list(fmt), **st})
    for (q, k, v, lengths, fmt), kw in \
            spies["flash_decode_certified"].seen.values():
        st = check_flash(torch, fd, q, k, v, lengths, fmt,
                         (kw["has_subnormals"], kw["saturating"]))
        rows["flash_decode_certified"].append(
            {"shape": list(q.shape), "Smax": k.shape[1],
             "lengths": lengths.tolist(), "format": list(fmt), **st})
    for (x, w), kw in spies["quant_matmul"].seen.values():
        _, st = check_gemm_k(torch, qmm, x, w, kw["k"])
        rows["quant_matmul"].append({"M": x.shape[0], "K": x.shape[1],
                                     "N": w.shape[1], "k": kw["k"], **st})
    for (q, k, v, lengths), _ in \
            spies["flash_decode_attention"].seen.values():
        st = check_flash_attention(torch, fd, q, k, v, lengths,
                                   f"shape {list(q.shape)}")
        rows["flash_decode_attention"].append(
            {"shape": list(q.shape), "Smax": k.shape[1],
             "lengths": lengths.tolist(), **st})
    return rows


def train_nano(torch, T, TorchOps, cfg):
    """The 2-layer nano LM overfit to one profile of 2 × 6 tokens, on the
    host: full-batch gradient descent (lr 0.5, 200 steps) on the mean
    next-token cross-entropy, from ``torch.Generator`` seed 0. Returns
    (params on the CPU, final loss)."""
    import numpy as np

    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, (2, 6)))
    tgt = torch.roll(toks, -1, dims=1)
    bk = TorchOps()

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], path + (k,))
        else:
            yield path, tree

    def rebuild(flat):
        out = {}
        for path, t in flat:
            d = out
            for k in path[:-1]:
                d = d.setdefault(k, {})
            d[path[-1]] = t
        return out

    flat = list(leaves(params))
    loss = None
    for _ in range(CERT_NANO_STEPS):
        ps = [(p, t.detach().requires_grad_(True)) for p, t in flat]
        logits, _ = T.forward(bk, rebuild(ps), cfg, toks)
        loss = torch.nn.functional.cross_entropy(
            logits.reshape(-1, cfg.vocab).float(), tgt.reshape(-1))
        grads = torch.autograd.grad(loss, [t for _, t in ps])
        flat = [(p, (t - CERT_NANO_LR * g).detach())
                for (p, t), g in zip(ps, grads)]
    return rebuild(flat), float(loss.detach())


def certify_digits(torch, C, PM, TorchOps, qmm, serve, fns, store):
    """Digits at full width: trained on the card, certified three ways on
    the card and on the CPU with the same weights (decisions equal, bounds
    within CERT_REL_TOL), the format map served through FormatQuantJOps on
    the card bit for bit against its emulation through the plain versions;
    then a store hit. Returns (report, launches of the serve)."""
    import numpy as np

    from repro_torch.data import synthetic_digits

    imgs, labels = synthetic_digits.make_dataset(800, seed=0)
    params = PM.init_digits(torch.Generator().manual_seed(0), device="cuda")
    t0 = time.perf_counter()
    params, acc = train_digits(torch, PM, TorchOps, params, imgs, labels)
    train_s = sync_seconds(torch, t0)
    on_cpu = {k: v.cpu() for k, v in params.items()}
    los, his = [], []
    for c in range(10):
        m = imgs[labels == c].mean(0)
        los.append(np.clip(m - 0.02, 0.0, 1.0))
        his.append(np.clip(m + 0.02, 0.0, 1.0))
    common = dict(p_star=CERT_P_STAR, model_id="digits/h700x256",
                  k_max=CERT_DIGITS_K_MAX)
    report, card = {}, {}
    for name, kw in CERT_DIGITS_RUNS.items():
        cs, secs, peak = timed_certify(
            torch, C.certify, PM.digits_forward, params, los, his,
            store=store if name == "formats" else None, **common, **kw)
        t0 = time.perf_counter()
        cpu = C.certify(PM.digits_forward, on_cpu, los, his, **common, **kw)
        cpu_s = time.perf_counter() - t0
        worst = card_vs_cpu(f"digits {name}", cs, cpu)
        report[name] = {**cert_summary(cs, secs, peak), "cpu_seconds": cpu_s,
                        "worst_rel_bound_vs_cpu": worst,
                        "required_k_all": [c.required_k
                                           for c in cs.certificates]}
        card[name] = cs
    cs = card["formats"]
    sm = cs.serving_layer_format
    if sm is None or any(c.required_k is None for c in cs.certificates):
        raise AssertionError(f"digits: no format map certified: "
                             f"{cs.meta.get('formats')}")

    # the v3 map served on the card, against the plain versions
    bk = serve.FormatQuantJOps(sm)
    x = torch.from_numpy(imgs[:64]).cuda()
    reset_launches(fns)
    with torch.no_grad():
        got = PM.digits_forward(bk, params, x)
    torch.cuda.synchronize()
    launches = read_launches(fns)
    from repro_torch.core.quantize import quantize_to_format
    from repro_torch.kernels.row_order import f32_matmul_seq_ref

    # the kernel's order: one exact fmaf chain an output from +0 (products
    # of operands wider than 12 bits are not exact in f32, so a separate
    # multiply and add would round twice)
    h = x
    for scope, w, b in (("dense1", "w1", "b1"), ("dense2", "w2", "b2"),
                        ("dense3", "w3", "b3")):
        fmt = bk.format_for([scope])
        q = lambda v: quantize_to_format(v, *fmt, bk.has_subnormals,
                                         bk.saturating)
        o = q(f32_matmul_seq_ref(q(h), q(params[w]))) + params[b]
        h = torch.relu(o)
    want = torch.softmax(o.float(), dim=-1)
    if launches["quant_matmul_format"] < 1 or not same_bits(torch, got,
                                                            want):
        raise AssertionError(f"digits v3 serve: launches {launches}, "
                             "softmax not bit for bit the emulation")
    # the second call is a store hit
    hit = C.certify(PM.digits_forward, params, los, his, store=store,
                    **common, **CERT_DIGITS_RUNS["formats"])
    if not hit.meta.get("from_store") or \
            cert_decisions(hit) != cert_decisions(cs):
        raise AssertionError("digits: the second certify was not a store "
                             "hit of the first")
    return {"train": {"steps": 400, "accuracy": acc, "seconds": train_s},
            "runs": report, "served_format": sm, "serve_rows": 64,
            "serve_launches": launches, "serve_bitwise_vs_plain": True,
            "store_hit_lookup_s": hit.meta.get("lookup_seconds")}, launches


def certify_qwen(torch, C, T, batching, fns, qmm, fd, root):
    """Qwen2-7B at full width, depth cut to CERT_LM_LAYERS: certify_lm
    uniform (k_max 24) and mixed + formats (k_max 53) into a store; if a
    set certifies, ``launch/batching.py --certificates`` serves it from the
    store with a reference check. Returns (report, launches)."""
    from repro_torch import configs
    from repro_torch.certify.store import CertificateStore

    cfg = dataclasses.replace(configs.get("qwen2_7b").FULL,
                              n_layers=CERT_LM_LAYERS)
    params = T.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    store = CertificateStore(str(root))
    uni, uni_s, uni_peak = timed_certify(
        torch, C.certify_lm, "qwen2_7b", cfg, params, k_max=24, store=store)
    mf, mf_s, mf_peak = timed_certify(
        torch, C.certify_lm, "qwen2_7b", cfg, params, k_max=53, mixed=True,
        formats=True, store=store)
    report = {"config": "qwen2_7b.FULL", "n_layers": CERT_LM_LAYERS,
              "profile": "batch 1 x seq 8, seed 1",
              "uniform": cert_summary(uni, uni_s, uni_peak),
              "mixed_formats": cert_summary(mf, mf_s, mf_peak)}
    del params
    free_device_memory(torch)
    launches = {name: 0 for name in fns}
    for tag, cs, flags in (
            ("mixed_formats", mf, ["--certify-mixed", "--certify-formats",
                                   "--certify-k-max", "53"]),
            ("uniform", uni, ["--certify-k-max", "24"])):
        if cs.serving_k is None:
            continue
        argv = ["--size", "full", "--max-layers", str(CERT_LM_LAYERS),
                "--device", "cuda", "--lanes", "4", "--max-seq", "64",
                "--requests", "4", "--prompt-len", "24", "--max-new", "8",
                "--certificates", str(root), "--check-ref", *flags]
        reset_launches(fns)
        engine, responses = batching.main(argv)
        launches = read_launches(fns)
        report["served"] = {"certificate": tag, "argv": argv,
                            "launches": launches, "steps": engine.steps,
                            "tokens": {r["id"]: r["tokens"]
                                       for r in responses},
                            "reference_check": "passed"}
        del engine, responses
        break
    else:
        report["served"] = None
    return report, launches


def certify_nano(torch, C, T, TorchOps, serve, batching, fns, qmm, fd,
                 root):
    """The 2-layer nano LM (d 16, 2 heads of 8, d_ff 32, vocab 256),
    trained on the host, certified mixed + formats + profiles (4,) on the
    card and on the CPU (decisions equal), and served from its own store
    entry through the batching engine: the format map (kernels 1-2) and
    the k map (kernels 3-4), every request's tokens and logits bit for bit
    ``reference_generate``'s. Returns (report, launches summed)."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.certify.store import CertificateStore

    cfg = dataclasses.replace(
        configs.get("qwen2_7b").SMOKE, name="qwen2-nano", n_layers=2,
        d_model=16, n_heads=2, n_kv_heads=2, d_head=8, d_ff=32, vocab=256)
    t0 = time.perf_counter()
    host, loss = train_nano(torch, T, TorchOps, cfg)
    train_s = time.perf_counter() - t0
    if not loss < 0.1:
        raise AssertionError(f"nano LM did not overfit its profile: {loss}")
    params = _to_device(host, "cuda")
    store = CertificateStore(str(root))
    cs, secs, peak = timed_certify(torch, C.certify_lm, "qwen2_7b", cfg,
                                   params, store=store, **CERT_NANO)
    t0 = time.perf_counter()
    cpu = C.certify_lm("qwen2_7b", cfg, host, **CERT_NANO)
    cpu_s = time.perf_counter() - t0
    worst = card_vs_cpu("nano", cs, cpu, rel=CERT_LM_REL_TOL,
                        rel_ebar=math.inf)
    if cs.serving_k is None:
        raise AssertionError(f"nano: not certified: {cs.meta.get('reason')}")

    sc0 = serve.ServeConfig(arch="qwen2_7b", batch=4, max_seq=32,
                            certificates=str(root))
    sc_fmt, hit = serve.apply_certificates(sc0, cfg, params, **{
        k: v for k, v in CERT_NANO.items()})
    if not hit.meta.get("from_store"):
        raise AssertionError("nano: serving did not find its own entry")
    sc_k = dataclasses.replace(sc_fmt, precision_layer_format=None,
                               precision_layer_k=cs.serving_layer_k)
    rng = np.random.RandomState(3)
    reqs = [batching.Request(rid=i, prompt=rng.randint(
        0, cfg.vocab, int(rng.randint(3, 12))).tolist(), max_new_tokens=6,
        arrival_step=i) for i in range(6)]
    served, launches_all = {}, {name: 0 for name in fns}
    for tag, sc in (("format", sc_fmt), ("k", sc_k)):
        if tag == "format" and not sc.precision_layer_format:
            raise AssertionError("nano: the certificate carries no format "
                                 "map to serve")
        with serving_spies(qmm, fd) as spies:
            reset_launches(fns)
            engine = batching.ContinuousBatchingEngine(
                cfg, sc, params, n_lanes=4, max_seq=32, page_size=8,
                certset=hit, device="cuda", keep_logits=True)
            responses = engine.run(reqs)
            torch.cuda.synchronize()
            launches = read_launches(fns)
        for name in fns:
            launches_all[name] += launches[name]
        vs_plain = spied_vs_plain(torch, qmm, fd, spies)
        bits = lane_bits(torch, responses, {
            r.rid: batching.reference_generate(
                cfg, sc, params, r.prompt, r.max_new_tokens, max_seq=32,
                return_logits=True) for r in reqs})
        want = (("quant_matmul_format", "flash_decode_certified")
                if tag == "format" else
                ("quant_matmul", "flash_decode_attention"))
        if any(launches[name] < 1 for name in want):
            raise AssertionError(f"nano {tag}: launches {launches}")
        bad = [b for b in bits if not (b["tokens_equal"]
                                       and b["logits_bitwise"])]
        if bad:
            raise AssertionError(f"nano {tag}: not reference_generate's bit "
                                 f"for bit: {bad}")
        served[tag] = {"launches": launches, "steps": engine.steps,
                       "requests": len(responses), "vs_reference": bits,
                       "kernels_vs_plain": vs_plain}
    return {"config": "qwen2-nano (d 16, 2 x 8 heads, d_ff 32, vocab 256, "
                      "2 layers)",
            "train": {"steps": CERT_NANO_STEPS, "lr": CERT_NANO_LR,
                      "loss": loss, "seconds": train_s},
            "request": {k: list(v) if isinstance(v, tuple) else v
                        for k, v in CERT_NANO.items()},
            "card": cert_summary(cs, secs, peak), "cpu_seconds": cpu_s,
            "worst_rel_bound_vs_cpu": worst, "served": served}, launches_all


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def phase_certify(torch, serve, batching, qmm, fd, T):
    """The certification pipeline on the card: Digits at full width, then
    Qwen2-7B at full width with its depth cut, then the nano LM; each
    certifies, is held against the CPU port where the CPU can run it, and
    serves what it certified."""
    import shutil

    from repro_torch import certify as C
    from repro_torch.certify.store import CertificateStore
    from repro_torch.core.backend import TorchOps
    from repro_torch.models import paper_models as PM

    emit("free", before="certify", allocated_gb=free_device_memory(torch))
    t_phase = time.perf_counter()
    fns = kernel_fns(qmm, fd)
    root = ROOT / "build" / "chip_smoke_certify"
    shutil.rmtree(root, ignore_errors=True)
    digits_store = CertificateStore(str(root / "digits"))
    digits, l_digits = certify_digits(torch, C, PM, TorchOps, qmm, serve,
                                      fns, digits_store)
    evicted = C.CertificateStore(str(root / "digits")).gc(max_entries=0)
    if evicted != 1 or len(digits_store) != 0:
        raise AssertionError(f"gc --max-entries 0 evicted {evicted}")
    emit("certify_digits", **digits, gc_evicted=evicted,
         rel_tol=CERT_REL_TOL)
    free_device_memory(torch)
    qwen, l_qwen = certify_qwen(torch, C, T, batching, fns, qmm, fd,
                                root / "qwen2_7b")
    emit("certify_qwen2_7b", **qwen)
    free_device_memory(torch)
    nano, l_nano = certify_nano(torch, C, T, TorchOps, serve, batching, fns,
                                qmm, fd, root / "nano")
    emit("certify_nano", **nano)
    launches = {name: l_digits[name] + l_qwen[name] + l_nano[name]
                for name in fns}
    emit("certify", launches=launches, by_part={
        "digits": l_digits, "qwen2_7b": l_qwen, "nano": l_nano},
        seconds=time.perf_counter() - t_phase)
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


FLASH_KEYS = ("Smax", "lengths", "ms", "host_ms", "plain_ms", "bound_ms",
              "library_ms")


def kernel_row(name, source, replaces, launches_by_path, path, err,
               timing, what, **extra):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches_by_path[path],
            "launches_by_path": launches_by_path, "max_abs_err": err,
            **{key: timing[key] for key in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")},
            "what": what, **extra}


def gemm_layer_timing(rows, M):
    """The seven GEMMs of one layer at batch M, summed (rows that were
    timed: k = 12 / format k12_e15)."""
    rows = [r for r in rows if r["M"] == M and "ms" in r]
    if len(rows) != len(GEMM_SHAPES):
        raise AssertionError(f"{len(rows)} timed rows at M={M}")
    out = {key: sum(r[key] for r in rows)
           for key in ("ms", "plain_ms", "library_ms")}
    n_bytes = sum(4.0 * (M * K + K * N + M * N) for K, N in
                  GEMM_SHAPES.values())
    n_ops = sum(2.0 * M * K * N for K, N in GEMM_SHAPES.values())
    out["bound_ms"], out["bound_by"] = bound_ms(n_bytes, n_ops)
    return out


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels").is_dir():
        print("chip_smoke: src/repro_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 3
    from repro_torch import obs
    from repro_torch.certify import spec
    from repro_torch.core import quantize
    from repro_torch.kernels import _build, flash_decode as fd
    from repro_torch.kernels import quant_matmul as qmm
    from repro_torch.core import interval as iv
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import batching, serve
    from repro_torch.models import transformer as T

    phase_env(torch, serve)
    phase_build(_build)
    phase_rounding(torch, quantize, qmm)
    phase_gemm_order(torch, qmm)
    qrows, qerr = phase_quant_matmul(torch, qmm)
    fcases, ferr = phase_flash_decode(torch, fd)
    krows, kerr = phase_quant_matmul_k(torch, qmm)
    acases, aerr = phase_flash_decode_attention(torch, fd)
    rorows = phase_row_order(torch, serve.configs.get("qwen2_7b").FULL)

    by_path, timings = {}, {}
    by_path["serve"], fmt_path, timings["serve"] = phase_serve(
        torch, serve, qmm, fd, T)
    (by_path["serve_k"], k_path, k_attn_path,
     timings["serve_k"]) = phase_serve_k(
        torch, serve, qmm, fd, T, "serve_k",
        ["--precision-k", str(SERVE_K)],
        {f"layer{i}": uniform_ks(SERVE_K, SERVE_K) for i in range(2)})
    v2_set = write_v2_set(spec)
    (by_path["serve_mixed"], mixed_path, mixed_attn_path,
     timings["serve_mixed"]) = (
        phase_serve_k(torch, serve, qmm, fd, T, "serve_mixed",
                      ["--certificate-set", str(v2_set)],
                      {"layer0": uniform_ks(12, 14),
                       "layer1": uniform_ks(12, 10)}))
    (by_path["batching"], batch_fmt_path, batch_k_path,
     batch_timing) = phase_batching(torch, serve, batching, qmm, fd, T)
    by_path["profile"], prows, prof_path = phase_profile(torch, obs, qmm, fd)
    emit("decode_trace", steps=TRACE_STEPS, note="one decode step of each "
         "full-width serve path: host-clock median, and the device split "
         "(medians over traced steps)",
         **{path: t["decode_trace"] for path, t in timings.items()})
    free_device_memory(torch)
    emit("end_to_end", note="decode ms per step and prefill s of the three "
         "full-width serve paths, side by side; the batching engine's "
         "decode on the host clock", **{
             path: {key: t[key] for key in (
                 "prefill_s", "decode_ms_per_step", "decode_tokens_per_s")}
             for path, t in timings.items()}, batching={
             path: {key: t[key] for key in (
                 "decode_ms_per_step", "decode_tokens_per_s",
                 "mean_occupancy", "steps")}
             for path, t in (("format", batch_timing),
                             ("k", batch_timing["k"]))})

    phase_interval_libm(torch, iv)
    by_path["ranges"] = phase_ranges(torch, qmm, fd)
    by_path["certify"] = phase_certify(torch, serve, batching, qmm, fd, T)
    seen = phase_analyze(torch)
    operands = analysis_operands(torch, seen)
    del seen
    by_path["analysis_ops"], path_outs = phase_analysis_ops(
        torch, kops, qmm, fd, operands)
    free_device_memory(torch)
    phase_interval_gemm_order(torch, operands)
    cpath, crows, cerr = phase_caa_kernel(torch, "caa_matmul", kops,
                                          operands, path_outs)
    ipath, irows, ierr = phase_caa_kernel(torch, "interval_matmul", kops,
                                          operands, path_outs)
    del path_outs, operands

    qerr = max([qerr] + [r["max_abs_err"] for r in (
        fmt_path["quant_matmul_format"] + prof_path["quant_matmul_format"]
        + batch_fmt_path["quant_matmul_format"])])
    ferr = max([ferr] + [r["max_abs_err"] for r in (
        fmt_path["flash_decode_certified"]
        + batch_fmt_path["flash_decode_certified"])])
    kerr = max([kerr] + [r["max_abs_err"] for r in (
        k_path + mixed_path + prof_path["quant_matmul"]
        + batch_k_path["quant_matmul"])])
    aerr = max([aerr] + [r["max_abs_err"] for r in (
        prof_path["flash_decode_attention"] + k_attn_path + mixed_attn_path
        + batch_k_path["flash_decode_attention"])])
    launches = {name: {path: counts[name] for path, counts in by_path.items()}
                for name in KERNELS}
    roofline = {}
    for r in prows:
        roofline.setdefault(r["kernel"], []).append(r["roofline_frac"])
    serve_last = f"Smax={FLASH_CASES['serve_last'][0]} lengths " \
        f"{FLASH_CASES['serve_last'][1][0]}"
    kernels = [
        kernel_row(
            "quant_matmul_format",
            "src/repro_torch/csrc/quant_matmul_format.cu",
            "src/repro/kernels/quant_matmul.py:123",
            launches["quant_matmul_format"], "serve", qerr,
            gemm_layer_timing(qrows, SERVE_BATCH),
            "the 7 GEMMs of one layer at decode, M=4, format k12_e15, "
            "weights cold",
            prefill_per_layer=gemm_layer_timing(qrows, 512)),
        kernel_row(
            "flash_decode_certified",
            "src/repro_torch/csrc/flash_decode_certified.cu",
            "src/repro/kernels/flash_decode.py:112",
            launches["flash_decode_certified"], "serve", ferr,
            fcases["serve_last"],
            f"the serve cache at its last step: B=4 K=4 G=7 D=128 "
            f"{serve_last}, format k12_e15",
            other_cases={c: {key: fcases[c][key] for key in FLASH_KEYS}
                         for c in fcases if c != "serve_last"}),
        kernel_row(
            "quant_matmul", "src/repro_torch/csrc/quant_matmul.cu",
            "src/repro/kernels/quant_matmul.py:39",
            launches["quant_matmul"], "serve_k", kerr,
            gemm_layer_timing(krows, SERVE_BATCH),
            f"the 7 GEMMs of one layer at decode, M=4, k={SERVE_K}, "
            "weights cold",
            prefill_per_layer=gemm_layer_timing(krows, 512)),
        kernel_row(
            "flash_decode_attention", "src/repro_torch/csrc/flash_decode.cu",
            "src/repro/kernels/flash_decode.py:40",
            launches["flash_decode_attention"], "serve_k", aerr,
            acases["serve_last"],
            f"the serve cache's shape: B=4 K=4 G=7 D=128 {serve_last}",
            other_cases={c: {key: acases[c][key] for key in FLASH_KEYS}
                         for c in acases if c != "serve_last"}),
    ]
    for name, replaces, path_rows, rows, err in (
            ("caa_matmul", "src/repro/kernels/caa_matmul.py:25", cpath,
             crows, cerr),
            ("interval_matmul", "src/repro/kernels/interval_matmul.py:34",
             ipath, irows, ierr)):
        kernels.append(kernel_row(
            name, f"src/repro_torch/csrc/{name}.cu", replaces,
            launches[name], "analysis_ops", err, layer_sum(rows, 4),
            "the 7 GEMMs of one Qwen2-7B layer at M=4, seeded inputs, "
            "weights cold; "
            "launches: ops wrappers on the Digits analysis's own operands "
            "(not on the analysis path, as in the reference)",
            prefill_per_layer=layer_sum(rows, 512),
            analysis_operands=[{key: r[key] for key in (
                "M", "K", "N", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")} for r in path_rows]))
    for name, what in (
            ("row_mean", "the rmsnorm's mean of squares over d_model=3584 "
                         "for the 4 rows of a decode step"),
            ("f32_matmul", "the LM head at decode: 4 rows x 3584 against the "
                           "transposed 3584 x 152064 table")):
        kernels.append(kernel_row(
            name, f"src/repro_torch/csrc/{name}.cu", ROW_ORDER_REPLACES[name],
            launches[name], "batching", 0.0, rorows[name]["decode"], what,
            prefill=rorows[name]["prefill"], port_only=True))
    for row in kernels:
        row["profile_roofline_frac"] = roofline.get(
            {"flash_decode_attention": "flash_decode"}.get(row["name"],
                                                           row["name"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
