#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with ``python3 chip_smoke.py``. It builds the
port's CUDA kernels (nine sources in ``src/repro_torch/csrc``; the ``dtypes``
phase builds the five of the bf16 / e4m3 instances) with nvcc (into
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
* ``serve_monitor`` — ``serve``'s run again under a certificate-violation
  monitor (``--monitor --metrics --prom --trace``, a v3 set whose
  ``scope_ranges`` are the per-label maxima of a first monitored pass):
  logits bit for bit ``serve``'s, one ``numeric_health`` launch and one
  observation a GEMM, silent at the observed maxima, firing with
  ``layer*/mlp`` halved, one more device-to-host copy a decode step; then
  the same at the uniform k = 12 against ``serve_k``, each product read
  before its final rounding and rounded in place (``round_k_inplace``),
  its decode step traced beside the unmonitored one;
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
  k maps served, logits bit for bit ``reference_generate``'s, and its v3
  set served under a violation monitor on card and CPU, counters equal;
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
  and on every Digits analysis shape;
* ``paper`` — the paper's drivers (``python -m
  repro_torch.benchmarks.run``: Table I, analysis speed, bound tightness)
  and the examples ``quickstart`` (Digits at full width; its required k
  and certified / correct counts equal on the card and on the CPU with the
  same weights), ``serve_custom_formats``, ``serve_certified
  --precision-k 12``, ``serve_certified_lm`` and
  ``lm_precision_analysis`` (Qwen2, Mixtral and RWKV6 at SMOKE), each
  through its ``main``, with its launches of kernels 1-4;
* ``zoo`` — the GQA model zoo: kernel 4 with Gemma-2's softcap and windows
  of 16 and 4,096 against both plain versions at the serve cache and at
  32K (timed there with window 4,096); Gemma-2 27B at full width cut to 8
  layers served under the format map and at k = 12 (its decode attention
  through kernel 4, one launch a layer a step, kernel 2 never), then at
  batch 1 with a 4,224-token prompt so that the local layers' window bites,
  each decode-attention call held against kernel 4's plain versions, then
  through the batching engine (every request bit for bit alone) and the
  library products' lane bits at its widths; Mixtral 8x22B at full width
  cut to 2 layers at k = 12 and under the format map (router launches,
  assignments dropped by capacity); Command-R 35B at full width cut to 4
  layers under the format map (kernels 1 and 2); Llama-4 Maverick at SMOKE
  on card and CPU (full width does not fit the card); and the four SMOKE
  configs analysed (CAA forward, router records) and certified on card and
  CPU with the same weights, decisions equal;
* ``ssm`` — the recurrent families at full width, depth cut to 2 layers
  (``ZOO_LAYERS``: room in the time limit; no check needs the depth): RWKV6
  1.6B under a format map with a ``layer*`` key (its layers have no
  sub-scope; the scope each product resolved to printed) and at k = 12,
  then at batch 1 with a 4,096-token prompt on the plain backend, its last
  decode logits held against one full forward of the 4,112 tokens; Hymba
  1.5B under the format map and at k = 12 (kernel 4 once a layer a decode
  step, kernel 2 never), at batch 1 with a 1,200-token prompt past its
  window (every decode-attention call held against kernel 4's plain
  versions), through the batching engine (prompts off the page grid,
  every request bit for bit alone) and the lane bits of every op of a
  decode step, its Mamba state and the Mamba step's library pieces;
  kernels 1 and 3 and ``f32_matmul`` at the new shapes (N = 1, 16, 64)
  on the inputs the serve runs gave them; both SMOKE configs analysed and
  certified on card and CPU, and one CAA pass of each at full width on 2
  layers with its recurrences' fixpoint bounds;
* ``mla_encdec`` — the last three families at full width, depth cut to 2
  decoder layers (``ZOO_LAYERS``, as ``ssm``),
  each under the format map plus a ``layer*`` key and at k = 12 (batch 4
  × 128 × 16): MiniCPM3 4B (MLA: its two per-head weight products through
  ``f32_matmul`` on block-diagonal tables, its decode attention through
  kernel 4 as one kv head of keys [c | k_rope] at the latent scale, two
  steps' calls held against the plain versions), then through the
  batching engine (every request bit for bit alone), every op of a ragged
  decode step against each lane alone and the library products' lane
  bits; Whisper medium (24 encoder layers, 1,500 frames encoded once, the
  encoder states reused by every step; the last decode logits against a
  full forward; the engine refuses it); PaliGemma 3B (256 patches + 128
  tokens; the engine text-only, bit for bit alone); the three SMOKE
  configs analysed and certified on card and CPU, and one CAA pass of
  MiniCPM3 at full width on 2 layers;
* ``dtypes`` — serving in bf16 and fp8 (``ServeConfig.compute_dtype``,
  ``cache_dtype``, ``param_dtype``): the narrow instances of kernels 1-4,
  ``f32_matmul`` and ``row_mean`` at Qwen2-7B's shapes (M = 4 / 512, the
  serve cache and 32K), bf16 x with bf16 or e4m3 w / cache, bit for bit
  their f32 instances on the upcast operands and held against their
  plain versions on the same operands (kernel 4's bf16 instance, the
  reference's composed bf16 path: bit for bit its plain version), timed,
  their bounds' operations at the bf16 peak; kernels 2 and 4 on an f32 q
  with the narrow caches (f32 compute, narrow ``cache_dtype``);
  Qwen2-7B FULL at full depth in bf16 under the plain, k = 12 and format
  backends (bf16 cache), then the format map and k = 12 with an e4m3
  cache and e4m3 params (exact launches, every kept kernel call checked,
  the decode step against a full forward, peak memory); the batching
  cell's requests through the engine in bf16, every lane bit for bit
  alone; Gemma-2 27B FULL at all 46 layers (bf16 compute, e4m3 params,
  bf16 cache, format map) with its peak memory and the share of its
  weights e4m3 stores as zero or subnormal; MLA's bf16 decode through the
  port-only latent kernel: bit for bit its plain version at MiniCPM3's
  decode shapes, at 32K and with a lane of length 0 (bf16, e4m3 and f32
  latent caches), timed beside the composed bf16 einsum path; MiniCPM3 4B
  FULL at all 62 layers in bf16 under the plain, k = 12 and format
  backends (one latent launch a layer and decode step, two steps' calls
  bit for bit the plain version), then through the engine, every lane bit
  for bit alone; and the dry run (``launch/dryrun.py``, started in a
  spawned CPU process after the kernel phases): Qwen2-7B's four shapes on
  the fake single-pod 16 × 16 mesh, and the prefill steps of ``dtypes``'
  Qwen2-7B and Gemma-2 runs on 1 × 1, whose params and cache bytes must
  equal the bytes those runs allocated on the card;
* ``train`` — training (``launch/train.py``): every arch's SMOKE loss and
  gradients on the card, with each layer rematerialised and without (bit
  for bit), against the CPU port's on the same params and batch (loss
  within 1e-5 relative, each gradient leaf within 1e-4 of its max |g|);
  three steps of SMOKE Qwen2-7B with 8-bit moments and three with
  error-feedback compression, card against CPU; Qwen2-7B at full width
  through ``train.main`` (2 layers, seq 512 × batch 4, 6 steps with a
  checkpoint every 3, then resumed from step 3: losses and final params
  bit for bit the uninterrupted run's; step ms, tokens/s, peak memory,
  checkpoint bytes, save and restore seconds), then 8 layers for 3 steps.
  No hand-written kernel may launch on any of its runs: under autograd
  the model's kernel routes compose library ops;
* ``mesh`` — the device mesh (``launch/mesh.py``, ``parallel/sharding.py``;
  a process here has one card, so the mesh is 1 × 1): the batching
  engine on ``make_serving_mesh()`` with ``batching``'s requests, format
  map and k = 12, every request's tokens, logit sha256 and the launch
  counts equal to ``batching``'s; kernels 1 and 3 on each column shard of
  layer 0's seven projections (M = 4 and 512) and ``f32_matmul`` on each
  vocab shard of the LM head, kernels 2 and 4 on each KV-head shard of
  the serve cache, for "model" = 2, 4, 8, bit for bit the same columns or
  heads of the whole call; and Qwen2-7B at full width cut to 2 layers, 3
  steps of ``build_train_step`` on the mesh with ``param_sharding`` fsdp
  and tp, losses bit for bit ``train``'s.

The CPU halves of the card-against-CPU checks (``ranges``' maps, the SMOKE
analyses of ``zoo``, ``ssm`` and ``mla_encdec``, ``certify``'s Digits and
nano certificates, ``analyze``'s Table I) run in one spawned process with
CPU_SIDE_THREADS torch threads and no card, queued as soon as their inputs
exist, while the card works; a phase compares where it always did, and a
CPU half that failed fails it there. The ``paper`` phase (with its
quickstart's CPU half) runs in a second spawned process on the card
while this one runs ``zoo``, ``ssm`` and ``mla_encdec``: it needs nothing
of them and counts its own launches; the run waits for it before
``dtypes`` and fails if it failed. A third spawned process on the card
(SMOKE_CARD) runs the card halves of those three phases' SMOKE analyses
from ``ranges`` on, counting its own launches, which the phases add to
theirs. ``dtypes`` runs alone: beside the analyses of ``ssm`` and
``mla_encdec`` both ran up to twice as long.

Each phase prints one JSON object on a line of its own, then a ``seconds``
line with its host seconds; a phase that fails raises and the script exits
non-zero. The last three lines are the kernels'
summary (``{"kernels": [...]}``), the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them, and ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the repository beside it, the script exits non-zero and prints no
result. It imports nothing of JAX.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import hashlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

F32_TFLOPS = 67e12      # H100 SXM f32 outside the tensor cores (data sheet)
BF16_TFLOPS = 989e12    # H100 SXM dense bf16 on the tensor cores (data sheet)
FP8_TFLOPS = 1979e12    # H100 SXM dense fp8 on the tensor cores (data sheet)
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
           "row_mean", "f32_matmul", "numeric_health", "round_k_inplace")


# While two processes share the card (``paper`` beside ``zoo``, ``ssm`` and
# ``mla_encdec``), every line either prints carries this note as
# "contended": its timings were taken on a shared card and host.
CONTENDED = {"note": None}


def emit(phase: str, **fields) -> None:
    if CONTENDED["note"]:
        fields.setdefault("contended", CONTENDED["note"])
    print(json.dumps({"phase": phase, **fields}), flush=True)


# ---------------------------------------------------------------------------
# the CPU halves of the card-against-CPU checks, in a second process
# ---------------------------------------------------------------------------

CPU_SIDE_THREADS = 2    # the CPU process's torch threads: the card phases'
#                         host work keeps the other cores to itself
CPU_SIDE_ROOT = ROOT / "build" / "chip_smoke_cpu_side"
PAPER_THREADS = 4       # the paper process's: its CPU halves run inline there


def _side_init(src: str, threads: int, card: bool) -> None:
    if not card:
        os.environ["CUDA_VISIBLE_DEVICES"] = ""   # it never uses a card
    sys.path.insert(0, src)
    import torch

    torch.set_num_threads(threads)
    torch.set_num_interop_threads(1)


class _Done:
    """A finished job's stand-in for a future (no CPU process running)."""

    def __init__(self, value):
        self.value = value

    def result(self):
        return self.value

    def done(self):
        return True


class SideProcess:
    """One worker process beside the main one (spawned, ``threads`` torch
    threads). ``CPU`` (no card) computes the CPU halves of the
    card-against-CPU checks while the card works: ``ranges``' maps and the
    SMOKE analyses and certificates of ``zoo``, ``ssm`` and ``mla_encdec``
    (queued when the run starts), Digits' and the nano's CPU certificates,
    ``analyze``'s CPU Table I and ``quickstart``'s CPU analysis (queued as
    soon as their weights exist). ``PAPER`` (the card) runs the ``paper``
    phase while the main process runs ``zoo``, ``ssm`` and ``mla_encdec``:
    it needs nothing of them, its models are small, and it counts its own
    launches. A phase takes the result where it compares; a job that
    failed raises there, so the phase fails as before. Without a process
    (``start`` not called: a rehearsal that imports this script) a job
    runs where it is submitted."""

    def __init__(self, card: bool):
        self.card, self.pool = card, None

    def start(self, threads: int = CPU_SIDE_THREADS):
        import concurrent.futures
        import multiprocessing

        self.pool = concurrent.futures.ProcessPoolExecutor(
            max_workers=1, mp_context=multiprocessing.get_context("spawn"),
            initializer=_side_init,
            initargs=(str(ROOT / "src"), threads, self.card))
        return self

    def submit(self, fn, *args):
        if self.pool is None:
            return _Done(fn(*args))
        return self.pool.submit(fn, *args)

    def close(self):
        """Stop the process, jobs still queued or running included."""
        if self.pool is None:
            return
        procs = list((self.pool._processes or {}).values())
        self.pool.shutdown(wait=False, cancel_futures=True)
        for proc in procs:
            if proc.is_alive():
                proc.terminate()
            proc.join(timeout=10)
        self.pool = None


CPU = SideProcess(card=False)
PAPER = SideProcess(card=True)
SMOKE_CARD = SideProcess(card=True)
CPU_JOBS = {}           # (phase, arch) → future of a job queued at the start
CARD_JOBS = {}          # (phase, arch) → future of a card half (SMOKE_CARD)
SMOKE_CARD_THREADS = 1  # its SMOKE analyses are host-bound Python


SMOKE_CARD_ROOTS = {"zoo": ROOT / "build" / "chip_smoke_zoo",
                    "ssm": ROOT / "build" / "chip_smoke_ssm",
                    "mla": ROOT / "build" / "chip_smoke_mla_encdec"}


def card_smoke_side(kind: str, arch: str, root):
    """The card half of ``kind``'s SMOKE check of ``arch`` (the
    ``*_smoke_side`` function with ``dev="cuda"``), in the SMOKE_CARD
    process, and the kernel launches it made there (every counter set to
    0 just before, read just after)."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import quant_matmul as qmm

    fns = kernel_fns(qmm, fd)
    reset_launches(fns)
    fn = {"zoo": zoo_smoke_side, "ssm": ssm_smoke_side,
          "mla": mla_smoke_side}[kind]
    out = fn(arch, "cuda", root)
    return out, read_launches(fns)


def queue_card_smoke_sides() -> None:
    """Queue the card halves of ``zoo``'s, ``ssm``'s and ``mla_encdec``'s
    SMOKE analyses in the SMOKE_CARD process: host-bound eager passes on
    tiny tensors, which run there while the main process serves."""
    import shutil

    for kind, archs in (("zoo", ZOO_SMOKE), ("ssm", SSM_ARCHS),
                        ("mla", MLA_ENCDEC_ARCHS)):
        shutil.rmtree(SMOKE_CARD_ROOTS[kind], ignore_errors=True)
        for arch in archs:
            CARD_JOBS[(kind, arch)] = SMOKE_CARD.submit(
                card_smoke_side, kind, arch, SMOKE_CARD_ROOTS[kind])


def card_job(kind: str, arch: str, fns):
    """The card half of ``kind``'s SMOKE check of ``arch`` (queued, or run
    here when it was not); its launches are added to ``fns``' counters,
    as if it had run in this process."""
    job = CARD_JOBS.pop((kind, arch), None)
    if job is None:
        job = SMOKE_CARD.submit(card_smoke_side, kind, arch,
                                SMOKE_CARD_ROOTS[kind])
    out, launches = job.result()
    for name, n in launches.items():
        fns[name].launches += n
    return out


def queue_smoke_sides() -> None:
    """Queue the CPU halves whose inputs come from seeds on the CPU: the
    SMOKE analyses of ``zoo``, ``ssm`` and ``mla_encdec``, and ``ranges``'
    maps."""
    for kind, fn, archs in (("zoo", zoo_smoke_side, ZOO_SMOKE),
                            ("ssm", ssm_smoke_side, SSM_ARCHS),
                            ("mla", mla_smoke_side, MLA_ENCDEC_ARCHS)):
        for arch in archs:
            CPU_JOBS[(kind, arch)] = CPU.submit(fn, arch, "cpu",
                                                CPU_SIDE_ROOT / kind)
    CPU_JOBS[("ranges", None)] = CPU.submit(ranges_cpu_side)


def cpu_job(kind: str, arch: str):
    """The queued CPU half of ``kind``'s check of ``arch`` (queued now when
    it was not)."""
    job = CPU_JOBS.pop((kind, arch), None)
    if job is None:
        fn = {"zoo": zoo_smoke_side, "ssm": ssm_smoke_side,
              "mla": mla_smoke_side}[kind]
        job = CPU.submit(fn, arch, "cpu", CPU_SIDE_ROOT / kind)
    return job


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


def trace_ms(torch, fn, copies, iters: int, attempts: int = 6) -> float:
    """Mean device time of ``fn(w)`` a call, ``w`` rotating through
    ``copies`` (after one warm-up pass): the summed durations of the device
    activities (kernels, copies) in a ``torch.profiler`` trace of ``iters``
    calls. For calls shorter than their launch from the host, where CUDA
    events around a loop of calls time the host. The profiler now and then
    returns a trace without the device's activities (three such traces in
    a row were seen once, after the monitored serve runs): such a trace is
    taken again, after a pause, up to six times in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for w in copies:
        fn(w)
    torch.cuda.synchronize()
    for attempt in range(attempts):
        if attempt:
            time.sleep(0.5)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(copies[i % len(copies)])
            torch.cuda.synchronize()
        spans = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if spans:
            return sum(spans) / 1e3 / iters
    raise AssertionError(f"{attempts} traces held no device activity")


def graph_ms(torch, fn, copies, iters: int) -> float:
    """Mean device time of ``fn(w)`` a call, ``w`` rotating through
    ``copies``: ``iters`` calls captured in one CUDA graph (after a warm-up
    pass on a side stream), the graph replayed between two CUDA events. The
    device runs the calls back to back with no host launch between them,
    so a call shorter than its launch is timed by the device, without the
    profiler (whose traces now and then hold no device activity)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for w in copies:
            fn(w)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for i in range(iters):
            fn(copies[i % len(copies)])
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    return ms


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


def ops_peak(*dtypes) -> float:
    """The card's peak rate for work on operands of ``dtypes``: that of the
    widest (f32 outside the tensor cores; bf16 and fp8 on them)."""
    names = {str(d).rsplit(".", 1)[-1] for d in dtypes}
    if names & {"float32", "float64"}:
        return F32_TFLOPS
    return BF16_TFLOPS if "bfloat16" in names else FP8_TFLOPS


def bound_ms(n_bytes: float, n_ops: float, peak: float = F32_TFLOPS):
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / peak
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
    # before the first cuBLAS call: cuBLAS reads it once, and the train
    # phase's deterministic mode refuses a GEMM without it (on an H100 it
    # is PyTorch's default workspace, 8 × 4 MiB)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    serve.configure_precision()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=nvidia_smi_line(),
         tf32=False, float32_matmul_precision="highest",
         cublas_workspace_config=os.environ["CUBLAS_WORKSPACE_CONFIG"])


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


def built(build, sources):
    """Build ``sources``, every nvcc started together; returns the fields
    of a build line: seconds, each source's seconds and ptxas report."""
    t0 = time.perf_counter()
    res = build.build(sources, ptxas_verbose=True)
    for name, r in res.items():
        print(f"--- nvcc {name}\n{r['log']}", file=sys.stderr)
    return dict(seconds=time.perf_counter() - t0, sources=list(sources),
                per_source_s={n: r["seconds"] for n, r in res.items()},
                ptxas={n: ptxas_report(res[n]["log"]) for n in sources})


def phase_build(build):
    """The f32 kernels' sources (``SOURCES``)."""
    emit("build", **built(build, build.SOURCES))


class NarrowBuild:
    """The ``dtypes`` phase's sources (``NARROW_SOURCES``: the bf16 / e4m3
    instances) built in a thread beside the run's first phases, every nvcc
    started together at a lower priority (cores the card's phases leave
    idle; the phase runs some ten minutes later). ``finish()`` waits for it, prints its
    ``dtypes_build`` line and raises if the build failed."""

    def __init__(self, build):
        import threading

        self.result, self.error = None, None
        self.thread = threading.Thread(target=self._run, args=(build,),
                                       daemon=True)
        self.thread.start()

    def _run(self, build):
        # this thread and the nvcc processes it starts yield the host's
        # cores to the kernel phases' timing loops (on Linux a nice value
        # is a thread's, and a child inherits it)
        os.nice(10)
        try:
            self.result = built(build, build.NARROW_SOURCES)
        except BaseException as e:       # raised again in finish()
            self.error = e

    def finish(self):
        self.thread.join()
        if self.error is not None:
            raise self.error
        emit("dtypes_build", **self.result)


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
    """Equal bit for bit (and in dtype), except that any NaN equals any
    NaN."""
    if got.dtype != want.dtype:
        return False
    nan = torch.isnan(want)
    bits = {4: torch.int32, 2: torch.int16, 1: torch.int8}[got.element_size()]
    return bool(torch.equal(torch.isnan(got), nan)) and bool(torch.equal(
        got[~nan].view(bits), want[~nan].view(bits)))


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
                   "lane of length 0; the window's under a window); and "
                   "against the f64 split version, one ulp + 8·√(n + 16)·"
                   "2⁻²⁴·max|v|; with a softcap c, + 16·c·2⁻²⁴·max|v| and "
                   "+ 8·c·2⁻²⁴·max|v|: tanhf within 2 ulps (CUDA C "
                   "Programming Guide), a score off by Δ ≤ 4·c·2⁻²⁴ moves "
                   "the output by ≤ 2Δ·max|v|")


def attended(torch, lengths, S):
    """Positions each lane attends: its length, or all S for a lane of
    length 0 (every score is masked alike, so every weight is exp(0))."""
    return torch.where(lengths <= 0, S, lengths.clamp(max=S))


def first_attended(torch, lengths, S, window=0):
    """The first position each lane attends under a sliding ``window`` (0:
    none): max(0, n - window), 0 for a lane of length 0."""
    if not window:
        return torch.zeros_like(lengths)
    n = attended(torch, lengths, S)
    return torch.where(lengths <= 0, 0, (n - window).clamp(min=0))


def flash_vmax(torch, v, lengths, fmt=None, window=0):
    """The n positions each lane attends, and the largest |v| there
    (rounded into ``fmt`` when given) per (b, kv-head)."""
    from repro_torch.core.quantize import quantize_to_format

    S = v.shape[1]
    n = attended(torch, lengths, S)
    lo = first_attended(torch, lengths, S, window)
    pos = torch.arange(S, device=v.device)[None, :]
    valid = (pos < n[:, None]) & (pos >= lo[:, None])
    va = (v if fmt is None else quantize_to_format(v, *fmt)).abs()
    return n - lo, torch.where(valid[:, :, None, None], va,
                               0).amax(dim=(1, 3))


def flash_tol(torch, v, lengths, fmt=None, window=0, softcap=0.0):
    """Sums over the n attended positions in another order, plus expf: a
    few f32 ulps of the largest |v| attended (rounded into ``fmt`` when
    given), 2·(n + 16)·2⁻²⁴·max|v|, per (b, kv-head); with a softcap c,
    + 16·c·2⁻²⁴·max|v| (two tanhs, each score within 4·c·2⁻²⁴ of exact)."""
    n, vmax = flash_vmax(torch, v, lengths, fmt, window)
    slack = (2.0 * (n.double() + 16)[:, None] + 16.0 * softcap) * 2.0 ** -24
    return (slack * vmax.double())[:, :, None, None]


def flash_f64_tol(torch, v, lengths, fmt=None, window=0, softcap=0.0):
    """A kernel against the f64 split version: the probabilistic bound on
    the rounding errors of its f32 sums, λ·√(n + 16)·2⁻²⁴·max|v|, λ = 8
    (Higham and Mary, SIAM J. Sci. Comput. 41(5), 2019: exceeded with
    probability below 2·exp(-λ²/2) ≈ 3e-14 an element). At 32K it is 45
    times tighter than :func:`flash_tol`, below what one chunk of 64
    positions moves an output, so a chunk dropped or folded with a wrong
    weight fails it. With a softcap c, + 8·c·2⁻²⁴·max|v| (the kernel's
    tanhf and its two products put a score within 4·c·2⁻²⁴ of exact)."""
    n, vmax = flash_vmax(torch, v, lengths, fmt, window)
    slack = (8.0 * (n.double() + 16).sqrt()[:, None]
             + 8.0 * softcap) * 2.0 ** -24
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
# (Smax, lengths, (K, G, D)): the shapes beyond the serve's K=4, G=7, D=128
# that kernels 2 and 4 take, at batch 4 — paligemma_3b's head dim 256 with
# G = 8 and one kv head, a second tile of query heads (G = 16), hymba_1p5b's
# G = 5 at D = 64 (5 kv heads), and D = 96. Beside FLASH_CASES, whose
# (Smax, lengths) pairs tools/quant_gemm_compare.py times at the serve's
# shape.
FLASH_WIDE_CASES = {
    "g8_d256": (8192, [8192, 4097, 64, 0], (1, 8, 256)),
    "g16_d64": (1024, [1, 255, 256, 1000], (2, 16, 64)),
    "g5_d64": (1024, [1000, 64, 65, 0], (5, 5, 64)),
    "g7_d96": (1024, [1, 255, 256, 1000], (4, 7, 96)),
    # above 256, the wide instance (D in slices of 256): one dim past it
    # (4-byte copies), 320 and 512 (two slices), G = 1, 8 and 16
    "g1_d257": (1024, [1000, 64, 65, 0], (2, 1, 257)),
    "g8_d320": (1024, [1, 255, 256, 1000], (1, 8, 320)),
    "g16_d512": (2048, [2048, 1025, 64, 0], (1, 16, 512)),
    # the last three families' serve caches (128 + 16 tokens): Whisper's
    # decoder self-attention, 16 kv heads of one query head; PaliGemma's one
    # kv head of 8 query heads at D = 256, 256 patches more
    "whisper": (SERVE_PROMPT + SERVE_STEPS + 1, [144, 129, 64, 1],
                (16, 1, 64)),
    "paligemma": (256 + SERVE_PROMPT + SERVE_STEPS + 1, [400, 385, 256, 1],
                  (1, 8, 256)),
}


# (Smax, lengths, (K, G, D), scale): MiniCPM3's latent decode at the serve
# cache (mla_attention through TorchOps.latent_decode_attention): one kv
# head of its 40 query heads over keys [c | k_rope] of 256 + 32 that serve
# as the values too, at the scale (d_nope + d_rope)^-½; kernel 4 only
FLASH_LATENT_CASE = (SERVE_PROMPT + SERVE_STEPS + 1, [144, 129, 64, 1],
                     (1, 40, 288), (64 + 32) ** -0.5)


def flash_cases():
    """(case, Smax, lengths, (K, G, D)) of every decode-attention case."""
    for case, (S, lens) in FLASH_CASES.items():
        yield case, S, lens, (4, 7, 128)
    for case, (S, lens, shape) in FLASH_WIDE_CASES.items():
        yield case, S, lens, shape


def cache_copies(torch, k, v):
    """Copies of the cache (k, v) whose total exceeds the L2 twice over (at
    least two), so that a call that rotates through them reads its cache
    from HBM, as a decode step does (it reads 28 layers' caches in turn)."""
    n = max(2, math.ceil(2 * L2_BYTES / (k.element_size() * k.numel()
                                         + v.element_size() * v.numel())))
    return [(k.clone(), v.clone()) for _ in range(n)]


def flash_iters(S: int) -> int:
    """Traced calls of one decode-attention timing: 10 for a cache of more
    than 4,096 positions (the PR 15 body takes ~19 ms a call at 32K), else
    50. ``tools/quant_gemm_compare.py`` times with the same count."""
    return 10 if S > 4096 else 50


def flash_timing(torch, kernel, plain, q, k, v, lengths, scale=None,
                 shared_kv=False, timer=None, plain_timer=None):
    """Device ms of ``kernel`` and ``plain`` on the same inputs and of the
    SDPA yardstick, each from a profiler trace (:func:`trace_ms`) with the
    cache rotated through :func:`cache_copies`; ``host_ms``: the kernel
    timed by CUDA events around back-to-back calls, which time the host's
    launch where that is longer. The bound: bytes (q in, out, k over the
    positions below each lane's length, v over the attended ones) or
    operations (2·G·D a position and kv head for the scores, the same for
    P·V): a lane of length 0 reads no k and computes no score, its weights
    are all exp(0). With ``shared_kv`` the keys serve as the values (k is
    v, as in MLA's latent decode): read once, they count once; ``scale``
    (None: D^-½) is the yardstick's. ``timer`` / ``plain_timer`` (default
    :func:`trace_ms`) time the kernel and the yardstick / the plain
    version; the bound counts each operand's own bytes.
    """
    timer = timer or trace_ms
    plain_timer = plain_timer or trace_ms
    B, H, G, D = q.shape
    S = k.shape[1]
    lens = lengths.tolist()
    iters = flash_iters(S)
    copies = cache_copies(torch, k, v)
    if shared_kv:
        copies = [(ck, ck) for ck, _ in copies]
    timing = {
        "ms": timer(torch, lambda c: kernel(q, *c, lengths), copies, iters),
        "host_ms": time_cold_ms(torch, lambda c: kernel(q, *c, lengths),
                                copies, iters),
        "plain_ms": plain_timer(torch, lambda c: plain(q, *c, lengths),
                                copies, max(2, iters // 5)),
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
    tcopies = [tuple(t[:, :n].permute(0, 2, 1, 3).contiguous().to(q.dtype)
                     for t in c) for c in copies]
    del copies
    timing["library_ms"] = timer(
        torch, lambda c: sdpa(qs, *c, attn_mask=mask, enable_gqa=True,
                              scale=scale), tcopies, iters)
    del tcopies
    n_k = int(lengths.clamp(min=0, max=S).sum())
    n_v = int(attended(torch, lengths, S).sum())
    n_read = n_v if shared_kv else n_k + n_v    # attended ⊇ below length
    n_bytes = (2.0 * q.element_size() * q.numel()
               + k.element_size() * n_read * H * D + 4 * B)
    timing["bound_ms"], timing["bound_by"] = bound_ms(
        n_bytes, 2.0 * G * D * H * (n_k + n_v), ops_peak(q.dtype, k.dtype))
    return timing


def phase_flash_decode(torch, fd):
    B = SERVE_BATCH
    gen = torch.Generator(device="cuda").manual_seed(3)
    fmt12 = FORMATS["k12_e15"]
    worst, cases = 0.0, {}
    for case, S, lens, (H, G, D) in flash_cases():
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
        cases[case] = {"Smax": S, "lengths": lens,
                       "shape": {"B": B, "K": H, "G": G, "D": D}, **timing,
                       "rows": rows}
        del q, k, v
    emit("flash_decode_certified", tolerance=FLASH_TOLERANCE,
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
    """Kernel 4 against its plain version in every FLASH_CASES case (the
    serve cache's shape, a ragged Smax=1024 cache, a cache with a lane of
    length 0 and the 32K one) and every FLASH_WIDE_CASES shape."""
    B = SERVE_BATCH
    gen = torch.Generator(device="cuda").manual_seed(4)
    worst, cases = 0.0, {}
    for case, S, lens, (H, G, D) in flash_cases():
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = torch.randn(B, H, G, D, device="cuda", generator=gen)
        k = torch.randn(B, S, H, D, device="cuda", generator=gen)
        v = torch.randn(B, S, H, D, device="cuda", generator=gen)
        st = check_flash_attention(torch, fd, q, k, v, lengths, case)
        worst = max(worst, st["max_abs_err"])
        timing = flash_timing(torch, fd.flash_decode_attention,
                              fd.flash_decode_ref, q, k, v, lengths)
        cases[case] = {"Smax": S, "lengths": lens,
                       "shape": {"B": B, "K": H, "G": G, "D": D}, **st,
                       **timing}
        del q, k, v
    S, lens, (H, G, D), scale = FLASH_LATENT_CASE
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = torch.randn(B, H, G, D, device="cuda", generator=gen)
    kv = torch.randn(B, S, H, D, device="cuda", generator=gen)
    st = check_flash_windowed(
        torch, fd, fd.flash_decode_attention(q, kv, kv, lengths, scale=scale),
        q, kv, kv, lengths, 0, 0.0, "minicpm3_latent", scale=scale)
    worst = max(worst, st["max_abs_err"])
    timing = flash_timing(
        torch, lambda *a: fd.flash_decode_attention(*a, scale=scale),
        lambda *a: fd.flash_decode_ref(*a, 0, 0.0, scale), q, kv, kv,
        lengths, scale=scale, shared_kv=True)
    cases["minicpm3_latent"] = {
        "Smax": S, "lengths": lens, "shape": {"B": B, "K": H, "G": G, "D": D},
        "scale": scale, **st, **timing}
    del q, kv
    emit("flash_decode_attention", tolerance=FLASH_TOLERANCE,
         max_abs_err=worst, cases=cases)
    return cases, worst


def kernel_fns(qmm, fd):
    """The ten kernel wrappers by name; each counts its launches."""
    from repro_torch.kernels import caa_matmul as cm
    from repro_torch.kernels import health
    from repro_torch.kernels import interval_matmul as im
    from repro_torch.kernels import row_order as ro

    return {"quant_matmul_format": qmm.quant_matmul_format,
            "flash_decode_certified": fd.flash_decode_certified,
            "quant_matmul": qmm.quant_matmul,
            "flash_decode_attention": fd.flash_decode_attention,
            "caa_matmul": cm.caa_matmul,
            "interval_matmul": im.interval_matmul,
            "row_mean": ro.row_mean, "f32_matmul": ro.f32_matmul,
            "numeric_health": health.numeric_health,
            "round_k_inplace": qmm.round_k_inplace}


# the serving and profile paths launch neither analysis kernel, and
# without a violation monitor no health kernel and no rounding in place
IDLE_ON_SERVING = {"caa_matmul": 0, "interval_matmul": 0,
                   "numeric_health": 0, "round_k_inplace": 0}


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
        logits_sha256=logits_sha256(res),
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
HEALTH_KERNEL_MARK = "numeric_health_kernel"
DTOH_MARK = "Memcpy DtoH"
TRACE_STEPS = 8
TRACE_GAP_S = 0.05                # idle after a trace's warm-up step
STEP_MARK = "chip_smoke.decode_step"


def op_device_us(e):
    """Device µs of the kernels an op launched, its children's included."""
    return (sum(k.duration for k in e.kernels)
            + sum(op_device_us(c) for c in e.cpu_children))


def step_split(prof, names=False):
    """Per decode step of a profiler trace whose steps each open a
    ``record_function(STEP_MARK)``, over the window from one step's start
    to the next (so the last step only closes a window): its length, and
    the device ms of the GEMM kernels (1 and 3), of attention (kernel 2's
    chunk and combine kernels, or the composed path's einsum and softmax
    ops), of the LM head (the f32_matmul kernel: the GEMM body
    instantiated with its PassThrough functor), of the violation monitor's
    health kernel, of the other kernels, and the gap in which the device
    was idle; and its counts of device activities (kernels, copies and
    fills), health kernels and device-to-host copies."""
    from torch.autograd import DeviceType

    evts = list(prof.events())
    # the marks' CPU ranges; on the device, the kernels and copies (the
    # marks' device-side copies are annotations, not activity)
    starts = sorted(e.time_range.start for e in evts if e.name == STEP_MARK
                    and e.device_type == DeviceType.CPU)
    # the warm-up step's activities (before the first mark, past an idle
    # gap) are not counted: the profiler may drop a session's first ones
    kernels = [e for e in evts if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation and e.name != STEP_MARK
               and e.time_range.start >= starts[0]] if starts else []
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
        health = [e for e in ks if HEALTH_KERNEL_MARK in e.name]
        health_us = sum(e.time_range.elapsed_us() for e in health)
        rows.append({"ms": (hi - lo) / 1e3, "gemm_ms": gemm / 1e3,
                     "attention_ms": attn / 1e3, "lm_head_ms": lm_head / 1e3,
                     "health_ms": health_us / 1e3,
                     "other_ms": (busy - gemm - attn - lm_head
                                  - health_us) / 1e3,
                     "idle_ms": (hi - lo - busy) / 1e3,
                     "kernels": len(ks), "health_kernels": len(health),
                     "dtoh_copies": sum(DTOH_MARK in e.name for e in ks)})
    if not rows:
        raise AssertionError("the trace holds no decode step")
    counts = ("kernels", "health_kernels", "dtoh_copies")
    # the whole trace's counts need no window: every traced step ends in a
    # synchronize inside the profiler, so each of its device activities
    # is in the trace once, wherever its timestamp puts it
    whole = {"kernels": len(kernels),
             "health_kernels": sum(HEALTH_KERNEL_MARK in e.name
                                   for e in kernels),
             "dtoh_copies": sum(DTOH_MARK in e.name for e in kernels),
             "steps": len(starts)}
    if names:
        whole["by_name"] = dict(collections.Counter(e.name for e in kernels))
    return {key: sorted(r[key] for r in rows)[len(rows) // 2]
            for key in rows[0]} | {"steps_traced": len(rows),
                                   "per_step": {key: [r[key] for r in rows]
                                                for key in counts},
                                   "whole_trace": whole}


# device activities a port kernel's launch leaves in a trace, by name mark:
# a GEMM (kernels 1 and 3, f32_matmul, raw or rounding), kernel 2 or 4 at
# G <= 8 (one chunk launch and the combine), the mean, the health stats,
# the rounding in place
PORT_TRACE_MARKS = (*GEMM_KERNEL_NAMES, "flash_decode_chunk_kernel",
                    "flash_decode_combine_kernel", "row_mean_kernel",
                    HEALTH_KERNEL_MARK, "repro_round_elementwise_kernel")
PORT_TRACE_ACTS = {"quant_matmul_format": 1, "quant_matmul": 1,
                   "f32_matmul": 1, "flash_decode_certified": 2,
                   "flash_decode_attention": 2, "row_mean": 1,
                   "numeric_health": 1, "round_k_inplace": 1}


def trace_whole(traced, launched):
    """Whether a decode trace (:func:`step_split` with ``names``) holds
    every device activity its counted steps made: the port kernels'
    activities equal to what the port's launch counters counted over those
    steps (``launched``: {kernel: launches}, at PORT_TRACE_ACTS a launch),
    and every activity name's count a whole multiple of the steps (the
    steps launch the same kernels, copies and fills; a lost activity
    leaves its name's count short). The per-step windows are no test:
    they split the trace by the host clock, and activities near a window's
    edge land in either neighbour. (Without the warm-up step, traces whose
    port activities were all there counted 8 of 9 steps' rope kernels: a
    session's first activities dropped.) Returns (whole, evidence)."""
    whole = traced["whole_trace"]
    n = whole["steps"]
    port = sum(c for name, c in whole["by_name"].items()
               if any(m in name for m in PORT_TRACE_MARKS))
    want = sum(PORT_TRACE_ACTS.get(name, 0) * c
               for name, c in launched.items())
    uneven = {name: c for name, c in whole["by_name"].items() if c % n}
    evidence = {"steps": n, "port_activities": port,
                "port_launch_activities": want, "uneven_names": uneven,
                "kernels": whole["kernels"]}
    return port == want and not uneven, evidence


def decode_trace(torch, serve, T, res, monitor=None, names=False,
                 fns=None):
    """Decode steps of a served run's own backend, params as ``serve.main``
    placed them on its mesh, and prompt, from a fresh cache: TRACE_STEPS
    timed by the host clock (each ends in a synchronize; their median),
    then under torch.profiler one warm-up step (the profiler may drop a
    session's first activities; it is followed by an idle gap and not
    counted) and TRACE_STEPS + 1 split by :func:`step_split`
    (medians over the steps; with ``names``, the whole trace's activities
    counted by name too). With a violation ``monitor`` (or without one
    after a monitored run) a backend of the run's class is built on the
    run's mesh with that monitor; every step then ends in its ``flush()``
    as the serving loop's steps do. With ``fns`` (the kernel wrappers by
    name) the port's launches over the traced steps are counted too
    (``launched``)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    bk = res.backend
    if getattr(bk, "monitor", None) is not monitor:
        bk = serve._backend(res.config, monitor, mesh=bk.mesh)
    # the served steps, and the trace's warm-up step
    cache = T.init_cache(res.cfg, res.prompt.shape[0],
                         SERVE_PROMPT + SERVE_STEPS + 2,
                         device=res.prompt.device)
    state = {"pos": SERVE_PROMPT}
    with torch.no_grad():
        logits, state["cache"] = serve.prefill_step(bk, res.placed, res.cfg,
                                                    cache, res.prompt)
        state["tok"] = torch.argmax(logits[:, -1, :], dim=-1)
        if monitor is not None:
            monitor.flush()

        def step():
            state["tok"], _, state["cache"] = serve.decode_step(
                bk, res.placed, res.cfg, state["cache"],
                state["tok"][:, None], state["pos"])
            if monitor is not None:
                monitor.flush()
            torch.cuda.synchronize()
            state["pos"] += 1

        host = []
        for _ in range(TRACE_STEPS):
            t0 = time.perf_counter()
            step()
            host.append(1e3 * (time.perf_counter() - t0))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            time.sleep(TRACE_GAP_S)
            before = read_launches(fns) if fns else {}
            for _ in range(TRACE_STEPS + 1):
                with record_function(STEP_MARK):
                    step()
        launched = {name: n - before[name]
                    for name, n in read_launches(fns).items()} if fns else {}
    out = {"host_ms_median": sorted(host)[len(host) // 2],
           "host_ms": host, "traced": step_split(prof, names)}
    if fns:
        out["launched"] = launched
    return out


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
                **IDLE_ON_SERVING,
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
    report = serve_report(torch, res, launches, expected, ref_logits)
    emit("serve", layer_format=SERVE_FORMAT, **report,
         main_path_inputs_vs_plain=main_path, decode_trace=trace)
    return launches, main_path, res.timing | {
        "decode_trace": trace, "logits_sha256": report["logits_sha256"]}


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
                **IDLE_ON_SERVING,
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
    report = serve_report(torch, res, launches, expected, ref_logits)
    emit(name, precision_k=res.config.precision_k,
         precision_layer_k=res.config.precision_layer_k,
         backend=type(serve._backend(res.config)).__name__,
         resolved_k_layers01=resolved, **report,
         main_path_inputs_vs_plain={"quant_matmul": main_path,
                                    "flash_decode_attention": attn_path},
         decode_trace=trace)
    return launches, main_path, attn_path, res.timing | {
        "decode_trace": trace, "logits_sha256": report["logits_sha256"]}


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
# certificate-violation monitors on the certified serving path
# ---------------------------------------------------------------------------

MONITOR_LABELS = ("layer*/attn", "layer*/mlp")
MONITOR_WIDE = 1e30               # the first pass's envelopes: finite, wide
MLP_OBSERVATIONS = 3 * L_FULL * (1 + SERVE_STEPS)     # gate, up, down
HEALTH_REPLACES = ("none: port-only (XLA computes the stats in the "
                   "reference, src/repro/core/quantize.py:213 "
                   "numeric_health, read through one jax.debug.callback "
                   "a matmul, src/repro/launch/serve.py:41)")
HEALTH_FORMAT = FORMATS["k12_e15"]


def write_monitor_set(spec, name, ranges, required_k, layer_format=None):
    """A schema-v3 CertificateSet file: one certificate (``required_k``,
    the format map ``layer_format`` when given) and set-level
    ``scope_ranges`` ``ranges`` {label: max_abs}. Nothing certified it:
    Qwen2-7B does not certify at full width (PERF.md §6), so its bounds are
    +inf ("no bound of this kind") and its ranges come from what the
    smoke observed; the set only drives the monitored serving path."""
    from repro_torch.core import formats

    fmts = None
    if layer_format is not None:
        fmts = {s: formats.FpFormat(
            f"custom_k{f['k']}_e{f['emax']}_{f['emin']}", k=f["k"],
            emax=f["emax"], emin=f["emin"]).to_dict()
            for s, f in layer_format.items()}
    cert = spec.Certificate(
        model_id="qwen2-7b/chip-smoke", params_digest="0" * 64,
        class_key="prompt128", cfg=spec.CaaConfig(),
        bounds_u_max=2.0 ** (1 - required_k), final_abs_u=float("inf"),
        final_rel_u=float("inf"), required_k=required_k, satisfied_by=[],
        layer_format=fmts)
    cs = spec.CertificateSet(
        model_id=cert.model_id, params_digest=cert.params_digest,
        certificates=[cert], meta={"formats": {
            "applied": True, "scope_ranges": {
                s: {"max_abs": float(v)} for s, v in ranges.items()},
            "note": "observed maxima of the chip smoke, not certified"}})
    path = ROOT / "build" / f"chip_smoke_{name}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(cs.to_json())
    return path


class RecordingMonitor:
    """Stands in for ``serve.ViolationMonitor`` during a run: the same
    monitor, which also keeps the largest max_abs each label observed."""

    def __init__(self, serve):
        self.serve, self.cls = serve, serve.ViolationMonitor
        self.maxima = {}

        rec = self

        class Monitor(self.cls):
            def observe_scope(self, scope, stats):
                label = "/".join(scope)
                rec.maxima[label] = max(rec.maxima.get(label, 0.0),
                                        stats["max_abs"])
                return super().observe_scope(scope, stats)

        self.monitor_cls = Monitor

    def __enter__(self):
        self.serve.ViolationMonitor = self.monitor_cls
        return self

    def __exit__(self, *exc):
        self.serve.ViolationMonitor = self.cls


def monitor_argv(set_path, out, tag):
    return serve_argv("--certificate-set", str(set_path), "--monitor",
                      "--metrics", str(out / f"{tag}_metrics.jsonl"),
                      "--prom", str(out / f"{tag}.prom"),
                      "--trace", str(out / f"{tag}_trace.jsonl"))


def monitored_expected(gemm, attn, observations):
    """Launches of a monitored full-width serve: the path's GEMM and
    decode-attention kernels, one health kernel a GEMM (on the uniform-k
    path also one rounding in place, of the product the monitor read
    unrounded), and the error sample's one full-precision prefill
    (TorchOps: f32_matmul on every projection and the head, row_mean on
    every rmsnorm)."""
    counts = {"quant_matmul_format": 0, "flash_decode_certified": 0,
              "quant_matmul": 0, "flash_decode_attention": 0,
              "caa_matmul": 0, "interval_matmul": 0,
              "numeric_health": observations,
              "round_k_inplace": observations if gemm == "quant_matmul"
              else 0}
    counts[gemm] = 7 * L_FULL * (1 + SERVE_STEPS)
    counts[attn] = L_FULL * SERVE_STEPS
    rows = row_order_launches(1 + SERVE_STEPS + 1)
    rows["f32_matmul"] += 7 * L_FULL
    return counts | rows


def run_monitored(torch, serve, fns, argv, expected, sha=None):
    """A monitored ``serve.main`` with every launch count set to 0 just
    before and read just after; raises unless the counts, the monitor's
    observations and (given ``sha``) the logits' sha256 are as expected."""
    res, launches = run_serve(torch, serve, fns, argv, expected)
    mon = res.monitor
    if mon is None or mon.pending:
        raise AssertionError("the run has no monitor, or left rows unfolded")
    obs_n = mon.counters["obs.scope_observations"]
    if obs_n != expected["numeric_health"]:
        raise AssertionError(f"{obs_n} observations, not "
                             f"{expected['numeric_health']}")
    digest = logits_sha256(res)
    if sha is not None and digest != sha:
        raise AssertionError(f"monitored logits {digest} != {sha}")
    return res, launches, digest


def logits_sha256(res):
    digest = hashlib.sha256()
    for lg in [res.prefill_logits] + res.decode_logits:
        digest.update(lg.detach().float().cpu().numpy().tobytes())
    return digest.hexdigest()


def health_edge_inputs(torch):
    """NaN, ±inf, −0, f32 subnormals, all zero, all beyond max_finite."""
    inf, nan = float("inf"), float("nan")
    sub = torch.arange(1, 5001, dtype=torch.float32) * 2.0 ** -149
    return {
        "specials": torch.tensor([nan, inf, -inf, -0.0, 0.0, 1.5, -2.0,
                                  2.0 ** -140, -2.0 ** -140, 2.0 ** -149,
                                  3e38]),
        "all_zero": torch.zeros(1000), "neg_zero": torch.full((77,), -0.0),
        "all_nan": torch.full((33,), nan), "subnormals": sub,
        "all_over": torch.full((4099,), 3.0e38)}


def health_vs_plain(torch, health, x, fmt):
    """The kernel's row and the plain version's row for ``x``; raises
    unless every stat is equal bit for bit."""
    from repro_torch.core.quantize import numeric_health as plain

    got = health.init_rows(1, x.device)
    health.numeric_health(x.contiguous(), *fmt, got, 0)
    want = health.init_rows(1, x.device)
    health.pack_row(plain(x, *fmt), want[0])
    if not torch.equal(got, want):
        raise AssertionError(
            f"numeric_health {tuple(x.shape)} {fmt}: "
            f"{health.unpack_rows(got.cpu())} != "
            f"{health.unpack_rows(want.cpu())}")
    return health.unpack_rows(got.cpu())[0]


def health_timing(torch, health, M, N, gen):
    """One launch at [M, N] (a projection's product): device time of the
    kernel and of its plain version from a profiler trace; at decode the
    product is hot in the L2 (the GEMM just wrote it), at prefill rotated
    through copies that exceed the L2."""
    from repro_torch.core.quantize import numeric_health as plain

    x = torch.randn(M, N, device="cuda", generator=gen)
    copies = [x] if M <= 8 else weight_copies(torch, x)
    row = health.init_rows(1, "cuda")
    fmt = HEALTH_FORMAT
    kernel = lambda t: health.numeric_health(t, *fmt, row, 0)
    ref = lambda t: health.pack_row(plain(t, *fmt), row[0])
    iters = 200 if M <= 8 else 30
    n_bytes = 4.0 * M * N + 4 * 8
    bound, by = bound_ms(n_bytes, 4.0 * M * N)
    out = {"M": M, "N": N, "ms": trace_ms(torch, kernel, copies, iters),
           "plain_ms": trace_ms(torch, ref, copies, iters),
           "bound_ms": bound, "bound_by": by, "library_ms": None}
    del copies
    return out


def layer_of_products(rows):
    """Per-product rows (one launch at each of the seven [M, N] products
    of a layer) summed into one layer at each M."""
    out = {}
    for M in sorted({r["M"] for r in rows}):
        t = {key: sum(r[key] for r in rows if r["M"] == M)
             for key in ("ms", "plain_ms", "bound_ms")}
        t.update(bound_by="bytes", library_ms=None,
                 us_per_launch=1e3 * t["ms"] / len(GEMM_SHAPES))
        out[M] = t
    return out


def round_k_timing(torch, qmm, M, N, gen):
    """``round_k_inplace`` at k = SERVE_K on an [M, N] product: bit for bit
    its plain version ``_quantize_normal`` on the same values, then the
    device time of both from a profiler trace, hot in the L2 at decode (the
    GEMM just wrote the product, the health kernel just read it), rotated
    through copies that exceed the L2 at prefill. The bound: the bytes of
    one read and one write of the product (its integer work has no
    published rate to count against); library_ms null: no PyTorch call
    rounds a mantissa to k bits."""
    from repro_torch.core.quantize import _quantize_normal as plain

    x = torch.randn(M, N, device="cuda", generator=gen) * 1e3
    want = plain(x, SERVE_K)
    got = qmm.round_k_inplace(x.clone(), SERVE_K)
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(f"round_k_inplace [{M}, {N}] differs from "
                             "_quantize_normal")
    copies = [x] if M <= 8 else weight_copies(torch, x)
    iters = 200 if M <= 8 else 30
    bound, by = bound_ms(8.0 * M * N, 0.0)
    out = {"M": M, "N": N,
           "ms": trace_ms(torch, lambda t: qmm.round_k_inplace(t, SERVE_K),
                          copies, iters),
           "plain_ms": trace_ms(torch, lambda t: plain(t, SERVE_K), copies,
                                iters),
           "bound_ms": bound, "bound_by": by, "library_ms": None,
           "bitwise": True}
    del copies
    return out


def round_k_edge_cases(torch, qmm):
    """``round_k_inplace`` bit for bit ``_quantize_normal`` at every k from
    1 to 24 on ±0, NaN, ±inf, the largest finite f32 (which carries into
    inf below k = 24), the f32 subnormals' ends, halfway cases and random
    values over the whole exponent range; returns the values checked."""
    from repro_torch.core.quantize import _quantize_normal as plain

    gen = torch.Generator(device="cuda").manual_seed(12)
    bits = torch.randint(-2 ** 31, 2 ** 31 - 1, (1 << 16,), device="cuda",
                         generator=gen, dtype=torch.int64).to(torch.int32)
    special = torch.tensor(
        [0.0, -0.0, float("nan"), float("inf"), -float("inf"),
         3.4028234663852886e38, -3.4028234663852886e38, 1.401298464e-45,
         1.1754942107e-38, 1.1754943508e-38, 1.5, 2.5, 1.0 + 2 ** -12,
         1.0 + 3 * 2 ** -13], dtype=torch.float32, device="cuda")
    x = torch.cat([special, bits.view(torch.float32)])
    for k in range(1, 25):
        got = qmm.round_k_inplace(x.clone(), k)
        want = plain(x, k)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"round_k_inplace at k={k} differs from "
                                 "_quantize_normal on edge inputs")
    return {"values": x.numel(), "ks": 24}


ROUND_K_MARK = "repro_round_elementwise_kernel"
ROUND_K_REPLACES = ("none: port-only (XLA's final _quantize_normal in the "
                    "reference's monitored uniform-k matmul, "
                    "src/repro/launch/serve.py:120, after the health stats "
                    "of :119)")
RAW_GEMM_MARK = "RawOut"


def k12_decode_traces(torch, serve, T, spec, res_k, set_path, fns):
    """The monitored uniform-k decode step traced beside the unmonitored
    one on the same run's weights and prompt (:func:`decode_trace`); raises
    unless, a step, the monitor adds one health kernel and one rounding in
    place a GEMM (196 each), turns each GEMM into its raw instance (the
    GEMM count unchanged), adds one device-to-host copy, and at most one
    other launch (the log's re-initialisation).

    Each trace is first proven whole (:func:`trace_whole`: the same count
    every step, the port kernels' activities equal to the launch
    counters'); a lossy trace is taken again once. If one is still lossy,
    the comparison is not made and the traces are reported as lossy
    (``lossy``): the profiler lost activities, which says nothing of the
    launches (the counters gate those exactly)."""
    mon = serve.ViolationMonitor.from_certificate_set(
        spec.CertificateSet.from_json(set_path.read_text()))
    traces, lossy = {}, {}
    for key, monitor in (("plain", None), ("monitored", mon)):
        for attempt in range(2):
            t = decode_trace(torch, serve, T, res_k, monitor, names=True,
                             fns=fns)
            whole, evidence = trace_whole(t["traced"], t["launched"])
            t["whole"] = dict(evidence, whole=whole, attempt=attempt)
            if whole:
                break
        traces[key] = t
        if not whole:
            lossy[key] = t["whole"]
    plain, monitored = traces["plain"], traces["monitored"]
    if lossy:
        emit("k12_decode_traces", lossy=lossy, note="a trace lost device "
             "activities twice; the per-name comparison is not made")
        return {"unmonitored": plain, "monitored": monitored,
                "lossy": lossy}
    a, b = (t["traced"]["whole_trace"] for t in (plain, monitored))
    n = a["steps"]
    names = set(a["by_name"]) | set(b["by_name"])
    per_name = {name: round((b["by_name"].get(name, 0)
                             - a["by_name"].get(name, 0)) / n)
                for name in names}
    gemm = lambda counts: sum(v for k, v in counts.items()
                              if any(g in k for g in GEMM_KERNEL_NAMES))
    marks = (HEALTH_KERNEL_MARK, DTOH_MARK, ROUND_K_MARK)
    extra = {"health_kernels": sum(v for k, v in per_name.items()
                                   if HEALTH_KERNEL_MARK in k),
             "rounded_in_place": sum(v for k, v in per_name.items()
                                     if ROUND_K_MARK in k),
             "raw_gemms": sum(v for k, v in per_name.items()
                              if RAW_GEMM_MARK in k),
             "gemms": round((gemm(b["by_name"]) - gemm(a["by_name"])) / n),
             "dtoh_copies": sum(v for k, v in per_name.items()
                                if DTOH_MARK in k),
             "other": {k: v for k, v in per_name.items() if v and not (
                 any(m in k for m in marks)
                 or any(g in k for g in GEMM_KERNEL_NAMES))},
             "kernels": (b["kernels"] - a["kernels"]) / n}
    for t in (a, b):
        del t["by_name"]
    per_step = 7 * L_FULL
    if (b["steps"] != n or extra["dtoh_copies"] != 1
            or extra["health_kernels"] != per_step
            or extra["rounded_in_place"] != per_step
            or extra["raw_gemms"] != per_step or extra["gemms"] != 0
            or sum(max(v, 0) for v in extra["other"].values()) > 1):
        raise AssertionError(
            f"a monitored k = 12 decode step adds {extra}: unmonitored {a} "
            f"{plain['traced']['per_step']}, monitored {b} "
            f"{monitored['traced']['per_step']}")
    return {"unmonitored": plain, "monitored": monitored, "extra": extra}


def phase_serve_monitor(torch, serve, qmm, fd, T, shas):
    """Monitored certified serving at full width, through ``serve.main``
    with ``--monitor --metrics --prom --trace`` and a v3 certificate-set
    file: the serve run's format map, then the uniform k = 12.

    A first pass under finite, very wide envelopes records every label's
    largest max_abs; the set's ``scope_ranges`` are then those observed
    maxima (not certified: Qwen2-7B does not certify at full width). Gates:
    logits bit for bit ``serve``'s (``serve_k``'s at k = 12); exact
    launches (one health kernel and one observation a GEMM); silent at the
    observed maxima; ``layer*/mlp`` halved fires 1..1,428 times, the same
    count twice, only that label's margin negative; a monitored decode
    step has one more device-to-host copy, 196 more health kernels and at
    most one more launch (the log's re-initialisation) than the
    unmonitored one; at k = 12 every product read before its final
    rounding and rounded in place (one ``round_k_inplace`` a GEMM), a
    monitored decode step 196 raw GEMMs in place of the rounding ones, 196
    roundings and 196 health kernels more; the trace validates and
    ``python -m repro_torch.obs report`` renders it; the health kernel and
    the rounding in place bit for bit their plain versions on the path's
    shapes and on edge inputs."""
    from repro_torch import obs
    from repro_torch.certify import spec
    from repro_torch.kernels import health

    emit("free", before="serve_monitor", allocated_gb=free_device_memory(
        torch))
    t_phase = time.perf_counter()
    fns = kernel_fns(qmm, fd)
    out = ROOT / "build" / "chip_smoke_monitor"
    out.mkdir(parents=True, exist_ok=True)
    for f in out.glob("*"):
        f.unlink()
    n_obs = 7 * L_FULL * (1 + SERVE_STEPS)
    expected = monitored_expected("quant_matmul_format",
                                  "flash_decode_certified", n_obs)
    wide = {label: MONITOR_WIDE for label in MONITOR_LABELS}

    # pass 1: wide envelopes record each label's largest max_abs
    with RecordingMonitor(serve) as rec:
        res, _, _ = run_monitored(
            torch, serve, fns, monitor_argv(write_monitor_set(
                spec, "monitor_wide", wide, 24, SERVE_FORMAT), out, "wide"),
            expected, shas["serve"])
    maxima = dict(rec.maxima)
    if sorted(maxima) != sorted(MONITOR_LABELS) or res.monitor.violations:
        raise AssertionError(f"wide pass: labels {sorted(maxima)}, "
                             f"violations {res.monitor.violations}")
    del res
    free_device_memory(torch)

    # pass 2: envelopes at the observed maxima; the health kernel's inputs
    dispatch = health.numeric_health_dispatch
    products = {}

    def spy(x, k, emax, emin, buf, row):
        x2 = x.reshape(-1, x.shape[-1])
        key = (*x2.shape, (k, emax, emin))
        if key not in products:
            products[key] = x2.clone()
        return dispatch(x, k, emax, emin, buf, row)

    at_max = write_monitor_set(spec, "monitor_at_max", maxima, 24,
                               SERVE_FORMAT)
    health.numeric_health_dispatch = spy
    try:
        res, launches, digest = run_monitored(
            torch, serve, fns, monitor_argv(at_max, out, "at_max"),
            expected, shas["serve"])
    finally:
        health.numeric_health_dispatch = dispatch
    summary = res.monitor.summary()
    if summary["violations"] != 0 or summary["counters"][
            "obs.enclosure_violations"]:
        raise AssertionError(f"at the observed maxima: {summary}")
    snapshot = json.loads((out / "at_max_metrics.jsonl").read_text()
                          .splitlines()[-1])
    events = obs.load_events(str(out / "at_max_trace.jsonl"))
    errors = obs.validate_events(events)
    if errors:
        raise AssertionError(f"trace invalid: {errors[:5]}")
    report = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "report",
         str(out / "at_max_trace.jsonl")], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    if report.returncode != 0 or "serve.decode" not in report.stdout:
        raise AssertionError(f"obs report failed: {report.stderr[-2000:]}")

    # the health kernel against its plain version, bit for bit
    shapes_checked = []
    for (M, N, fmt), x in sorted(products.items()):
        st = health_vs_plain(torch, health, x, fmt)
        shapes_checked.append({"M": M, "N": N, "format": list(fmt),
                               "max_abs": st["max_abs"],
                               "n_under": st["n_under"]})
    del products
    if {(r["M"], r["N"]) for r in shapes_checked} != {
            (M, N) for M in (SERVE_BATCH, SERVE_BATCH * SERVE_PROMPT)
            for _, N in GEMM_SHAPES.values()}:
        raise AssertionError(f"products seen: {shapes_checked}")
    edge_checked = 0
    for x in health_edge_inputs(torch).values():
        for fmt in [(k, 15, emin) for k in (8, 12, 24, 26)
                    for emin in (-6, -14, -126, -150)]:
            health_vs_plain(torch, health, x.cuda(), fmt)
            edge_checked += 1

    # decode steps traced with and without the monitor, side by side
    mon_trace = serve.ViolationMonitor.from_certificate_set(
        spec.CertificateSet.from_json(at_max.read_text()))
    plain_trace = decode_trace(torch, serve, T, res, names=True)
    monitored_trace = decode_trace(torch, serve, T, res, mon_trace,
                                   names=True)
    # per step from the whole traces' counts by activity name (the same
    # steps, each traced from its first launch to its closing
    # synchronize), not from windows between the steps' marks, whose edges
    # the device clock's offset against the host's can move an activity
    # across; rounded, because a trace may miss a few activities of its
    # first step
    a, b = (t["traced"]["whole_trace"] for t in (plain_trace,
                                                 monitored_trace))
    n = a["steps"]
    per_name = {name: round((b["by_name"].get(name, 0)
                             - a["by_name"].get(name, 0)) / n)
                for name in set(a["by_name"]) | set(b["by_name"])}
    extra = {"health_kernels": sum(v for k, v in per_name.items()
                                   if HEALTH_KERNEL_MARK in k),
             "dtoh_copies": sum(v for k, v in per_name.items()
                                if DTOH_MARK in k),
             "other": {k: v for k, v in per_name.items() if v and not (
                 HEALTH_KERNEL_MARK in k or DTOH_MARK in k)},
             "kernels": (b["kernels"] - a["kernels"]) / n}
    for t in (a, b):
        del t["by_name"]
    if (b["steps"] != n or extra["dtoh_copies"] != 1
            or extra["health_kernels"] != 7 * L_FULL
            or sum(max(v, 0) for v in extra["other"].values()) > 1):
        raise AssertionError(
            f"a monitored decode step adds {extra}: unmonitored {a} "
            f"{plain_trace['traced']['per_step']}, monitored {b} "
            f"{monitored_trace['traced']['per_step']}")
    timing = res.timing
    del res
    free_device_memory(torch)

    # layer*/mlp halved, twice: fires, the same count, only that label
    halved = dict(maxima, **{"layer*/mlp": maxima["layer*/mlp"] / 2})
    half_set = write_monitor_set(spec, "monitor_mlp_halved", halved, 24,
                                 SERVE_FORMAT)
    fired = []
    for i in range(2):
        res, _, _ = run_monitored(
            torch, serve, fns, monitor_argv(half_set, out, f"halved{i}"),
            expected, shas["serve"])
        s = res.monitor.summary()
        negative = sorted(lb for lb, m in s["scope_margin_log2"].items()
                          if m < 0)
        fired.append({"enclosure_violations":
                      s["counters"]["obs.enclosure_violations"],
                      "negative_margins": negative,
                      "scope_margin_log2": s["scope_margin_log2"]})
        del res
        free_device_memory(torch)
    n_fired = fired[0]["enclosure_violations"]
    if (not 1 <= n_fired <= MLP_OBSERVATIONS
            or fired[1]["enclosure_violations"] != n_fired
            or any(f["negative_margins"] != ["layer*/mlp"] for f in fired)):
        raise AssertionError(f"halved layer*/mlp: {fired}")

    # the uniform k = 12, monitored: every product observed before its
    # final rounding (kernel 3's raw instance, then the rounding in place)
    expected_k = monitored_expected("quant_matmul", "flash_decode_attention",
                                    n_obs)
    k12_set = write_monitor_set(spec, "monitor_k12", wide, SERVE_K)
    res_k, launches_k, digest_k = run_monitored(
        torch, serve, fns, monitor_argv(k12_set, out, "k12"), expected_k,
        shas["serve_k"])
    k_summary = res_k.monitor.summary()
    if k_summary["violations"]:
        raise AssertionError(f"k = 12 under wide envelopes: {k_summary}")
    k_timing = res_k.timing
    k_traces = k12_decode_traces(torch, serve, T, spec, res_k, k12_set, fns)
    del res_k
    free_device_memory(torch)

    gen = torch.Generator(device="cuda").manual_seed(11)
    health_rows = [health_timing(torch, health, M, N, gen)
                   for M in (SERVE_BATCH, SERVE_BATCH * SERVE_PROMPT)
                   for _, N in GEMM_SHAPES.values()]
    per_layer = layer_of_products(health_rows)
    round_rows = [round_k_timing(torch, qmm, M, N, gen)
                  for M in (SERVE_BATCH, SERVE_BATCH * SERVE_PROMPT)
                  for _, N in GEMM_SHAPES.values()]
    round_edges = round_k_edge_cases(torch, qmm)
    round_layer = layer_of_products(round_rows)

    emit("serve_monitor",
         note="monitored certified serving at full width through "
              "serve.main --monitor --metrics --prom --trace; the set's "
              "scope_ranges are the per-label maxima of a first monitored "
              "pass under wide envelopes, not certified (Qwen2-7B does not "
              "certify at full width)",
         observed_maxima=maxima, launches=launches,
         expected_launches=expected, logits_sha256=digest,
         serve_sha256=shas["serve"], summary=summary,
         sampled_err_u=summary["worst_err_u"],
         snapshot_keys={part: sorted(snapshot[part]) for part in
                        ("counters", "gauges", "histograms")},
         trace_events=len(events), report_lines=len(
             report.stdout.splitlines()),
         mlp_halved=fired, mlp_observations=MLP_OBSERVATIONS,
         health_vs_plain={"products": shapes_checked,
                          "edge_cases": edge_checked},
         decode_ms_per_step={"monitored": timing["decode_ms_per_step"],
                             "serve_unmonitored": shas["serve_decode_ms"]},
         prefill_s=timing["prefill_s"],
         decode_trace={"unmonitored": plain_trace,
                       "monitored": monitored_trace, "extra": extra},
         k12={"launches": launches_k, "expected_launches": expected_k,
              "rounded_in_place": launches_k["round_k_inplace"],
              "logits_sha256": digest_k, "serve_k_sha256": shas["serve_k"],
              "summary": k_summary,
              "decode_ms_per_step": k_timing["decode_ms_per_step"],
              "decode_trace": k_traces},
         health_kernel={"rows": health_rows, "per_layer": per_layer,
                        "format": list(HEALTH_FORMAT)},
         round_k_inplace={"rows": round_rows, "per_layer": round_layer,
                          "k": SERVE_K, "edge_cases": round_edges,
                          "tolerance": "bit for bit _quantize_normal"},
         seconds=time.perf_counter() - t_phase)
    launches_all = {name: launches[name] + launches_k[name] for name in fns}
    return launches_all, {"numeric_health": per_layer,
                          "round_k_inplace": round_layer}, timing | {
        "decode_trace": monitored_trace}


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


def mla_lane_bits(torch, cfg, device="cuda", lanes=4, S=256, P=83,
                  page=16, seed=9):
    """Whether the library products of MLA's absorbed attention keep a
    lane's bits at ``cfg``'s widths (MiniCPM3: H 40, kv_rank 256, d_nope
    64, d_rope 32, d_v 64), on seeded inputs laid out as the model lays
    them (W_uk and W_uv strided slices of the reshaped wkv_b): the five
    einsums and the softmax, each over ``lanes`` lanes against each lane
    alone (decode over an S-position latent cache), and over a prompt of
    ``P`` rows padded to whole pages against the unpadded one (prefill).
    Returns {product: {"bitwise": bool, "max_abs_diff": float}}."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, device=device, generator=gen)
    H, R = cfg.n_heads, cfg.kv_rank
    dn, dr, dv = cfg.d_nope, cfg.d_rope, cfg.d_v
    wkv_b = rnd(R, H * (dn + dv)).reshape(R, H, dn + dv) * R ** -0.5
    w_uk, w_uv = wkv_b[..., :dn], wkv_b[..., dn:]
    p_pad = page * -(-P // page)
    out = {}

    def record(name, got, want):
        out[name] = {"bitwise": same_bits(torch, got, want),
                     "max_abs_diff": float((got.double() - want.double())
                                           .abs().max())}

    ops = {
        "q_lat": (lambda q: torch.einsum("bqhd,rhd->bqhr", q, w_uk),
                  lambda b, q: (b, q, H, dn)),
        "s_nope": (lambda q, c: torch.einsum("bqhr,bsr->bhqs", q, c),
                   lambda b, q: (b, q, H, R)),
        "s_rope": (lambda q, k: torch.einsum("bqhd,bsd->bhqs", q, k),
                   lambda b, q: (b, q, H, dr)),
        "out_lat": (lambda p, c: torch.einsum("bhqs,bsr->bqhr", p, c),
                    lambda b, q: (b, H, q, S)),
        "out": (lambda o: torch.einsum("bqhr,rhd->bqhd", o, w_uv),
                lambda b, q: (b, q, H, R)),
        "softmax": (lambda s: torch.softmax(s, dim=-1),
                    lambda b, q: (b, H, q, S)),
    }
    cache = {"s_nope": (lanes, S, R), "s_rope": (lanes, S, dr),
             "out_lat": (lanes, S, R)}
    # the query axis of each op's first operand, for the prefill rows
    q_axis = {"q_lat": 1, "s_nope": 1, "s_rope": 1, "out_lat": 2, "out": 1,
              "softmax": 2}
    for name, (fn, shape) in ops.items():
        x = rnd(*shape(lanes, 1))
        if name == "out_lat":
            x = x.softmax(-1)
        rest = (rnd(*cache[name]),) if name in cache else ()
        got = fn(x, *rest)
        alone = torch.cat([fn(x[b:b + 1], *(r[b:b + 1] for r in rest))
                           for b in range(lanes)])
        record(f"{name}_decode", got, alone)
        xp = rnd(*shape(1, p_pad))
        if name == "out_lat":
            xp = xp.softmax(-1)
        rest1 = tuple(r[:1] for r in rest)
        ax = q_axis[name]
        out_ax = {"s_nope": 2, "s_rope": 2, "softmax": 2}.get(name, 1)
        full = fn(xp, *rest1).narrow(out_ax, 0, P)
        record(f"{name}_prefill", full, fn(xp.narrow(ax, 0, P), *rest1))
    return out


# every TorchOps op the transformer runs (op_lane_bits, exact_maxima)
LANE_OPS = ("param", "input", "const", "add", "sub", "mul", "scale",
            "shift", "matmul", "einsum", "tanh", "exp", "log", "rsqrt",
            "square", "relu", "silu", "softmax", "mean", "maximum", "where",
            "reshape", "broadcast_to", "concat", "take", "slice",
            "decode_attention", "windowed_decode_attention",
            "latent_decode_attention", "per_head_matmul")


def op_lane_bits(torch, serve, T, cfg, params, bk, lengths=(1, 17, 64, 65),
                 smax=96, seed=1):
    """Every backend op of one ragged decode step, each lane against the
    same lane run alone at B = 1: lane b sits at offset lengths[b] - 1 of a
    per-lane cache holding seeded values below it and NaN from lengths[b]
    on (a recurrent state, Hymba's h_ssm, seeded whole). ``bk`` is the
    serving backend under test (its class is wrapped, so every op it runs
    is recorded in order). Returns {"ops": n compared, "differing": [(i,
    op, scope, max |Δ|), ...] (at most 12), "by_op": {op: [compared,
    differing]}}, and for a recurrent state the lanes whose state after
    the step differs from the lane's alone ("state_differing")."""
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
        for name in c:
            if name == "idx":
                continue
            c[name].normal_(generator=gen)
            if name in ("k", "v"):
                for b, n in enumerate(lengths):
                    c[name][:, b, n:] = float("nan")
        if lanes is not None:
            c = {name: t[:, lanes].clone() for name, t in c.items()}
        return c

    tokens = torch.arange(B, device=dev) * 7 + 3

    states = []

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
        states.append(c.get("h_ssm"))
        return records[-1]

    batch = step(None)
    by_op, differing, n = {}, [], 0
    state_differing = []
    for b in range(B):
        alone = step([b])
        if states[0] is not None and not same_bits(
                torch, states[0][:, b:b + 1], states[-1]):
            state_differing.append(b)
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
    out = {"ops": n, "differing": differing, "by_op": by_op}
    if states[0] is not None:
        out["state_differing"] = state_differing
    return out


def reference_runs(batching, cfg, sc, params, reqs, eos_id):
    """Every request alone through ``reference_generate`` (after the
    engine run's counts were read)."""
    return {req.rid: batching.reference_generate(
        cfg, sc, params, req.prompt, req.max_new_tokens,
        max_seq=BATCH_ENGINE["max_seq"], eos_id=eos_id, return_logits=True)
        for req in reqs}


def batching_k_path(torch, serve, batching, qmm, fd, T, fns, cfg, params,
                    reqs):
    """``batching``'s k path: its first BATCH_K_REQUESTS requests through
    the engine at k = 12 (kernel 3, the decode attention through kernel
    4), kernel inputs against their plain versions, every request against
    ``reference_generate``, one ragged step's ops each lane against
    itself alone. Returns (ServeConfig, launches, report, kernel rows,
    lane bits, the mesh phase's handoff, op lane bits)."""
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
                **IDLE_ON_SERVING,
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
    handoff = {"launches": launches_k,
               "requests": served_digests(responses_k)}
    del ref_k, responses_k, engine_k
    k_ops = op_lane_bits(torch, serve, T, cfg, params,
                         serve.QuantJOps(SERVE_K),
                         smax=BATCH_ENGINE["max_seq"])
    return sc_k, launches_k, k_report, k_path, k_bits, handoff, k_ops


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
    # apply_certificates, which digests the params again; both digests
    # (host-bound, ~26 s each at full width) run in a thread while the k
    # path below serves
    root = ROOT / "build" / "chip_smoke_store"
    shutil.rmtree(root, ignore_errors=True)

    def from_store():
        t0 = time.perf_counter()
        digest = store.params_digest(params)
        digest_s = time.perf_counter() - t0
        key, path = write_format_entry(spec, formats, store, pipeline, root,
                                       cfg, digest)
        t0 = time.perf_counter()
        sc, certset = serve.apply_certificates(
            serve.ServeConfig(arch="qwen2_7b",
                              batch=BATCH_ENGINE["n_lanes"],
                              max_seq=BATCH_ENGINE["max_seq"],
                              certificates=str(root)),
            cfg, params, formats=True, k_max=53)
        return (digest, digest_s, key, path, sc, certset,
                time.perf_counter() - t0)

    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        stored = pool.submit(from_store)
        reqs, too_long = batching_requests(torch, batching, cfg.vocab)
        k_part = batching_k_path(torch, serve, batching, qmm, fd, T, fns,
                                 cfg, params, reqs)
        (digest, digest_s, key, path, sc, certset,
         apply_s) = stored.result()
    bk = serve._backend(sc)
    want_bk = serve.FormatQuantJOps(SERVE_FORMAT)
    paths = [["embed"], ["head"]] + [[f"layer{i}", s] for i in (0, 1, 27)
                                     for s in ("attn", "mlp")]
    if not isinstance(bk, serve.FormatQuantJOps) or any(
            bk.format_for(p) != want_bk.format_for(p) for p in paths):
        raise AssertionError(f"the store served {sc.precision_layer_format}")

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
                **IDLE_ON_SERVING,
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
    handoff = {"sc": sc, "certset": certset, "eos_id": eos_id,
               "format": {"launches": launches,
                          "requests": served_digests(responses)}}
    del ref, responses, engine
    # every op of one ragged decode step, each lane against itself alone
    fmt_ops = op_lane_bits(torch, serve, T, cfg, params,
                           serve.FormatQuantJOps(SERVE_FORMAT),
                           smax=BATCH_ENGINE["max_seq"])

    del params
    (sc_k, launches_k, k_report, k_path, k_bits, k_handoff,
     k_ops) = k_part
    handoff.update(sc_k=sc_k, k=k_handoff)

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
         note="the k path served while a thread digested the params for "
              "the store entry and apply_certificates",
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
    return (launches_all, main_path, k_path, fmt_report | {"k": k_report},
            handoff)


def served_digests(responses):
    """{request id: (tokens, sha256 of its logit rows)} of an engine run."""
    return {r["id"]: (list(r["tokens"]), hashlib.sha256(
        r["logits"].detach().float().cpu().numpy().tobytes()).hexdigest())
        for r in responses}


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
                **IDLE_ON_SERVING,
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


def ranges_models(torch):
    """The models ``ranges`` holds card against CPU: {name: (forward on a
    device, params on the CPU, input on a device, layers)}, all seeded on
    the CPU."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.core import caa
    from repro_torch.data import synthetic_digits
    from repro_torch.models import paper_models as PM
    from repro_torch.models import transformer as T

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
    return models


def ranges_cpu_side():
    """The CPU's half of ``ranges``' card-against-CPU check: every driver
    over :func:`ranges_models` on the CPU. Returns {name: maps}."""
    import torch

    from repro_torch.core import analyze as A
    from repro_torch.core import caa
    from repro_torch.core import formats as F

    ccfg = caa.CaaConfig(u_max=RANGES_UMAX)
    fmts = {k: F.custom(v) for k, v in RANGES_FMTS.items()}
    dflt = F.custom(RANGES_FMT_DEFAULT)
    out = {}
    with torch.no_grad():
        for name, (fwd, p, xin, L) in ranges_models(torch).items():
            out[name] = run_ranges(torch, A, fwd("cpu"), p, xin("cpu"),
                                   ccfg, fmts, dflt, L)
    return out


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

    from repro_torch import configs
    from repro_torch.core import analyze as A
    from repro_torch.core import caa
    from repro_torch.core import formats as F
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

    # the card against the CPU port on the same seeded inputs (the CPU's
    # maps come from the CPU process)
    cpu_vs_card = {}
    job = CPU_JOBS.pop(("ranges", None), None) or CPU.submit(ranges_cpu_side)
    on = lambda p, dev: {k: (v.to(dev) if torch.is_tensor(v) else
                             (on(v, dev) if isinstance(v, dict) else v))
                         for k, v in p.items()}
    cards = {name: run_ranges(torch, A, fwd(dev), on(p, dev), xin(dev), ccfg,
                              fmts, dflt, L)
             for name, (fwd, p, xin, L) in ranges_models(torch).items()}
    for name, cpu in job.result().items():
        card = cards[name]
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

    on_cpu = lambda p: {k: (v.cpu() if torch.is_tensor(v) else v)
                        for k, v in p.items()}
    cpu = CPU.submit(table1_cpu_side, on_cpu(digits), on_cpu(conv),
                     on_cpu(pend), imgs, labels)
    spy = MatmulSpy(caa.matmul)
    caa.matmul = spy
    try:
        card = table1(torch, m, "cuda", digits, conv, pend, imgs, labels)
    finally:
        caa.matmul = spy.fn
    cpu = cpu.result()
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


def table1_cpu_side(digits, conv, pend, imgs, labels):
    """``analyze``'s Table-I flow on the CPU with the card-trained weights
    (the CPU's half of the phase)."""
    import torch

    from repro_torch.core import analyze, caa, precision
    from repro_torch.core.backend import CaaOps, TorchOps
    from repro_torch.models import paper_models as PM

    m = {"caa": caa, "analyze": analyze, "precision": precision, "PM": PM,
         "CaaOps": CaaOps, "TorchOps": TorchOps}
    return table1(torch, m, "cpu", digits, conv, pend, imgs, labels)


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
    arguments) of the first call of each input shape and dtype."""

    def __init__(self, fn):
        super().__init__(
            fn, lambda *a, **kw: tuple((tuple(t.shape), t.dtype) for t in a
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
    cpu = CPU.submit(digits_cpu_side, on_cpu, los, his)
    report, card = {}, {}
    for name, kw in CERT_DIGITS_RUNS.items():
        cs, secs, peak = timed_certify(
            torch, C.certify, PM.digits_forward, params, los, his,
            store=store if name == "formats" else None, **common, **kw)
        report[name] = {**cert_summary(cs, secs, peak),
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
            "store_hit_lookup_s": hit.meta.get("lookup_seconds")}, \
        launches, (cpu, card)


def digits_cpu_side(params, los, his):
    """The CPU's half of ``certify_digits``: the three certifications with
    the card-trained weights. Returns {run: (certificate set, seconds)}."""
    from repro_torch import certify as C
    from repro_torch.models import paper_models as PM

    common = dict(p_star=CERT_P_STAR, model_id="digits/h700x256",
                  k_max=CERT_DIGITS_K_MAX)
    out = {}
    for name, kw in CERT_DIGITS_RUNS.items():
        t0 = time.perf_counter()
        cs = C.certify(PM.digits_forward, params, los, his, **common, **kw)
        out[name] = (cs, time.perf_counter() - t0)
    return out


def digits_vs_cpu(report, pending) -> None:
    """Hold each of ``certify_digits``' card certifications against the
    CPU's (decisions equal, bounds within CERT_REL_TOL) and add the CPU's
    seconds and the worst bound difference to ``report``'s runs."""
    job, card = pending
    for name, (cpu, cpu_s) in job.result().items():
        worst = card_vs_cpu(f"digits {name}", card[name], cpu)
        report["runs"][name].update(cpu_seconds=cpu_s,
                                    worst_rel_bound_vs_cpu=worst)


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
    cpu_half = CPU.submit(nano_cpu_side, cfg, host)
    cs, secs, peak = timed_certify(torch, C.certify_lm, "qwen2_7b", cfg,
                                   params, store=store, **CERT_NANO)
    cpu, cpu_s = cpu_half.result()
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
    reset_launches(fns)
    monitored = nano_monitored(torch, T, serve, cfg, cs, params, host)
    for name, n in read_launches(fns).items():
        launches_all[name] += n
    return {"config": "qwen2-nano (d 16, 2 x 8 heads, d_ff 32, vocab 256, "
                      "2 layers)",
            "train": {"steps": CERT_NANO_STEPS, "lr": CERT_NANO_LR,
                      "loss": loss, "seconds": train_s},
            "request": {k: list(v) if isinstance(v, tuple) else v
                        for k, v in CERT_NANO.items()},
            "card": cert_summary(cs, secs, peak), "cpu_seconds": cpu_s,
            "worst_rel_bound_vs_cpu": worst, "served": served,
            "monitored": monitored}, launches_all


def nano_cpu_side(cfg, host):
    """The CPU's half of ``certify_nano``'s certification, on the host
    weights. Returns (certificate set, seconds)."""
    from repro_torch import certify as C

    t0 = time.perf_counter()
    cs = C.certify_lm("qwen2_7b", cfg, host, **CERT_NANO)
    return cs, time.perf_counter() - t0


def nano_monitored(torch, T, serve, cfg, cs, params, host, steps=3):
    """The nano's card-certified v3 set served under a violation monitor
    on its own certification profile (prefill, then ``steps`` greedy
    decode steps, one ``flush()`` a step), on the card and on the CPU with
    the same weights; raises unless the counters are equal."""
    from repro_torch.certify.tokens import profile_tokens

    toks = profile_tokens(CERT_NANO["seed"], CERT_NANO["batch"],
                          CERT_NANO["seq"], cfg.vocab)
    sc = serve.apply_certificate_set(serve.ServeConfig(), cs)
    out = {}
    for dev, p in (("cuda", params), ("cpu", host)):
        mon = serve.ViolationMonitor.from_certificate_set(cs)
        bk = serve._backend(sc, mon)
        B, S = toks.shape
        cache = T.init_cache(cfg, B, S + steps + 1, device=dev)
        with torch.no_grad():
            logits, cache = serve.prefill_step(bk, p, cfg, cache,
                                               toks.to(dev))
            mon.flush()
            tok = torch.argmax(logits[:, -1], -1)
            for i in range(steps):
                tok, _, cache = serve.decode_step(bk, p, cfg, cache,
                                                  tok[:, None], S + i)
                mon.flush()
        out[dev] = mon.summary()
    if out["cuda"]["counters"] != out["cpu"]["counters"]:
        raise AssertionError(f"nano monitored: card {out['cuda']} != "
                             f"CPU {out['cpu']}")
    return {"envelopes": len(serve.ViolationMonitor.from_certificate_set(
        cs).envelopes), "card": out["cuda"], "cpu": out["cpu"]}


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
    digits, l_digits, digits_cpu = certify_digits(
        torch, C, PM, TorchOps, qmm, serve, fns, digits_store)
    evicted = C.CertificateStore(str(root / "digits")).gc(max_entries=0)
    if evicted != 1 or len(digits_store) != 0:
        raise AssertionError(f"gc --max-entries 0 evicted {evicted}")
    free_device_memory(torch)
    qwen, l_qwen = certify_qwen(torch, C, T, batching, fns, qmm, fd,
                                root / "qwen2_7b")
    emit("certify_qwen2_7b", **qwen)
    free_device_memory(torch)
    nano, l_nano = certify_nano(torch, C, T, TorchOps, serve, batching, fns,
                                qmm, fd, root / "nano")
    emit("certify_nano", **nano)
    # Digits' CPU certifications ran beside Qwen2-7B's and the nano's
    digits_vs_cpu(digits, digits_cpu)
    emit("certify_digits", **digits, gc_evicted=evicted,
         rel_tol=CERT_REL_TOL)
    launches = {name: l_digits[name] + l_qwen[name] + l_nano[name]
                for name in fns}
    emit("certify", launches=launches, by_part={
        "digits": l_digits, "qwen2_7b": l_qwen, "nano": l_nano},
        seconds=time.perf_counter() - t_phase)
    return launches


# ---------------------------------------------------------------------------
# the paper's drivers and the examples, through their entry points
# ---------------------------------------------------------------------------

PAPER_KERNELS = ("quant_matmul_format", "flash_decode_certified",
                 "quant_matmul", "flash_decode_attention")


def paper_side():
    """``phase_paper`` in the card process ``PAPER``: the precision setting
    of ``phase_env`` (the environment is the parent's), then the phase and
    its ``seconds`` line. Returns its launches."""
    import torch

    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import quant_matmul as qmm
    from repro_torch.launch import serve

    serve.configure_precision()
    CONTENDED["note"] = ("zoo, ssm and mla_encdec ran on the card in the "
                         "main process meanwhile")
    t0 = time.perf_counter()
    launches = phase_paper(torch, qmm, fd)
    emit("seconds", of="paper", seconds=time.perf_counter() - t0)
    return launches


def quickstart_cpu_side(params):
    """``quickstart``'s analysis on the CPU with the card-trained weights.
    Returns (its result, seconds)."""
    from repro_torch.data import synthetic_digits
    from repro_torch.examples import quickstart

    imgs, _ = synthetic_digits.make_dataset(800, seed=0)
    t0 = time.perf_counter()
    out = quickstart.analyse(params, imgs)
    return out, time.perf_counter() - t0


def phase_paper(torch, qmm, fd):
    """The paper's drivers and the six examples' card paths, as a user runs
    them (``main`` of each with ``--device cuda``): ``benchmarks.run``
    (Table I, analysis speed, bound tightness; its bench entry written
    under ``build/``), ``examples.quickstart`` at the Digits model's full
    width, whose required k and certified / correct counts must equal the
    same analysis on the CPU with the card-trained weights, and
    ``serve_custom_formats``, ``serve_certified --precision-k 12`` and
    ``serve_certified_lm`` (its differential bit for bit). Each step's
    launches of kernels 1-4 are counted (the counts set to 0 just before
    it); gates: the format sweep and ``serve_custom_formats`` launch kernel
    1, the serving rows and ``serve_certified`` kernels 3 and 4;
    ``serve_certified_lm`` certifies a layer map and its differential holds
    bit for bit."""
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.examples import (lm_precision_analysis, quickstart,
                                      serve_certified, serve_certified_lm,
                                      serve_custom_formats)

    t_phase = time.perf_counter()
    fns = kernel_fns(qmm, fd)
    out = ROOT / "build" / "chip_smoke_paper"
    if out.exists():
        import shutil
        shutil.rmtree(out)
    out.mkdir(parents=True)
    steps, seconds, results = {}, {}, {}

    def step(name, fn, *args):
        reset_launches(fns)
        t0 = time.perf_counter()
        results[name] = fn(*args)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        steps[name] = {k: v for k, v in read_launches(fns).items() if v}
        print(f"[paper] {name}: {seconds[name]:.2f} s, launches "
              f"{ {k: steps[name].get(k, 0) for k in PAPER_KERNELS} }",
              flush=True)

    prev = os.environ.get("REPRO_TORCH_BENCH_DIR")
    os.environ["REPRO_TORCH_BENCH_DIR"] = str(out)
    try:
        step("benchmarks.run", bench_run.main, ["--device", "cuda"])
    finally:
        if prev is None:
            os.environ.pop("REPRO_TORCH_BENCH_DIR")
        else:
            os.environ["REPRO_TORCH_BENCH_DIR"] = prev
    step("quickstart", quickstart.main, ["--device", "cuda"])
    card = results["quickstart"]
    # the CPU's analysis with the card-trained weights runs beside the
    # remaining examples
    cpu_half = CPU.submit(quickstart_cpu_side, {
        k: v.cpu() for k, v in card["params"].items()})
    step("serve_custom_formats", serve_custom_formats.main,
         ["--device", "cuda"])
    step("serve_certified", serve_certified.main,
         ["--device", "cuda", "--precision-k", "12"])
    step("serve_certified_lm", serve_certified_lm.main,
         ["--device", "cuda", "--certificates", str(out / "lm_store")])
    step("lm_precision_analysis", lm_precision_analysis.main,
         ["--device", "cuda"])
    cpu, cpu_s = cpu_half.result()
    differ = sorted(key for key in ("required_k", "n_cert", "n_ok")
                    if card[key] != cpu[key])
    per_input = {key: sum(a != b for a, b in zip(card[key], cpu[key]))
                 for key in ("certs", "pred")}

    rows = results["benchmarks.run"]
    table1 = {name: {"seconds": us / 1e6, "max_abs_u": d}
              for name, us, d in rows if name.startswith("table1_")}
    q = {key: card[key] for key in ("required_k", "n_cert", "n_ok",
                                    "max_abs_u", "max_rel_u", "seconds",
                                    "n_params", "train_accuracy")}
    emit("paper", steps=steps, seconds=seconds, csv_rows=len(rows),
         table1=table1, bench={r[0]: r[2] for r in rows},
         quickstart={"card": q, "cpu": {key: cpu[key] for key in (
             "required_k", "n_cert", "n_ok", "max_abs_u", "max_rel_u")},
             "cpu_seconds": cpu_s, "differing": differ,
             "per_input_differing": per_input},
         serve_custom_formats={
             "kernel_vs_plain_rule": results["serve_custom_formats"][
                 "kernel_vs_plain_rule"],
             "accuracy": results["serve_custom_formats"]["accuracy"]},
         serve_certified={key: results["serve_certified"][key] for key in (
             "mode", "prefill_s", "decode_s")},
         serve_certified_lm={
             "precision_k": results["serve_certified_lm"]["precision_k"],
             "layer_k": results["serve_certified_lm"]["layer_k"],
             "differential_bitwise": results["serve_certified_lm"][
                 "differential_bitwise"]},
         lm_precision_analysis=results["lm_precision_analysis"]["analysed"],
         phase_seconds=time.perf_counter() - t_phase)
    if differ:
        raise AssertionError(f"quickstart: card and CPU differ in {differ}")
    if card["n_ok"] != card["n_cert"]:
        raise AssertionError(f"quickstart: {card['n_cert']} certified, "
                             f"{card['n_ok']} match the exact model")
    need = {"benchmarks.run": ("quant_matmul_format", "quant_matmul"),
            "serve_custom_formats": ("quant_matmul_format",),
            "serve_certified": ("quant_matmul", "flash_decode_attention")}
    for name, kernels in need.items():
        missing = [k for k in kernels if not steps[name].get(k)]
        if missing:
            raise AssertionError(f"paper {name}: no launch of {missing}")
    analysed = results["lm_precision_analysis"]["analysed"]
    if [r["arch"] for r in analysed] != ["qwen2_7b", "mixtral_8x22b",
                                         "rwkv6_1p6b"] or not all(
            math.isfinite(r["max_abs_u"]) for r in analysed):
        raise AssertionError(f"lm_precision_analysis: {analysed}")
    lm = results["serve_certified_lm"]
    if not lm["layer_k"] or lm["differential_bitwise"] is not True:
        raise AssertionError(f"serve_certified_lm: no certified layer map "
                             f"({lm['layer_k']}) or its differential did "
                             f"not hold ({lm['differential_bitwise']})")
    return {name: sum(s.get(name, 0) for s in steps.values())
            for name in fns}


# ---------------------------------------------------------------------------
# the GQA model zoo: Gemma-2, Mixtral, Command-R and Llama-4 through the
# port's entry points
# ---------------------------------------------------------------------------

# full width, depth cut for memory (f32 weights; embeddings and the LM head's
# transposed copy included): Gemma-2 27B 8 layers (4 local, 4 global) ~27.5
# GB, Mixtral 8x22B 2 layers ~22.4 GB, Command-R 35B 4 layers ~28 GB
# the depth a full-width serve pass runs at: Gemma-2, Mixtral and Command-R
# cut to fit the card; the recurrent and the last three families cut to
# make room in the time limit (none of their checks needs the depth: each
# is a kernel's inputs, a layer's calls or lanes, or a decode against a
# full forward; every Hymba layer is a local, windowed one)
ZOO_LAYERS = {"gemma2_27b": 8, "mixtral_8x22b": 2, "command_r_35b": 4,
              "rwkv6_1p6b": 2, "hymba_1p5b": 2, "minicpm3_4b": 2,
              "whisper_medium": 2, "paligemma_3b": 2}
ZOO_WINDOW_PROMPT = 4224          # past Gemma-2's 4,096-position local window
ZOO_BATCH_REQUESTS, ZOO_BATCH_MAX_NEW = 4, 8
ZOO_SOFTCAP = 50.0                # Gemma-2's attention softcap
ZOO_FLASH_WINDOWS = (16, 4096)    # the SMOKE window, Gemma-2's / Mixtral's
ZOO_FLASH_SHAPE = (16, 2, 128)    # Gemma-2's K, G, D
ZOO_LONG = 32768
ZOO_SMOKE = ("command_r_35b", "gemma2_27b", "mixtral_8x22b",
             "llama4_maverick")
ZOO_CERT = {"seq": 6, "batch": 2, "seed": 0, "k_max": 24}
ZOO_CAA_U = 2.0 ** -11            # the zoo analysis's u (emulated k = 12)
LLAMA4_FULL = ("not run at full width: one layer's 128 experts take 128·3·"
               "5120·8192·4 B = 64.4 GB in f32 and the embeddings and LM "
               "head another 12.4 GB (its transposed copy a further 4.1), "
               "which leaves no room on an 80 GB card; SMOKE on card and "
               "CPU instead")
F32_FMT = (24, 127, -126)


def zoo_expected(cfg, path, forwards, steps):
    """Exact launches of ``forwards`` forwards (``steps`` of them decode
    steps) of a zoo model on a serving path ("format", "k" or "plain"):
    per layer 7 GEMMs (q, k, v, o, gate, up, down), or 5 for MoE (q, k, v,
    o and the router: the experts are raw f32 products); one decode
    attention a layer a step, kernel 2 on the format path of a plain-causal
    model, else kernel 4 (a softcapped or windowed model decodes through
    kernel 4 on every path, as the reference composes it unrounded)."""
    gemms = (5 if cfg.family == "moe" else 7) * cfg.n_layers * forwards
    windowed = (cfg.softcap_attn is not None or cfg.window is not None
                or cfg.local_global_period is not None)
    certified = path == "format" and not windowed
    attn = cfg.n_layers * steps
    return {"quant_matmul_format": gemms if path == "format" else 0,
            "flash_decode_certified": attn if certified else 0,
            "quant_matmul": gemms if path == "k" else 0,
            "flash_decode_attention": 0 if certified else attn,
            **IDLE_ON_SERVING, **row_order_launches(forwards, cfg.n_layers)}


def run_zoo_serve(torch, serve, fns, arch, path, extra, batch=SERVE_BATCH,
                  prompt=SERVE_PROMPT, steps=SERVE_STEPS, expected_of=None):
    """``serve.main`` on ``arch`` at full width with its ZOO_LAYERS depth
    (full depth for an arch not listed there), every launch counter set to
    0 just before and read just after; raises unless the counts are
    ``expected_of``'s (default :func:`zoo_expected`) and the run served
    valid tokens with finite logits. Returns (result, report)."""
    full = serve.configs.get(arch).FULL
    layers = ZOO_LAYERS.get(arch, full.n_layers)
    argv = ["--arch", arch, "--size", "full", "--max-layers", str(layers),
            "--batch", str(batch), "--prefill-len", str(prompt),
            "--decode-steps", str(steps), "--device", "cuda", "--seed", "0",
            *extra]
    torch.cuda.reset_peak_memory_stats()
    reset_launches(fns)
    res = serve.main(argv)
    launches = read_launches(fns)
    cfg = res.cfg
    if cfg != dataclasses.replace(full, n_layers=layers):
        raise AssertionError(f"{arch}: served {cfg}")
    expected = (expected_of or zoo_expected)(cfg, path, 1 + steps, steps)
    if launches != expected:
        raise AssertionError(f"{arch} {path}: launch counts {launches} != "
                             f"{expected}")
    toks = res.tokens
    if toks.shape != (batch, 1 + steps) or not bool(
            ((toks >= 0) & (toks < cfg.vocab)).all()):
        raise AssertionError(f"{arch}: bad tokens {toks.shape}")
    for lg in [res.prefill_logits] + res.decode_logits:
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"{arch}: non-finite logits")
    n_params = sum(t.numel() for t in _leaves(res.params))
    return res, dict(
        config=f"{arch}.FULL", path=path, n_layers=layers,
        full_layers=full.n_layers,
        d_model=cfg.d_model, params=n_params, param_gb=4 * n_params / 1e9,
        batch=batch, prompt_tokens=prompt, decode_steps=steps,
        launches=launches, prefill_s=res.timing["prefill_s"],
        decode_ms_per_step=res.timing["decode_ms_per_step"],
        decode_step_ms_first=res.timing["decode_step_ms"][0],
        decode_step_ms_median=statistics.median(
            res.timing["decode_step_ms"]),
        decode_tokens_per_s=res.timing["decode_tokens_per_s"],
        init_s=res.timing["init_s"],
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        sample_tokens=toks[0].tolist(), logits_sha256=logits_sha256(res))


def check_flash_windowed(torch, fd, got, q, k, v, lengths, window, softcap,
                         what, scale=0.0):
    """Kernel 4's output ``got`` with ``window``, ``softcap`` and ``scale``
    (0: D^-½) against its plain version and the f64 split version on the
    same inputs, under FLASH_TOLERANCE; raises on disagreement or a non-finite output."""
    want = fd.flash_decode_ref(q, k, v, lengths, window, softcap, scale)
    ok, st = compare(torch, got, want, F32_FMT,
                     flash_tol(torch, v, lengths, None, window, softcap))
    if not ok or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"flash_decode_attention {what}: {st}")
    exact = fd.flash_decode_split_ref(q, k, v, lengths, None,
                                      dtype=torch.float64, window=window,
                                      softcap=softcap, scale=scale)
    tol = flash_f64_tol(torch, v, lengths, None, window, softcap)
    ok, st64 = compare(torch, got, exact, F32_FMT, tol)
    if not ok:
        raise AssertionError(f"flash_decode_attention {what} against the "
                             f"f64 split version: {st64}")
    return {**st, "f64_max_abs_err": st64["max_abs_err"],
            "f64_max_tol": float(tol.max())}


class WindowCheckSpy(KernelSpy):
    """Stands in for kernel 4 while a path runs: launches it, then holds
    its output against both plain versions on the same inputs at once (the
    cache is written in place, so a call is checked when it is made), and
    keeps a row per call."""

    def __init__(self, torch, fd):
        super().__init__(fd.flash_decode_attention, None, None)
        self.torch, self.fd, self.rows = torch, fd, []

    def __call__(self, q, k, v, lengths, window=0, softcap=0.0):
        out = self.fn(q, k, v, lengths, window=window, softcap=softcap)
        torch = self.torch
        st = check_flash_windowed(torch, self.fd, out, q, k, v, lengths,
                                  window, softcap,
                                  f"call {len(self.rows)}")
        lo = first_attended(torch, lengths, k.shape[1], window)
        self.rows.append({"window": window, "softcap": softcap,
                          "lengths": lengths.tolist(),
                          "first_attended": lo.tolist(),
                          "max_abs_err": st["max_abs_err"],
                          "f64_max_abs_err": st["f64_max_abs_err"]})
        return out


def windowed_timing(torch, fd, q, k, v, lengths, window, softcap):
    """Kernel 4 with a window and a softcap: device ms (profiler trace,
    caches rotated past the L2), host ms, its plain version's ms, and SDPA
    on the window's positions where no softcap is asked (SDPA has none:
    null otherwise). The bound: bytes (q in, out, k and v over each lane's
    attended positions, the window) or operations (4·G·D a position and
    kv head)."""
    B, H, G, D = q.shape
    S = k.shape[1]
    iters = flash_iters(S)
    copies = cache_copies(torch, k, v)
    kernel = lambda c: fd.flash_decode_attention(q, *c, lengths,
                                                 window=window,
                                                 softcap=softcap)
    plain = lambda c: fd.flash_decode_ref(q, *c, lengths, window, softcap)
    timing = {"ms": trace_ms(torch, kernel, copies, iters),
              "host_ms": time_cold_ms(torch, kernel, copies, iters),
              "plain_ms": trace_ms(torch, plain, copies, max(2, iters // 5)),
              "cache_copies": len(copies), "library_ms": None}
    n = attended(torch, lengths, S)
    lo = first_attended(torch, lengths, S, window)
    if not softcap and len(set(n.tolist())) == 1:
        a, b = int(lo[0]), int(n[0])
        sdpa = torch.nn.functional.scaled_dot_product_attention
        qs = q.reshape(B, H * G, 1, D)
        tcopies = [tuple(t[:, a:b].permute(0, 2, 1, 3).contiguous()
                         for t in c) for c in copies]
        timing["library_ms"] = trace_ms(
            torch, lambda c: sdpa(qs, *c, enable_gqa=True), tcopies, iters)
        del tcopies
    del copies
    n_pos = int((n - lo).sum())
    timing["bound_ms"], timing["bound_by"] = bound_ms(
        4.0 * (2 * q.numel() + 2 * n_pos * H * D) + 4 * B,
        4.0 * G * D * H * n_pos)
    timing["attended_positions"] = (n - lo).tolist()
    return timing


def phase_flash_windowed(torch, fd):
    """Kernel 4 with windows 16 and 4,096 and Gemma-2's softcap 50 at its
    shape (K 16, G 2, D 128) against both plain versions, at the serve
    cache (a lane of length 0 among them) and at a 32K cache; timed at 32K
    with window 4,096, with the softcap (Gemma-2's local layers) and
    without (Mixtral's layers, beside SDPA on the window). Run beside the
    other kernel phases, before the serving paths: late in the run the
    profiler was seen to return traces without device activity."""
    H, G, D = ZOO_FLASH_SHAPE
    B = SERVE_BATCH
    gen = torch.Generator(device="cuda").manual_seed(6)
    cases, worst = {}, 0.0
    serve_S = SERVE_PROMPT + SERVE_STEPS + 1
    for name, S, lens in (
            ("serve", serve_S, [serve_S - 1, SERVE_PROMPT + 1, 17, 0]),
            ("long", ZOO_LONG, [ZOO_LONG, ZOO_LONG - 1, 4097, 5000])):
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        # q scaled so that the softcap bends the scores
        q = 8.0 * torch.randn(B, H, G, D, device="cuda", generator=gen)
        k = torch.randn(B, S, H, D, device="cuda", generator=gen)
        v = torch.randn(B, S, H, D, device="cuda", generator=gen)
        for window in ZOO_FLASH_WINDOWS:
            got = fd.flash_decode_attention(q, k, v, lengths, window=window,
                                            softcap=ZOO_SOFTCAP)
            st = check_flash_windowed(torch, fd, got, q, k, v, lengths,
                                      window, ZOO_SOFTCAP,
                                      f"{name} window {window}")
            worst = max(worst, st["max_abs_err"])
            cases[f"{name}_w{window}"] = {
                "Smax": S, "lengths": lens, "window": window,
                "softcap": ZOO_SOFTCAP, **st}
        del q, k, v
    lengths = torch.full((B,), ZOO_LONG, dtype=torch.int32, device="cuda")
    q = torch.randn(B, H, G, D, device="cuda", generator=gen)
    k = torch.randn(B, ZOO_LONG, H, D, device="cuda", generator=gen)
    v = torch.randn(B, ZOO_LONG, H, D, device="cuda", generator=gen)
    timing = {f"softcap_{c:g}": windowed_timing(torch, fd, q, k, v, lengths,
                                                4096, c)
              for c in (ZOO_SOFTCAP, 0.0)}
    del q, k, v
    out = {"cases": cases, "max_abs_err": worst, "timing_32k_w4096": {
        "Smax": ZOO_LONG, "lengths": [ZOO_LONG] * B, "window": 4096,
        "shape": {"B": B, "K": H, "G": G, "D": D}, **timing}}
    emit("flash_decode_windowed", tolerance=FLASH_TOLERANCE, **out)
    return out


def zoo_gemma(torch, serve, batching, fd, fns, T):
    """Gemma-2 27B at full width, 8 layers: served under the format map and
    at k = 12 (batch 4, 128-token prompts, 16 steps), then at batch 1 with
    a 4,224-token prompt under the format map, every decode-attention call
    held against kernel 4's plain versions; the batching engine at 4 lanes
    under the format map, every request bit for bit alone; the library
    products' lane bits at its widths."""
    out = {}
    for path, extra in (("format", ["--layer-format",
                                    json.dumps(SERVE_FORMAT)]),
                        ("k", ["--precision-k", str(SERVE_K)])):
        free_device_memory(torch)
        res, out[f"serve_{path}"] = run_zoo_serve(torch, serve, fns,
                                                  "gemma2_27b", path, extra)
        del res
    free_device_memory(torch)
    spy = WindowCheckSpy(torch, fd)
    fd.flash_decode_attention = spy
    try:
        res, report = run_zoo_serve(
            torch, serve, fns, "gemma2_27b", "format",
            ["--layer-format", json.dumps(SERVE_FORMAT)], batch=1,
            prompt=ZOO_WINDOW_PROMPT)
    finally:
        fd.flash_decode_attention = spy.fn
    local = [r for r in spy.rows if r["window"]]
    if (len(spy.rows) != ZOO_LAYERS["gemma2_27b"] * SERVE_STEPS
            or len(local) != len(spy.rows) // 2
            or min(r["first_attended"][0] for r in local) <= 0):
        raise AssertionError("the windowed run's decode attention: "
                             f"{len(spy.rows)} calls, {len(local)} local, "
                             "or the window never bit")
    out["windowed"] = dict(
        report, note="decode timings include each call's check against "
        "the plain versions", calls=len(spy.rows),
        local_calls=len(local),
        first_attended=[local[0]["first_attended"][0],
                        local[-1]["first_attended"][0]],
        max_abs_err=max(r["max_abs_err"] for r in spy.rows),
        f64_max_abs_err=max(r["f64_max_abs_err"] for r in spy.rows),
        sample_tokens=res.tokens[0].tolist())
    del res, spy
    free_device_memory(torch)

    cfg = dataclasses.replace(serve.configs.get("gemma2_27b").FULL,
                              n_layers=ZOO_LAYERS["gemma2_27b"])
    params = T.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    sc = serve.ServeConfig(arch="gemma2_27b", batch=BATCH_ENGINE["n_lanes"],
                           max_seq=BATCH_ENGINE["max_seq"],
                           precision_layer_format=SERVE_FORMAT,
                           device="cuda")
    gen = torch.Generator().manual_seed(1)
    reqs = []
    for i in range(ZOO_BATCH_REQUESTS):
        P = int(torch.randint(BATCH_PROMPT[0], BATCH_PROMPT[1] + 1, (1,),
                              generator=gen))
        reqs.append(batching.Request(
            rid=i, prompt=torch.randint(0, cfg.vocab, (P,),
                                        generator=gen).tolist(),
            max_new_tokens=ZOO_BATCH_MAX_NEW,
            arrival_step=BATCH_STRIDE * i))
    engine, responses, launches, registry, wall = run_batching(
        torch, batching, fns, cfg, sc, params, reqs, None, -1,
        lambda eng, admitted: zoo_expected(cfg, "format",
                                           admitted + eng.steps, eng.steps))
    ref = reference_runs(batching, cfg, sc, params, reqs, -1)
    rows = lane_bits(torch, responses, ref)
    if not all(r["tokens_equal"] and r["logits_bitwise"] for r in rows):
        raise AssertionError(f"gemma2_27b batching: a request's bits differ "
                             f"from the request alone: {rows}")
    out["batching"] = dict(batching_report(engine, responses, registry,
                                           wall), launches=launches,
                           lanes_vs_alone=rows)
    del engine, responses, ref, params
    free_device_memory(torch)
    out["library_lane_bits"] = library_lane_bits(torch, cfg)
    return out


def zoo_mixtral(torch, serve, fns):
    """Mixtral 8x22B at full width, 2 layers: lock-step serve at k = 12 and
    under the format map, with the router's launches (its products of N =
    8 among the kernel's) and the (token, expert) assignments each forward
    dropped by capacity."""
    from repro_torch.models import moe

    out = {}
    n_experts = serve.configs.get("mixtral_8x22b").FULL.n_experts
    for path, name, extra in (
            ("k", "quant_matmul_dynamic_k", ["--precision-k", str(SERVE_K)]),
            ("format", "quant_matmul_format_dispatch",
             ["--layer-format", json.dumps(SERVE_FORMAT)])):
        free_device_memory(torch)
        dispatch, routers = getattr(serve, name), []

        def counted(a, b, *args, _d=dispatch, **kw):
            if b.shape[-1] == n_experts:
                routers.append(tuple(a.shape))
            return _d(a, b, *args, **kw)

        setattr(serve, name, counted)
        moe.drop_log = []
        try:
            res, report = run_zoo_serve(torch, serve, fns, "mixtral_8x22b",
                                        path, extra)
            drops = moe.drop_log
        finally:
            setattr(serve, name, dispatch)
            moe.drop_log = None
        L = res.cfg.n_layers
        per_forward = [sum(drops[i * L:(i + 1) * L])
                       for i in range(len(drops) // L)]
        if len(routers) != L * (1 + SERVE_STEPS) or len(per_forward) != \
                1 + SERVE_STEPS:
            raise AssertionError(f"mixtral {path}: {len(routers)} router "
                                 f"products, {len(drops)} dispatches")
        out[f"serve_{path}"] = dict(
            report, router_launches=len(routers),
            router_rows={"prefill": routers[0][0], "decode": routers[-1][0]},
            dropped_by_capacity={"prefill": per_forward[0],
                                 "decode_steps": per_forward[1:]},
            window=res.cfg.window)
        del res
    return out


def zoo_command_r(torch, serve, fns):
    """Command-R 35B at full width, 4 layers, under the format map: kernels
    1 and 2, as Qwen2-7B."""
    free_device_memory(torch)
    res, report = run_zoo_serve(torch, serve, fns, "command_r_35b", "format",
                                ["--layer-format", json.dumps(SERVE_FORMAT)])
    del res
    return {"serve_format": report}


def zoo_llama4(torch, serve, T, fns):
    """Llama-4 Maverick at SMOKE under the format map, the same weights
    (drawn on the CPU) on the card and on the CPU: a prefill of 32 tokens
    at batch 4 and 16 greedy steps. Tokens equal, or each mismatch with
    the CPU's top-1 logit gap at that step and any route flip (a token
    whose top-1 expert differs, with the CPU's router margin)."""
    cfg = serve.configs.get("llama4_maverick").SMOKE
    host = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    prompt = torch.randint(0, cfg.vocab, (SERVE_BATCH, 32),
                           generator=torch.Generator().manual_seed(2))
    runs = {}
    for dev in ("cuda", "cpu"):
        params = host if dev == "cpu" else _to_device(host, "cuda")
        bk = serve.FormatQuantJOps(SERVE_FORMAT)
        routes = []
        top_k = bk.top_k_mask

        def spy(scores, k, name="router", _f=top_k, _r=routes):
            _r.append(scores.detach().double().cpu())
            return _f(scores, k, name)

        bk.top_k_mask = spy
        cache = T.init_cache(cfg, SERVE_BATCH, 32 + SERVE_STEPS + 1,
                             device=dev)
        reset_launches(fns)
        with torch.no_grad():
            lg, cache = serve.prefill_step(bk, params, cfg, cache,
                                           prompt.to(dev))
            tok, toks, logits = torch.argmax(lg[:, -1], -1), [], [lg[:, -1]]
            toks.append(tok)
            for i in range(SERVE_STEPS):
                tok, last, cache = serve.decode_step(bk, params, cfg, cache,
                                                     tok[:, None], 32 + i)
                toks.append(tok)
                logits.append(last)
        runs[dev] = (torch.stack(toks, 1).cpu(),
                     torch.stack(logits, 1).double().cpu(), routes,
                     read_launches(fns))
    (ct, cl, cr, launches), (ht, hl, hr, _) = runs["cuda"], runs["cpu"]
    expected = zoo_expected(cfg, "format", 1 + SERVE_STEPS, SERVE_STEPS)
    if launches != expected:
        raise AssertionError(f"llama4 SMOKE: launch counts {launches} != "
                             f"{expected}")
    flips = []
    for i, (a, b) in enumerate(zip(cr, hr)):
        for t in torch.nonzero(a.argmax(-1) != b.argmax(-1)).flatten():
            top2 = torch.topk(b[t], 2).values
            flips.append({"router_call": i, "token": int(t),
                          "cpu_margin": float(top2[0] - top2[1])})
    mismatches = []
    for b in range(SERVE_BATCH):
        diff = torch.nonzero(ct[b] != ht[b]).flatten()
        if len(diff):
            s = int(diff[0])
            top2 = torch.topk(hl[b, s], 2).values
            mismatches.append({"lane": b, "first_step": s,
                               "cpu_top1_gap": float(top2[0] - top2[1])})
    if mismatches and not flips:
        gaps = [m["cpu_top1_gap"] for m in mismatches]
        if min(gaps) > 1e-3:
            raise AssertionError(f"llama4 SMOKE: tokens differ with no "
                                 f"route flip and wide gaps {mismatches}")
    return {"config": "llama4_maverick.SMOKE", "full_width": LLAMA4_FULL,
            "launches": launches, "tokens_equal": not mismatches,
            "mismatches": mismatches, "route_flips": flips,
            "router_calls": len(cr),
            "max_abs_dlogit": float((cl - hl).abs().max()),
            "sample_tokens": ct[0].tolist()}


def zoo_analysis(torch, T, fns):
    """The four zoo archs at SMOKE, the same weights (drawn on the CPU) on
    the card and on the CPU: the CaaOps forward at emulated k = 12 on 16
    tokens (trace records, router records) and ``certify_lm`` (uniform,
    k_max 24); decisions equal: the certificates', and each route's
    flip-safety at the analysis's u; the trace records' δ̄ and ε̄ within
    CERT_LM_REL_TOL (their worst reported, and whether it is within 1e-9),
    the router records' and the certificates' bounds reported. Then
    ``python -m
    repro_torch.launch.analyze --routers`` on the card for the MoE archs."""
    from repro_torch import configs
    from repro_torch.launch import analyze

    out = {}
    reset_launches(fns)
    for arch in ZOO_SMOKE:
        cpu = cpu_job("zoo", arch)
        traces, certs, secs = {}, {}, {}
        traces["cuda"], certs["cuda"], secs["cuda"] = card_job(
            "zoo", arch, fns)
        traces["cpu"], certs["cpu"], secs["cpu"] = cpu.result()
        a, b = traces["cuda"], traces["cpu"]
        if [(r.name, r.kind) for r in a] != [(r.name, r.kind) for r in b]:
            raise AssertionError(f"{arch}: the traces' records differ")
        worst, router_worst = 0.0, 0.0
        for ra, rb in zip(a, b):
            for x, y in ((ra.max_dbar, rb.max_dbar),
                         (ra.max_ebar, rb.max_ebar)):
                if not same_bound(x, y, CERT_LM_REL_TOL):
                    raise AssertionError(f"{arch} {ra.name}: {x} on the "
                                         f"card, {y} on the CPU")
                if math.isfinite(x) and x != y:
                    worst = max(worst, abs(x - y) / max(abs(x), abs(y)))
            if ra.kind != "router":
                continue
            # a router record's margin is a difference of emulated values,
            # which the card's and the CPU's k-bit products may put an ulp
            # at k apart, and its flip-safe u divides it by the distance to
            # the exact enclosure: what must agree is the decision, whether
            # the route is flip-safe at the analysis's u
            safe = [r.extra["flip_safe_if_u_le"] >= ZOO_CAA_U
                    for r in (ra, rb)]
            if safe[0] != safe[1]:
                raise AssertionError(f"{arch} {ra.name}: flip-safe at u "
                                     f"{ZOO_CAA_U} {safe[0]} on the card, "
                                     f"{safe[1]} on the CPU")
            for key in ra.extra:
                x, y = ra.extra[key], rb.extra[key]
                if x != y:
                    router_worst = max(router_worst,
                                       abs(x - y) / max(abs(x), abs(y)))
        # a certificate's final bound is reported, not held: it is the
        # distance from the emulated run's logits to their exact enclosure,
        # and at the certified k (5 or 6 here, an ulp of 2^-4 or 2^-5) the
        # card's and the CPU's k-bit products may round a value an ulp
        # apart (Llama-4's SMOKE bound was 7 % apart, Command-R's 1e-6)
        if cert_decisions(certs["cuda"]) != cert_decisions(certs["cpu"]):
            raise AssertionError(f"certify {arch}: card decides "
                                 f"{cert_decisions(certs['cuda'])}, CPU "
                                 f"{cert_decisions(certs['cpu'])}")
        cert_worst = max(
            [0.0] + [abs(x - y) / max(abs(x), abs(y))
                     for (x, _), (y, _) in zip(cert_bounds(certs["cuda"]),
                                               cert_bounds(certs["cpu"]))
                     if math.isfinite(x) and x != y])
        routers = [{"name": r.name, **r.extra} for r in a
                   if r.kind == "router"]
        out[arch] = {"trace_records": len(a), "trace_worst_rel": worst,
                     "router_worst_rel": router_worst,
                     "within_1e-9": worst <= 1e-9,
                     "routers": routers,
                     "certificate": cert_summary(certs["cuda"]),
                     "certificate_worst_rel": cert_worst,
                     "seconds": secs}
    out["launches"] = read_launches(fns)
    for arch in ("mixtral_8x22b", "llama4_maverick"):
        res = analyze.main(["--arch", arch, "--routers", "--device", "cuda",
                            "--seq", "16"])
        if len(res["routers"]) != configs.get(arch).SMOKE.n_layers:
            raise AssertionError(f"analyze --routers {arch}: "
                                 f"{len(res['routers'])} records")
        out[arch]["analyze_cli_routers"] = [
            {"name": r.name, **r.extra} for r in res["routers"]]
    return out


def zoo_smoke_side(arch, dev, root):
    """One device's half of ``zoo_analysis``'s SMOKE check of ``arch``: the
    CaaOps forward at emulated k = 12 on 16 tokens and ``certify_lm``
    (uniform, k_max 24) on the seed-0 weights drawn on the CPU. Returns
    (trace, certificates, seconds)."""
    import torch

    from repro_torch import certify as C
    from repro_torch import configs
    from repro_torch.certify.tokens import profile_tokens
    from repro_torch.core import caa
    from repro_torch.core.backend import CaaOps
    from repro_torch.models import transformer as T

    cfg = configs.get(arch).SMOKE
    host = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    params = host if dev == "cpu" else _to_device(host, dev)
    toks = profile_tokens(1, 1, 16, cfg.vocab)
    t0 = time.perf_counter()
    bk = CaaOps(caa.CaaConfig(u_max=ZOO_CAA_U, emulate_k=12))
    T.forward(bk, params, cfg, toks.to(dev))
    certs = C.certify_lm(arch, cfg, params, **ZOO_CERT,
                         store=C.CertificateStore(str(root / arch / dev)))
    return bk.trace, certs, time.perf_counter() - t0


def phase_zoo(torch, serve, batching, qmm, fd, T):
    """The GQA model zoo on the card (see the module docstring)."""
    emit("free", before="zoo", allocated_gb=free_device_memory(torch))
    t_phase = time.perf_counter()
    fns = kernel_fns(qmm, fd)
    parts, launches = {}, {name: 0 for name in fns}

    def run(name, fn, *args):
        t0 = time.perf_counter()
        parts[name] = fn(*args)
        parts[name]["seconds"] = time.perf_counter() - t0
        emit(f"zoo_{name}", **parts[name])
        free_device_memory(torch)

    # every path sets the counters to 0 before it runs and reads them
    # after; the phase's launches are the sum of its paths' own counts
    run("gemma2_27b", zoo_gemma, torch, serve, batching, fd, fns, T)
    run("mixtral_8x22b", zoo_mixtral, torch, serve, fns)
    run("command_r_35b", zoo_command_r, torch, serve, fns)
    run("llama4_maverick", zoo_llama4, torch, serve, T, fns)
    run("analysis", zoo_analysis, torch, T, fns)
    for counts in _launch_counts(parts):
        for name, n in counts.items():
            launches[name] += n
    emit("zoo", launches=launches, seconds=time.perf_counter() - t_phase)
    return launches, parts


def _launch_counts(report):
    """Every run's launch counts in a phase's nested report."""
    if not isinstance(report, dict):
        return []
    if isinstance(report.get("launches"), dict):
        return [report["launches"]]
    return [c for v in report.values() for c in _launch_counts(v)]


# ---------------------------------------------------------------------------
# the recurrent families: RWKV6 1.6B and Hymba 1.5B through the port's entry
# points, at full width, depth cut to ZOO_LAYERS
# ---------------------------------------------------------------------------

SSM_ARCHS = ("rwkv6_1p6b", "hymba_1p5b")
# SERVE_FORMAT's layer*/attn and layer*/mlp keys match no RWKV product (an
# RWKV layer has no sub-scope) and not Hymba's Mamba heads, which run in
# layer{i} itself: a layer* key gives them a format of their own
SSM_FORMAT = {**SERVE_FORMAT, "layer*": {"k": 12, "emax": 15, "emin": -14}}
SSM_RWKV_LONG = 4096              # 128 chunks of 32
SSM_HYMBA_LONG = 1200             # past Hymba's 1,024-position window
SSM_LONG_TOL = 1e-3               # decode vs full forward, × max |logit|
SSM_NEW_N = (1, 16, 64)           # w_dt; w_B / w_C; RWKV's decay LoRA wA
SSM_CAA_U = 2.0 ** -11            # the analysis's u (emulated k = 12)
# the full-width analysis pass's depth: RWKV6's second layer is where its
# saturation shows; Hymba's softplus saturates in its first layer, so one
# layer keeps that check and halves its pass (35-72 s at 2 layers)
SSM_FULL_LAYERS = {"rwkv6_1p6b": 2, "hymba_1p5b": 1}
SSM_CAA_TOKENS = 8
# the full-width pass at f32's own u: at k = 12 RWKV's decay exp(−exp(·))
# already has no finite bound at full width (its argument's δ̄ of ~4.6e5 u
# is an error of ~224 at u = 2^-11), so the recurrence would only pass ∞ on
SSM_FULL_K = 24
SSM_FIXPOINT_STEPS = (8, 4096, 500_000)


def ssm_expected(cfg, path, forwards, steps):
    """Exact launches of ``forwards`` forwards (``steps`` of them decode
    steps) of RWKV6 or Hymba on a serving path ("format", "k" or "plain"):
    RWKV 10 GEMMs a layer (time mix r, k, v, g, the decay LoRA's two, o;
    channel mix k, v, r) and 3 rmsnorms (ln1, the time mix's ln_out, ln2);
    Hymba 13 GEMMs (attention q, k, v, o; Mamba in, gate, dt, B, C, out;
    MLP gate, up, down), 2 rmsnorms and its decode attention through kernel
    4 on every path (windowed, as the reference composes it unrounded). The
    plain path's GEMMs are ``f32_matmul``; every path's LM head is one."""
    L = cfg.n_layers
    gemms = (10 if cfg.rwkv else 13) * L * forwards
    return {"quant_matmul_format": gemms if path == "format" else 0,
            "flash_decode_certified": 0,
            "quant_matmul": gemms if path == "k" else 0,
            "flash_decode_attention": 0 if cfg.rwkv else L * steps,
            **IDLE_ON_SERVING,
            "row_mean": ((3 if cfg.rwkv else 2) * L + 1) * forwards,
            "f32_matmul": forwards + (gemms if path == "plain" else 0)}


@contextlib.contextmanager
def resolved_formats(serve):
    """Records, while a format-map path runs, the (k, emax, emin) each
    scope path of a product resolved to: yields {path: triple}."""
    seen = {}
    cls = serve.FormatQuantJOps
    orig = cls.format_for

    def format_for(self, path):
        got = orig(self, path)
        seen.setdefault("/".join(path), list(got))
        return got

    cls.format_for = format_for
    try:
        yield seen
    finally:
        cls.format_for = orig


def ssm_new_shape(x, w):
    """The key of a kernel-1 or 3 call at one of SSM_NEW_N, else None."""
    return (x.shape[0], w.shape[1]) if w.shape[1] in SSM_NEW_N else None


class NewShapeSpy(KernelSpy):
    """A KernelSpy on a GEMM wrapper (kernel 1 or 3, ``f32_matmul``)
    keeping the inputs of the first call of each key that ``key_of(x, w)``
    gives (None: not kept): x copied, w copied unless ``copy_w`` is False
    (a table nothing writes, kept by reference)."""

    def __init__(self, fn, key_of=ssm_new_shape, copy_w=True):
        super().__init__(fn, None, None)
        self.key_of, self.copy_w = key_of, copy_w

    def __call__(self, *args, **kw):
        x, w = args[0], args[1]
        key = self.key_of(x, w)
        if key is not None and key not in self.seen:
            self.seen[key] = ((x.clone(), w.clone() if self.copy_w else w)
                              + args[2:], dict(kw))
        return self.fn(*args, **kw)


def ssm_format_and_k(torch, serve, qmm, fns, arch):
    """``arch`` served under SSM_FORMAT and at k = 12, batch 4 × 128 × 16,
    kernel 1 resp. 3 spied at the new shapes. Returns (reports by path,
    the scope paths the format map's products resolved at, the spies)."""
    out, spies = {}, []
    for path, extra, kernel in (
            ("format", ["--layer-format", json.dumps(SSM_FORMAT)],
             "quant_matmul_format"),
            ("k", ["--precision-k", str(SERVE_K)], "quant_matmul")):
        free_device_memory(torch)
        spy = NewShapeSpy(getattr(qmm, kernel))
        spies.append((kernel, spy))
        setattr(qmm, kernel, spy)
        try:
            with resolved_formats(serve) as seen:
                res, out[f"serve_{path}"] = run_zoo_serve(
                    torch, serve, fns, arch, path, extra,
                    expected_of=ssm_expected)
        finally:
            setattr(qmm, kernel, spy.fn)
        if path == "format":
            scopes = seen
        del res
    out["serve_format"]["format_map"] = SSM_FORMAT
    return out, scopes, spies


def new_shape_checks(torch, qmm, spies, f32_rows=None):
    """Kernels 1 and 3 on the inputs ``spies`` (pairs of kernel name and
    :class:`NewShapeSpy`) kept from the serve runs, against their plain
    versions (the GEMM rule), and ``f32_matmul`` on the same inputs (and on
    those its own spy kept) bit for bit against its fmaf chain, on the
    first ``f32_rows`` rows (default all: a row's bits depend on K alone,
    the instance on M); raises on disagreement. Returns the rows."""
    from repro_torch.kernels import row_order as ro

    rows = []
    for name, spy in spies:
        for args, kw in spy.seen.values():
            x, w = args[0], args[1]
            if name == "quant_matmul_format":
                _, st = check_gemm(torch, qmm, x, w, args[2],
                                   (kw["has_subnormals"], kw["saturating"]))
                rule = {"format": list(args[2])}
            elif name == "quant_matmul":
                _, st = check_gemm_k(torch, qmm, x, w, kw["k"])
                rule = {"k": kw["k"]}
            else:
                st, rule = {}, {}
            n = x.shape[0] if f32_rows is None else min(f32_rows, x.shape[0])
            f32 = ro.f32_matmul(x, w)[:n]
            bitwise = same_bits(torch, f32, ro.f32_matmul_seq_ref(x[:n], w))
            del f32
            if not bitwise:
                raise AssertionError(f"f32_matmul {tuple(x.shape)}@"
                                     f"{tuple(w.shape)}: differs from its "
                                     "fmaf chain")
            rows.append({"kernel": name, "M": x.shape[0], "K": x.shape[1],
                         "N": w.shape[1], **rule, **st,
                         "f32_matmul_bitwise": bitwise,
                         "f32_matmul_rows_checked": n})
    return rows


def ssm_rwkv(torch, serve, qmm, T, fns):
    """RWKV6 1.6B at full width, depth ZOO_LAYERS: served under the format map
    (its products at the map's layer* key) and at k = 12, batch 4 ×
    128-token prompts × 16 steps, kernels 1 and 3 spied at the new shapes;
    then at batch 1 with a 4,096-token prompt (128 chunks) and 16 steps on
    the plain backend, the last decode logits held against one full
    forward of the same 4,112 tokens."""
    from repro_torch.core.backend import TorchOps

    out, scopes, spies = ssm_format_and_k(torch, serve, qmm, fns,
                                          "rwkv6_1p6b")
    want = {f"layer{i}": list(FORMATS["k12_e15"])
            for i in range(ZOO_LAYERS["rwkv6_1p6b"])}
    if scopes != want:
        raise AssertionError(f"rwkv format map: products resolved at "
                             f"{scopes}")
    out["serve_format"]["resolved"] = scopes
    free_device_memory(torch)
    res, report = run_zoo_serve(torch, serve, fns, "rwkv6_1p6b", "plain", [],
                                batch=1, prompt=SSM_RWKV_LONG,
                                expected_of=ssm_expected)
    seq = torch.cat([res.prompt, res.tokens[:, :SERVE_STEPS]], dim=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        full, _ = T.forward(TorchOps(), res.params, res.cfg, seq)
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    got, want = res.decode_logits[-1][0].double(), full[0, -1].double()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    top2 = torch.topk(want, 2).values
    gap = float(top2[0] - top2[1])
    argmax_ok = bool(got.argmax() == want.argmax()) or gap <= 2 * err
    out["long"] = dict(report, full_forward_tokens=seq.shape[1],
                       full_forward_s=full_s, max_abs_dlogit=err,
                       max_abs_logit=scale, tolerance=SSM_LONG_TOL * scale,
                       argmax_agrees=bool(got.argmax() == want.argmax()),
                       top1_gap=gap)
    if not err <= SSM_LONG_TOL * scale or not argmax_ok:
        raise AssertionError(f"rwkv {SSM_RWKV_LONG}-token decode against "
                             f"its full forward: {out['long']}")
    del res, full, seq
    return out, spies


def mamba_lane_bits(torch, cfg, lanes=4, seed=7):
    """Whether the library pieces of a Mamba decode step keep a lane's
    bits at ``cfg``'s widths, on seeded inputs: the state update d·h + b,
    the projection ``einsum('bdn,bn->bd')``, the softplus log(exp(x) + 1)
    and the decay exp(−dt·A), each over ``lanes`` lanes against each lane
    alone. Returns {op: {"bitwise", "max_abs_diff"}}."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)
    din, N = cfg.mamba_expand * cfg.d_model, cfg.ssm_state
    ops = {
        "state_update": (lambda d, h, b: d * h + b,
                         (rnd(lanes, 1, N).sigmoid(), rnd(lanes, din, N),
                          rnd(lanes, din, N))),
        "project": (lambda h, c: torch.einsum("bdn,bn->bd", h, c),
                    (rnd(lanes, din, N), rnd(lanes, N))),
        "softplus": (lambda x: torch.log(torch.exp(x) + 1.0),
                     (rnd(lanes, 1, 1),)),
        "decay": (lambda dt, a: torch.exp(-(dt * a)),
                  (rnd(lanes, 1, 1, 1).abs(), rnd(1, 1, 1, N).exp())),
    }
    out = {}
    for name, (fn, args) in ops.items():
        got = fn(*args)
        alone = torch.cat([fn(*(a[b:b + 1] if a.shape[0] == lanes else a
                                for a in args)) for b in range(lanes)])
        out[name] = {"bitwise": same_bits(torch, got, alone),
                     "max_abs_diff": float((got.double() - alone.double())
                                           .abs().max())}
    return out


def engine_requests(torch, batching, vocab, seed=3):
    """ZOO_BATCH_REQUESTS requests of BATCH_PROMPT tokens, off the page
    grid (a recurrent state's unpadded prefill, a pad's masked rows), one
    every BATCH_STRIDE steps."""
    gen = torch.Generator().manual_seed(seed)
    reqs = []
    for i in range(ZOO_BATCH_REQUESTS):
        P = int(torch.randint(BATCH_PROMPT[0], BATCH_PROMPT[1] + 1, (1,),
                              generator=gen))
        P += P % BATCH_ENGINE["page_size"] == 0      # off the page grid
        reqs.append(batching.Request(
            rid=i, prompt=torch.randint(0, vocab, (P,),
                                        generator=gen).tolist(),
            max_new_tokens=ZOO_BATCH_MAX_NEW,
            arrival_step=BATCH_STRIDE * i))
    return reqs


def ssm_hymba(torch, serve, batching, qmm, fd, T, fns):
    """Hymba 1.5B at full width, depth ZOO_LAYERS: served under the format map and
    at k = 12 (batch 4 × 128 × 16; kernel 4 once a layer a decode step,
    kernel 2 never), kernels 1 and 3 spied at the new shapes; at batch 1
    with a 1,200-token prompt under the format map, every decode-attention
    call held against kernel 4's plain versions (the window bites); the
    batching engine at 4 lanes under the format map, prompts off the page
    grid, every request bit for bit alone; the lane bits of a decode step's
    every op and of the Mamba step's library pieces."""
    out, scopes, spies = ssm_format_and_k(torch, serve, qmm, fns,
                                          "hymba_1p5b")
    # the attention, Mamba heads and MLP of the first two layers
    out["serve_format"]["resolved"] = {
        p: f for p, f in scopes.items()
        if p.split("/")[0] in ("layer0", "layer1")}
    free_device_memory(torch)
    spy = WindowCheckSpy(torch, fd)
    fd.flash_decode_attention = spy
    try:
        res, report = run_zoo_serve(
            torch, serve, fns, "hymba_1p5b", "format",
            ["--layer-format", json.dumps(SSM_FORMAT)], batch=1,
            prompt=SSM_HYMBA_LONG, expected_of=ssm_expected)
    finally:
        fd.flash_decode_attention = spy.fn
    window = res.cfg.window
    if (len(spy.rows) != res.cfg.n_layers * SERVE_STEPS
            or any(r["window"] != window for r in spy.rows)
            or min(r["first_attended"][0] for r in spy.rows) <= 0):
        raise AssertionError("hymba's windowed run: "
                             f"{len(spy.rows)} calls, or the window never "
                             "bit")
    out["windowed"] = dict(
        report, note="decode timings include each call's check against "
        "the plain versions", calls=len(spy.rows), window=window,
        first_attended=[spy.rows[0]["first_attended"][0],
                        spy.rows[-1]["first_attended"][0]],
        max_abs_err=max(r["max_abs_err"] for r in spy.rows),
        f64_max_abs_err=max(r["f64_max_abs_err"] for r in spy.rows))
    del res, spy
    free_device_memory(torch)

    cfg = dataclasses.replace(serve.configs.get("hymba_1p5b").FULL,
                              n_layers=ZOO_LAYERS["hymba_1p5b"])
    params = T.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    sc = serve.ServeConfig(arch="hymba_1p5b", batch=BATCH_ENGINE["n_lanes"],
                           max_seq=BATCH_ENGINE["max_seq"],
                           precision_layer_format=SSM_FORMAT, device="cuda")
    reqs = engine_requests(torch, batching, cfg.vocab)
    engine, responses, launches, registry, wall = run_batching(
        torch, batching, fns, cfg, sc, params, reqs, None, -1,
        lambda eng, admitted: ssm_expected(cfg, "format",
                                           admitted + eng.steps, eng.steps))
    ref = reference_runs(batching, cfg, sc, params, reqs, -1)
    rows = lane_bits(torch, responses, ref)
    if not all(r["tokens_equal"] and r["logits_bitwise"] for r in rows):
        raise AssertionError(f"hymba batching: a request's bits differ "
                             f"from the request alone: {rows}")
    out["batching"] = dict(batching_report(engine, responses, registry,
                                           wall), launches=launches,
                           prompts=[len(r.prompt) for r in reqs],
                           lanes_vs_alone=rows)
    del engine, responses, ref
    ops = op_lane_bits(torch, serve, T, cfg, params, serve._backend(sc))
    out["step_op_lane_bits"] = ops
    out["mamba_lane_bits"] = mamba_lane_bits(torch, cfg)
    del params
    free_device_memory(torch)
    if ops["differing"] or ops.get("state_differing"):
        raise AssertionError(f"hymba decode step: a lane's ops differ from "
                             f"the lane alone: {ops}")
    return out, spies


class ScanSpy:
    """Wraps a CAA backend's ``ssm_scan``: one record a recurrence (scope,
    largest δ̄ of its decay, its drive and its bound); keeps the values of
    the first recurrence's operands as ``first`` and the unwrapped rule as
    ``rule``."""

    def __init__(self, torch, bk):
        self.rows, self.first = [], None
        orig = self.rule = bk.ssm_scan

        def scan(decay, drive, n_steps, time_axis=1):
            if self.first is None:
                self.first = (decay.val, drive.val)
            out = orig(decay, drive, n_steps, time_axis)
            mx = lambda t: float(torch.max(t))
            self.rows.append({"scope": "/".join(bk.scope_path),
                              "steps": n_steps,
                              "decay_dbar": mx(decay.dbar),
                              "drive_dbar": mx(drive.dbar),
                              "dbar": mx(out.dbar),
                              "mag": mx(out.exact.hi)})
            return out

        bk.ssm_scan = scan


def ssm_analysis(torch, T, fns):
    """Both SMOKE configs analysed (``CaaOps``, emulated k = 12, 16 tokens)
    and certified (``certify_lm`` uniform, k_max 24) on the card and on the
    CPU with the same weights: trace records and recurrence records (δ̄,
    |h|) within 1e-9 relative, decisions equal. Then each arch at full
    width, cut to SSM_FULL_LAYERS[arch] layers, through one ``CaaOps`` pass on 8
    tokens at f32's u (SSM_FULL_K): seconds, peak memory and each
    recurrence's bound, which is finite wherever its operands' bounds are
    (at full width with random weights they are not everywhere: RWKV's
    second layer and Hymba's softplus already saturate, and the rule
    passes ∞ on); and the
    rule on the first recurrence's own operands, each charged one rounding
    (``caa.const_rounded``), over 8, 4,096 and 500,000 steps: finite, as
    its contraction clamp promises."""
    from repro_torch import configs
    from repro_torch.certify.tokens import profile_tokens
    from repro_torch.core import caa
    from repro_torch.core.backend import CaaOps

    out = {}
    reset_launches(fns)
    for arch in SSM_ARCHS:
        cfg = configs.get(arch).SMOKE
        cpu = cpu_job("ssm", arch)
        traces, scans, certs, secs = {}, {}, {}, {}
        (traces["cuda"], scans["cuda"], certs["cuda"],
         secs["cuda"]) = card_job("ssm", arch, fns)
        traces["cpu"], scans["cpu"], certs["cpu"], secs["cpu"] = \
            cpu.result()
        worst = 0.0
        pairs = [((ra.name, "dbar"), ra.max_dbar, rb.max_dbar)
                 for ra, rb in zip(traces["cuda"], traces["cpu"])]
        pairs += [((ra.name, "ebar"), ra.max_ebar, rb.max_ebar)
                  for ra, rb in zip(traces["cuda"], traces["cpu"])]
        pairs += [((ra["scope"], key), ra[key], rb[key])
                  for ra, rb in zip(scans["cuda"], scans["cpu"])
                  for key in ("dbar", "mag")]
        if ([(r.name, r.kind) for r in traces["cuda"]]
                != [(r.name, r.kind) for r in traces["cpu"]]
                or len(scans["cuda"]) != len(scans["cpu"])
                or len(scans["cuda"]) != cfg.n_layers):
            raise AssertionError(f"{arch}: the records differ")
        for what, x, y in pairs:
            if not same_bound(x, y, CERT_REL_TOL):
                raise AssertionError(f"{arch} {what}: {x} on the card, {y} "
                                     "on the CPU")
            if math.isfinite(x) and x != y:
                worst = max(worst, abs(x - y) / max(abs(x), abs(y)))
        if cert_decisions(certs["cuda"]) != cert_decisions(certs["cpu"]):
            raise AssertionError(f"certify {arch}: card decides "
                                 f"{cert_decisions(certs['cuda'])}, CPU "
                                 f"{cert_decisions(certs['cpu'])}")
        out[arch] = {"trace_records": len(traces["cuda"]),
                     "recurrences": scans["cuda"], "worst_rel": worst,
                     "certificate": cert_summary(certs["cuda"]),
                     "seconds": secs}
    out["launches"] = read_launches(fns)
    for arch in SSM_ARCHS:
        cfg = dataclasses.replace(configs.get(arch).FULL,
                                  n_layers=SSM_FULL_LAYERS[arch])
        free_device_memory(torch)
        params = T.init_params(cfg, generator=torch.Generator(
            device="cuda").manual_seed(0), device="cuda")
        toks = profile_tokens(1, 1, SSM_CAA_TOKENS, cfg.vocab).to("cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        u = 2.0 ** (1 - SSM_FULL_K)
        ccfg = caa.CaaConfig(u_max=u, emulate_k=SSM_FULL_K)
        bk = CaaOps(ccfg)
        spy = ScanSpy(torch, bk)
        logits, _ = T.forward(bk, params, cfg, toks)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        a_abs, _ = caa.actual_error_in_u(logits, u)
        rows = spy.rows
        bad = [r for r in rows if math.isfinite(r["decay_dbar"])
               and math.isfinite(r["drive_dbar"])
               and not math.isfinite(r["dbar"])]
        dec, drv = spy.first
        rule = {}
        for n in SSM_FIXPOINT_STEPS:
            h = spy.rule(caa.const_rounded(dec, ccfg),
                         caa.const_rounded(drv, ccfg), n, 1)
            rule[n] = {"dbar": float(torch.max(h.dbar)),
                       "mag": float(torch.max(h.exact.hi))}
        if (len(rows) != SSM_FULL_LAYERS[arch] or bad
                or not all(math.isfinite(r["dbar"]) and math.isfinite(
                    r["mag"]) for r in rule.values())):
            raise AssertionError(f"{arch} full width: recurrence bounds "
                                 f"{rows}, the rule on its operands {rule}")
        finite = [r["dbar"] for r in rows if math.isfinite(r["dbar"])]
        out[f"{arch}_full"] = {
            "config": f"{arch}.FULL cut to {SSM_FULL_LAYERS[arch]} layers",
            "tokens": SSM_CAA_TOKENS, "emulate_k": SSM_FULL_K,
            "seconds": secs, "peak_gb": peak, "recurrences": rows,
            "max_finite_recurrence_dbar": max(finite) if finite else None,
            "rule_on_first_operands": {
                "operand_shapes": [list(dec.shape), list(drv.shape)],
                "by_steps": rule},
            "logits_actual_abs_u": float(a_abs.max())}
        del params, logits, bk, spy, dec, drv
    return out


def ssm_smoke_side(arch, dev, root):
    """One device's half of ``ssm_analysis``'s SMOKE check of ``arch``: the
    CaaOps forward at emulated k = 12 on 16 tokens (its recurrences
    recorded) and ``certify_lm`` (uniform, k_max 24). Returns (trace,
    recurrence rows, certificates, seconds)."""
    import torch

    from repro_torch import certify as C
    from repro_torch import configs
    from repro_torch.certify.tokens import profile_tokens
    from repro_torch.core import caa
    from repro_torch.core.backend import CaaOps
    from repro_torch.models import transformer as T

    cfg = configs.get(arch).SMOKE
    host = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    params = host if dev == "cpu" else _to_device(host, dev)
    toks = profile_tokens(1, 1, 16, cfg.vocab)
    t0 = time.perf_counter()
    bk = CaaOps(caa.CaaConfig(u_max=SSM_CAA_U, emulate_k=12))
    spy = ScanSpy(torch, bk)
    T.forward(bk, params, cfg, toks.to(dev))
    certs = C.certify_lm(arch, cfg, params, **ZOO_CERT,
                         store=C.CertificateStore(str(root / arch / dev)))
    return bk.trace, spy.rows, certs, time.perf_counter() - t0


def phase_ssm(torch, serve, batching, qmm, fd, T):
    """The recurrent families on the card (see the module docstring)."""
    emit("free", before="ssm", allocated_gb=free_device_memory(torch))
    t_phase = time.perf_counter()
    fns = kernel_fns(qmm, fd)
    parts, launches, spies = {}, {name: 0 for name in fns}, []

    def run(name, fn, *args):
        t0 = time.perf_counter()
        got = fn(*args)
        if isinstance(got, tuple):
            got, more = got
            spies.extend(more)
        parts[name] = got
        parts[name]["seconds"] = time.perf_counter() - t0
        emit(f"ssm_{name}", **parts[name])
        free_device_memory(torch)

    # every path sets the counters to 0 before it runs and reads them
    # after; the phase's launches are the sum of its paths' own counts
    run("rwkv6_1p6b", ssm_rwkv, torch, serve, qmm, T, fns)
    run("hymba_1p5b", ssm_hymba, torch, serve, batching, qmm, fd, T, fns)
    t0 = time.perf_counter()
    rows = new_shape_checks(torch, qmm, spies)
    seen = {(r["kernel"], r["M"], r["N"]) for r in rows}
    want = {(k, M, N) for k in ("quant_matmul_format", "quant_matmul")
            for M in (SERVE_BATCH, SERVE_BATCH * SERVE_PROMPT)
            for N in SSM_NEW_N}
    if not want <= seen:
        raise AssertionError(f"new GEMM shapes not all seen: {sorted(seen)}")
    parts["new_shapes"] = {"rows": rows,
                           "seconds": time.perf_counter() - t0}
    emit("ssm_new_shapes", **parts["new_shapes"])
    del spies
    free_device_memory(torch)
    run("analysis", ssm_analysis, torch, T, fns)
    for counts in _launch_counts(parts):
        for name, n in counts.items():
            launches[name] += n
    emit("ssm", launches=launches, seconds=time.perf_counter() - t_phase)
    return launches, parts


# ---------------------------------------------------------------------------
# the last three families: MiniCPM3 4B (MLA), Whisper medium (encoder-
# decoder) and PaliGemma 3B (vision prefix) through the port's entry points,
# at full width, depth cut to ZOO_LAYERS
# ---------------------------------------------------------------------------

MLA_ENCDEC_ARCHS = ("minicpm3_4b", "whisper_medium", "paligemma_3b")
# SSM_FORMAT's layer* key reaches the products with no sub-scope: Whisper's
# encoder layers and its cross-attention run in layer{i} itself
MLA_FORMAT = SSM_FORMAT
MLA_CHECK_STEPS = (0, SERVE_STEPS - 1)   # decode steps whose latent calls
#                                          are held to kernel 4's plain ones
MLA_FULL_LAYERS = 2               # the full-width analysis pass's depth
MLA_CAA_TOKENS = 8
MLA_FULL_K = 24                   # as SSM_FULL_K
MLA_CERT = {"minicpm3_4b": {}, "whisper_medium": {"mixed": True},
            "paligemma_3b": {"mixed": True}}
# the GEMM shapes kernels 1 and 3 meet first in this phase: MiniCPM3's kv
# latent and rope key (N 288), q latent (768) and q up-projection (40 ×
# 96); PaliGemma's patch projection (K 1,152, SigLIP's width); Whisper's
# encoder and cross k / v at its rows (batch × 1,500 frames)
MLA_NEW_N = (288, 768, 3840)
MLA_PATCH_K = 1152
MLA_ENCODER_M = SERVE_BATCH * 1500
MLA_F32_ROWS = 16        # rows of a kept product held to the fmaf chain


def mla_new_shape(x, w):
    """The key (M, K, N) of a kernel-1 or 3 call at one of the phase's new
    shapes, else None."""
    M, K, N = x.shape[0], x.shape[1], w.shape[1]
    if N in MLA_NEW_N or K == MLA_PATCH_K or M == MLA_ENCODER_M:
        return (M, K, N)
    return None


@contextlib.contextmanager
def spying(module, name, spy):
    """``spy`` stands in for ``module.name`` while the block runs."""
    setattr(module, name, spy)
    try:
        yield spy
    finally:
        setattr(module, name, spy.fn)


def mla_serves(torch, serve, qmm, fns, arch, fd_spy=None, fd=None):
    """``arch`` served through ``serve.main`` under MLA_FORMAT and at k =
    12 (batch 4 × 128 × 16, full width, ZOO_LAYERS depth), kernels 1 and 3 spied
    at the phase's new shapes and ``f32_matmul`` at every shape (the LM
    head, MiniCPM3's block-diagonal tables), ``fd_spy`` standing in for
    kernel 4 on the k path; then every kept input held to its plain
    version (:func:`new_shape_checks`). Returns (reports by path with
    ``new_shapes``, the k path's result)."""
    from repro_torch.kernels import row_order as ro

    out, res = {}, None
    f32 = NewShapeSpy(ro.f32_matmul, lambda x, w: (
        x.shape[0], x.shape[1], w.shape[1]), copy_w=False)
    spies = [("f32_matmul", f32)]
    for path, extra, kernel in (
            ("format", ["--layer-format", json.dumps(MLA_FORMAT)],
             "quant_matmul_format"),
            ("k", ["--precision-k", str(SERVE_K)], "quant_matmul")):
        del res
        free_device_memory(torch)
        spy = NewShapeSpy(getattr(qmm, kernel), mla_new_shape)
        spies.append((kernel, spy))
        with contextlib.ExitStack() as stack:
            stack.enter_context(spying(qmm, kernel, spy))
            stack.enter_context(spying(ro, "f32_matmul", f32))
            if path == "k" and fd_spy is not None:
                stack.enter_context(spying(fd, "flash_decode_attention",
                                           fd_spy))
            res, out[f"serve_{path}"] = run_zoo_serve(
                torch, serve, fns, arch, path, extra,
                expected_of=mla_encdec_expected)
    out["serve_format"]["format_map"] = MLA_FORMAT
    out["new_shapes"] = {"rows": new_shape_checks(torch, qmm, spies,
                                                  MLA_F32_ROWS)}
    del spies, f32, spy
    return out, res


def mla_encdec_expected(cfg, path, forwards, steps, stub=None):
    """Exact launches of ``forwards`` forwards (``steps`` of them decode
    steps; ``stub`` of them carry the modality stub's inputs, default the
    prefills ``forwards - steps``) of MiniCPM3, Whisper or PaliGemma on a
    serving path ("format", "k" or "plain"). MiniCPM3: 7 GEMMs a layer (q
    down and up, the latent down, o; gate, up, down), 4 rmsnorms (ln1, the
    q and kv latent norms, ln2), 2 ``f32_matmul`` a layer of a decode step
    (the per-head weight products into and out of the latent space; a
    prefill's are library products), its decode
    attention through kernel 4 on every path (the reference composes MLA
    unrounded). Whisper: 11 GEMMs a decoder layer (self-attention q, k, v,
    o; cross-attention q, k, v, o; the MLP's 3), 3 LayerNorms of 2 means
    (ln1, ln1 again before the cross-attention, ln2) and the final rmsnorm;
    an encode (one a prefill) the frame projection and 7 GEMMs and 2
    LayerNorms an encoder layer, then its rmsnorm. PaliGemma: 7 GEMMs and 2
    rmsnorms a layer, the patch projection once a prefill. Whisper's and
    PaliGemma's decode attention through kernel 2 on the format path, else
    kernel 4; every forward's LM head one ``f32_matmul`` (the plain path's
    GEMMs too)."""
    stub = forwards - steps if stub is None else stub
    L = cfg.n_layers
    f32 = forwards
    if cfg.mla:
        gemms, means = 7 * L * forwards, (4 * L + 1) * forwards
        f32 += 2 * L * steps
    elif cfg.enc_dec:
        Le = cfg.n_enc_layers
        gemms = 11 * L * forwards + (7 * Le + 1) * stub
        means = (6 * L + 1) * forwards + (4 * Le + 1) * stub
    else:
        gemms, means = 7 * L * forwards + stub, (2 * L + 1) * forwards
    attn = L * steps
    certified = path == "format" and not cfg.mla
    return {"quant_matmul_format": gemms if path == "format" else 0,
            "flash_decode_certified": attn if certified else 0,
            "quant_matmul": gemms if path == "k" else 0,
            "flash_decode_attention": 0 if certified else attn,
            **IDLE_ON_SERVING, "row_mean": means,
            "f32_matmul": f32 + (gemms if path == "plain" else 0)}


class LatentCheckSpy(KernelSpy):
    """Stands in for kernel 4 while MiniCPM3's k path runs: launches it,
    then holds the calls of the MLA_CHECK_STEPS decode steps (every layer's
    latent attention: one kv head of keys [c | k_rope], the scale (d_nope +
    d_rope)^-½) against both plain versions at that scale, a row a checked
    call."""

    def __init__(self, torch, fd, n_layers):
        super().__init__(fd.flash_decode_attention, None, None)
        self.torch, self.fd, self.n_layers = torch, fd, n_layers
        self.rows, self.calls = [], 0

    def __call__(self, q, k, v, lengths, window=0, softcap=0.0, scale=0.0):
        out = self.fn(q, k, v, lengths, window=window, softcap=softcap,
                      scale=scale)
        step = self.calls // self.n_layers
        self.calls += 1
        if step in MLA_CHECK_STEPS:
            st = check_flash_windowed(self.torch, self.fd, out, q, k, v,
                                      lengths, window, softcap,
                                      f"latent call {self.calls - 1}",
                                      scale=scale)
            self.rows.append({"step": step, "shape": list(q.shape),
                              "Smax": k.shape[1], "scale": scale,
                              "lengths": lengths.tolist(),
                              "max_abs_err": st["max_abs_err"],
                              "f64_max_abs_err": st["f64_max_abs_err"]})
        return out


def engine_alone(torch, serve, batching, fns, cfg, arch, params):
    """The batching engine at 4 lanes under MLA_FORMAT (PaliGemma's
    text-only: requests carry no patches, as in the reference's engine),
    every launch counted, every request's tokens and logits against the
    request alone; raises unless all are bit for bit. Returns the
    report."""
    sc = serve.ServeConfig(arch=arch, batch=BATCH_ENGINE["n_lanes"],
                           max_seq=BATCH_ENGINE["max_seq"],
                           precision_layer_format=MLA_FORMAT, device="cuda")
    reqs = engine_requests(torch, batching, cfg.vocab)
    engine, responses, launches, registry, wall = run_batching(
        torch, batching, fns, cfg, sc, params, reqs, None, -1,
        lambda eng, admitted: mla_encdec_expected(
            cfg, "format", admitted + eng.steps, eng.steps, stub=0))
    ref = reference_runs(batching, cfg, sc, params, reqs, -1)
    rows = lane_bits(torch, responses, ref)
    if not all(r["tokens_equal"] and r["logits_bitwise"] for r in rows):
        raise AssertionError(f"{arch} batching: a request's bits differ "
                             f"from the request alone: {rows}")
    return dict(batching_report(engine, responses, registry, wall),
                launches=launches, prompts=[len(r.prompt) for r in reqs],
                lanes_vs_alone=rows), sc


def mla_minicpm3(torch, serve, batching, qmm, fd, T, fns):
    """MiniCPM3 4B at full width, depth ZOO_LAYERS: served under the format map
    and at k = 12 (batch 4 × 128 × 16, :func:`mla_serves`), the k path's
    latent decode attention held against kernel 4's plain versions at two
    steps, its last decode logits against a full forward
    (:func:`decode_vs_full`); the batching engine under the format map,
    every request bit for bit alone; every op of a ragged decode step
    against each lane alone;
    and the library products of the absorbed attention, lane by lane (the
    measurement that routes them)."""
    spy = LatentCheckSpy(torch, fd, ZOO_LAYERS["minicpm3_4b"])
    out, res = mla_serves(torch, serve, qmm, fns, "minicpm3_4b", spy, fd)
    out["decode_vs_full"] = decode_vs_full(torch, serve, T, res)
    cfg, params = res.cfg, res.params          # the same seed-0 weights
    del res
    if len(spy.rows) != cfg.n_layers * len(MLA_CHECK_STEPS):
        raise AssertionError(f"minicpm3 latent calls checked: "
                             f"{len(spy.rows)}")
    out["serve_k"].update(
        note="decode timings include the checks of two steps' latent calls",
        latent_calls_checked=len(spy.rows),
        latent_shape=spy.rows[0]["shape"], latent_scale=spy.rows[0]["scale"],
        max_abs_err=max(r["max_abs_err"] for r in spy.rows),
        f64_max_abs_err=max(r["f64_max_abs_err"] for r in spy.rows))
    del spy
    free_device_memory(torch)
    out["batching"], sc = engine_alone(torch, serve, batching, fns, cfg,
                                       "minicpm3_4b", params)
    free_device_memory(torch)
    ops = op_lane_bits(torch, serve, T, cfg, params, serve._backend(sc))
    out["step_op_lane_bits"] = ops
    out["library_lane_bits"] = mla_lane_bits(torch, cfg)
    del params
    free_device_memory(torch)
    if ops["differing"]:
        raise AssertionError(f"minicpm3 decode step: a lane's ops differ "
                             f"from the lane alone: {ops}")
    return out


def decode_vs_full(torch, serve, T, res):
    """A k-path serve's last decode logits against one full forward (no
    cache) of the same tokens and the stub's inputs on the same backend:
    within SSM_LONG_TOL · max |logit|, the argmax equal unless the top two
    lie within twice the difference (the decode's attention runs in a
    kernel's order, the full forward's composed, and a k = 12 rounding
    that flips moves a logit further); raises otherwise. Returns the
    report."""
    seq = torch.cat([res.prompt, res.tokens[:, :SERVE_STEPS]], dim=1)
    bk = serve._backend(serve.ServeConfig(precision_k=SERVE_K,
                                          device="cuda"))
    stub = {}
    if res.frontend is not None:
        stub = {"enc_embeds" if res.cfg.frontend == "audio"
                else "frontend_embeds": res.frontend}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        full, _ = T.forward(bk, res.params, res.cfg, seq, **stub)
    torch.cuda.synchronize()
    got, want = res.decode_logits[-1].double(), full[:, -1].double()
    del full
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    top2 = torch.topk(want, 2, dim=-1).values
    gap = float((top2[:, 0] - top2[:, 1]).min())
    agree = bool((got.argmax(-1) == want.argmax(-1)).all())
    report = dict(
        path="k", full_forward_tokens=seq.shape[1],
        stub_positions=0 if res.frontend is None else res.frontend.shape[1],
        full_forward_s=time.perf_counter() - t0, max_abs_dlogit=err,
        max_abs_logit=scale, tolerance=SSM_LONG_TOL * scale,
        argmax_agrees=agree, top1_gap=gap)
    if not err <= SSM_LONG_TOL * scale or not (agree or gap <= 2 * err):
        raise AssertionError(f"{res.cfg.name} decode against its full "
                             f"forward: {report}")
    return report


def mla_whisper(torch, serve, batching, qmm, T, fns):
    """Whisper medium at full width, decoder depth ZOO_LAYERS (24 encoder and 2 decoder
    layers, 1,500 frames): served under the format map and at k = 12
    (batch 4 × 128 × 16, :func:`mla_serves`; the frames encoded once, the
    encoder states reused by every step); the k path's last decode logits
    held against one full forward of the same tokens and frames
    (:func:`decode_vs_full`); the batching engine refuses it (no encoder
    input)."""
    out, res = mla_serves(torch, serve, qmm, fns, "whisper_medium")
    out["decode_vs_full"] = decode_vs_full(torch, serve, T, res)
    cfg, params = res.cfg, res.params
    del res
    sc = serve.ServeConfig(arch="whisper_medium", batch=4, device="cuda")
    try:
        batching.ContinuousBatchingEngine(cfg, sc, params, device="cuda",
                                          **BATCH_ENGINE)
    except NotImplementedError as e:
        out["batching"] = {"raises": "NotImplementedError", "reason": str(e)}
    else:
        raise AssertionError("whisper: the batching engine did not refuse "
                             "an encoder-decoder model")
    del params
    return out


def mla_paligemma(torch, serve, batching, qmm, T, fns):
    """PaliGemma 3B at full width, depth ZOO_LAYERS: served under the format map
    and at k = 12 (batch 4, 256 patches + 128 tokens, 16 steps,
    :func:`mla_serves`), its last decode logits against a full forward
    over the patches and tokens (:func:`decode_vs_full`); then the batching
    engine text-only under the format map, every request bit for bit
    alone."""
    out, res = mla_serves(torch, serve, qmm, fns, "paligemma_3b")
    out["serve_k"]["cache_positions"] = res.config.max_seq
    out["decode_vs_full"] = decode_vs_full(torch, serve, T, res)
    cfg, params = res.cfg, res.params
    del res
    free_device_memory(torch)
    out["batching"], _ = engine_alone(torch, serve, batching, fns, cfg,
                                      "paligemma_3b", params)
    del params
    return out


def mla_analysis(torch, T, fns):
    """The three SMOKE configs analysed (``CaaOps`` at emulated k = 12 on
    ``certify_lm``'s profile and the stub's inputs it draws) and certified
    (MiniCPM3 uniform; Whisper and PaliGemma through the stacked pipeline,
    the one that passes the stub's inputs) on the card and on the CPU with
    the same weights: trace records within 1e-9 relative, decisions equal.
    Then MiniCPM3 at full width cut to MLA_FULL_LAYERS layers through one
    ``CaaOps`` pass on 8 tokens at f32's u: seconds, peak memory, the
    logits' bound."""
    from repro_torch import configs
    from repro_torch.certify.tokens import profile_tokens
    from repro_torch.core import caa
    from repro_torch.core.backend import CaaOps

    out = {}
    reset_launches(fns)
    for arch in MLA_ENCDEC_ARCHS:
        cpu = cpu_job("mla", arch)
        traces, certs, secs = {}, {}, {}
        traces["cuda"], certs["cuda"], secs["cuda"] = card_job(
            "mla", arch, fns)
        traces["cpu"], certs["cpu"], secs["cpu"] = cpu.result()
        worst = 0.0
        if ([(r.name, r.kind) for r in traces["cuda"]]
                != [(r.name, r.kind) for r in traces["cpu"]]):
            raise AssertionError(f"{arch}: the records differ")
        for ra, rb in zip(traces["cuda"], traces["cpu"]):
            for f in ("max_dbar", "max_ebar"):
                x, y = getattr(ra, f), getattr(rb, f)
                if not same_bound(x, y, CERT_REL_TOL):
                    raise AssertionError(f"{arch} {ra.name} {f}: {x} on the "
                                         f"card, {y} on the CPU")
                if math.isfinite(x) and x != y:
                    worst = max(worst, abs(x - y) / max(abs(x), abs(y)))
        if cert_decisions(certs["cuda"]) != cert_decisions(certs["cpu"]):
            raise AssertionError(f"certify {arch}: card decides "
                                 f"{cert_decisions(certs['cuda'])}, CPU "
                                 f"{cert_decisions(certs['cpu'])}")
        out[arch] = {"trace_records": len(traces["cuda"]), "worst_rel": worst,
                     "certify": {"uniform": not MLA_CERT[arch], **MLA_CERT[
                         arch]},
                     "certificate": cert_summary(certs["cuda"]),
                     "seconds": secs}
    out["launches"] = read_launches(fns)
    cfg = dataclasses.replace(configs.get("minicpm3_4b").FULL,
                              n_layers=MLA_FULL_LAYERS)
    free_device_memory(torch)
    params = T.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    toks = profile_tokens(1, 1, MLA_CAA_TOKENS, cfg.vocab).to("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    u = 2.0 ** (1 - MLA_FULL_K)
    bk = CaaOps(caa.CaaConfig(u_max=u, emulate_k=MLA_FULL_K))
    logits, _ = T.forward(bk, params, cfg, toks)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    a_abs, _ = caa.actual_error_in_u(logits, u)
    d, e = caa.worst(logits)
    probs = [r for r in bk.trace if r.kind == "softmax"]
    out["minicpm3_4b_full"] = {
        "config": f"minicpm3_4b.FULL cut to {MLA_FULL_LAYERS} layers",
        "tokens": MLA_CAA_TOKENS, "emulate_k": MLA_FULL_K, "seconds": secs,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "logits_dbar": d, "logits_ebar": e,
        "logits_actual_abs_u": float(a_abs.max()),
        "attn_probs_dbar": [r.max_dbar for r in probs]}
    if len(probs) != MLA_FULL_LAYERS or not math.isfinite(
            float(a_abs.max())):
        raise AssertionError(f"minicpm3 full width: {out['minicpm3_4b_full']}")
    del params, logits, bk
    return out


def mla_smoke_side(arch, dev, root):
    """One device's half of ``mla_analysis``'s SMOKE check of ``arch``: the
    CaaOps forward at emulated k = 12 on ``certify_lm``'s profile and the
    stub's inputs, and ``certify_lm`` (MLA_CERT's pipeline). Returns
    (trace, certificates, seconds)."""
    import torch

    from repro_torch import certify as C
    from repro_torch import configs
    from repro_torch.certify.lm import frontend_kwargs
    from repro_torch.certify.tokens import profile_tokens
    from repro_torch.core import caa
    from repro_torch.core.backend import CaaOps
    from repro_torch.models import transformer as T

    cfg = configs.get(arch).SMOKE
    host = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    params = host if dev == "cpu" else _to_device(host, dev)
    b = ZOO_CERT["batch"]
    toks = profile_tokens(1, b, ZOO_CERT["seq"], cfg.vocab)
    t0 = time.perf_counter()
    bk = CaaOps(caa.CaaConfig(u_max=ZOO_CAA_U, emulate_k=12))
    T.forward(bk, params, cfg, toks.to(dev),
              **frontend_kwargs(cfg, b, 0, dev))
    certs = C.certify_lm(arch, cfg, params, **ZOO_CERT, **MLA_CERT[arch],
                         store=C.CertificateStore(str(root / arch / dev)))
    return bk.trace, certs, time.perf_counter() - t0


def phase_mla_encdec(torch, serve, batching, qmm, fd, T):
    """The last three families on the card (see the module docstring)."""
    emit("free", before="mla_encdec", allocated_gb=free_device_memory(torch))
    t_phase = time.perf_counter()
    fns = kernel_fns(qmm, fd)
    parts, launches = {}, {name: 0 for name in fns}

    def run(name, fn, *args):
        t0 = time.perf_counter()
        parts[name] = fn(*args)
        parts[name]["seconds"] = time.perf_counter() - t0
        emit(f"mla_encdec_{name}", **parts[name])
        free_device_memory(torch)

    # every path sets the counters to 0 before it runs and reads them
    # after; the phase's launches are the sum of its paths' own counts
    run("minicpm3_4b", mla_minicpm3, torch, serve, batching, qmm, fd, T,
        fns)
    run("whisper_medium", mla_whisper, torch, serve, batching, qmm, T, fns)
    run("paligemma_3b", mla_paligemma, torch, serve, batching, qmm, T, fns)
    run("analysis", mla_analysis, torch, T, fns)
    for counts in _launch_counts(parts):
        for name, n in counts.items():
            launches[name] += n
    emit("mla_encdec", launches=launches,
         seconds=time.perf_counter() - t_phase)
    return launches, parts


TRAIN_SMOKE = {"seq": 16, "global_batch": 2}
TRAIN_MODE_STEPS = 3
TRAIN_FULL = ["--size", "full", "--seq", "512", "--global-batch", "4",
              "--device", "cuda"]
TRAIN_LOSS_REL = 1e-5             # card against CPU, as the CPU tests hold
TRAIN_GRAD_REL = 1e-4             # a leaf, of its max |g|
# leaves whose gradient is zero analytically (Llama-4's router under
# top-1: the renormalised gate is p / p), held to the tree's max |g|
TRAIN_ZERO_GRAD = {"llama4_maverick": {("layers", "moe", "w_router")}}


def _tree_to(tree, dev):
    return {k: _tree_to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def grads_card_vs_cpu(torch, arch, card, cpu):
    """(loss, grads) on the card against the CPU port's: the loss within
    TRAIN_LOSS_REL relative, each leaf within TRAIN_GRAD_REL of its max
    |g| (TRAIN_ZERO_GRAD's leaves of the tree's); returns the worst
    leaf's error over its scale."""
    from repro_torch.optim.optimizer import tree_paths

    (cl, cg), (hl, hg) = card, cpu
    if abs(float(cl) - float(hl)) > TRAIN_LOSS_REL * abs(float(hl)):
        raise AssertionError(f"train {arch}: loss {float(cl)} on the card, "
                             f"{float(hl)} on the CPU")
    hg = dict(tree_paths(hg))
    tree_max = max(float(g.abs().max()) for g in hg.values())
    worst = 0.0
    for path, g in tree_paths(cg):
        want = hg[path]
        scale = float(want.abs().max())
        if path in TRAIN_ZERO_GRAD.get(arch, ()):
            scale = tree_max
        err = float((g.cpu() - want).abs().max())
        if not (torch.isfinite(g).all() and err <= TRAIN_GRAD_REL * scale):
            raise AssertionError(f"train {arch}: grad {'/'.join(path)} "
                                 f"{err} against scale {scale}")
        worst = max(worst, err / scale if scale else err)
    return worst


def train_smoke_grads(torch, train, T, configs):
    """Phase (a): every arch's SMOKE loss and grads on the card, remat on
    and off (bit for bit), against the CPU port's on the same params and
    batch."""
    from repro_torch.data import pipeline
    from repro_torch.optim.optimizer import tree_paths

    out = {}
    for arch in configs.ARCHS:
        cfg = configs.get(arch).SMOKE
        params = T.init_params(cfg, generator=torch.Generator().manual_seed(
            0), device="cpu")
        batch = train.batch_for(cfg, pipeline.DataConfig(
            vocab=cfg.vocab, seq=TRAIN_SMOKE["seq"],
            global_batch=TRAIN_SMOKE["global_batch"]), 0, "cpu")
        runs = {}
        for where, remat in (("card", True), ("card_plain", False),
                             ("cpu", True)):
            dev = "cpu" if where == "cpu" else "cuda"
            tc = train.TrainConfig(remat=remat, **TRAIN_SMOKE)
            t0 = time.perf_counter()
            with train.deterministic():
                runs[where] = train.loss_and_grads(
                    train.make_loss_fn(cfg, tc), _tree_to(params, dev),
                    _tree_to(batch, dev))
            runs[where + "_s"] = time.perf_counter() - t0
        a, b = (dict(tree_paths(runs[k][1])) for k in ("card", "card_plain"))
        remat_bitwise = torch.equal(runs["card"][0], runs["card_plain"][0]) \
            and all(torch.equal(g, b[p]) for p, g in a.items())
        if not remat_bitwise:
            raise AssertionError(f"train {arch}: remat changed the card's "
                                 "grads")
        out[arch] = {"loss_card": float(runs["card"][0]),
                     "loss_cpu": float(runs["cpu"][0]),
                     "worst_grad_rel": grads_card_vs_cpu(
                         torch, arch, runs["card"], runs["cpu"]),
                     "remat_bitwise": remat_bitwise,
                     "card_s": runs["card_s"], "cpu_s": runs["cpu_s"]}
    return out


def train_modes(torch, train, T, configs):
    """Phase (b): three steps of SMOKE Qwen2-7B with 8-bit moments and
    three with error-feedback compression, card against CPU (the losses;
    params after Adam are not held, as in the CPU tests)."""
    from repro_torch.data import pipeline
    from repro_torch.optim import optimizer as opt

    cfg = configs.get("qwen2_7b").SMOKE
    out = {}
    for mode in ("quantized_moments", "grad_compression"):
        tc = train.TrainConfig(steps=TRAIN_MODE_STEPS, **{mode: True},
                               **TRAIN_SMOKE)
        adam = opt.AdamWConfig(quantized_moments=tc.quantized_moments,
                               total_steps=tc.steps)
        dc = pipeline.DataConfig(vocab=cfg.vocab, seq=tc.seq,
                                 global_batch=tc.global_batch)
        params = T.init_params(cfg, generator=torch.Generator().manual_seed(
            0), device="cpu")
        losses = {}
        for dev in ("cuda", "cpu"):
            step_fn, _ = train.build_train_step(cfg, tc, dev, adam)
            state = train.init_state(_tree_to(params, dev), tc, adam)
            losses[dev] = [float(step_fn(state, train.batch_for(
                cfg, dc, i, dev))[1]) for i in range(tc.steps)]
        for a, b in zip(losses["cuda"], losses["cpu"]):
            if abs(a - b) > TRAIN_LOSS_REL * abs(b):
                raise AssertionError(f"train {mode}: losses {losses}")
        out[mode] = losses
    return out


def train_report(res, tokens):
    return {"losses": {str(k): v for k, v in res.losses.items()},
            "first_step_ms": 1e3 * res.step_s[0],
            "step_ms": 1e3 * statistics.median(res.step_s[1:]),
            "tokens_per_s": res.tokens_per_s, "tokens_per_step": tokens,
            "peak_gb": res.peak_gb}


def train_full(torch, train, T, configs):
    """Phases (c) and (d): Qwen2-7B at full width through ``train.main``:
    2 layers, 6 steps with a checkpoint every 3, then again resumed from
    step 3 (losses and final params bit for bit the uninterrupted run's);
    then 8 layers for 3 steps."""
    import shutil

    cfg = dataclasses.replace(configs.get("qwen2_7b").FULL, n_layers=2)
    n_params = T.analytic_params(cfg)
    ck_dir = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(ck_dir, ignore_errors=True)
    ck_dir.mkdir(parents=True)
    need = 2 * 3 * 4 * n_params                 # two of (param, m, v)
    free = shutil.disk_usage(ck_dir).free
    if free < need * 1.05:
        raise AssertionError(f"train: the two checkpoints need {need:,} "
                             f"bytes; {ck_dir} has {free:,} free")
    argv = TRAIN_FULL + ["--max-layers", "2", "--steps", "6",
                         "--checkpoint-dir", str(ck_dir)]
    tokens = 4 * 512
    try:
        a = train.main(argv + ["--checkpoint-every", "3"])
        want_params = a.state["params"]
        a_report = train_report(a, tokens)
        a_report["checkpoints"] = a.checkpoints
        del a
        free_device_memory(torch)
        # the resumed run writes no checkpoint of its own
        b = train.main(argv + ["--checkpoint-every", "1000", "--resume", "3"])
        same_losses = all(b.losses[i] == float(a_report["losses"][str(i)])
                          for i in (3, 4, 5))
        from repro_torch.optim.optimizer import tree_paths
        got = dict(tree_paths(b.state["params"]))
        same_params = all(torch.equal(t, got[p])
                          for p, t in tree_paths(want_params))
        b_report = {"losses": {str(k): v for k, v in b.losses.items()},
                    "restore_s": b.restore_s, "peak_gb": b.peak_gb,
                    "same_losses": same_losses, "same_params": same_params}
        del b, want_params, got
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    if not (same_losses and same_params):
        raise AssertionError(f"train: the resumed run differs: {b_report}")
    free_device_memory(torch)
    d = train.main(TRAIN_FULL + ["--max-layers", "8", "--steps", "3"])
    d_report = train_report(d, tokens)
    del d
    free_device_memory(torch)
    return {"params_2_layers": n_params,
            "params_8_layers": T.analytic_params(
                dataclasses.replace(cfg, n_layers=8)),
            "layers2": a_report, "layers2_resumed": b_report,
            "layers8": d_report}


def phase_train(torch, qmm, fd, T):
    """Training on the card (see the module docstring): no hand-written
    kernel may launch on any of its runs."""
    from repro_torch import configs
    from repro_torch.launch import train

    emit("free", before="train", allocated_gb=free_device_memory(torch))
    t_phase = time.perf_counter()
    fns = kernel_fns(qmm, fd)
    reset_launches(fns)
    parts = {}
    for name, fn in (("smoke_grads", train_smoke_grads),
                     ("modes", train_modes), ("full", train_full)):
        t0 = time.perf_counter()
        parts[name] = fn(torch, train, T, configs)
        parts[name + "_s"] = time.perf_counter() - t0
    launches = read_launches(fns)
    if any(launches.values()):
        raise AssertionError(f"train launched kernels: {launches}")
    emit("train", card=nvidia_smi_line(), launches=launches,
         seconds=time.perf_counter() - t_phase, **parts)
    return launches, parts


# ---------------------------------------------------------------------------
# the device mesh: the engine and training on the card's 1 × 1 mesh, and the
# column and head shards of a wider mesh, kernel by kernel
# ---------------------------------------------------------------------------

MESH_SPLITS = (2, 4, 8)            # "model" sizes the shard checks split
MESH_TRAIN_STEPS = 3
MESH_TRAIN_MODES = ("fsdp", "tp")
MESH_TRAIN_SEQ, MESH_TRAIN_BATCH = 512, 4
MESH_PROJ = {"wq": "attn", "wk": "attn", "wv": "attn", "wo": "attn",
             "w_gate": "mlp", "w_up": "mlp", "w_down": "mlp"}


def mesh_engine(torch, batching, fns, cfg, params, mesh, handoff):
    """The continuous-batching engine on ``mesh`` with ``batching``'s
    requests, the format map then k = 12: every request's tokens and logit
    sha256 and the launch counts must equal ``batching``'s."""
    reqs, too_long = batching_requests(torch, batching, cfg.vocab)
    out = {}
    for path, sc, certset, eos_id, run in (
            ("format", handoff["sc"], handoff["certset"], handoff["eos_id"],
             reqs + [too_long]),
            ("k", handoff["sc_k"], None, -1, reqs[:BATCH_K_REQUESTS])):
        engine = batching.ContinuousBatchingEngine(
            cfg, sc, params, certset=certset, eos_id=eos_id, device="cuda",
            keep_logits=True, mesh=mesh, **BATCH_ENGINE)
        torch.cuda.synchronize()
        reset_launches(fns)
        t0 = time.perf_counter()
        responses = engine.run(run)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches(fns)
        got, want = served_digests(responses), handoff[path]
        equal = sorted(rid for rid, w in want["requests"].items()
                       if got.get(rid) == w)
        out[path] = {"launches": launches,
                     "launches_equal_batching": launches == want["launches"],
                     "requests": sorted(got),
                     "equal_to_batching": equal, "steps": engine.steps,
                     "wall_s": wall, "decode_ms_per_step":
                         1e3 * engine.decode_s / max(engine.steps, 1)}
        del engine, responses
        if launches != want["launches"] or sorted(got) != equal \
                or sorted(got) != sorted(want["requests"]):
            raise AssertionError(f"mesh engine, {path}: {out[path]} against "
                                 f"batching's launches {want['launches']}")
    return out


def mesh_shards(torch, qmm, fd, params):
    """What column and head parallelism rely on, on the card: for "model"
    sizes MESH_SPLITS, kernels 1 and 3 on each column shard of layer 0's
    seven projections at M = 4 and 512 and ``f32_matmul`` on each vocab
    shard of the LM head (the route ``TorchOps.einsum`` takes, through a
    transposed table) give the same columns of the whole product bit for
    bit; kernels 2 and 4 on each KV-head shard of the serve cache give the
    same heads of the whole call bit for bit (a split that does not divide
    the heads is not made, as the lane rule makes none)."""
    from repro_torch.kernels import row_order as ro

    gen = torch.Generator(device="cuda").manual_seed(11)
    fmt = FORMATS["k12_e15"]
    kernels = {"quant_matmul_format": lambda x, w: qmm.quant_matmul_format(
                   x, w, fmt, has_subnormals=True, saturating=True),
               "quant_matmul": lambda x, w: qmm.quant_matmul(x, w,
                                                             k=SERVE_K)}
    rows, bad = [], []

    def shards(what, whole, part, n, m, dim):
        step = n // m
        ok = all(same_bits(torch, part(r * step, (r + 1) * step),
                           whole.narrow(dim, r * step, step))
                 for r in range(m))
        rows.append({"what": what, "model": m, "bitwise": ok})
        if not ok:
            bad.append(rows[-1])

    layer = params["layers"]
    for M in (SERVE_BATCH, 512):
        for name, sub in MESH_PROJ.items():
            w = layer[sub][name][0]
            x = torch.randn(M, w.shape[0], generator=gen, device="cuda")
            for kname, fn in kernels.items():
                whole = fn(x, w)
                for m in MESH_SPLITS:
                    shards(f"{kname} {name} M={M}", whole,
                           lambda a, b: fn(x, w[:, a:b].contiguous()),
                           w.shape[1], m, 1)
    table = params["head"]
    x = torch.randn(SERVE_BATCH, 1, table.shape[1], generator=gen,
                    device="cuda")
    whole = ro.lm_head_dispatch(x, ro.transposed(table))
    for m in MESH_SPLITS:
        shards("f32_matmul head", whole,
               lambda a, b: ro.lm_head_dispatch(x, ro.transposed(table[a:b])),
               table.shape[0], m, 2)
    del whole
    S, lengths = FLASH_CASES["serve_last"]
    B, K, G, D = SERVE_BATCH, 4, 7, 128
    q = torch.randn(B, K, G, D, generator=gen, device="cuda")
    k = torch.randn(B, S, K, D, generator=gen, device="cuda")
    v = torch.randn(B, S, K, D, generator=gen, device="cuda")
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    flash = {"flash_decode_certified": lambda q, k, v:
             fd.flash_decode_certified(q, k, v, lens, fmt,
                                       has_subnormals=True, saturating=True),
             "flash_decode_attention": lambda q, k, v:
             fd.flash_decode_attention(q, k, v, lens)}
    for kname, fn in flash.items():
        whole = fn(q, k, v)
        for m in MESH_SPLITS:
            if K % m:
                rows.append({"what": f"{kname} serve cache", "model": m,
                             "bitwise": None, "note": f"{K} kv heads: not "
                             "split"})
                continue
            shards(f"{kname} serve cache", whole,
                   lambda a, b: fn(q[:, a:b].contiguous(),
                                   k[:, :, a:b].contiguous(),
                                   v[:, :, a:b].contiguous()), K, m, 1)
    torch.cuda.synchronize()
    if bad:
        raise AssertionError(f"mesh shards differ from the whole: {bad}")
    return rows


def mesh_train_cfg():
    """The mesh phase's training config: Qwen2-7B at full width, 2
    layers."""
    from repro_torch import configs

    return dataclasses.replace(configs.get("qwen2_7b").FULL, n_layers=2)


def _state_bytes(tree):
    """Bytes of this rank's blocks of a tree of tensors and DTensors."""
    total = 0
    for t in _leaves(tree if not hasattr(tree, "_fields") else
                     {f: getattr(tree, f) for f in tree._fields}):
        if t is None:
            continue
        t = t.to_local() if hasattr(t, "to_local") else t
        total += t.numel() * t.element_size()
    return total


def mesh_train(torch, T, mesh, want_losses, train_peak_gb=None,
               dry_train=None):
    """Qwen2-7B at full width cut to 2 layers, MESH_TRAIN_STEPS steps of
    ``build_train_step`` on ``mesh`` with each ``param_sharding``, the
    ``train`` phase's run's config, seed and stream, through the mesh
    step's per-layer path (each layer's params gathered inside its
    checkpointed region; no collective on the 1 × 1 mesh's axes): the
    losses must equal that run's bit for bit. Each run's
    ``max_memory_allocated`` is reported beside the ``train`` phase's peak
    (not gated). ``dry_train``: the dry run's record of the same step on a
    fake 1 × 1 group, whose params and optimizer bytes must equal the
    state's the card allocated under "fsdp", exactly."""
    from repro_torch.data import pipeline
    from repro_torch.launch import train
    from repro_torch.optim import optimizer as opt

    cfg = mesh_train_cfg()
    dev = torch.device("cuda")
    steps = 6                              # the train phase's schedule
    dc = pipeline.DataConfig(vocab=cfg.vocab, seq=MESH_TRAIN_SEQ,
                             global_batch=MESH_TRAIN_BATCH, seed=0)
    out = {}
    for mode in MESH_TRAIN_MODES:
        tc = train.TrainConfig(arch="qwen2_7b", smoke=False,
                               seq=MESH_TRAIN_SEQ,
                               global_batch=MESH_TRAIN_BATCH, steps=steps,
                               param_sharding=mode)
        torch.cuda.reset_peak_memory_stats()
        step_fn, init_fn = train.build_train_step(
            cfg, tc, dev, opt.AdamWConfig(total_steps=steps), mesh=mesh)
        state = init_fn(torch.Generator(device=dev).manual_seed(0))
        card = {"params": _state_bytes(state["params"]),
                "opt": _state_bytes(state["opt"])}
        losses, t0 = [], time.perf_counter()
        for step in range(MESH_TRAIN_STEPS):
            state, loss = step_fn(state, train.batch_for(cfg, dc, step, dev))
            losses.append(float(loss))
        out[mode] = {"losses": losses, "seconds": time.perf_counter() - t0,
                     "equal_to_train": losses == want_losses,
                     "state_bytes": card,
                     "max_memory_allocated_gb":
                         torch.cuda.max_memory_allocated() / 1e9,
                     "train_phase_peak_gb": train_peak_gb}
        del state, step_fn, init_fn
        free_device_memory(torch)
        if losses != want_losses:
            raise AssertionError(f"mesh train {mode}: losses {losses}, the "
                                 f"train phase's {want_losses}")
        if mode == "fsdp" and dry_train is not None:
            parts = dry_train["argument_parts"]
            dry = {"params": parts["params"], "opt": parts["opt"]}
            if dry != card:
                raise AssertionError(f"mesh train: the dry run's state "
                                     f"{dry} != the card's {card}")
            out[mode].update(dry_run_state_bytes=dry,
                             dry_run_equal_to_card=True,
                             dry_run_peak_gb=dry_train["peak_bytes"] / 1e9)
    return out


def phase_mesh(torch, batching, qmm, fd, T, handoff, train_losses,
               train_peak_gb=None, dry_train=None):
    """The device mesh on the card, whose process has one device: the
    engine on the 1 × 1 serving mesh (``batching``'s requests and results,
    bit for bit), the per-shard bits a wider mesh relies on, and training on
    the 1 × 1 mesh under each ``param_sharding`` (``train``'s losses bit
    for bit; the dry run's state bytes the card's, :func:`mesh_train`).
    Returns the engine runs' launches (the path's)."""
    from repro_torch import configs
    from repro_torch.launch import mesh as meshlib

    emit("free", before="mesh", allocated_gb=free_device_memory(torch))
    t_phase = time.perf_counter()
    fns = kernel_fns(qmm, fd)
    mesh = meshlib.make_serving_mesh(device="cuda")
    shape = meshlib.mesh_shape(mesh)
    if shape != {"data": 1, "model": 1}:
        raise AssertionError(f"the card's serving mesh is {shape}")
    cfg = configs.get("qwen2_7b").FULL
    params = T.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    engine = mesh_engine(torch, batching, fns, cfg, params, mesh, handoff)
    shards = mesh_shards(torch, qmm, fd, params)
    del params
    free_device_memory(torch)
    reset_launches(fns)
    trained = mesh_train(torch, T, mesh, train_losses, train_peak_gb,
                         dry_train)
    train_launches = read_launches(fns)
    if any(train_launches.values()):
        raise AssertionError(f"mesh train launched kernels: "
                             f"{train_launches}")
    launches = {name: engine["format"]["launches"][name]
                + engine["k"]["launches"][name] for name in fns}
    emit("mesh", card=nvidia_smi_line(), mesh=shape, engine=engine,
         shards={"checked": len(shards), "rows": shards}, train=trained,
         train_launches=train_launches, launches=launches,
         seconds=time.perf_counter() - t_phase)
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


FLASH_KEYS = ("Smax", "lengths", "shape", "ms", "host_ms", "plain_ms",
              "bound_ms", "library_ms")


# -- dtypes: serving in bf16 and fp8 -----------------------------------------

# (instance, activation dtype, weight / cache dtype); e4m3 is the
# reference's jnp.float8_e4m3fn
DTYPE_CASES = (("bf16", "bfloat16", "bfloat16"),
               ("e4m3", "bfloat16", "float8_e4m3fn"))
DTYPES_FORMAT = FORMATS["k12_e15"]
DTYPES_FLASH = {"serve_last": FLASH_CASES["serve_last"],
                "long": FLASH_CASES["long"]}
DTYPES_GEMMA_STEPS = 8
DTYPES_DECODE_TOL = 0.05          # decode vs full forward, × max |logit|
DTYPES_REPLACES = {
    "quant_matmul_format": "src/repro/kernels/quant_matmul.py:123",
    "quant_matmul": "src/repro/kernels/quant_matmul.py:39",
    "flash_decode_certified": "src/repro/kernels/flash_decode.py:112",
    "flash_decode_attention": "src/repro/kernels/flash_decode.py:40",
    "f32_matmul": ROW_ORDER_REPLACES["f32_matmul"],
    "row_mean": ROW_ORDER_REPLACES["row_mean"]}
DTYPES_SOURCES = {
    "quant_matmul_format": "src/repro_torch/csrc/quant_matmul_format_narrow.cu",
    "quant_matmul": "src/repro_torch/csrc/quant_matmul_narrow.cu",
    "f32_matmul": "src/repro_torch/csrc/f32_matmul_narrow.cu",
    "row_mean": "src/repro_torch/csrc/row_mean.cu",
    "flash_decode_certified":
        "src/repro_torch/csrc/flash_decode_certified_narrow.cu",
    "flash_decode_attention": "src/repro_torch/csrc/flash_decode_bf16.cu"}


def device_timer(how):
    """A timer like :func:`trace_ms` that, where its trace holds no device
    activity (the profiler's loss, seen after the monitored runs), times by
    CUDA events instead (:func:`time_cold_ms`, which time the host's
    launch where that is longer); ``how`` gets the method used."""
    def timer(torch, fn, copies, iters):
        try:
            ms = trace_ms(torch, fn, copies, iters, attempts=1)
            how.append("trace")
        except AssertionError:
            ms = time_cold_ms(torch, fn, copies, iters)
            how.append("events")
        return ms

    return timer


def narrow_flash_timing(torch, kernel, plain, q, k, v, lengths):
    """:func:`flash_timing` of a narrow instance: the kernel and bf16 SDPA
    (an e4m3 cache upcast to bf16 outside the timing) by
    :func:`device_timer`, the plain version by CUDA events."""
    how = []
    out = flash_timing(torch, kernel, plain, q, k, v, lengths,
                       timer=device_timer(how),
                       plain_timer=lambda *a: time_cold_ms(*a[:3], 2))
    return dict(out, timed_by=how)


def narrow_copies(torch, w):
    """:func:`weight_copies` counted in ``w``'s own bytes."""
    n = max(2, math.ceil(2 * L2_BYTES / (w.element_size() * w.numel())))
    return [w.clone() for _ in range(n)]


def narrow_vs_f32(torch, what, got, f32_out):
    """A narrow instance's output against its f32 instance on the upcast
    operands, cast to the output's dtype: bit for bit, or it raises."""
    want = f32_out.to(got.dtype)
    if not same_bits(torch, got, want):
        n = int((got.float() != want.float()).sum())
        raise AssertionError(f"{what}: {n} of {got.numel()} elements differ "
                             "from the f32 instance on the upcast operands")
    return {"bitwise_f32_instance": True, "elements": got.numel()}


def narrow_agreement(torch, got, want, fmt, pre_tol, what):
    """A narrow instance's output (rounded into ``got``'s dtype) against its
    plain version's f32 result on the same narrow operands, cast to that
    dtype: the f32 phases' rule (:func:`compare`: one ulp at k plus the
    order's ``pre_tol``) with the output's own rounding added, one ulp of
    its dtype (bf16: 8 significant bits) on top of one at k. Returns the
    stats; raises on disagreement."""
    k, emax, emin = fmt
    kb = min(k, 8) if got.dtype == torch.bfloat16 else k
    w32 = want.float()
    tol = pre_tol + ulp_at_k(torch, w32.abs().double(), k, emin)
    ok, st = compare(torch, got.float(), w32.to(got.dtype).float(),
                     (kb, emax, emin), tol)
    if not ok:
        raise AssertionError(f"{what} against its plain version: {st}")
    return st


def f32_matmul_plain_columns(torch, ro, x, w, got, what):
    """``f32_matmul``'s output on HEAD_COLUMNS sampled columns against its
    plain version (the fmaf chain) on the same narrow operands, cast to
    the output's dtype: bit for bit, or it raises."""
    N = w.shape[1]
    cols = torch.linspace(0, N - 1, min(HEAD_COLUMNS, N),
                          device=w.device).long()
    want = ro.f32_matmul_seq_ref(x, w[:, cols]).to(got.dtype)
    if not same_bits(torch, got[:, cols].contiguous(), want):
        raise AssertionError(f"{what}: differs from the fmaf chain")
    return {"bitwise_plain_columns": len(cols)}


def dtype_gemm_fns(qmm, ro):
    """(kernel, callable(x, w)) of the three GEMM wrappers at the dtypes
    phase's format / k."""
    return (("quant_matmul_format",
             lambda x, w: qmm.quant_matmul_format(x, w, DTYPES_FORMAT),
             lambda x, w: qmm.quant_matmul_format_ref(x, w, DTYPES_FORMAT)),
            ("quant_matmul", lambda x, w: qmm.quant_matmul(x, w, k=SERVE_K),
             lambda x, w: qmm.quant_matmul_ref(x, w, SERVE_K)),
            ("f32_matmul", ro.f32_matmul, None))


def dtype_gemm_rows(torch, qmm, ro, dt):
    """Kernels 1, 3 and f32_matmul on bf16 x with bf16 or e4m3 w at every
    Qwen2-7B projection, M = 4 and 512: bit for bit the f32 instance on the
    upcast operands, and against the plain version on the same narrow
    operands (kernels 1 and 3 under :func:`narrow_agreement` with the GEMM
    order spread; f32_matmul bit for bit on sampled columns at M = 4 of
    wq and w_down, both K of the projections); kernels 1
    and 3 timed with the weights cold (plain: the plain version on the
    same narrow operands; library: one bf16 ``torch.matmul``, an e4m3 w
    upcast to bf16 outside the timing; the bound's operations at the bf16
    peak)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = []
    for case, xname, wname in DTYPE_CASES:
        xdt, wdt = getattr(torch, xname), getattr(torch, wname)
        for proj, (K, N) in GEMM_SHAPES.items():
            w = dt.cast(torch.randn(K, N, device="cuda", generator=gen)
                        / math.sqrt(K), wdt)
            for M in (4, 512):
                x = torch.randn(M, K, device="cuda", generator=gen).to(xdt)
                for name, fn, plain in dtype_gemm_fns(qmm, ro):
                    what = f"{name} {case} {proj} M={M}"
                    got = fn(x, w)
                    st = narrow_vs_f32(torch, what, got,
                                       fn(x.float(), w.float()))
                    if plain is None:
                        # the fmaf chain costs ~10 launches a k: at both K
                        # of the projections (the head's whole output is
                        # held in dtype_head_rows)
                        if M == SERVE_BATCH and proj in ("wq", "w_down"):
                            st.update(f32_matmul_plain_columns(
                                torch, ro, x, w, got, what))
                    else:
                        fmt = (DTYPES_FORMAT if name == "quant_matmul_format"
                               else (SERVE_K, 127, -126))
                        xq, wq = (gemm_rounded(torch, t, name) for t in (x, w))
                        st["vs_plain"] = narrow_agreement(
                            torch, got, plain(x, w), fmt,
                            gemm_order_tol(torch, xq, wq), what)
                        st["max_abs_err"] = st["vs_plain"]["max_abs_err"]
                        del xq, wq
                    del got
                    row = {"kernel": name, "case": case, "proj": proj,
                           "M": M, "K": K, "N": N, **st}
                    if plain is not None:
                        copies = narrow_copies(torch, w)
                        iters = 10 if M == 4 else 3
                        row["ms"] = time_cold_ms(
                            torch, lambda wc: fn(x, wc), copies, iters)
                        row["plain_ms"] = time_cold_ms(
                            torch, lambda wc: plain(x, wc), copies, 2)
                        lib = [wc.to(torch.bfloat16) for wc in copies]
                        del copies
                        row["library_ms"] = time_cold_ms(
                            torch, lambda wc: torch.matmul(x, wc), lib,
                            iters)
                        del lib
                        row["bound_ms"], row["bound_by"] = bound_ms(
                            x.element_size() * (M * K + M * N)
                            + w.element_size() * K * N, 2.0 * M * N * K,
                            ops_peak(x.dtype, w.dtype))
                    rows.append(row)
                del x
            del w
    return rows


def gemm_rounded(torch, t, name):
    """The operand as the plain version of kernel ``name`` rounds it, in
    f32 (for the order spread :func:`gemm_order_tol`)."""
    from repro_torch.core.quantize import _quantize_normal, quantize_to_format

    t = t.float()
    if name == "quant_matmul_format":
        return quantize_to_format(t, *DTYPES_FORMAT, True, True)
    return _quantize_normal(t, SERVE_K)


def dtype_layer_timing(rows, name, case, M):
    """One layer's seven GEMMs of a narrow instance at batch M, summed;
    max_abs_err the largest against the plain version."""
    got = [r for r in rows if r["kernel"] == name and r["case"] == case
           and r["M"] == M]
    if len(got) != len(GEMM_SHAPES):
        raise AssertionError(f"{len(got)} timed {name} {case} rows at M={M}")
    out = {key: sum(r[key] for r in got)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    out["max_abs_err"] = max(r["max_abs_err"] for r in got)
    out["bound_by"] = got[0]["bound_by"] if len(
        {r["bound_by"] for r in got}) == 1 else "bytes and operations"
    return out


def dtype_head_rows(torch, ro, dt, cfg):
    """f32_matmul as the LM head at decode (x [4, d] bf16 against the
    transposed [d, V] table in bf16 or e4m3): bit for bit the f32 instance
    on the upcast operands and its plain version (the fmaf chain, run
    once, timed) on the same operands; library: one bf16
    ``torch.matmul``); and row_mean on bf16 rows of d_model at 4 and 512
    rows bit for bit its f32 instance on the upcast rows and its plain
    version, timed by device time (:func:`graph_ms`; library:
    ``Tensor.mean`` in bf16). Bounds: the operations at the operands' peak
    (:func:`ops_peak`)."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    out = {}
    d, V = cfg.d_model, cfg.vocab
    for case, xname, wname in DTYPE_CASES:
        wdt = getattr(torch, wname)
        table_t = dt.cast(torch.randn(d, V, device="cuda", generator=gen)
                          * 0.02, wdt)
        x = torch.randn(SERVE_BATCH, d, device="cuda",
                        generator=gen).to(torch.bfloat16)
        st = narrow_vs_f32(torch, f"f32_matmul head {case}",
                           ro.f32_matmul(x, table_t),
                           ro.f32_matmul(x.float(), table_t.float()))
        copies = narrow_copies(torch, table_t)
        ms = time_cold_ms(torch, lambda w: ro.f32_matmul(x, w), copies, 10)
        del copies
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = ro.f32_matmul_seq_ref(x, table_t)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        if not same_bits(torch, ro.f32_matmul(x, table_t),
                         plain.to(x.dtype)):
            raise AssertionError(f"f32_matmul head {case}: differs from "
                                 "its plain version")
        st["bitwise_plain"] = True
        del plain
        lib = narrow_copies(torch, table_t.to(torch.bfloat16))
        library_ms = time_cold_ms(torch, lambda w: torch.matmul(x, w), lib,
                                  10)
        del lib
        out[f"f32_matmul/{case}"] = dict(
            st, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            **dict(zip(("bound_ms", "bound_by"), bound_ms(
                2.0 * SERVE_BATCH * (d + V) + table_t.element_size() * d * V,
                2.0 * SERVE_BATCH * d * V,
                ops_peak(x.dtype, table_t.dtype)))))
        del table_t, x
    for rows in (SERVE_BATCH, SERVE_BATCH * SERVE_PROMPT):
        x = (torch.randn(rows, d, device="cuda", generator=gen) ** 2).to(
            torch.bfloat16)
        got = ro.row_mean(x)
        st = narrow_vs_f32(torch, f"row_mean bf16 R={rows}", got,
                           ro.row_mean(x.float()))
        if not same_bits(torch, got, ro.row_mean_ref(x)[:, 0].to(x.dtype)):
            raise AssertionError(f"row_mean bf16 R={rows}: differs from "
                                 "its plain version")
        st["bitwise_plain"] = True
        del got
        one = [x.clone() for _ in range(8)]
        out[f"row_mean/bf16/R{rows}"] = dict(
            st, ms=graph_ms(torch, ro.row_mean, one, 50),
            plain_ms=time_cold_ms(torch, ro.row_mean_ref, one, 10),
            library_ms=graph_ms(torch, lambda t: t.mean(-1), one, 50),
            timed_by="graph", **dict(zip(("bound_ms", "bound_by"), bound_ms(
                2.0 * rows * (d + 1), 1.0 * rows * d, ops_peak(x.dtype)))))
        del x, one
    return out


def dtype_flash_rows(torch, fd, dt):
    """Kernel 2 on bf16 q with a bf16 or e4m3 cache against its f32
    instance on the upcast operands (bit for bit) and its plain version
    (``flash_decode_quantized_ref``) on the same narrow operands under
    :func:`narrow_agreement` with :func:`flash_tol`, and kernel 4's bf16
    instance against its plain version (``flash_decode_bf16_ref``, bit for
    bit), at the serve cache (B 4, K 4, G 7, D 128) at its last step and
    at 32K, plus Gemma-2's shape with a window and a softcap; each timed
    from a trace with the cache rotated (library: bf16 SDPA, an e4m3 cache
    upcast to bf16 outside the timing; the bound's operations at the bf16
    peak). At the serve cache and at 32K, kernels 2 and 4 on an f32 q with
    the same narrow cache (f32 compute with a narrow ``cache_dtype``): bit
    for bit the f32 instance on the upcast cache, against the plain
    versions under the f32 phases' rule, and timed."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    B, out = SERVE_BATCH, {}
    cases = [(c, S, lens, (4, 7, 128), 0, 0.0)
             for c, (S, lens) in DTYPES_FLASH.items()]
    cases.append(("gemma_w16_cap50", 145, [145, 144, 17, 1],
                  ZOO_FLASH_SHAPE, 16, ZOO_SOFTCAP))
    for case, xname, wname in DTYPE_CASES:
        cdt = getattr(torch, wname)
        for name, S, lens, (H, G, D), window, cap in cases:
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            q = torch.randn(B, H, G, D, device="cuda",
                            generator=gen).to(torch.bfloat16)
            k, v = (dt.cast(torch.randn(B, S, H, D, device="cuda",
                                        generator=gen), cdt)
                    for _ in range(2))
            up = [t.float() for t in (q, k, v)]
            rows = {}
            if not window:
                what = f"flash_decode_certified {case} {name}"
                got = fd.flash_decode_certified(q, k, v, lengths,
                                                DTYPES_FORMAT)
                st = narrow_vs_f32(
                    torch, what, got,
                    fd.flash_decode_certified(*up, lengths, DTYPES_FORMAT))
                st["vs_plain"] = narrow_agreement(
                    torch, got, fd.flash_decode_quantized_ref(
                        q, k, v, lengths, DTYPES_FORMAT), DTYPES_FORMAT,
                    flash_tol(torch, up[2], lengths, DTYPES_FORMAT), what)
                st["max_abs_err"] = st["vs_plain"]["max_abs_err"]
                del got
                rows["flash_decode_certified"] = dict(
                    st, **narrow_flash_timing(
                        torch, lambda *a: fd.flash_decode_certified(
                            *a, DTYPES_FORMAT),
                        lambda *a: fd.flash_decode_quantized_ref(
                            *a, DTYPES_FORMAT), q, k, v, lengths))
            got = fd.flash_decode_attention(q, k, v, lengths, window=window,
                                            softcap=cap)
            want = fd.flash_decode_bf16_ref(q, k, v, lengths, window=window,
                                            softcap=cap)
            if not same_bits(torch, got, want):
                n = int((got.float() != want.float()).sum())
                raise AssertionError(
                    f"flash_decode_attention bf16 {case} {name}: {n} of "
                    f"{got.numel()} elements differ from its plain version")
            diff = (got.double() - fd.flash_decode_ref(
                *up, lengths, window=window, softcap=cap).double()).abs()
            timing = narrow_flash_timing(
                torch, fd.flash_decode_attention, fd.flash_decode_bf16_ref,
                q, k, v, lengths) if not window else {}
            rows["flash_decode_attention"] = dict(
                bitwise_plain=True, elements=got.numel(),
                max_abs_vs_f32_instance=float(diff.max()), **timing)
            if not window:
                rows["f32_q"] = f32_q_narrow_cache(torch, fd, up[0], k, v,
                                                   lengths, f"{case} {name}")
            out[f"{case}/{name}"] = {"Smax": S, "lengths": lens,
                                     "shape": [B, H, G, D], "window": window,
                                     "softcap": cap, **rows}
            del q, k, v, up
    return out


def f32_q_narrow_cache(torch, fd, q, k, v, lengths, what):
    """Kernels 2 and 4 on an f32 q with a bf16 or e4m3 cache: bit for bit
    the f32 instance on the upcast cache, and against the plain versions on
    the same operands under the f32 phases' rule (:func:`compare` with
    :func:`flash_tol`); each timed (:func:`narrow_flash_timing`, library:
    f32 SDPA on the upcast cache). Returns the stats; raises on
    disagreement."""
    kf, vf = k.float(), v.float()
    out = {}
    for name, fmt, kern, plain in (
            ("flash_decode_certified", DTYPES_FORMAT,
             lambda *a: fd.flash_decode_certified(*a, DTYPES_FORMAT),
             lambda *a: fd.flash_decode_quantized_ref(*a, DTYPES_FORMAT)),
            ("flash_decode_attention", F32_FMT, fd.flash_decode_attention,
             fd.flash_decode_ref)):
        got = kern(q, k, v, lengths)
        st = narrow_vs_f32(torch, f"{name} f32 q, {what}", got,
                           kern(q, kf, vf, lengths))
        ok, cmp = compare(torch, got, plain(q, k, v, lengths), fmt,
                          flash_tol(torch, vf, lengths,
                                    fmt if fmt != F32_FMT else None))
        if not ok:
            raise AssertionError(f"{name} f32 q, {what} against its plain "
                                 f"version: {cmp}")
        out[name] = dict(st, vs_plain=cmp, max_abs_err=cmp["max_abs_err"],
                         **narrow_flash_timing(torch, kern, plain, q, k, v,
                                               lengths))
    return out


@contextlib.contextmanager
def dtype_spies(qmm, fd, ro):
    spies = {"quant_matmul_format": qmm, "quant_matmul": qmm,
             "flash_decode_certified": fd, "flash_decode_attention": fd,
             "row_mean": ro, "f32_matmul": ro}
    made = {name: ShapeSpy(getattr(mod, name)) for name, mod in spies.items()}
    for name, mod in spies.items():
        setattr(mod, name, made[name])
    try:
        yield made
    finally:
        for name, mod in spies.items():
            setattr(mod, name, made[name].fn)


def spied_narrow(torch, fd, spies):
    """Every kept call of a narrow serving run again on the card: a kernel
    against its f32 instance on the upcast operands (kernels 1, 2, 3,
    f32_matmul, row_mean), kernel 4's bf16 instance against its plain
    version; bit for bit, or it raises. Returns the calls checked a
    kernel."""
    checked = {}
    for name, spy in spies.items():
        n = 0
        for args, kw in spy.seen.values():
            tensors = [a for a in args if hasattr(a, "dtype")]
            if all(t.dtype in (torch.float32, torch.int32) for t in tensors):
                continue                  # an f32 call: the earlier phases'
            got = spy.fn(*args, **kw)
            if name == "flash_decode_attention":
                want = fd.flash_decode_bf16_ref(*args, **kw)
                if not same_bits(torch, got, want):
                    raise AssertionError(f"{name}: a served call differs "
                                         "from its plain version")
            else:
                up = [a.float() if hasattr(a, "dtype") and a.is_floating_point()
                      else a for a in args]
                narrow_vs_f32(torch, f"{name} served", got,
                              spy.fn(*up, **kw))
            n += 1
        checked[name] = n
    return checked


def dtype_expected(cfg, path, forwards, steps):
    """Exact launches of a narrow Qwen2-7B / Gemma-2 serve: as
    :func:`zoo_expected`, with the plain path's products through
    f32_matmul (7 a layer a forward beside the LM head); of MiniCPM3's:
    as :func:`mla_encdec_expected`, its decode attention through the
    latent kernel instead of kernel 4."""
    path = path.split("_")[0]         # "format_fp8" / "k_fp8": the backend
    if cfg.mla:
        # the decode attention through the latent kernel, counted apart
        # (dtype_minicpm3), not kernel 4
        return dict(mla_encdec_expected(cfg, path, forwards, steps),
                    flash_decode_attention=0)
    want = zoo_expected(cfg, path, forwards, steps)
    if path == "plain":
        want["f32_matmul"] += 7 * cfg.n_layers * forwards
    return want


def decode_vs_full_narrow(torch, T, res):
    """The run's last decode logits against one full forward of the same
    tokens on the run's own backend and params, through a fresh cache of
    the run's cache dtype (so that its attention, too, reads the keys and
    values rounded into the cache): within DTYPES_DECODE_TOL · max |logit|,
    the argmax equal unless the top two lie within twice the difference
    (the decode's attention runs in a kernel, the full forward's composed,
    and a bf16 rounding that flips moves a logit further); raises
    otherwise."""
    seq = torch.cat([res.prompt, res.tokens[:, :-1]], dim=1)
    cache = T.init_cache(res.cfg, seq.shape[0], seq.shape[1],
                         device=seq.device,
                         dtype=res.config.dtypes[1])
    with torch.no_grad():
        full, _ = T.forward(res.backend, res.placed, res.cfg, seq,
                            cache=cache, q_offset=0)
    del cache
    got, want = res.decode_logits[-1].double(), full[:, -1].double()
    del full
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    top2 = torch.topk(want, 2, dim=-1).values
    gap = float((top2[:, 0] - top2[:, 1]).min())
    agree = bool((got.argmax(-1) == want.argmax(-1)).all())
    rep = dict(max_abs_dlogit=err, max_abs_logit=scale,
               tolerance=DTYPES_DECODE_TOL * scale, argmax_agrees=agree,
               top1_gap=gap)
    if not err <= DTYPES_DECODE_TOL * scale or not (agree or gap <= 2 * err):
        raise AssertionError(f"{res.cfg.name} decode vs full forward: {rep}")
    return rep


def dtype_serve(torch, serve, T, qmm, fd, fns, spies_ctx, arch, path,
                extra, steps):
    """``serve.main`` at full width in bf16 with its launch counters set to
    0 just before and read just after: exact counts, finite logits, each
    kept kernel call checked (:func:`spied_narrow`), the decode step
    against a full forward. Returns (result, report)."""
    full = serve.configs.get(arch).FULL
    argv = ["--arch", arch, "--size", "full", "--batch", str(SERVE_BATCH),
            "--prefill-len", str(SERVE_PROMPT), "--decode-steps", str(steps),
            "--device", "cuda", "--seed", "0", "--compute-dtype",
            "bfloat16", *extra]
    torch.cuda.reset_peak_memory_stats()
    caches, init_cache = [], serve.T.init_cache

    def kept_cache(*a, **kw):
        caches.append(init_cache(*a, **kw))
        return caches[-1]

    with spies_ctx() as spies:
        reset_launches(fns)
        by_dtype = {n: dict(qmm.BY_DTYPE[n]) for n in spies}
        serve.T.init_cache = kept_cache
        try:
            res = serve.main(argv)
        finally:
            serve.T.init_cache = init_cache
        launches = read_launches(fns)
        by_dtype = {n: {k: c - by_dtype[n].get(k, 0)
                        for k, c in qmm.BY_DTYPE[n].items()
                        if c != by_dtype[n].get(k, 0)}
                    for n in spies}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        cfg = res.cfg
        if cfg != full:
            raise AssertionError(f"{arch}: served {cfg}")
        expected = dtype_expected(cfg, path, 1 + steps, steps)
        if launches != expected:
            raise AssertionError(f"{arch} {path}: launch counts {launches} "
                                 f"!= {expected}")
        for lg in [res.prefill_logits] + res.decode_logits:
            if lg.dtype != torch.bfloat16 or not bool(
                    torch.isfinite(lg).all()):
                raise AssertionError(f"{arch} {path}: logits {lg.dtype}, "
                                     "or not finite")
        checked = spied_narrow(torch, fd, spies)
    rep = dict(config=f"{arch}.FULL", path=path, argv=extra,
               n_layers=cfg.n_layers, batch=SERVE_BATCH,
               prompt_tokens=SERVE_PROMPT, decode_steps=steps,
               launches=launches, launches_by_dtype=by_dtype,
               spied_calls_checked=checked,
               prefill_s=res.timing["prefill_s"],
               decode_ms_per_step=res.timing["decode_ms_per_step"],
               decode_step_ms_median=statistics.median(
                   res.timing["decode_step_ms"]),
               decode_tokens_per_s=res.timing["decode_tokens_per_s"],
               init_s=res.timing["init_s"], max_memory_allocated_gb=peak_gb,
               param_gb=sum(t.numel() * t.element_size()
                            for t in _leaves(res.params)) / 1e9,
               card_bytes={"params": sum(t.numel() * t.element_size()
                                         for t in _leaves(res.params)),
                           "cache": sum(t.numel() * t.element_size()
                                        for c in caches for t in c.values())},
               sample_tokens=res.tokens[0].tolist(),
               logits_sha256=logits_sha256(res),
               decode_vs_full=decode_vs_full_narrow(torch, T, res))
    return res, rep


def e4m3_small_share(torch, params):
    """Of the weights stored in e4m3 (dense leaves of two or more dims),
    the share stored as zero and the share stored subnormal (|w| < 2⁻⁶):
    the reference keeps no scales, so N(0, 1/fan_in) weights of a wide
    layer fall there."""
    n = zero = sub = 0
    for t in _leaves(params):
        if t.dtype != torch.float8_e4m3fn or t.dim() < 2:
            continue
        for part in (t if t.dim() > 2 else t[None]):   # a layer at a time
            bits = part.view(torch.uint8) & 0x7F
            n += part.numel()
            zero += int(torch.count_nonzero(bits == 0))
            sub += int(torch.count_nonzero((bits > 0) & (bits < 8)))
            del bits
    return {"weights": n, "zero_share": zero / n, "subnormal_share": sub / n}


def dtype_engine(torch, batching, serve, T, fd, fns, spies_ctx, cfg):
    """The batching cell's requests through the engine in bf16 (params in
    bf16, the f32 cache of the reference's engine) under the format map:
    every request's tokens and logit rows bit for bit
    ``reference_generate``'s (the request alone), exact launches."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = T.init_params(cfg, generator=gen, device="cuda",
                           dtype=torch.bfloat16)
    sc = serve.ServeConfig(arch="qwen2_7b", batch=BATCH_ENGINE["n_lanes"],
                           max_seq=BATCH_ENGINE["max_seq"],
                           compute_dtype="bfloat16",
                           precision_layer_format=SERVE_FORMAT)
    reqs, too_long = batching_requests(torch, batching, cfg.vocab)

    def expected(engine, admitted):
        fwd = admitted + engine.steps
        return {"quant_matmul_format": 7 * L_FULL * fwd,
                "flash_decode_certified": L_FULL * engine.steps,
                "quant_matmul": 0, "flash_decode_attention": 0,
                **IDLE_ON_SERVING, **row_order_launches(fwd)}

    with spies_ctx() as spies:
        engine, responses, launches, registry, wall = run_batching(
            torch, batching, fns, cfg, sc, params, reqs + [too_long], None,
            -1, expected)
        checked = spied_narrow(torch, fd, spies)
    ref = {}
    for r in reqs:
        toks, rows = batching.reference_generate(
            cfg, sc, params, r.prompt, r.max_new_tokens,
            max_seq=BATCH_ENGINE["max_seq"], return_logits=True)
        ref[r.rid] = (toks, rows)
    served = [r for r in responses if r["id"] in ref]
    lanes = lane_bits(torch, served, ref)
    if len(served) != len(reqs) or not all(
            r["tokens_equal"] and r["logits_bitwise"] for r in lanes):
        raise AssertionError(f"bf16 engine lanes differ from the requests "
                             f"alone: {lanes}")
    return dict(batching_report(engine, responses, registry, wall),
                launches=launches, spied_calls_checked=checked,
                lanes=lanes, requests=len(reqs))


# MiniCPM3's latent decode in bf16: (B, H, R, Dr, S, lengths) of each case
LATENT_CASES = {
    "minicpm3_decode": (SERVE_BATCH, 40, 256, 32,
                        SERVE_PROMPT + SERVE_STEPS + 1, [145, 130, 64, 1]),
    "minicpm3_32k": (SERVE_BATCH, 40, 256, 32, 32768,
                     [32768, 20001, 4097, 65]),
    "ragged_empty": (3, 40, 256, 32, 200, [0, 129, 64])}
LATENT_REPLACES = ("none: port-only (the reference composes MLA's bf16 "
                   "decode attention, src/repro/models/attention.py:210; its "
                   "f32 route is kernel 4's, src/repro/kernels/"
                   "flash_decode.py:40)")
LATENT_SOURCE = "src/repro_torch/csrc/latent_decode_bf16.cu"
MLA_SCALE = (64 + 32) ** -0.5     # MiniCPM3's (d_nope + d_rope)^-1/2


def latent_composed(torch, q_lat, q_rope, c, k_rope, lengths, scale):
    """The composed bf16 path of MLA's decode attention as library calls
    (bf16 einsums with f32 sums, their sum, the scale, the mask, softmax in
    f32, the mix of c): the latent kernel's yardstick; c and k_rope in
    bf16."""
    S = c.shape[1]
    s = (torch.einsum("bhr,bsr->bhs", q_lat, c)
         + torch.einsum("bhd,bsd->bhs", q_rope, k_rope)) * scale
    s = s.masked_fill(torch.arange(S, device=c.device)[None, None, :]
                      >= lengths[:, None, None], -1e9)
    p = torch.softmax(s.float(), dim=-1).to(torch.bfloat16)
    return torch.einsum("bhs,bsr->bhr", p, c)


def latent_vs_plain(torch, fd, q_lat, q_rope, c, k_rope, lengths, scale,
                    what):
    """The latent kernel bit for bit its plain version on the same
    operands; raises otherwise."""
    got = fd.latent_decode_bf16(q_lat, q_rope, c, k_rope, lengths, scale)
    want = fd.latent_decode_bf16_ref(q_lat, q_rope, c, k_rope, lengths,
                                     scale)
    if not same_bits(torch, got, want):
        n = int((got.float() != want.float()).sum())
        raise AssertionError(f"latent_decode_bf16 {what}: {n} of "
                             f"{got.numel()} elements differ from its plain "
                             "version")
    return {"shape": list(q_lat.shape), "Smax": c.shape[1],
            "cache_dtype": str(c.dtype), "lengths": lengths.tolist(),
            "bitwise_plain": True}


def dtype_latent_rows(torch, fd, dt):
    """The latent kernel on MiniCPM3's decode shapes (40 heads on one
    latent of R = 256 and a rope key of Dr = 32) at the serve cache's
    length, at 32K and with a lane of length 0, on bf16, e4m3 and f32
    latent caches: bit for bit its plain version; the first two on the
    bf16 cache timed by :func:`graph_ms` with the cache rotated past the L2
    (plain version: CUDA events; library: the composed bf16 path,
    :func:`latent_composed`). The bound: bytes (q
    in, out, c and k_rope up to each lane's length) or operations (2·H·(R
    + Dr) a position for the scores, 2·H·R for p·c) at the operands' peak
    (:func:`ops_peak`)."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    out = {}
    for name, (B, H, R, Dr, S, lens) in LATENT_CASES.items():
        for cname in ("bfloat16", "float8_e4m3fn", "float32"):
            if cname != "bfloat16" and name == "minicpm3_32k":
                continue
            cdt = getattr(torch, cname)
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            f = lambda *sh: torch.randn(*sh, device="cuda", generator=gen)
            q_lat, q_rope = f(B, H, R).to(torch.bfloat16), f(
                B, H, Dr).to(torch.bfloat16)
            c, k_rope = dt.cast(f(B, S, R), cdt), dt.cast(f(B, S, Dr), cdt)
            row = latent_vs_plain(torch, fd, q_lat, q_rope, c, k_rope,
                                  lengths, MLA_SCALE, f"{name} {cname}")
            if cname == "bfloat16" and name != "ragged_empty":
                copies = cache_copies(torch, c, k_rope)
                iters = flash_iters(S)
                run = lambda fn: lambda cc: fn(q_lat, q_rope, *cc, lengths,
                                               MLA_SCALE)
                row["ms"] = graph_ms(torch, run(fd.latent_decode_bf16),
                                     copies, iters)
                row["plain_ms"] = time_cold_ms(
                    torch, run(fd.latent_decode_bf16_ref), copies, 2)
                row["library_ms"] = graph_ms(
                    torch, lambda cc: latent_composed(
                        torch, q_lat, q_rope, *cc, lengths, MLA_SCALE),
                    copies, iters)
                del copies
                n = int(torch.where(lengths <= 0, S,
                                    lengths.clamp(max=S)).sum())
                row["bound_ms"], row["bound_by"] = bound_ms(
                    2.0 * B * H * (R + Dr) + 2.0 * B * H * R + 4 * B
                    + c.element_size() * n * (R + Dr),
                    2.0 * H * n * (R + Dr) + 2.0 * H * n * R,
                    ops_peak(q_lat.dtype, c.dtype))
                row["bound_f32_cores_ms"] = 1e3 * (
                    2.0 * H * n * (2 * R + Dr)) / F32_TFLOPS
            out[f"{name}/{cname}"] = row
            del q_lat, q_rope, c, k_rope
    return out


class LatentInputSpy:
    """Stands in for the latent kernel while a serve runs: launches it, and
    keeps (cloned) the operands of the calls numbered in ``keep``."""

    def __init__(self, fd, keep):
        self.fn, self.keep, self.seen, self.calls = (
            fd.latent_decode_bf16, set(keep), [], 0)

    def __call__(self, q_lat, q_rope, c, k_rope, lengths, scale):
        if self.calls in self.keep:
            self.seen.append((*(t.clone() for t in (q_lat, q_rope, c,
                                                    k_rope, lengths)),
                              scale))
        self.calls += 1
        return self.fn(q_lat, q_rope, c, k_rope, lengths, scale)

    launches = KernelSpy.launches


def dtype_minicpm3(torch, serve, batching, T, qmm, fd, fns, spies_ctx):
    """MiniCPM3 4B at full width and full depth (62 layers) in bf16 (bf16
    params and latent cache) through ``serve.main`` under the plain, k = 12
    and format backends (:func:`dtype_serve`: exact launches, finite
    logits, the last decode step against a full forward), its decode
    attention through the latent kernel: one launch a layer and decode
    step, counted apart (its counter set to 0 just before each run and
    read just after), the operands of the first call and of the last
    step's first call bit for bit the plain version's result. Then the
    batching engine in bf16 (the engine's f32 cache, read as bf16 by the
    kernel) under the format map on the same weights: every request's
    tokens and logit rows bit for bit the request alone, exact launches.
    Returns ({path: report}, engine report, latent launches)."""
    arch = "minicpm3_4b"
    L = serve.configs.get(arch).FULL.n_layers
    fmt = ["--layer-format", json.dumps(MLA_FORMAT)]
    runs = (("plain", []), ("k", ["--precision-k", str(SERVE_K)]),
            ("format", fmt))
    reps, latent_launches = {}, 0
    for path, extra in runs:
        params = None                 # the last run's weights, for the engine
        free_device_memory(torch)
        t0 = time.perf_counter()
        spy = LatentInputSpy(fd, (0, L * (SERVE_STEPS - 1)))
        spy.fn.launches = 0
        fd.latent_decode_bf16 = spy
        try:
            res, rep = dtype_serve(torch, serve, T, qmm, fd, fns, spies_ctx,
                                   arch, path,
                                   ["--cache-dtype", "bfloat16", *extra],
                                   SERVE_STEPS)
        finally:
            fd.latent_decode_bf16 = spy.fn
        n = spy.fn.launches           # read before the checks launch it
        checked = [latent_vs_plain(torch, fd, *ops, f"{path} call {i}")
                   for i, ops in zip(sorted(spy.keep), spy.seen)]
        if n != L * SERVE_STEPS or len(checked) != 2:
            raise AssertionError(f"minicpm3 bf16 {path}: {n} latent "
                                 f"launches, {len(checked)} calls checked")
        latent_launches += n
        rep.update(latent_launches=n, latent_calls_checked=checked,
                   seconds=time.perf_counter() - t0)
        reps[path] = rep
        emit("dtypes_serve", **rep)
        cfg, params = res.cfg, res.params
        del res, spy
    free_device_memory(torch)
    t0 = time.perf_counter()
    sc = serve.ServeConfig(arch=arch, batch=BATCH_ENGINE["n_lanes"],
                           max_seq=BATCH_ENGINE["max_seq"],
                           compute_dtype="bfloat16",
                           precision_layer_format=MLA_FORMAT, device="cuda")
    reqs = engine_requests(torch, batching, cfg.vocab)
    fd.latent_decode_bf16.launches = 0
    engine, responses, launches, registry, wall = run_batching(
        torch, batching, fns, cfg, sc, params, reqs, None, -1,
        lambda eng, admitted: dict(mla_encdec_expected(
            cfg, "format", admitted + eng.steps, eng.steps, stub=0),
            flash_decode_attention=0))
    n = fd.latent_decode_bf16.launches
    if n != L * engine.steps:
        raise AssertionError(f"minicpm3 bf16 engine: {n} latent launches, "
                             f"{engine.steps} steps")
    latent_launches += n
    ref = reference_runs(batching, cfg, sc, params, reqs, -1)
    rows = lane_bits(torch, responses, ref)
    if not all(r["tokens_equal"] and r["logits_bitwise"] for r in rows):
        raise AssertionError(f"minicpm3 bf16 engine: a request's bits "
                             f"differ from the request alone: {rows}")
    eng = dict(batching_report(engine, responses, registry, wall),
               launches=launches, latent_launches=n, lanes_vs_alone=rows,
               seconds=time.perf_counter() - t0)
    del params, engine, responses, ref
    free_device_memory(torch)
    return reps, eng, latent_launches


DRYRUN_TIMEOUT_S = 900
DRYRUN_ONE_BY_ONE = (
    ("qwen2_7b", "format", SERVE_STEPS, {"cache_dtype": "bfloat16",
                                         "param_dtype": "same"}),
    ("gemma2_27b", "format_fp8", DTYPES_GEMMA_STEPS,
     {"cache_dtype": "bfloat16", "param_dtype": "fp8"}))


def start_dryrun():
    """The dry run (``repro_torch.launch.dryrun``) in a freshly spawned CPU
    process beside the card's work, waited for in a thread: Qwen2-7B's
    four shapes on the single-pod 16 × 16 mesh (a fake group of 256
    ranks), then on 1 × 1 (a fake group of one) the prefill steps that
    ``dtypes`` serves on the card, DRYRUN_ONE_BY_ONE (4 × 128 prompts into
    a cache of the run's length, its param and cache dtypes), and the
    train step that ``mesh`` runs on the card (:func:`mesh_train`'s
    config, fsdp). Returns the future of the records (a list a group)."""
    import concurrent.futures

    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun

    single = [dict(arch="qwen2_7b", shape=s, mesh_shape=(16, 16))
              for s in SHAPES]
    one = [dict(arch=arch, shape=dict(name=f"dtypes_{arch}",
                                      kind="prefill", seq=SERVE_PROMPT,
                                      batch=SERVE_BATCH),
                mesh_shape=(1, 1), cache_len=SERVE_PROMPT + steps + 1,
                serve_policy=pol)
           for arch, _, steps, pol in DRYRUN_ONE_BY_ONE]
    train = [dict(arch="qwen2_7b", shape=dict(
        name="mesh_train", kind="train", seq=MESH_TRAIN_SEQ,
        batch=MESH_TRAIN_BATCH), cfg=mesh_train_cfg(), mesh_shape=(1, 1),
        train_policy={"param_sharding": "fsdp"})]
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    future = pool.submit(dryrun.run_isolated, [(256, 0, single), (1, 0, one),
                                               (1, 0, train)],
                         DRYRUN_TIMEOUT_S)
    pool.shutdown(wait=False)
    return future


def _dryrun_summary(rec):
    if rec["status"] != "ok":
        return {k: rec.get(k) for k in ("shape", "status", "reason",
                                        "error")}
    return {"shape": rec["shape"], "mesh": rec["mesh"],
            "status": rec["status"], "step_s": rec["step_s"],
            "argument_bytes": rec["memory"]["argument_bytes"],
            "argument_parts": rec["memory"]["argument_parts"],
            "peak_bytes": rec["memory"]["peak_bytes"],
            "fits": rec["memory"]["fits"],
            "flops_products": rec["cost"]["flops"],
            "collectives": rec["collectives"]}


def dryrun_vs_card(serves, future):
    """The dry run's records (:func:`start_dryrun`): Qwen2-7B's four
    single-pod cells ok but the documented skip of long_500k; each 1 × 1
    cell's params and cache bytes equal to the bytes of the params and
    cache that ``dtypes``' serve of the same arch and dtypes allocated on
    the card (the batch's token ids, int32 as the reference's input
    specs, are counted apart; the card's prompt holds int64 ids), and its
    peak beside the card's ``max_memory_allocated`` for the run (not
    gated: the card's also holds the LM head's transposed table copy,
    kernel scratch, the decode steps and the allocator's rounding). Raises
    on any other outcome. Returns the report."""
    t0 = time.perf_counter()
    single, one, (train,) = future.result()
    waited = time.perf_counter() - t0
    if train["status"] != "ok":
        raise AssertionError(f"dry run, the mesh phase's train step 1 x 1: "
                             f"{train}")
    want = ["ok", "ok", "ok", "skipped"]
    got = [r["status"] for r in single]
    if got != want:
        raise AssertionError(f"dry run, qwen2_7b on 16 x 16: {got} "
                             f"{[r.get('error') for r in single]}")
    cells = []
    for rec, (arch, path, _, pol) in zip(one, DRYRUN_ONE_BY_ONE):
        if rec["status"] != "ok":
            raise AssertionError(f"dry run {arch} 1 x 1: {rec}")
        card = serves[f"{arch}/{path}"]
        parts = rec["memory"]["argument_parts"]
        dry = {"params": parts["params"], "cache": parts["cache"]}
        if dry != card["card_bytes"]:
            raise AssertionError(f"dry run {arch} 1 x 1: params and cache "
                                 f"{dry} != the card's {card['card_bytes']}")
        cfg = __import__("repro_torch.configs", fromlist=["get"]).get(
            arch).FULL
        head = cfg.vocab * cfg.d_model * (1 if pol["param_dtype"] == "fp8"
                                          else 2)
        cells.append(dict(
            _dryrun_summary(rec), arch=arch, policy=pol,
            card_bytes=card["card_bytes"], params_and_cache_equal=True,
            batch_bytes=parts["batch"],
            card_max_memory_allocated_gb=card["max_memory_allocated_gb"],
            dry_peak_gb=rec["memory"]["peak_bytes"] / 1e9,
            gap_gb=card["max_memory_allocated_gb"]
            - rec["memory"]["peak_bytes"] / 1e9,
            head_table_copy_gb=head / 1e9))
    rep = {"single_pod_qwen2_7b": [_dryrun_summary(r) for r in single],
           "one_by_one": cells, "train_1x1": _dryrun_summary(train),
           "waited_s": waited}
    emit("dryrun", note="the dry run in a spawned CPU process on fake "
         "process groups (no card); 1 x 1 cells: the prefill steps dtypes "
         "serves, params and cache bytes equal the card's exactly; the "
         "mesh phase's train step, held to the card in mesh", **rep)
    return rep


def phase_dtypes(torch, serve, batching, qmm, fd, T, dryrun_records):
    """Serving in bf16 and fp8 (``ServeConfig.compute_dtype`` /
    ``cache_dtype`` / ``param_dtype``; their sources ``NARROW_SOURCES``,
    built by :class:`NarrowBuild` beforehand, or at first use): the
    narrow instances of kernels 1-4, f32_matmul and row_mean at Qwen2-7B's
    shapes, bit for bit their f32 instances on the upcast operands and
    held against their plain versions (kernel 4's bf16 instance: bit for
    bit its plain version), timed; Qwen2-7B FULL at full depth in
    bf16 (bf16 cache) under the plain, k = 12 and format backends, then
    the format map and k = 12 with an e4m3 cache and e4m3 params; the
    engine in bf16; Gemma-2
    27B FULL at all 46 layers (bf16 compute, e4m3 params, bf16 cache,
    format map); MiniCPM3 4B FULL at 62 layers in bf16 through the latent
    kernel (:func:`dtype_minicpm3`); the dry run's 1 × 1 cells against the
    card's bytes (:func:`dryrun_vs_card`; ``dryrun_records``: a future of
    :func:`start_dryrun`'s records). Returns ({kernel: launches of the
    phase's runs}, report)."""
    from repro_torch.core import dtypes as dt
    from repro_torch.kernels import row_order as ro

    t_phase = time.perf_counter()
    emit("free", before="dtypes", allocated_gb=free_device_memory(torch))
    fns = kernel_fns(qmm, fd)
    cfg = serve.configs.get("qwen2_7b").FULL
    out, part_s = {}, {}
    for part, fn, args in (("gemm", dtype_gemm_rows, (torch, qmm, ro, dt)),
                           ("head_mean", dtype_head_rows,
                            (torch, ro, dt, cfg)),
                           ("flash", dtype_flash_rows, (torch, fd, dt)),
                           ("latent", dtype_latent_rows, (torch, fd, dt))):
        t0 = time.perf_counter()
        out[part] = fn(*args)
        part_s[part] = time.perf_counter() - t0
    emit("dtypes_kernels", note="narrow instances bit for bit their f32 "
         "instance on the upcast operands (kernel 4's bf16 instance and the "
         "latent kernel: their plain versions)",
         seconds=time.perf_counter() - t_phase,
         part_seconds=part_s, **out)
    spies_ctx = lambda: dtype_spies(qmm, fd, ro)
    fmt = ["--layer-format", json.dumps(SERVE_FORMAT)]
    runs = (("plain", ["--cache-dtype", "bfloat16"]),
            ("k", ["--cache-dtype", "bfloat16", "--precision-k",
                   str(SERVE_K)]),
            ("format", ["--cache-dtype", "bfloat16", *fmt]),
            ("format_fp8", ["--cache-dtype", "fp8", "--param-dtype", "fp8",
                            *fmt]),
            ("k_fp8", ["--cache-dtype", "fp8", "--param-dtype", "fp8",
                       "--precision-k", str(SERVE_K)]))
    launches, serves = collections.Counter(), {}
    for path, extra in runs:
        free_device_memory(torch)
        t0 = time.perf_counter()
        res, rep = dtype_serve(torch, serve, T, qmm, fd, fns, spies_ctx,
                               "qwen2_7b", path, extra, SERVE_STEPS)
        rep["seconds"] = time.perf_counter() - t0
        launches.update(rep["launches"])
        serves[f"qwen2_7b/{path}"] = rep
        emit("dtypes_serve", **rep)
        del res
    free_device_memory(torch)
    t0 = time.perf_counter()
    eng = dtype_engine(torch, batching, serve, T, fd, fns, spies_ctx, cfg)
    launches.update(eng["launches"])
    emit("dtypes_engine", seconds=time.perf_counter() - t0, **eng)
    free_device_memory(torch)
    t0 = time.perf_counter()
    res, rep = dtype_serve(
        torch, serve, T, qmm, fd, fns, spies_ctx, "gemma2_27b", "format",
        ["--cache-dtype", "bfloat16", "--param-dtype", "fp8", *fmt],
        DTYPES_GEMMA_STEPS)
    rep["e4m3_weights"] = e4m3_small_share(torch, res.params)
    rep["seconds"] = time.perf_counter() - t0
    launches.update(rep["launches"])
    serves["gemma2_27b/format_fp8"] = rep
    emit("dtypes_serve", **rep)
    del res
    t0 = time.perf_counter()
    mla, mla_engine, latent_launches = dtype_minicpm3(
        torch, serve, batching, T, qmm, fd, fns, spies_ctx)
    for path, rep in mla.items():
        launches.update(rep["launches"])
        serves[f"minicpm3_4b/{path}"] = rep
    launches.update(mla_engine["launches"])
    emit("dtypes_minicpm3_engine", **mla_engine)
    mla_s = time.perf_counter() - t0
    dryrun = dryrun_vs_card(serves, dryrun_records)
    free_device_memory(torch)
    seconds = time.perf_counter() - t_phase
    emit("dtypes", seconds=seconds, minicpm3_seconds=mla_s,
         launches=dict(launches, latent_decode_bf16=latent_launches))
    return dict(launches, latent_decode_bf16=latent_launches), dict(
        out, serves=serves, engine=eng, minicpm3_engine=mla_engine,
        dryrun=dryrun, seconds=seconds)


def dtype_kernel_rows(parts, launches_by_path):
    """The kernels line's rows of the narrow instances: one a kernel and
    operand case, launches from the dtypes phase's runs (per dtype), times
    at the serve shapes."""
    serves = list(parts["serves"].values())
    by_dtype = collections.Counter()
    for rep in serves:
        for name, counts in rep["launches_by_dtype"].items():
            for key, n in counts.items():
                by_dtype[(name, key)] += n
    rows = []
    for case, _, wname in DTYPE_CASES:
        key = "bf16/" + ("e4m3" if "float8" in wname else "bf16")
        for name in ("quant_matmul_format", "quant_matmul"):
            t = dtype_layer_timing(parts["gemm"], name, case, SERVE_BATCH)
            rows.append(dict(
                name=f"{name}[{case}]", route="cuda",
                source=DTYPES_SOURCES[name],
                replaces=DTYPES_REPLACES[name],
                launches=by_dtype[(name, key)],
                launches_by_path=launches_by_path, **t,
                what=f"the 7 GEMMs of one Qwen2-7B layer at decode, M=4, "
                     f"bf16 x, {case} w, weights cold; bit for bit the f32 "
                     "instance on the upcast operands; max_abs_err: "
                     "against the plain version on the same operands",
                prefill_per_layer=dtype_layer_timing(parts["gemm"], name,
                                                     case, 512)))
        t = parts["head_mean"][f"f32_matmul/{case}"]
        rows.append(dict(
            name=f"f32_matmul[{case}]", route="cuda",
            source=DTYPES_SOURCES["f32_matmul"],
            replaces=DTYPES_REPLACES["f32_matmul"],
            launches=by_dtype[("f32_matmul", key)],
            launches_by_path=launches_by_path,
            max_abs_err=0.0,          # bit for bit its plain version
            **{k: t[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                 "bound_by")},
            what=f"the LM head at decode: 4 rows x 3584 bf16 against the "
                 f"transposed {case} table"))
        for name in ("flash_decode_certified", "flash_decode_attention"):
            t = parts["flash"][f"{case}/serve_last"][name]
            rows.append(dict(
                name=f"{name}[{case}]", route="cuda",
                source=DTYPES_SOURCES[name], replaces=DTYPES_REPLACES[name],
                launches=by_dtype[(name, "bf16/" + key.split("/")[1])],
                launches_by_path=launches_by_path,
                max_abs_err=t.get("max_abs_err", 0.0),
                **{k: t[k] for k in ("ms", "plain_ms", "library_ms",
                                     "bound_ms", "bound_by")},
                what=f"the serve cache at its last step, bf16 q, {case} "
                     "cache; "
                     + ("bit for bit the f32 instance on the upcast "
                        "operands; max_abs_err: against the plain version "
                        "on the same operands"
                        if name == "flash_decode_certified" else
                        "the composed bf16 path, bit for bit its plain "
                        "version"),
                long_32k={k: parts["flash"][f"{case}/long"][name][k]
                          for k in ("ms", "plain_ms", "library_ms",
                                    "bound_ms")}))
    t = parts["latent"]["minicpm3_decode/bfloat16"]
    rows.append(dict(
        name="latent_decode_bf16", route="cuda", source=LATENT_SOURCE,
        replaces=LATENT_REPLACES,
        launches=launches_by_path["dtypes"].get("latent_decode_bf16", 0),
        launches_by_path={p: c.get("latent_decode_bf16", 0)
                          for p, c in launches_by_path.items()},
        max_abs_err=0.0,              # bit for bit its plain version
        **{k: t[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                             "bound_by")},
        what="MiniCPM3's absorbed decode attention in bf16 at the serve "
             "cache's length: B=4, 40 heads on one latent, R=256, Dr=32, "
             "Smax=145, a bf16 cache; library: the composed bf16 einsum "
             "path; bit for bit its plain version",
        long_32k={k: parts["latent"]["minicpm3_32k/bfloat16"][k]
                  for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                            "bound_by")}))
    t = parts["head_mean"][f"row_mean/bf16/R{SERVE_BATCH}"]
    rows.append(dict(
        name="row_mean[bf16]", route="cuda", source=DTYPES_SOURCES["row_mean"],
        replaces=DTYPES_REPLACES["row_mean"],
        launches=by_dtype[("row_mean", "bf16")],
        launches_by_path=launches_by_path,
        max_abs_err=0.0,              # bit for bit its plain version
        **{k: t[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                             "bound_by")},
        what="the rmsnorm's mean of bf16 squares over d_model=3584 for the "
             "4 rows of a decode step (no e4m3 instance: its operand is an "
             "activation, never stored in e4m3)",
        prefill=parts["head_mean"][
            f"row_mean/bf16/R{SERVE_BATCH * SERVE_PROMPT}"]))
    return rows


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
    """Runs the smoke; the CPU process stops with it, however it ends."""
    try:
        return _main()
    finally:
        CPU.close()
        PAPER.close()
        SMOKE_CARD.close()


class PhaseClock:
    """Prints one ``seconds`` line a phase: the host seconds since the
    previous phase ended."""

    def __init__(self):
        self.last = time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        emit("seconds", of=name, seconds=now - self.last)
        self.last = now


def _main() -> int:
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

    t_main = time.perf_counter()
    marks = []
    clock = PhaseClock()
    phase_env(torch, serve)
    phase_build(_build)
    marks.append(("build", time.perf_counter()))
    clock("env_build")
    narrow_build = NarrowBuild(_build)
    # the CPU halves of the card-against-CPU checks run in their own process
    import shutil

    shutil.rmtree(CPU_SIDE_ROOT, ignore_errors=True)
    CPU.start()
    queue_smoke_sides()
    phase_rounding(torch, quantize, qmm)
    clock("rounding")
    phase_gemm_order(torch, qmm)
    clock("gemm_order")
    qrows, qerr = phase_quant_matmul(torch, qmm)
    clock("quant_matmul_format")
    fcases, ferr = phase_flash_decode(torch, fd)
    clock("flash_decode_certified")
    krows, kerr = phase_quant_matmul_k(torch, qmm)
    clock("quant_matmul")
    acases, aerr = phase_flash_decode_attention(torch, fd)
    clock("flash_decode_attention")
    windowed = phase_flash_windowed(torch, fd)
    clock("flash_decode_windowed")
    rorows = phase_row_order(torch, serve.configs.get("qwen2_7b").FULL)
    clock("row_order")
    marks.append(("kernels", time.perf_counter()))
    # the dry run's CPU process starts once the narrow sources' nvcc
    # processes are done with the host's cores (they share it with the
    # CPU side process and the kernel phases' timing loops)
    dryrun_records = start_dryrun()

    by_path, timings = {}, {}
    by_path["serve"], fmt_path, timings["serve"] = phase_serve(
        torch, serve, qmm, fd, T)
    clock("serve")
    (by_path["serve_k"], k_path, k_attn_path,
     timings["serve_k"]) = phase_serve_k(
        torch, serve, qmm, fd, T, "serve_k",
        ["--precision-k", str(SERVE_K)],
        {f"layer{i}": uniform_ks(SERVE_K, SERVE_K) for i in range(2)})
    clock("serve_k")
    (by_path["serve_monitor"], product_layer,
     timings["serve_monitor"]) = phase_serve_monitor(
        torch, serve, qmm, fd, T, {
            "serve": timings["serve"]["logits_sha256"],
            "serve_k": timings["serve_k"]["logits_sha256"],
            "serve_decode_ms": timings["serve"]["decode_ms_per_step"]})
    clock("serve_monitor")
    v2_set = write_v2_set(spec)
    (by_path["serve_mixed"], mixed_path, mixed_attn_path,
     timings["serve_mixed"]) = (
        phase_serve_k(torch, serve, qmm, fd, T, "serve_mixed",
                      ["--certificate-set", str(v2_set)],
                      {"layer0": uniform_ks(12, 14),
                       "layer1": uniform_ks(12, 10)}))
    clock("serve_mixed")
    (by_path["batching"], batch_fmt_path, batch_k_path,
     batch_timing, handoff) = phase_batching(torch, serve, batching, qmm,
                                             fd, T)
    clock("batching")
    by_path["profile"], prows, prof_path = phase_profile(torch, obs, qmm, fd)
    clock("profile")
    marks.append(("serve_batching_profile", time.perf_counter()))
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

    clock("decode_trace_end_to_end")
    phase_interval_libm(torch, iv)
    clock("interval_libm")
    # the SMOKE analyses' card halves of zoo, ssm and mla_encdec run in a
    # side process on the card from here (~150 s, host-bound), done before
    # the analysis kernels' timed phases begin; ``paper`` in another beside
    # zoo, ssm and mla_encdec. A phase's lines are marked contended while
    # either runs (the note is renewed as each phase ends).
    SMOKE_CARD.start(SMOKE_CARD_THREADS)
    queue_card_smoke_sides()
    sides = {"the zoo / ssm / mla_encdec SMOKE analyses' card halves":
             list(CARD_JOBS.values())}

    def renew_note():
        running = [what for what, jobs in sides.items()
                   if not all(j.done() for j in jobs)]
        CONTENDED["note"] = (" and ".join(running) + " ran on the card in "
                             "side processes meanwhile") if running else None

    def tick(name, mark=False):
        clock(name)
        if mark:
            marks.append((name, time.perf_counter()))
        renew_note()

    renew_note()
    by_path["ranges"] = phase_ranges(torch, qmm, fd)
    tick("ranges")
    marks.append(("interval_libm_ranges", time.perf_counter()))
    by_path["certify"] = phase_certify(torch, serve, batching, qmm, fd, T)
    tick("certify", mark=True)
    seen = phase_analyze(torch)
    tick("analyze")
    operands = analysis_operands(torch, seen)
    del seen
    by_path["analysis_ops"], path_outs = phase_analysis_ops(
        torch, kops, qmm, fd, operands)
    free_device_memory(torch)
    tick("analysis_ops")
    phase_interval_gemm_order(torch, operands)
    tick("interval_gemm_order")
    cpath, crows, cerr = phase_caa_kernel(torch, "caa_matmul", kops,
                                          operands, path_outs)
    tick("caa_matmul")
    ipath, irows, ierr = phase_caa_kernel(torch, "interval_matmul", kops,
                                          operands, path_outs)
    del path_outs, operands
    free_device_memory(torch)
    tick("interval_matmul")
    marks.append(("analyze_caa_interval", time.perf_counter()))
    PAPER.start(PAPER_THREADS)
    paper = PAPER.submit(paper_side)
    sides["the paper phase"] = [paper]
    renew_note()

    def phase_ended(name):
        tick(name, mark=True)

    by_path["zoo"], zoo_parts = phase_zoo(torch, serve, batching, qmm, fd,
                                          T)
    phase_ended("zoo")
    by_path["ssm"], ssm_parts = phase_ssm(torch, serve, batching, qmm, fd, T)
    phase_ended("ssm")
    by_path["mla_encdec"], mla_parts = phase_mla_encdec(
        torch, serve, batching, qmm, fd, T)
    phase_ended("mla_encdec")
    by_path["paper"] = paper.result()
    CONTENDED["note"] = None
    PAPER.close()
    SMOKE_CARD.close()
    clock("paper_wait")
    marks.append(("paper", time.perf_counter()))
    narrow_build.finish()
    by_path["dtypes"], dtype_parts = phase_dtypes(torch, serve, batching,
                                                  qmm, fd, T, dryrun_records)
    clock("dtypes")
    marks.append(("dtypes", time.perf_counter()))
    by_path["train"], train_parts = phase_train(torch, qmm, fd, T)
    marks.append(("train", time.perf_counter()))
    clock("train")
    train_losses = [train_parts["full"]["layers2"]["losses"][str(i)]
                    for i in range(MESH_TRAIN_STEPS)]
    by_path["mesh"] = phase_mesh(
        torch, batching, qmm, fd, T, handoff, train_losses,
        train_parts["full"]["layers2"]["peak_gb"],
        dtype_parts["dryrun"]["train_1x1"])
    del handoff
    marks.append(("mesh", time.perf_counter()))
    clock("mesh")
    emit("timeline", note="host seconds from the start of main to the end "
         "of each phase group", **{name: t - t_main for name, t in marks})
    ssm_new = ssm_parts["new_shapes"]["rows"] + [
        r for arch in MLA_ENCDEC_ARCHS
        for r in mla_parts[arch]["new_shapes"]["rows"]]

    qerr = max([qerr] + [r["max_abs_err"] for r in (
        fmt_path["quant_matmul_format"] + prof_path["quant_matmul_format"]
        + batch_fmt_path["quant_matmul_format"]
        + [r for r in ssm_new if r["kernel"] == "quant_matmul_format"])])
    ferr = max([ferr] + [r["max_abs_err"] for r in (
        fmt_path["flash_decode_certified"]
        + batch_fmt_path["flash_decode_certified"])])
    kerr = max([kerr] + [r["max_abs_err"] for r in (
        k_path + mixed_path + prof_path["quant_matmul"]
        + batch_k_path["quant_matmul"]
        + [r for r in ssm_new if r["kernel"] == "quant_matmul"])])
    aerr = max([aerr, windowed["max_abs_err"],
                zoo_parts["gemma2_27b"]["windowed"]["max_abs_err"],
                ssm_parts["hymba_1p5b"]["windowed"]["max_abs_err"],
                mla_parts["minicpm3_4b"]["serve_k"]["max_abs_err"]]
               + [r["max_abs_err"] for r in (
                   prof_path["flash_decode_attention"] + k_attn_path
                   + mixed_attn_path
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
                         for c in acases if c != "serve_last"},
            windowed_32k=windowed["timing_32k_w4096"]),
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
    health_layer = product_layer["numeric_health"]
    kernels.append(kernel_row(
        "numeric_health", "src/repro_torch/csrc/numeric_health.cu",
        HEALTH_REPLACES, launches["numeric_health"], "serve_monitor", 0.0,
        health_layer[SERVE_BATCH],
        "the violation monitor's stats of the 7 GEMM products of one layer "
        "at decode (4 rows), hot in the L2 as the GEMM leaves them; "
        "library_ms null: no single PyTorch call computes the five stats",
        prefill_per_layer=health_layer[SERVE_BATCH * SERVE_PROMPT],
        port_only=True))
    round_layer = product_layer["round_k_inplace"]
    kernels.append(kernel_row(
        "round_k_inplace", "src/repro_torch/csrc/quant_matmul.cu",
        ROUND_K_REPLACES, launches["round_k_inplace"], "serve_monitor", 0.0,
        round_layer[SERVE_BATCH],
        f"the final rounding at k={SERVE_K}, in place, of the 7 GEMM "
        "products of one monitored layer at decode (4 rows), hot in the L2 "
        "as the GEMM and the health kernel leave them; bit for bit "
        "_quantize_normal; library_ms null: no PyTorch call rounds a "
        "mantissa to k bits",
        prefill_per_layer=round_layer[SERVE_BATCH * SERVE_PROMPT],
        port_only=True))
    for row in kernels:
        row["profile_roofline_frac"] = roofline.get(
            {"flash_decode_attention": "flash_decode"}.get(row["name"],
                                                           row["name"]))
    kernels += dtype_kernel_rows(dtype_parts, {"dtypes": by_path["dtypes"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
