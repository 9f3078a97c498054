"""Measured kernel/serving profiling: warmup + median-of-k timing against
analytic roofline terms (the PyTorch port of ``repro.obs.profile``).

Two entry points:

* :func:`profile_kernels` — times the port's kernels (``quant_matmul``,
  ``quant_matmul_dynamic_k``, ``quant_matmul_format``, ``flash_decode``)
  and a true-f32 ``torch.matmul`` baseline across shapes, precisions and
  formats. Every row carries the measured median beside the ANALYTIC terms
  (flops, bytes, intensity, roofline time at the
  :class:`repro_torch.obs.costmodel.Hardware` peaks), so achieved-vs-roofline
  is one division, and :func:`repro_torch.obs.costmodel.fit_cost_model` fits
  achieved (α, β) rates from the same rows.
* :func:`profile_serving` — runs the port's lock-step serve (prefill + a
  decode loop) for an arch's SMOKE config (the reference's) or its FULL
  published one under trace spans and digests the step latencies into
  p50/p95/p99 through :class:`repro_torch.obs.Histogram`.

Timing discipline (the reference's): ``warmup`` untimed calls, then ``reps``
timed calls, reported as the median. PyTorch returns before the card
finishes, so :func:`measure` synchronizes the device before and after each
timed call. Rows carry ``route``: ``"cuda"`` for a call timed on the card
(the hand-written kernel, or ``torch.matmul`` for the baseline) and
``"plain"`` for the plain PyTorch version timed on the CPU — the
counterpart of the reference's ``interpret`` flag; only ``cuda`` rows say
anything about the card.

No counterpart, not ported: the reference's Pallas tile sweep (``blocks``,
``block_candidates``) — the port's GEMM kernels pin their tile shape
because their bits must not depend on M — and its ``time_compile`` and
``jaxpr_stats`` gauges (PyTorch runs eagerly; the kernels are built once by
``kernels/_build.py``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.obs import trace as obs
from repro_torch.obs.costmodel import H100_SXM, Hardware, format_bits
from repro_torch.obs.metrics import MetricsRegistry

BYTES_F32 = 4  # the emulation's carrier width: everything streams as f32


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def measure(fn: Callable, *args, reps: int = 5, warmup: int = 2,
            **kwargs) -> Dict[str, float]:
    """Median-of-``reps`` wall time of ``fn(*args)``, post-warmup.

    The warmup calls absorb the kernels' first-use build and load and
    first-touch allocation; the device is synchronized before and after
    every timed call, so asynchronous launches cannot hide device time.
    Returns median/min/mean/max plus the raw samples."""
    for _ in range(max(warmup, 0)):
        fn(*args, **kwargs)
    times: List[float] = []
    for _ in range(max(reps, 1)):
        _sync()
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _sync()
        times.append(time.perf_counter() - t0)
    ts = sorted(times)
    n = len(ts)
    median = ts[n // 2] if n % 2 else 0.5 * (ts[n // 2 - 1] + ts[n // 2])
    return {"median_s": median, "min_s": ts[0], "max_s": ts[-1],
            "mean_s": sum(ts) / n, "reps": n, "samples": times}


def _terms(flops: float, bytes_moved: float, hw: Hardware) -> Dict[str, Any]:
    compute_s = flops / hw.peak_flops
    memory_s = bytes_moved / hw.hbm_bytes_per_s
    return {
        "flops": flops, "bytes": bytes_moved,
        "intensity": flops / bytes_moved,
        "compute_s": compute_s, "memory_s": memory_s,
        "roofline_s": max(compute_s, memory_s),
        "bound": "memory" if memory_s >= compute_s else "compute",
    }


def gemm_terms(M: int, K: int, N: int, bits: float = 32.0,
               hw: Hardware = H100_SXM) -> Dict[str, Any]:
    """Analytic roofline terms of one [M,K]@[K,N] GEMM at ``bits``/value
    storage: flops = 2·M·K·N, bytes = operands in + result out (each value
    touched once — the floor), intensity = flops/bytes vs the ridge."""
    return _terms(2.0 * M * K * N, (M * K + K * N + M * N) * bits / 8.0, hw)


def flash_decode_terms(B: int, S: int, K: int, G: int, D: int,
                       bits: float = 32.0,
                       hw: Hardware = H100_SXM) -> Dict[str, Any]:
    """Analytic terms of one flash-decode call: QK^T + PV are 2·2·B·K·G·S·D
    flops; bytes stream the KV cache once plus q in / o out."""
    return _terms(4.0 * B * K * G * S * D,
                  (2.0 * B * S * K * D + 2.0 * B * K * G * D) * bits / 8.0,
                  hw)


#: the reference's default sweep (small, shaped like real tiles)
DEFAULT_GEMM_SHAPES: Sequence[tuple] = ((128, 128, 128), (128, 256, 128))
DEFAULT_KS: Sequence[int] = (8, 24)
DEFAULT_FORMATS: Sequence[tuple] = ((4, 8, -6), (8, 15, -14))
DEFAULT_FLASH_SHAPES: Sequence[tuple] = ((2, 256, 2, 2, 64),)

ALL_KERNELS = ("matmul_baseline", "quant_matmul_dynamic_k",
               "quant_matmul_format", "flash_decode")


def _row(kernel: str, terms: Dict[str, Any], timing: Dict[str, float],
         **extra) -> Dict[str, Any]:
    med = timing["median_s"]
    return {
        "kernel": kernel,
        "median_s": med, "min_s": timing["min_s"], "reps": timing["reps"],
        "flops": terms["flops"], "bytes": terms["bytes"],
        "intensity": terms["intensity"],
        "roofline_s": terms["roofline_s"], "bound": terms["bound"],
        "achieved_flops_per_s": terms["flops"] / med if med > 0 else 0.0,
        "achieved_bytes_per_s": terms["bytes"] / med if med > 0 else 0.0,
        "roofline_frac": terms["roofline_s"] / med if med > 0 else 0.0,
        **extra,
    }


def profile_kernels(gemm_shapes: Iterable[tuple] = DEFAULT_GEMM_SHAPES,
                    ks: Iterable[int] = DEFAULT_KS,
                    formats: Iterable[tuple] = DEFAULT_FORMATS,
                    blocks: Optional[Iterable[tuple]] = None,
                    flash_shapes: Iterable[tuple] = DEFAULT_FLASH_SHAPES,
                    include: Sequence[str] = ALL_KERNELS,
                    reps: int = 5, warmup: int = 2, device: str = "cuda",
                    hw: Hardware = H100_SXM) -> List[Dict[str, Any]]:
    """Time every kernel across the sweep; one row per point, with the
    reference's kernel names and row keys (``route`` in place of
    ``interpret``). ``quant_matmul`` (kernel 3 called directly) is opt-in,
    as in the reference; ``quant_matmul_dynamic_k`` times it through the
    serving dispatch. On ``device="cpu"`` every row times a plain version.
    ``blocks`` has no counterpart (the kernels pin their tiles) and
    raises."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import quant_matmul as qmm
    from repro_torch.launch.serve import configure_precision, resolve_device

    if blocks is not None:
        raise ValueError("profile_kernels: the port's GEMM kernels pin one "
                         "tile shape (their bits must not depend on M), so "
                         "there is no block sweep")
    dev = resolve_device(device)
    configure_precision()          # the baseline is true f32 (no TF32)
    on_card = dev.type == "cuda"
    route = "cuda" if on_card else "plain"
    kernel_k = qmm.quant_matmul if on_card else (
        lambda a, b, *, k: qmm.quant_matmul_ref(a, b, k))
    flash = fd.flash_decode_attention if on_card else fd.flash_decode_ref
    rows: List[Dict[str, Any]] = []

    with torch.no_grad():
        for (M, K, N) in gemm_shapes:
            gen = torch.Generator(device=dev).manual_seed(M * K + N)
            x = torch.randn(M, K, generator=gen, device=dev)
            w = torch.randn(K, N, generator=gen, device=dev)
            shape = {"M": M, "K": K, "N": N, "shape": f"{M}x{K}x{N}"}
            terms32 = gemm_terms(M, K, N, 32.0, hw)

            if "matmul_baseline" in include:
                with obs.span("profile.kernel", kernel="matmul_baseline",
                              shape=shape["shape"]):
                    t = measure(torch.matmul, x, w, reps=reps, warmup=warmup)
                rows.append(_row("matmul_baseline", terms32, t, **shape,
                                 route=route))

            if "quant_matmul_dynamic_k" in include:
                for k in ks:
                    with obs.span("profile.kernel",
                                  kernel="quant_matmul_dynamic_k", k=int(k),
                                  shape=shape["shape"]):
                        t = measure(qmm.quant_matmul_dynamic_k, x, w, int(k),
                                    reps=reps, warmup=warmup)
                    rows.append(_row("quant_matmul_dynamic_k", terms32, t,
                                     **shape, k=int(k), route=route,
                                     format_bits=format_bits(k)))

            if "quant_matmul_format" in include:
                for (fk, femax, femin) in formats:
                    fmt = (int(fk), int(femax), int(femin))
                    with obs.span("profile.kernel",
                                  kernel="quant_matmul_format", k=fmt[0],
                                  shape=shape["shape"]):
                        t = measure(qmm.quant_matmul_format_dispatch, x, w,
                                    fmt, reps=reps, warmup=warmup)
                    rows.append(_row(
                        "quant_matmul_format", terms32, t, **shape,
                        k=fmt[0], emax=fmt[1], emin=fmt[2], route=route,
                        format_bits=format_bits(*fmt)))

            if "quant_matmul" in include:  # kernel 3 called directly
                for k in ks:
                    with obs.span("profile.kernel", kernel="quant_matmul",
                                  k=int(k), shape=shape["shape"]):
                        t = measure(kernel_k, x, w, k=int(k), reps=reps,
                                    warmup=warmup)
                    rows.append(_row("quant_matmul", terms32, t, **shape,
                                     k=int(k), route=route))

        if "flash_decode" in include:
            for (B, S, Kh, G, D) in flash_shapes:
                gen = torch.Generator(device=dev).manual_seed(S + D)
                q = torch.randn(B, Kh, G, D, generator=gen, device=dev)
                kc = torch.randn(B, S, Kh, D, generator=gen, device=dev)
                vc = torch.randn(B, S, Kh, D, generator=gen, device=dev)
                lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
                terms = flash_decode_terms(B, S, Kh, G, D, 32.0, hw)
                name = f"B{B}S{S}K{Kh}G{G}D{D}"
                with obs.span("profile.kernel", kernel="flash_decode",
                              shape=name):
                    t = measure(flash, q, kc, vc, lengths, reps=reps,
                                warmup=warmup)
                rows.append(_row("flash_decode", terms, t, B=B, S=S, K=Kh,
                                 G=G, D=D, shape=name, route=route))
    return rows


def profile_serving(arch: str = "qwen2_7b", max_layers: Optional[int] = 2,
                    batch: int = 2, prefill_len: int = 8,
                    decode_steps: int = 8,
                    precision_k: Optional[int] = None,
                    registry: Optional[MetricsRegistry] = None,
                    device: str = "cuda",
                    size: str = "smoke") -> Dict[str, Any]:
    """Profile the port's serving path end to end (the reference's
    defaults: SMOKE config, layer count capped, lock-step batch).
    ``size="full"`` profiles the arch's published config instead, whose
    timings are the card's rather than launch overhead; ``max_layers``
    None or 0 keeps the config's depth.

    Runs one prefill, one untimed decode (first-use kernel builds and
    allocations), then ``decode_steps`` timed decodes, each under a trace
    span and ending in a device synchronize. Latencies land in the
    registry's log-bucket histograms and come back as p50/p95/p99
    digests."""
    from repro_torch import configs
    from repro_torch.launch import serve as S
    from repro_torch.models import transformer as T

    if size not in ("smoke", "full"):
        raise ValueError(f"size must be 'smoke' or 'full', not {size!r}")
    dev = S.resolve_device(device)
    S.configure_precision()
    cfg = getattr(configs.get(arch), size.upper())
    if max_layers:
        cfg = dataclasses.replace(cfg,
                                  n_layers=min(cfg.n_layers, int(max_layers)))
    sc = S.ServeConfig(arch=arch, batch=batch,
                       max_seq=prefill_len + decode_steps + 1,
                       prefill_len=prefill_len, precision_k=precision_k,
                       device=str(dev))
    reg = registry if registry is not None else MetricsRegistry()
    reg.meta.update(arch=arch, size=size, batch=batch,
                    n_layers=cfg.n_layers, precision_k=precision_k)
    out: Dict[str, Any] = {"arch": arch, "size": size,
                           "n_layers": cfg.n_layers,
                           "batch": batch, "prefill_len": prefill_len,
                           "decode_steps": decode_steps,
                           "precision_k": precision_k, "device": str(dev)}

    bk = S._backend(sc)
    params = T.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    cache = T.init_cache(cfg, sc.batch, sc.max_seq, device=dev)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, (sc.batch, sc.prefill_len))).to(dev)
    with torch.no_grad():
        _sync()
        t0 = time.perf_counter()
        with obs.span("serve.prefill", arch=arch, batch=sc.batch,
                      prefill_len=sc.prefill_len):
            logits, cache = S.prefill_step(bk, params, cfg, cache, tokens)
            _sync()
        t_prefill = time.perf_counter() - t0
        reg.observe("serve.prefill_latency_s", t_prefill)

        tok = torch.argmax(logits[:, -1, :], dim=-1)
        tok, _, cache = S.decode_step(bk, params, cfg, cache, tok[:, None],
                                      sc.prefill_len)
        _sync()
        for i in range(decode_steps):
            td = time.perf_counter()
            with obs.span("serve.decode", step=i):
                tok, _, cache = S.decode_step(bk, params, cfg, cache,
                                              tok[:, None],
                                              sc.prefill_len + 1 + i)
                _sync()
            reg.observe("serve.decode_latency_s", time.perf_counter() - td)

    hp = reg.histograms["serve.decode_latency_s"]
    out.update({
        "prefill": {"latency_s": t_prefill,
                    "tokens_per_s": sc.batch * sc.prefill_len / t_prefill},
        "decode": {"percentiles": hp.percentiles(),
                   "mean_s": hp.mean, "count": hp.count,
                   "tokens_per_s": (sc.batch * hp.count / hp.sum
                                    if hp.sum > 0 else 0.0)},
    })
    return out
