"""Interval GEMM of rigorous inference: [lo, hi] @ constant W.

The counterpart of the JAX package's ``repro.kernels.interval_matmul`` (a
Pallas TPU kernel): for interval activations lo, hi [M, K] and W [K, N],
all f32, the raw sign-split enclosure and the magnitude majorant

    lo'  = lo @ W⁺ + hi @ W⁻        hi' = hi @ W⁺ + lo @ W⁻
    mag' = max(|lo|, |hi|) @ |W|

(W⁺ = max(W, 0), W⁻ = min(W, 0)), accumulated in f32 round to nearest. The
bounds become a rigorous enclosure only after the γ-slop widening of
:func:`repro_torch.kernels.ops.interval_matmul_rigorous`.
:func:`interval_matmul` is the hand-written CUDA kernel
(``csrc/interval_matmul.cu``: the sign split is taken per term, as two
fmas per bound predicated on w ≥ 0, of which one runs),
:func:`interval_matmul_plain` its plain PyTorch version (five products, as
the reference writes it). :func:`interval_matmul_seq_ref` repeats the
kernel's own arithmetic step by step (k = 0..K-1 from +0, one emulated
``fmaf`` per term and bound), so it equals the kernel bit for bit on any
operands; it checks the kernel's order, and nothing serves through it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.caa_matmul import fmaf_rn
from repro_torch.kernels.quant_matmul import _check_cuda_f32

_P, _I = ctypes.c_void_p, ctypes.c_int


def interval_matmul_plain(lo: torch.Tensor, hi: torch.Tensor,
                          w: torch.Tensor):
    """Plain version: (lo', hi', mag') by ``torch.matmul`` in f32."""
    lo, hi, w = (t.to(torch.float32) for t in (lo, hi, w))
    wp = torch.clamp(w, min=0.0)
    wm = torch.clamp(w, max=0.0)
    out_lo = torch.matmul(lo, wp) + torch.matmul(hi, wm)
    out_hi = torch.matmul(hi, wp) + torch.matmul(lo, wm)
    mag = torch.matmul(torch.maximum(lo.abs(), hi.abs()), w.abs())
    return out_lo, out_hi, mag


def interval_matmul_seq_ref(lo: torch.Tensor, hi: torch.Tensor,
                            w: torch.Tensor):
    """The kernel's arithmetic in plain PyTorch: mag = fmaxf(|lo|, |hi|)
    once per element, then for k = 0..K-1 from +0, with p = w_k ≥ 0,
    lo' = fmaf(p ? lo_k : hi_k, w_k, lo'), hi' = fmaf(p ? hi_k : lo_k, w_k,
    hi'), mag' = fmaf(mag_k, |w_k|, mag'). Bit for bit the kernel's
    (lo', hi', mag'), unwidened."""
    lo, hi, w = (v.to(torch.float32) for v in (lo, hi, w))
    mag = torch.fmax(lo.abs(), hi.abs())
    aw = w.abs()
    # the three chains stacked, one emulated fmaf a step
    acc = torch.zeros((3, lo.shape[0], w.shape[1]), dtype=torch.float32,
                      device=lo.device)
    for k in range(lo.shape[1]):
        wk = w[k:k + 1]
        pos = wk >= 0
        lk, hk = lo[:, k:k + 1], hi[:, k:k + 1]
        a = torch.stack([torch.where(pos, lk, hk), torch.where(pos, hk, lk),
                         mag[:, k:k + 1].expand_as(acc[2])])
        acc = fmaf_rn(a, torch.stack([wk, wk, aw[k:k + 1]]), acc)
    return tuple(acc)


def _lib():
    lib = _build.load("interval_matmul")
    if not getattr(lib, "_typed", False):
        lib.repro_interval_matmul_f32.argtypes = [_P, _P, _P, _P, _P, _P, _I,
                                                  _I, _I, _P]
        lib.repro_interval_matmul_f32.restype = _I
        lib._typed = True
    return lib


def interval_matmul(lo: torch.Tensor, hi: torch.Tensor, w: torch.Tensor):
    """The CUDA kernel: lo, hi f32[M, K] and w f32[K, N] on the card,
    contiguous → (lo', hi', mag') f32[M, N], unwidened. Launches on the
    current stream; raises on a refused launch. ``interval_matmul.launches``
    counts launches."""
    _check_cuda_f32("lo", lo, 2)
    _check_cuda_f32("hi", hi, 2)
    _check_cuda_f32("w", w, 2)
    M, K = lo.shape
    K2, N = w.shape
    if (K != K2 or hi.shape != lo.shape or w.device != lo.device
            or hi.device != lo.device):
        raise ValueError(f"shapes {tuple(lo.shape)}, {tuple(hi.shape)} @ "
                         f"{tuple(w.shape)} on {lo.device}/{hi.device}/"
                         f"{w.device} do not match")
    outs = [torch.empty((M, N), dtype=torch.float32, device=lo.device)
            for _ in range(3)]
    rc = _lib().repro_interval_matmul_f32(
        lo.data_ptr(), hi.data_ptr(), w.data_ptr(),
        *(o.data_ptr() for o in outs), M, N, K, _build.stream_ptr(lo.device))
    _build.check(rc, "interval_matmul")
    interval_matmul.launches += 1
    return tuple(outs)


interval_matmul.launches = 0
