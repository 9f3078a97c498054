"""Fused value + absolute-error-bound GEMM of the CAA analysis.

The counterpart of the JAX package's ``repro.kernels.caa_matmul`` (a Pallas
TPU kernel): for x, dbar [M, K] and W [K, N], all f32,

    val = x @ W
    err = (dbar + g·|x|) @ |W|        (units of u; g = the rule's γ(K))

— with exact weights, the dbar term of the CAA contraction rule
(``repro_torch.core.caa.contract``). :func:`caa_matmul` is the hand-written
CUDA kernel (``csrc/caa_matmul.cu``), :func:`caa_matmul_plain` its plain
PyTorch version; :func:`repro_torch.kernels.ops.caa_matmul_fused` takes the
plain version for tensors on the CPU and the kernel for tensors on the card
(or raises — there is no fallback).

Both round g up to f32, so the f32 bound still covers the analysis's f64
g. The kernel's err is an upper bound by construction (directed rounding
up, ≥ the exact value of its f32 operands); the plain version's err is
rounded to nearest, as the reference's. val is round-to-nearest in both,
summed in different orders: they differ by a few √K·2⁻²⁴·(|x|@|W|).

:func:`caa_matmul_seq_ref` repeats the kernel's own arithmetic step by step
(k = 0..K-1 from +0, t staged once, ``fmaf`` and ``__fmaf_ru`` emulated
exactly by :func:`fmaf_rn` and :func:`fmaf_ru`), so it equals the kernel bit
for bit on any operands. It checks the kernel's order; nothing serves
through it.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quant_matmul import _check_cuda_f32

_P, _I = ctypes.c_void_p, ctypes.c_int


def g_up_f32(g: float) -> float:
    """The smallest f32 value ≥ ``g`` (as a Python float)."""
    g32 = np.float32(g)
    if float(g32) < g:
        g32 = np.nextafter(g32, np.float32(math.inf))
    return float(g32)


def _fma_round_to_odd(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """a·b + c of f32 tensors (broadcast) in f64, rounded to odd: the f64
    product is exact, a two-sum gives the sum s and its residual e exactly,
    and where e ≠ 0 and s is even, s moves one f64 step toward e. Rounding
    that once more, to f32, gives the exact value's f32 rounding, to nearest
    or up (round to odd then round: 53 ≥ 24 + 2 bits, Boldo and Melquiond,
    IEEE TC 2008)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)      # NaN where s is not finite
    inexact = ((e > 0) | (e < 0)) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.copysign(torch.full_like(s, math.inf), e)
    return torch.where(inexact, torch.nextafter(s, toward), s)


def fmaf_rn(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """f32 ``fmaf(a, b, c)``: a·b + c rounded once to nearest (ties to
    even), on f32 tensors (broadcast)."""
    return _fma_round_to_odd(a, b, c).float()


def fmaf_ru(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """f32 ``__fmaf_ru(a, b, c)``: a·b + c rounded once toward +inf, on
    f32 tensors (broadcast): the nearest f32 of the odd-rounded sum, or the
    f32 above it where that lies below the sum."""
    s = _fma_round_to_odd(a, b, c)
    r = s.float()
    return torch.where(r.double() < s,
                       torch.nextafter(r, torch.full_like(r, math.inf)), r)


def caa_matmul_plain(x: torch.Tensor, dbar: torch.Tensor, w: torch.Tensor,
                     *, g: float):
    """Plain version: (x @ W, (dbar + g↑·|x|) @ |W|) by ``torch.matmul`` in
    f32, g↑ = g rounded up to f32."""
    x, dbar, w = (t.to(torch.float32) for t in (x, dbar, w))
    t = dbar + g_up_f32(g) * x.abs()
    return torch.matmul(x, w), torch.matmul(t, w.abs())


def caa_matmul_seq_ref(x: torch.Tensor, dbar: torch.Tensor,
                       w: torch.Tensor, *, g: float):
    """The kernel's arithmetic in plain PyTorch: t = __fmaf_ru(g↑, |x|,
    dbar) once per element, then for k = 0..K-1 from +0, val = fmaf(x_k,
    w_k, val) and err = __fmaf_ru(t_k, |w_k|, err). Bit for bit the
    kernel's (val, err)."""
    x, dbar, w = (v.to(torch.float32) for v in (x, dbar, w))
    g32 = torch.full_like(x, g_up_f32(g))
    t = fmaf_ru(g32, x.abs(), dbar)
    aw = w.abs()
    shape = (x.shape[0], w.shape[1])
    val = torch.zeros(shape, dtype=torch.float32, device=x.device)
    err = torch.zeros_like(val)
    for k in range(x.shape[1]):
        val = fmaf_rn(x[:, k:k + 1], w[k:k + 1], val)
        err = fmaf_ru(t[:, k:k + 1], aw[k:k + 1], err)
    return val, err


def _lib():
    lib = _build.load("caa_matmul")
    if not getattr(lib, "_typed", False):
        lib.repro_caa_matmul_f32.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I,
                                             ctypes.c_float, _P]
        lib.repro_caa_matmul_f32.restype = _I
        lib._typed = True
    return lib


def caa_matmul(x: torch.Tensor, dbar: torch.Tensor, w: torch.Tensor, *,
               g: float):
    """The CUDA kernel: x, dbar f32[M, K] and w f32[K, N] on the card,
    contiguous → (val, err) f32[M, N]. Launches on the current stream;
    raises on a refused launch. ``caa_matmul.launches`` counts launches."""
    _check_cuda_f32("x", x, 2)
    _check_cuda_f32("dbar", dbar, 2)
    _check_cuda_f32("w", w, 2)
    M, K = x.shape
    K2, N = w.shape
    if (K != K2 or dbar.shape != x.shape or w.device != x.device
            or dbar.device != x.device):
        raise ValueError(f"shapes {tuple(x.shape)}, {tuple(dbar.shape)} @ "
                         f"{tuple(w.shape)} on {x.device}/{dbar.device}/"
                         f"{w.device} do not match")
    g32 = g_up_f32(g)
    if not g32 >= 0.0:
        raise ValueError(f"caa_matmul: g must be >= 0, got {g}")
    val = torch.empty((M, N), dtype=torch.float32, device=x.device)
    err = torch.empty_like(val)
    rc = _lib().repro_caa_matmul_f32(
        x.data_ptr(), dbar.data_ptr(), w.data_ptr(), val.data_ptr(),
        err.data_ptr(), M, N, K, g32, _build.stream_ptr(x.device))
    _build.check(rc, "caa_matmul")
    caa_matmul.launches += 1
    return val, err


caa_matmul.launches = 0
