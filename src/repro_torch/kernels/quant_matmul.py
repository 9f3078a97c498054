"""Emulated low-precision GEMMs with f32 accumulation: ``q(q(x) @ q(w))``.

The counterparts of the JAX package's ``repro.kernels.quant_matmul`` (Pallas
TPU kernels), each a hand-written CUDA kernel beside its plain PyTorch
version and the dispatch serving calls (the plain version for tensors on
the CPU, the kernel for tensors on the card, or an exception — no
fallback):

* q = rounding into a certified (k, emax, emin) format:
  :func:`quant_matmul_format` (``csrc/quant_matmul_format.cu``),
  :func:`quant_matmul_format_ref`, :func:`quant_matmul_format_dispatch`;
* q = mantissa-only RNE rounding to k bits over the full f32 exponent range
  (a v1 uniform or v2 per-layer certificate): :func:`quant_matmul`
  (``csrc/quant_matmul.cu``), :func:`quant_matmul_ref`,
  :func:`quant_matmul_dynamic_k`. k is a runtime int of the kernel, so one
  build serves every k.

Accumulation order differs between the kernels (one fixed sequential order
per element), PyTorch's CPU/cuBLAS GEMMs and XLA's: before the final
rounding they differ by at most 2·γ_K·(|q(x)| @ |q(w)|), and in practice by
a few √K·2⁻²⁴·(|q(x)| @ |q(w)|) (the rounding errors have random signs);
after it they are equal or, where that straddles a rounding boundary, a few
ulps at k apart. On operands whose partial sums are exact in f32 they are
equal bit for bit.

:func:`quant_matmul_format_seq_ref` and :func:`quant_matmul_seq_ref` add the
products in the kernels' own order (k = 0..K-1, from +0, one f32 rounding
per step). Where every product x̂·ŵ is exact in f32 (k ≤ 12, no underflow),
each step is the kernels' ``fmaf``, so these equal the kernels bit for bit
on any operands. They check the kernels' order; nothing serves through
them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quantize import _quantize_normal, quantize_to_format
from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int


def fmt_triple(fmt):
    """(k, emax, emin) as Python ints from a tuple or list."""
    k, emax, emin = (int(v) for v in fmt)
    return k, emax, emin


def quant_matmul_format_ref(x: torch.Tensor, w: torch.Tensor, fmt, *,
                            has_subnormals: bool = True,
                            saturating: bool = True) -> torch.Tensor:
    """Plain version: operands and result rounded with
    :func:`repro_torch.core.quantize.quantize_to_format`, the product by
    ``torch.matmul`` in f32."""
    k, emax, emin = fmt_triple(fmt)

    def q(v):
        return quantize_to_format(v.to(torch.float32), k, emax, emin,
                                  has_subnormals, saturating)

    return q(torch.matmul(q(x), q(w)))


def _seq_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """acc = acc + xq[:, j:j+1] * wq[j:j+1, :] for j = 0..K-1, in f32 from
    +0: one product and one rounded addition per step, in ascending j."""
    acc = torch.zeros((xq.shape[0], wq.shape[1]), dtype=torch.float32,
                      device=xq.device)
    for j in range(xq.shape[1]):
        acc = acc + xq[:, j:j + 1] * wq[j:j + 1, :]
    return acc


def quant_matmul_format_seq_ref(x: torch.Tensor, w: torch.Tensor, fmt, *,
                                has_subnormals: bool = True,
                                saturating: bool = True) -> torch.Tensor:
    """:func:`quant_matmul_format_ref` with the product summed in the
    kernel's sequential order (:func:`_seq_matmul`)."""
    k, emax, emin = fmt_triple(fmt)

    def q(v):
        return quantize_to_format(v.to(torch.float32), k, emax, emin,
                                  has_subnormals, saturating)

    return q(_seq_matmul(q(x), q(w)))


def _lib():
    lib = _build.load("quant_matmul_format")
    if not getattr(lib, "_typed", False):
        lib.repro_quant_matmul_format_f32.argtypes = [
            _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]
        lib.repro_quant_matmul_format_f32.restype = _I
        lib.repro_quantize_format_f32.argtypes = [
            _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _I, _P]
        lib.repro_quantize_format_f32.restype = _I
        lib._typed = True
    return lib


def _check_cuda_f32(name, t, ndim):
    if t.device.type != "cuda" or t.dtype != torch.float32:
        raise ValueError(f"{name}: needs a float32 CUDA tensor, got "
                         f"{t.dtype} on {t.device}")
    if t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous {ndim}-d tensor, got "
                         f"shape {tuple(t.shape)}")


def quant_matmul_format(x: torch.Tensor, w: torch.Tensor, fmt, *,
                        has_subnormals: bool = True,
                        saturating: bool = True) -> torch.Tensor:
    """The CUDA kernel: x f32[M, K] @ w f32[K, N] → f32[M, N], both on the
    card and contiguous. Launches on the current stream; raises on a
    refused launch. ``quant_matmul_format.launches`` counts launches."""
    _check_cuda_f32("x", x, 2)
    _check_cuda_f32("w", w, 2)
    M, K = x.shape
    K2, N = w.shape
    if K != K2 or w.device != x.device:
        raise ValueError(f"shapes {tuple(x.shape)} @ {tuple(w.shape)} on "
                         f"{x.device}/{w.device} do not match")
    k, emax, emin = fmt_triple(fmt)
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    rc = _lib().repro_quant_matmul_format_f32(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K, k, emax, emin,
        int(has_subnormals), int(saturating), _build.stream_ptr(x.device))
    _build.check(rc, "quant_matmul_format")
    quant_matmul_format.launches += 1
    return out


quant_matmul_format.launches = 0


def quantize_format_cuda(x: torch.Tensor, fmt, *, has_subnormals=True,
                         saturating=True) -> torch.Tensor:
    """Elementwise rounding by the kernels' device function (a check of
    ``csrc/quantize_format.cuh`` against the plain version; not on the
    serving path)."""
    _check_cuda_f32("x", x, x.dim())
    k, emax, emin = fmt_triple(fmt)
    y = torch.empty_like(x)
    rc = _lib().repro_quantize_format_f32(
        x.data_ptr(), y.data_ptr(), x.numel(), k, emax, emin,
        int(has_subnormals), int(saturating), _build.stream_ptr(x.device))
    _build.check(rc, "quantize_format")
    return y


def quant_matmul_format_dispatch(x: torch.Tensor, w: torch.Tensor, fmt, *,
                                 has_subnormals: bool = True,
                                 saturating: bool = True) -> torch.Tensor:
    """Serving dispatch. Tensors on the CPU take the plain version; tensors
    on the card launch the kernel (or raise — there is no fallback).
    Batched ``x`` [..., K] is flattened to [M, K] and restored after."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return quant_matmul_format_ref(x, w, fmt,
                                       has_subnormals=has_subnormals,
                                       saturating=saturating)
    lead, K = x.shape[:-1], x.shape[-1]
    out = quant_matmul_format(x.reshape(-1, K).contiguous(), w.contiguous(),
                              fmt, has_subnormals=has_subnormals,
                              saturating=saturating)
    return out.reshape(*lead, w.shape[-1])


def quant_matmul_ref(x: torch.Tensor, w: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version of :func:`quant_matmul` (the reference's
    ``ref.quant_matmul_ref``): operands and result RNE-rounded to ``k``
    mantissa bits by ``_quantize_normal``, the product by ``torch.matmul``
    in f32."""
    k = int(k)
    xq = _quantize_normal(x.to(torch.float32), k)
    wq = _quantize_normal(w.to(torch.float32), k)
    return _quantize_normal(torch.matmul(xq, wq), k)


def quant_matmul_seq_ref(x: torch.Tensor, w: torch.Tensor,
                        k: int) -> torch.Tensor:
    """:func:`quant_matmul_ref` with the product summed in the kernel's
    sequential order (:func:`_seq_matmul`)."""
    k = int(k)
    xq = _quantize_normal(x.to(torch.float32), k)
    wq = _quantize_normal(w.to(torch.float32), k)
    return _quantize_normal(_seq_matmul(xq, wq), k)


def _lib_k():
    lib = _build.load("quant_matmul")
    if not getattr(lib, "_typed", False):
        lib.repro_quant_matmul_f32.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P]
        lib.repro_quant_matmul_f32.restype = _I
        lib._typed = True
    return lib


def quant_matmul(x: torch.Tensor, w: torch.Tensor, *, k: int) -> torch.Tensor:
    """The CUDA kernel: x f32[M, K] @ w f32[K, N] → f32[M, N] at mantissa
    precision ``k`` ≥ 1 (k ≥ 24 rounds nothing), both on the card and
    contiguous. Launches on the current stream; raises on a refused launch.
    ``quant_matmul.launches`` counts launches."""
    _check_cuda_f32("x", x, 2)
    _check_cuda_f32("w", w, 2)
    M, K = x.shape
    K2, N = w.shape
    if K != K2 or w.device != x.device:
        raise ValueError(f"shapes {tuple(x.shape)} @ {tuple(w.shape)} on "
                         f"{x.device}/{w.device} do not match")
    k = int(k)
    if k < 1:
        raise ValueError(f"quant_matmul: k must be >= 1, got {k}")
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    rc = _lib_k().repro_quant_matmul_f32(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K, k,
        _build.stream_ptr(x.device))
    _build.check(rc, "quant_matmul")
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0


def quant_matmul_dynamic_k(x: torch.Tensor, w: torch.Tensor,
                           k: int) -> torch.Tensor:
    """Serving dispatch of the k-bit GEMM (the reference's function of the
    same name). Tensors on the CPU take the plain version; tensors on the
    card launch the kernel (or raise). ``k`` is a Python int: the port's
    layer loop is unrolled, so a per-layer k is resolved before the call.
    Batched ``x`` [..., K] is flattened to [M, K] and restored after."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return quant_matmul_ref(x, w, k)
    lead, K = x.shape[:-1], x.shape[-1]
    out = quant_matmul(x.reshape(-1, K).contiguous(), w.contiguous(), k=k)
    return out.reshape(*lead, w.shape[-1])
