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

Narrow operands (``compute_dtype`` "bfloat16", ``param_dtype`` "fp8"): x in
f32 or bf16, w in f32, bf16 or e4m3 (``csrc/quant_gemm.cuh``'s body with
its loads typed). Each kernel upcasts them in registers (exact) and runs
its f32 arithmetic in the same order, then writes the result in x's dtype
by RNE: bit for bit the f32
instance on the upcast operands followed by ``.to(x.dtype)``, the
reference's ``preferred_element_type=f32`` product and ``.astype``. The
plain versions upcast first, and the dispatchers cast their f32 result to
x's dtype. ``launches_by_dtype`` counts each wrapper's launches by operand
dtypes (``"f32/f32"``, ``"bf16/e4m3"``, ...).

:func:`quant_matmul_format_seq_ref` and :func:`quant_matmul_seq_ref` add the
products in the kernels' own order (k = 0..K-1, from +0, one f32 rounding
per step). Where every product x̂·ŵ is exact in f32 (k ≤ 12, no underflow),
each step is the kernels' ``fmaf``, so these equal the kernels bit for bit
on any operands. They check the kernels' order; nothing serves through
them.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.core.quantize import _quantize_normal, quantize_to_format
from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int


#: the C functions' dtype codes (csrc/gemm_common.cuh's OperandType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16",
               torch.float8_e4m3fn: "e4m3"}
X_DTYPES = (torch.float32, torch.bfloat16)       # activations
W_DTYPES = (torch.float32, torch.bfloat16, torch.float8_e4m3fn)   # weights


#: launches by kernel wrapper and instance (:func:`dtype_key`), also each
#: wrapper's ``launches_by_dtype``; kept here, not read off the wrapper's
#: name, so that a stand-in for a wrapper need not forward it
BY_DTYPE = collections.defaultdict(collections.Counter)


def dtype_key(*ts) -> str:
    """The instance a call launches, by its operands' dtypes: "f32/f32",
    "bf16/e4m3", ..."""
    return "/".join(DTYPE_NAMES.get(t.dtype, str(t.dtype)) for t in ts)


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


_NARROW_FNS = {}


def _lib_narrow(name, fn, argtypes):
    """``fn`` of the narrow instances' library ``csrc/<name>.cu``
    (:data:`repro_torch.kernels._build.NARROW_SOURCES`), typed."""
    f = _NARROW_FNS.get((name, fn))
    if f is None:
        f = getattr(_build.load(name), fn)
        f.argtypes, f.restype = argtypes, _I
        _NARROW_FNS[name, fn] = f
    return f


def _check_cuda_f32(name, t, ndim, dtypes=(torch.float32,)):
    if t.device.type != "cuda" or t.dtype not in dtypes:
        raise ValueError(f"{name}: needs a CUDA tensor of "
                         f"{[str(d) for d in dtypes]}, got {t.dtype} on "
                         f"{t.device}")
    if t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous {ndim}-d tensor, got "
                         f"shape {tuple(t.shape)}")


def check_gemm_operands(x, w):
    """(M, N, K) of x [M, K] (f32 or bf16) @ w [K, N] (f32, bf16 or e4m3),
    both contiguous on one card; raises ValueError on anything else."""
    _check_cuda_f32("x", x, 2, X_DTYPES)
    _check_cuda_f32("w", w, 2, W_DTYPES)
    M, K = x.shape
    K2, N = w.shape
    if K != K2 or w.device != x.device:
        raise ValueError(f"shapes {tuple(x.shape)} @ {tuple(w.shape)} on "
                         f"{x.device}/{w.device} do not match")
    return M, N, K


def _count(fn, name, key):
    fn.launches += 1
    BY_DTYPE[name][key] += 1


def quant_matmul_format(x: torch.Tensor, w: torch.Tensor, fmt, *,
                        has_subnormals: bool = True,
                        saturating: bool = True) -> torch.Tensor:
    """The CUDA kernel: x [M, K] (f32 or bf16) @ w [K, N] (f32, bf16 or
    e4m3) → [M, N] in x's dtype, both on the card and contiguous. Launches
    on the current stream; raises on a refused launch.
    ``quant_matmul_format.launches`` counts launches."""
    M, N, K = check_gemm_operands(x, w)
    k, emax, emin = fmt_triple(fmt)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    args = (x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K, k, emax,
            emin, int(has_subnormals), int(saturating))
    if x.dtype == w.dtype == torch.float32:
        rc = _lib().repro_quant_matmul_format_f32(
            *args, _build.stream_ptr(x.device))
    else:
        rc = _lib_narrow(
            "quant_matmul_format_narrow", "repro_quant_matmul_format_narrow",
            [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P])(
            *args, DTYPE_CODES[x.dtype], DTYPE_CODES[w.dtype],
            _build.stream_ptr(x.device))
    _build.check(rc, "quant_matmul_format")
    _count(quant_matmul_format, "quant_matmul_format", dtype_key(x, w))
    return out


quant_matmul_format.launches = 0
quant_matmul_format.launches_by_dtype = BY_DTYPE["quant_matmul_format"]


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
    Batched ``x`` [..., K] is flattened to [M, K] and restored after; the
    result is in x's dtype."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return quant_matmul_format_ref(x, w, fmt,
                                       has_subnormals=has_subnormals,
                                       saturating=saturating).to(x.dtype)
    lead, K = x.shape[:-1], x.shape[-1]
    out = quant_matmul_format(x.reshape(-1, K).contiguous(), w.contiguous(),
                              fmt, has_subnormals=has_subnormals,
                              saturating=saturating)
    return out.reshape(*lead, w.shape[-1])


def quant_matmul_ref(x: torch.Tensor, w: torch.Tensor, k: int,
                     observe=None) -> torch.Tensor:
    """Plain version of :func:`quant_matmul` (the reference's
    ``ref.quant_matmul_ref``): operands and result RNE-rounded to ``k``
    mantissa bits by ``_quantize_normal``, the product by ``torch.matmul``
    in f32. ``observe`` (None, or a callable) is handed the f32 product
    before its final rounding."""
    k = int(k)
    xq = _quantize_normal(x.to(torch.float32), k)
    wq = _quantize_normal(w.to(torch.float32), k)
    acc = torch.matmul(xq, wq)
    if observe is not None:
        observe(acc)
    return _quantize_normal(acc, k)


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
        for fn in (lib.repro_quant_matmul_f32,
                   lib.repro_quant_matmul_raw_f32):
            fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P]
            fn.restype = _I
        lib.repro_quantize_k_inplace_f32.argtypes = [
            _P, ctypes.c_longlong, _I, _P]
        lib.repro_quantize_k_inplace_f32.restype = _I
        lib._typed = True
    return lib


def quant_matmul(x: torch.Tensor, w: torch.Tensor, *, k: int,
                 raw: bool = False) -> torch.Tensor:
    """The CUDA kernel: x [M, K] (f32 or bf16) @ w [K, N] (f32, bf16 or
    e4m3) → [M, N] in x's dtype at mantissa precision ``k`` ≥ 1 (k ≥ 24
    rounds nothing), both on the card and contiguous. Launches on the
    current stream; raises on a refused launch. ``quant_matmul.launches``
    counts launches.

    ``raw=True`` launches the instance whose epilogue leaves the f32
    accumulator unrounded, in f32 whatever x's dtype (the operands are
    rounded as always, and the sums run in the same order):
    :func:`round_k_inplace` then gives the f32 bits of ``raw=False``."""
    M, N, K = check_gemm_operands(x, w)
    k = int(k)
    if k < 1:
        raise ValueError(f"quant_matmul: k must be >= 1, got {k}")
    out = torch.empty((M, N), dtype=torch.float32 if raw else x.dtype,
                      device=x.device)
    stream = _build.stream_ptr(x.device)
    if x.dtype == w.dtype == torch.float32:
        lib = _lib_k()
        fn = (lib.repro_quant_matmul_raw_f32 if raw
              else lib.repro_quant_matmul_f32)
        rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K, k,
                stream)
    else:
        rc = _lib_narrow("quant_matmul_narrow", "repro_quant_matmul_narrow",
                         [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P])(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K, k, int(raw),
            DTYPE_CODES[x.dtype], DTYPE_CODES[w.dtype], stream)
    _build.check(rc, "quant_matmul")
    _count(quant_matmul, "quant_matmul", dtype_key(x, w))
    return out


quant_matmul.launches = 0
quant_matmul.launches_by_dtype = BY_DTYPE["quant_matmul"]


def round_k_inplace(t: torch.Tensor, k: int) -> torch.Tensor:
    """``t`` ← RNE rounding of its mantissa to ``k`` bits, in place, by the
    GEMM epilogue's own device function (``t`` a contiguous f32 tensor on
    the card); returns ``t``. What rounds a ``raw=True`` product of
    :func:`quant_matmul` after a monitor has read it. Its plain version is
    ``_quantize_normal(t, k)``; ``round_k_inplace.launches`` counts
    launches."""
    _check_cuda_f32("t", t, t.dim())
    rc = _lib_k().repro_quantize_k_inplace_f32(
        t.data_ptr(), t.numel(), int(k), _build.stream_ptr(t.device))
    _build.check(rc, "quantize_k_inplace")
    round_k_inplace.launches += 1
    return t


round_k_inplace.launches = 0


def quant_matmul_dynamic_k(x: torch.Tensor, w: torch.Tensor, k: int,
                           observe=None) -> torch.Tensor:
    """Serving dispatch of the k-bit GEMM (the reference's function of the
    same name). Tensors on the CPU take the plain version; tensors on the
    card launch the kernel (or raise). ``k`` is a Python int: the port's
    layer loop is unrolled, so a per-layer k is resolved before the call.
    Batched ``x`` [..., K] is flattened to [M, K] and restored after.

    ``observe`` (None, or a callable) is handed the f32 product before its
    final rounding, as the reference's uniform-k backend observes it; the
    product is then rounded in place, to the same bits as without
    ``observe``. On the card that is one launch of the kernel's raw instance
    and one of :func:`round_k_inplace`: no second GEMM. The result is in
    x's dtype (after ``observe``, a bf16 product is cast from the rounded
    f32 one)."""
    lead, K, N = x.shape[:-1], x.shape[-1], w.shape[-1]
    if x.device.type == "cpu" and w.device.type == "cpu":
        return quant_matmul_ref(x, w, k, observe).to(x.dtype)
    x2, w = x.reshape(-1, K).contiguous(), w.contiguous()
    if observe is None:
        return quant_matmul(x2, w, k=k).reshape(*lead, N)
    out = quant_matmul(x2, w, k=k, raw=True)
    observe(out.reshape(*lead, N))
    return round_k_inplace(out, k).reshape(*lead, N).to(x.dtype)
