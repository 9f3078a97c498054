"""Serving's products with one fixed order per row: the rmsnorm's mean and
the LM head.

A lane of the batching engine must give the bits it gives alone (the port's
contract "within the port, results are bitwise"). The serving kernels keep
it; PyTorch's library reductions and GEMMs choose their schedule by the row
count, and at Qwen2-7B's width the rmsnorm's mean and the LM head did not.
These two hand-written CUDA kernels, each beside its plain version, take
their place on the card:

* :func:`row_mean` (``csrc/row_mean.cu``): the mean over the last dim of an
  f32 ``[..., n]`` tensor, in an order that depends on n alone (256 strided
  per-thread sums, an xor butterfly a warp, the 8 warp sums in order);
  :func:`row_mean_ref` is that order in plain PyTorch, bit for bit.
* :func:`f32_matmul` (``csrc/f32_matmul.cu``): ``x @ w`` in f32, the
  certified GEMM body of kernels 1 and 3 with nothing rounded — one fmaf
  chain per output from +0 in k order, whatever M; :func:`f32_matmul_seq_ref`
  is that chain with ``fmaf`` emulated exactly, bit for bit.

:func:`row_mean_dispatch`, :func:`lm_head_dispatch` and
:func:`matmul_dispatch` are what serving calls (``TorchOps.mean`` /
``TorchOps.einsum`` / ``TorchOps.matmul`` on the card): the plain
version for tensors on the CPU, the kernel for tensors on the card, or an
exception — no fallback. Against ``torch.mean`` / ``torch.einsum`` both
differ only by summation order (a few f32 ulps of the sum of magnitudes).

MLA's two per-head weight products of a single-token step (into the
latent space and out of it, ``TorchOps.per_head_matmul``) also run
through :func:`f32_matmul`, on a :func:`block_diagonal` table of the
heads' weights: at MiniCPM3's widths the library product's bits depend on
the batch there.

Narrow instances (``compute_dtype`` "bfloat16", ``param_dtype`` "fp8"):
:func:`row_mean` reads bf16 rows and writes the f32 mean rounded to bf16;
:func:`f32_matmul` takes x in f32 or bf16 and w in f32, bf16 or e4m3
(``csrc/f32_matmul_narrow.cu``: the same body with its loads typed) and
writes x's dtype. Each is bit for bit its
f32 instance on the upcast operands followed by the cast, and the plain
versions upcast first; the dispatchers cast to the input's dtype.

These are port-only kernels: the JAX package has no Pallas kernel for
either (XLA computes both), so they replace no TPU kernel.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.caa_matmul import fmaf_rn
from repro_torch.kernels.quant_matmul import (BY_DTYPE, DTYPE_CODES,
                                              _lib_narrow,
                                              check_gemm_operands,
                                              dtype_key)

_P, _I = ctypes.c_void_p, ctypes.c_int

#: threads of a row_mean block (csrc/row_mean.cu's kThreads)
ROW_THREADS = 256


def _check_cuda_f32(name, t, ndim, dtypes=(torch.float32,)):
    if t.device.type != "cuda" or t.dtype not in dtypes:
        raise ValueError(f"{name}: needs a CUDA tensor of "
                         f"{[str(d) for d in dtypes]}, got {t.dtype} on "
                         f"{t.device}")
    if t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous {ndim}-d tensor, got "
                         f"shape {tuple(t.shape)}")


# --------------------------------------------------------------- row mean

def row_mean_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`row_mean` over the last dim of ``x``
    [..., n] (f32), keepdim: thread t of 256 adds x[t], x[t+256], ... from
    +0; each warp of 32 folds by an xor butterfly (offsets 16, 8, 4, 2, 1);
    the 8 warp sums add in order; the sum is divided by n. Bit for bit the
    kernel's."""
    lead, n = x.shape[:-1], x.shape[-1]
    rows = x.reshape(-1, n).to(torch.float32)
    R = rows.shape[0]
    cols = F.pad(rows, (0, (-n) % ROW_THREADS)).reshape(R, -1, ROW_THREADS)
    acc = torch.zeros((R, ROW_THREADS), dtype=torch.float32, device=x.device)
    for j in range(cols.shape[1]):
        acc = acc + cols[:, j]
    lanes = acc.reshape(R, ROW_THREADS // 32, 32)
    ar = torch.arange(32, device=x.device)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., ar ^ off]
    warps = lanes[..., 0]
    s = warps[:, 0]
    for w in range(1, ROW_THREADS // 32):
        s = s + warps[:, w]
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its rounded reciprocal, which is not IEEE division
    return (s / torch.full_like(s, float(n))).reshape(*lead, 1)


def _lib_mean():
    lib = _build.load("row_mean")
    if not getattr(lib, "_typed", False):
        for fn in (lib.repro_row_mean_f32, lib.repro_row_mean_bf16):
            fn.argtypes = [_P, _P, _I, _I, _P]
            fn.restype = _I
        lib._typed = True
    return lib


def row_mean(x: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel: x [R, n] (f32 or bf16) on the card, contiguous →
    [R] in x's dtype, each row's mean in the order of :func:`row_mean_ref`
    (in f32; a bf16 mean is the f32 one rounded). Launches on the current
    stream; raises on a refused launch. ``row_mean.launches`` counts
    launches."""
    _check_cuda_f32("x", x, 2, (torch.float32, torch.bfloat16))
    R, n = x.shape
    if n < 1:
        raise ValueError("row_mean: rows must not be empty")
    out = torch.empty((R,), dtype=x.dtype, device=x.device)
    lib = _lib_mean()
    fn = (lib.repro_row_mean_f32 if x.dtype == torch.float32
          else lib.repro_row_mean_bf16)
    rc = fn(x.data_ptr(), out.data_ptr(), R, n, _build.stream_ptr(x.device))
    _build.check(rc, "row_mean")
    row_mean.launches += 1
    BY_DTYPE["row_mean"][dtype_key(x)] += 1
    return out


row_mean.launches = 0
row_mean.launches_by_dtype = BY_DTYPE["row_mean"]


def row_mean_dispatch(x: torch.Tensor) -> torch.Tensor:
    """mean(x, -1, keepdim=True) of an f32 or bf16 tensor with a fixed
    order per row, in x's dtype: the plain version on the CPU, the kernel
    on the card."""
    if x.device.type == "cpu":
        return row_mean_ref(x).to(x.dtype)
    lead, n = x.shape[:-1], x.shape[-1]
    return row_mean(x.reshape(-1, n).contiguous()).reshape(*lead, 1)


# ------------------------------------------------------------ f32 product

def f32_matmul_seq_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`f32_matmul`: x f32[M, K] @ w f32[K, N] as
    acc = fmaf(x[:, j], w[j, :], acc) for j = 0..K-1 from +0, ``fmaf``
    emulated exactly (:func:`repro_torch.kernels.caa_matmul.fmaf_rn`). Bit
    for bit the kernel's."""
    x, w = x.to(torch.float32), w.to(torch.float32)
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32,
                      device=x.device)
    for j in range(x.shape[1]):
        acc = fmaf_rn(x[:, j:j + 1], w[j:j + 1, :], acc)
    return acc


def _lib_mm():
    lib = _build.load("f32_matmul")
    if not getattr(lib, "_typed", False):
        lib.repro_f32_matmul.argtypes = [_P, _P, _P, _I, _I, _I, _P]
        lib.repro_f32_matmul.restype = _I
        lib._typed = True
    return lib


def f32_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel: x [M, K] (f32 or bf16) @ w [K, N] (f32, bf16 or
    e4m3) → [M, N] in x's dtype, both on the card and contiguous, in the
    order of :func:`f32_matmul_seq_ref` (then cast). Launches on the
    current stream; raises on a refused launch. ``f32_matmul.launches``
    counts launches."""
    M, N, K = check_gemm_operands(x, w)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    stream = _build.stream_ptr(x.device)
    if x.dtype == w.dtype == torch.float32:
        rc = _lib_mm().repro_f32_matmul(x.data_ptr(), w.data_ptr(),
                                        out.data_ptr(), M, N, K, stream)
    else:
        rc = _lib_narrow("f32_matmul_narrow", "repro_f32_matmul_narrow",
                         [_P, _P, _P, _I, _I, _I, _I, _I, _P])(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K,
            DTYPE_CODES[x.dtype], DTYPE_CODES[w.dtype], stream)
    _build.check(rc, "f32_matmul")
    f32_matmul.launches += 1
    BY_DTYPE["f32_matmul"][dtype_key(x, w)] += 1
    return out


f32_matmul.launches = 0
f32_matmul.launches_by_dtype = BY_DTYPE["f32_matmul"]


def transposed(table: torch.Tensor) -> torch.Tensor:
    """A contiguous ``[D, V]`` copy of an embedding table ``[V, D]``: the
    layout the GEMM body reads w in (2.18 GB at Qwen2-7B's width in f32;
    an e4m3 table is copied as its bytes)."""
    if table.dtype == torch.float8_e4m3fn:
        return table.view(torch.uint8).t().contiguous().view(table.dtype)
    return table.t().contiguous()


def block_diagonal(blocks: torch.Tensor) -> torch.Tensor:
    """The ``[H·n_in, H·n_out]`` block-diagonal matrix of ``blocks`` [H,
    n_in, n_out], zeros off the blocks. ``x [..., H·n_in] @`` it through
    :func:`f32_matmul` is every head's own product in one launch, bit for
    bit head by head: a zero weight adds an exact ±0 to the fmaf chain, so
    each output is its head's n_in-long chain from +0 (finite x)."""
    H, n_in, n_out = blocks.shape
    bd = blocks.new_zeros((H, n_in, H, n_out))
    heads = torch.arange(H, device=blocks.device)
    bd[heads, :, heads, :] = blocks
    return bd.reshape(H * n_in, H * n_out)


def matmul_dispatch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., K] @ w [K, N]`` with a fixed order per output element, in
    x's dtype: the plain version on the CPU, the kernel on the card (``w``
    read as it lies: it must be contiguous, so no copy is made)."""
    lead, K = x.shape[:-1], x.shape[-1]
    rows = x.reshape(-1, K)
    if x.device.type == "cpu" and w.device.type == "cpu":
        out = f32_matmul_seq_ref(rows, w).to(x.dtype)
    else:
        out = f32_matmul(rows.contiguous(), w)
    return out.reshape(*lead, w.shape[-1])


def lm_head_dispatch(x: torch.Tensor, table_t: torch.Tensor) -> torch.Tensor:
    """``einsum('bsd,vd->bsv', x, table)`` with a fixed order per row, in
    x's dtype, given ``table_t`` = :func:`transposed` (table): the plain
    version on the CPU, the kernel on the card. ``x`` [..., D] is
    flattened to rows and restored after."""
    lead, D = x.shape[:-1], x.shape[-1]
    rows = x.reshape(-1, D)
    if x.device.type == "cpu" and table_t.device.type == "cpu":
        out = f32_matmul_seq_ref(rows, table_t).to(x.dtype)
    else:
        out = f32_matmul(rows.contiguous(), table_t)
    return out.reshape(*lead, table_t.shape[-1])
