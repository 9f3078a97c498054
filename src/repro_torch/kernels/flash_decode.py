"""Flash decode attention (GQA, one query token), certified and plain.

The counterparts of the JAX package's ``repro.kernels.flash_decode`` (Pallas
TPU kernels), each a hand-written CUDA kernel beside its plain PyTorch
version:

* certificate-aware: q, k and v are rounded into a certified (k, emax,
  emin) format, the softmax runs in f32, and the output ``acc / l`` is
  rounded once; scores and probabilities are not rounded.
  :func:`flash_decode_certified` launches ``csrc/flash_decode_certified.cu``,
  :func:`flash_decode_quantized_ref` is its plain version (one pass over the
  whole cache, the op order of the reference's eager oracle), and
  :func:`certified_decode_attention` is what serving calls: the plain
  version for tensors on the CPU, the kernel for tensors on the card.
* uncertified: :func:`flash_decode_attention` launches
  ``csrc/flash_decode.cu`` (the same kernel with the rounding compiled out),
  :func:`flash_decode_ref` is its plain version (the reference's
  ``ref.flash_decode_ref``).

Both mask positions at or beyond ``lengths[b]`` with a score of -1e30, as
the reference does, so a lane of length 0 attends uniformly to all S cached
positions (the mean of v).

The kernels walk the cache in tiles with an online softmax, so their sums
run in another order than the plain versions': before any final rounding
the two differ by a few f32 ulps of max|v|; after it they are equal or an
ulp at k apart.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quantize import quantize_to_format
from repro_torch.kernels import _build
from repro_torch.kernels.quant_matmul import fmt_triple

NEG = -1e30

_P, _I = ctypes.c_void_p, ctypes.c_int


def flash_decode_quantized_ref(q, k, v, lengths, fmt, *,
                               has_subnormals: bool = True,
                               saturating: bool = True) -> torch.Tensor:
    """Plain version. q [B, K, G, D]; k, v [B, S, K, D]; lengths [B] valid
    cache lengths. Returns [B, K, G, D]."""
    kk, emax, emin = fmt_triple(fmt)

    def qf(t):
        return quantize_to_format(t.to(torch.float32), kk, emax, emin,
                                  has_subnormals, saturating)

    D, S = q.shape[-1], k.shape[1]
    qq, kq, vq = qf(q), qf(k), qf(v)
    s = torch.einsum("bhgd,bshd->bhgs", qq, kq) * D ** -0.5
    pos = torch.arange(S, device=q.device)
    valid = pos[None, :] < lengths.to(q.device)[:, None]       # [B, S]
    s = torch.where(valid[:, None, None, :], s, NEG)
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgs,bshd->bhgd", p, vq)
    return qf(acc / l).to(q.dtype)


def _lib():
    lib = _build.load("flash_decode_certified")
    if not getattr(lib, "_typed", False):
        lib.repro_flash_decode_certified_f32.argtypes = [
            _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float,
            _I, _I, _I, _I, _I, _P]
        lib.repro_flash_decode_certified_f32.restype = _I
        lib._typed = True
    return lib


def _check_decode_args(q, k, v, lengths):
    """Shapes (B, S, H, G, D) of a decode-attention call, after checking
    what the kernels take; raises ValueError on anything else."""
    for name, t in {"q": q, "k": k, "v": v}.items():
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise ValueError(f"{name}: needs a float32 CUDA tensor, got "
                             f"{t.dtype} on {t.device}")
        if not t.is_contiguous() or t.dim() != 4:
            raise ValueError(f"{name}: needs a contiguous 4-d tensor")
    B, H, G, D = q.shape
    S = k.shape[1]
    if k.shape != (B, S, H, D) or v.shape != k.shape or S < 1:
        raise ValueError(f"cache shapes {tuple(k.shape)}/{tuple(v.shape)} "
                         f"do not fit q {tuple(q.shape)}")
    if G > 8 or D > 128:
        raise ValueError(f"kernel takes G <= 8 and D <= 128, got G={G}, "
                         f"D={D}")
    if (lengths.dtype != torch.int32 or lengths.shape != (B,)
            or lengths.device != q.device or not lengths.is_contiguous()):
        raise ValueError("lengths: needs a contiguous int32 [B] tensor on "
                         "q's device")
    return B, S, H, G, D


def flash_decode_certified(q, k, v, lengths, fmt, *,
                           has_subnormals: bool = True,
                           saturating: bool = True) -> torch.Tensor:
    """The CUDA kernel. q f32[B, K, G, D], k/v f32[B, S, K, D] with S ≥ 1,
    lengths int32[B], all contiguous on one card; G ≤ 8 and D ≤ 128.
    ``flash_decode_certified.launches`` counts launches."""
    B, S, H, G, D = _check_decode_args(q, k, v, lengths)
    kk, emax, emin = fmt_triple(fmt)
    out = torch.empty_like(q)
    rc = _lib().repro_flash_decode_certified_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), B, S, H, G, D, D ** -0.5, kk, emax, emin,
        int(has_subnormals), int(saturating), _build.stream_ptr(q.device))
    _build.check(rc, "flash_decode_certified")
    flash_decode_certified.launches += 1
    return out


flash_decode_certified.launches = 0


def certified_decode_attention(q, k, v, lengths, fmt, *,
                               has_subnormals: bool = True,
                               saturating: bool = True) -> torch.Tensor:
    """Serving dispatch: the plain version for tensors on the CPU, the
    kernel for tensors on the card (or an exception — no fallback)."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_decode_quantized_ref(q, k, v, lengths, fmt,
                                          has_subnormals=has_subnormals,
                                          saturating=saturating)
    return flash_decode_certified(q.contiguous(), k.contiguous(),
                                  v.contiguous(), lengths, fmt,
                                  has_subnormals=has_subnormals,
                                  saturating=saturating)


def flash_decode_ref(q, k, v, lengths) -> torch.Tensor:
    """Plain version of :func:`flash_decode_attention` (the reference's
    ``ref.flash_decode_ref``): q [B, K, G, D], k/v [B, S, K, D], lengths
    [B]; masked scores, softmax in f32, returns [B, K, G, D]."""
    D, S = q.shape[-1], k.shape[1]
    s = torch.einsum("bkgd,bskd->bkgs", q, k) * D ** -0.5
    pos = torch.arange(S, device=q.device)
    valid = pos[None, :] < lengths.to(q.device)[:, None]       # [B, S]
    s = torch.where(valid[:, None, None, :], s, NEG)
    p = torch.softmax(s.to(torch.float32), dim=-1)
    return torch.einsum("bkgs,bskd->bkgd", p,
                        v.to(torch.float32)).to(q.dtype)


def _lib_plain():
    lib = _build.load("flash_decode")
    if not getattr(lib, "_typed", False):
        lib.repro_flash_decode_f32.argtypes = [
            _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P]
        lib.repro_flash_decode_f32.restype = _I
        lib._typed = True
    return lib


def flash_decode_attention(q, k, v, lengths) -> torch.Tensor:
    """The CUDA kernel of uncertified decode attention. q f32[B, K, G, D],
    k/v f32[B, S, K, D] with S ≥ 1, lengths int32[B], all contiguous on one
    card; G ≤ 8 and D ≤ 128 (Qwen2-7B needs G=7, D=128).
    ``flash_decode_attention.launches`` counts launches."""
    B, S, H, G, D = _check_decode_args(q, k, v, lengths)
    out = torch.empty_like(q)
    rc = _lib_plain().repro_flash_decode_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), B, S, H, G, D, D ** -0.5,
        _build.stream_ptr(q.device))
    _build.check(rc, "flash_decode_attention")
    flash_decode_attention.launches += 1
    return out


flash_decode_attention.launches = 0
