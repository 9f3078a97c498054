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

The kernels split the cache into chunks of :data:`FD_CHUNK` positions, one
block each, and fold the chunks' (max, sum, acc) partials in chunk order
(``csrc/flash_decode.cuh``); :func:`flash_decode_split_ref` is that
algorithm in plain PyTorch. Their sums run in another order than the plain
versions': before any final rounding the two differ by a few f32 ulps of
max|v|; after it they are equal or an ulp at k apart. Within the kernels
each output's order depends on its lane's length only, so a lane's bits do
not depend on the batch, its place in it, the other lanes or the cache's
capacity.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quantize import quantize_to_format
from repro_torch.kernels import _build
from repro_torch.kernels.quant_matmul import fmt_triple

NEG = -1e30
FD_CHUNK = 64      # cached positions a kernel block takes (flash_decode.cuh)

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



def flash_decode_split_ref(q, k, v, lengths, fmt=None, *,
                           has_subnormals: bool = True,
                           saturating: bool = True,
                           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of the kernels' split algorithm: chunk partials over
    FD_CHUNK positions from position 0 (m_c = max(-1e30, max s), l_c = Σ p,
    acc_c = Σ p·v̂ with p = exp(s - m_c) over the chunk's attended
    positions), folded in chunk order by the online recurrence. ``fmt``
    None: no rounding (kernel 4); else q, k, v and the output are rounded
    into it (kernel 2). Positions past a lane's length are never read.
    The scores and sums run in ``dtype``: in f32 this is the kernels'
    algorithm; in f64 it is the yardstick that the card checks hold the
    kernels to under a rule tight enough to fail a chunk dropped or folded
    with a wrong weight. Shapes as :func:`flash_decode_quantized_ref`; not
    on the serving path."""
    def rnd(t):
        if fmt is None:
            return t
        return quantize_to_format(t, *fmt_triple(fmt), has_subnormals,
                                  saturating)

    qf = lambda t: rnd(t.to(torch.float32)).to(dtype)
    B, H, G, D = q.shape
    S = k.shape[1]
    nc_max = -(-S // FD_CHUNK)
    Sp = nc_max * FD_CHUNK
    lengths = lengths.to(device=q.device, dtype=torch.int64)
    n = torch.where(lengths <= 0, S, lengths.clamp(max=S))     # attended
    real = torch.arange(Sp, device=q.device)[None, :] < n[:, None]
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, Sp - S))
    # what the kernels never read is zero here, so it cannot reach the sums
    kq = torch.where(real[:, :, None, None], qf(pad(k)), 0.0)
    vq = torch.where(real[:, :, None, None], qf(pad(v)), 0.0)
    s = torch.einsum("bhgd,bshd->bhgs", qf(q), kq) * D ** -0.5
    s = torch.where((lengths <= 0)[:, None, None, None], NEG, s)
    s = s.reshape(B, H, G, nc_max, FD_CHUNK)
    real_c = real.reshape(B, 1, 1, nc_max, FD_CHUNK)
    m_c = torch.where(real_c, s, NEG).amax(dim=-1).clamp_min(NEG)
    p = torch.where(real_c, torch.exp(s - m_c[..., None]), 0.0)
    l_c = p.sum(dim=-1)
    acc_c = torch.einsum("bhgcj,bcjhd->bhgcd", p,
                         vq.reshape(B, nc_max, FD_CHUNK, H, D))
    nc = -(-n // FD_CHUNK)                                      # [B]
    m, l, acc = m_c[..., 0], l_c[..., 0], acc_c[..., 0, :]
    for c in range(1, nc_max):
        live = (c < nc)[:, None, None]
        m2 = torch.maximum(m, m_c[..., c])
        a, bt = torch.exp(m - m2), torch.exp(m_c[..., c] - m2)
        l = torch.where(live, a * l + bt * l_c[..., c], l)
        acc = torch.where(live[..., None], a[..., None] * acc
                          + bt[..., None] * acc_c[..., c, :], acc)
        m = torch.where(live, m2, m)
    return rnd(acc / l[..., None])


def _lib():
    lib = _build.load("flash_decode_certified")
    if not getattr(lib, "_typed", False):
        lib.repro_flash_decode_certified_f32.argtypes = [
            _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float,
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
    if G > 8 or D > 128 or D % 4:
        raise ValueError(f"kernel takes G <= 8, D <= 128 and D % 4 == 0, "
                         f"got G={G}, D={D}")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("k, v: the kernel's 16-byte copies need 16-byte "
                         "aligned caches")
    if (lengths.dtype != torch.int32 or lengths.shape != (B,)
            or lengths.device != q.device or not lengths.is_contiguous()):
        raise ValueError("lengths: needs a contiguous int32 [B] tensor on "
                         "q's device")
    return B, S, H, G, D


def _partials(B, S, H, G, D, device) -> torch.Tensor:
    """The kernels' scratch: each (lane, kv head, head, chunk)'s acc [D],
    m and l (the layout is flash_decode.cuh's)."""
    n_chunks = -(-S // FD_CHUNK)
    return torch.empty(B * H * G * n_chunks * (D + 2), dtype=torch.float32,
                       device=device)


def flash_decode_certified(q, k, v, lengths, fmt, *,
                           has_subnormals: bool = True,
                           saturating: bool = True) -> torch.Tensor:
    """The CUDA kernel. q f32[B, K, G, D], k/v f32[B, S, K, D] with S ≥ 1,
    lengths int32[B], all contiguous on one card; G ≤ 8, D ≤ 128 and
    D % 4 == 0, k and v 16-byte aligned. ``flash_decode_certified.launches``
    counts calls (each launches the chunk and the combine kernel)."""
    B, S, H, G, D = _check_decode_args(q, k, v, lengths)
    kk, emax, emin = fmt_triple(fmt)
    out = torch.empty_like(q)
    part = _partials(B, S, H, G, D, q.device)
    rc = _lib().repro_flash_decode_certified_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), part.data_ptr(), B, S, H, G, D, D ** -0.5, kk, emax,
        emin, int(has_subnormals), int(saturating),
        _build.stream_ptr(q.device))
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
            _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P]
        lib.repro_flash_decode_f32.restype = _I
        lib._typed = True
    return lib


def flash_decode_attention(q, k, v, lengths) -> torch.Tensor:
    """The CUDA kernel of uncertified decode attention. q f32[B, K, G, D],
    k/v f32[B, S, K, D] with S ≥ 1, lengths int32[B], all contiguous on one
    card; G ≤ 8, D ≤ 128 and D % 4 == 0 (Qwen2-7B needs G=7, D=128), k and
    v 16-byte aligned. ``flash_decode_attention.launches`` counts calls
    (each launches the chunk and the combine kernel)."""
    B, S, H, G, D = _check_decode_args(q, k, v, lengths)
    out = torch.empty_like(q)
    part = _partials(B, S, H, G, D, q.device)
    rc = _lib_plain().repro_flash_decode_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), part.data_ptr(), B, S, H, G, D, D ** -0.5,
        _build.stream_ptr(q.device))
    _build.check(rc, "flash_decode_attention")
    flash_decode_attention.launches += 1
    return out


flash_decode_attention.launches = 0
