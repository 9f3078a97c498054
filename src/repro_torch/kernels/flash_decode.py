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
  ``ref.flash_decode_ref``). It also takes a sliding ``window`` and a
  ``softcap`` on the scores: the reference never offers such a step to its
  fused decode and composes einsums and a softmax instead
  (``repro.models.transformer``'s ``fused_ok``); on the card the port runs
  that composed f32 attention through this kernel, so that a lane's bits
  depend on its own length only (``TorchOps.windowed_decode_attention``).

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
capacity. They take any number G of query heads a kv head (in tiles of 8)
and any head dim D, as the Pallas kernels take any (D > 256 in slices of
256).

``window`` w > 0: a lane of length n attends positions [max(0, n - w), n)
(the reference's mask ``k_pos > q_pos - window`` at the query position
n - 1); ``softcap`` c > 0: a score s becomes c·tanh(s·(1/c)) after the
scale, before the softmax (the reference's ``bk.softcap``). 0 means none
for both. A lane of length 0 still attends all S positions uniformly.
``scale`` (kernel 4 and the plain versions): the scores' factor, D^-½
when 0 (what every GQA caller passes); MLA's absorbed decode runs as one
kv head of keys [c | k_rope] with the scale (d_nope + d_rope)^-½
(``TorchOps.latent_decode_attention``).

Narrow operands (``compute_dtype`` "bfloat16", D ≤ 256): a bf16 q with an
f32, bf16 or e4m3 cache. Kernel 2 upcasts them (exact) and runs its f32
arithmetic, then writes the output in bf16 by RNE: bit for bit the f32
instance on the upcast operands followed by the cast. Kernel 4's bf16
instance is the reference's composed bf16 path, whose scores,
probabilities and output round to bf16 (``csrc/flash_decode_bf16.cu``);
:func:`flash_decode_bf16_ref` is its algorithm in plain PyTorch. An f32 q
with a bf16 or e4m3 cache (``compute_dtype`` "float32" with a narrow
``cache_dtype``) takes the f32 instances' arithmetic on the upcast cache,
kernel 4 included (``csrc/flash_decode_certified_narrow.cu``), bit for bit
the f32 instance on the upcast operands. ``launches_by_dtype`` counts
launches by q / cache dtype.

MLA's latent decode in bf16 (MiniCPM3 under ``compute_dtype``
"bfloat16"): :func:`latent_decode_bf16` launches
``csrc/latent_decode_bf16.cu``, the composed bf16 path of the reference's
absorbed MLA attention (its two score products rounded apart, then their
sum, the scale, the mask; softmax in f32; p and the mix of c in bf16),
reading c and k_rope in place from the latent cache;
:func:`latent_decode_bf16_ref` is its algorithm in plain PyTorch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quantize import quantize_to_format
from repro_torch.kernels import _build
from repro_torch.kernels.caa_matmul import fmaf_rn
from repro_torch.kernels.quant_matmul import (BY_DTYPE, DTYPE_CODES,
                                              W_DTYPES, _lib_narrow,
                                              dtype_key, fmt_triple)

NEG = -1e30
NEG_BIG = -1e9     # the composed path's mask value (models.layers.NEG_BIG)
FD_CHUNK = 64      # cached positions a kernel block takes (flash_decode.cuh)
FD_PART = 128      # head dims of a lane part: 32 lanes of 4 (flash_decode.cuh)
NARROW_D_MAX = 256     # the narrow instances' largest head dim

_P, _I = ctypes.c_void_p, ctypes.c_int


def _attended_mask(lengths, S, window, device):
    """[B, S] positions a lane attends as a score (before the length-0
    rule): [max(0, n - window), n), or [0, n) without a window, n the
    lane's length (at most S)."""
    pos = torch.arange(S, device=device)[None, :]
    n = lengths.to(device=device, dtype=torch.int64).clamp(max=S)[:, None]
    valid = pos < n
    if window:
        valid = valid & (pos >= n - window)
    return valid


def _softcap(s, softcap: float):
    """The reference's ``bk.softcap`` after the scale: c·tanh(s·(1/c))."""
    if not softcap:
        return s
    return softcap * torch.tanh(s * (1.0 / softcap))


def _check_window_softcap(window, softcap):
    if int(window) < 0 or float(softcap) < 0:
        raise ValueError(f"window {window} and softcap {softcap} must be "
                         ">= 0 (0: none)")


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
    valid = _attended_mask(lengths, S, 0, q.device)             # [B, S]
    s = torch.where(valid[:, None, None, :], s, NEG)
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgs,bshd->bhgd", p, vq)
    return qf(acc / l).to(q.dtype)



def flash_decode_split_ref(q, k, v, lengths, fmt=None, *,
                           has_subnormals: bool = True,
                           saturating: bool = True,
                           dtype: torch.dtype = torch.float32,
                           window: int = 0,
                           softcap: float = 0.0,
                           scale: float = 0.0) -> torch.Tensor:
    """Plain version of the kernels' split algorithm: chunk partials over
    FD_CHUNK positions from position 0 (m_c = max(-1e30, max s), l_c = Σ p,
    acc_c = Σ p·v̂ with p = exp(s - m_c) over the chunk's attended
    positions), folded in chunk order by the online recurrence, from the
    chunk that holds a lane's first attended position (``window``; chunk 0
    without one). ``fmt`` None: no rounding (kernel 4, which alone takes a
    ``window`` and a ``softcap``); else q, k, v and the output are rounded
    into it (kernel 2). Positions a lane does not attend are never read.
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

    _check_window_softcap(window, softcap)
    qf = lambda t: rnd(t.to(torch.float32)).to(dtype)
    B, H, G, D = q.shape
    S = k.shape[1]
    nc_max = -(-S // FD_CHUNK)
    Sp = nc_max * FD_CHUNK
    lengths = lengths.to(device=q.device, dtype=torch.int64)
    n = torch.where(lengths <= 0, S, lengths.clamp(max=S))     # attended
    lo = torch.clamp(n - window, min=0) if window else torch.zeros_like(n)
    lo = torch.where(lengths <= 0, 0, lo)                      # the first
    pos = torch.arange(Sp, device=q.device)[None, :]
    real = (pos < n[:, None]) & (pos >= lo[:, None])
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, Sp - S))
    # what the kernels never read is zero here, so it cannot reach the sums
    kq = torch.where(real[:, :, None, None], qf(pad(k)), 0.0)
    vq = torch.where(real[:, :, None, None], qf(pad(v)), 0.0)
    s = torch.einsum("bhgd,bshd->bhgs", qf(q), kq) * (scale or D ** -0.5)
    s = _softcap(s, softcap)
    s = torch.where((lengths <= 0)[:, None, None, None], NEG, s)
    s = s.reshape(B, H, G, nc_max, FD_CHUNK)
    real_c = real.reshape(B, 1, 1, nc_max, FD_CHUNK)
    m_c = torch.where(real_c, s, NEG).amax(dim=-1).clamp_min(NEG)
    p = torch.where(real_c, torch.exp(s - m_c[..., None]), 0.0)
    l_c = p.sum(dim=-1)
    acc_c = torch.einsum("bhgcj,bcjhd->bhgcd", p,
                         vq.reshape(B, nc_max, FD_CHUNK, H, D))
    nc = -(-n // FD_CHUNK)                                      # [B]
    c_lo = lo // FD_CHUNK                          # the fold's first chunk
    first = c_lo[:, None, None, None].expand(B, H, G, 1)
    m = m_c.gather(-1, first)[..., 0]
    l = l_c.gather(-1, first)[..., 0]
    acc = acc_c.gather(3, first[..., None].expand(B, H, G, 1, D))[..., 0, :]
    for c in range(1, nc_max):
        live = ((c > c_lo) & (c < nc))[:, None, None]
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


def _narrow(q, k) -> bool:
    """Whether a call takes a narrow instance (a bf16 q or a narrow
    cache)."""
    return q.dtype == torch.bfloat16 or k.dtype != torch.float32


def _check_decode_args(q, k, v, lengths):
    """Shapes (B, S, H, G, D) of a decode-attention call, after checking
    what the kernels take; raises ValueError on anything else: q in f32 or
    bf16 with an f32, bf16 or e4m3 cache (D ≤ 256 unless both are f32)."""
    for name, t in {"q": q, "k": k, "v": v}.items():
        if t.device.type != "cuda" or t.dtype not in W_DTYPES:
            raise ValueError(f"{name}: needs a CUDA tensor of float32, "
                             f"bfloat16 or float8_e4m3fn, got {t.dtype} on "
                             f"{t.device}")
        if not t.is_contiguous() or t.dim() != 4:
            raise ValueError(f"{name}: needs a contiguous 4-d tensor")
    if k.dtype != v.dtype or q.dtype == torch.float8_e4m3fn:
        raise ValueError(f"q {q.dtype} with a {k.dtype}/{v.dtype} cache: "
                         "the kernels take an f32 or bf16 q with an f32, "
                         "bf16 or e4m3 cache")
    B, H, G, D = q.shape
    S = k.shape[1]
    if k.shape != (B, S, H, D) or v.shape != k.shape or S < 1:
        raise ValueError(f"cache shapes {tuple(k.shape)}/{tuple(v.shape)} "
                         f"do not fit q {tuple(q.shape)}")
    if G < 1 or D < 1:
        raise ValueError(f"kernel takes G >= 1 and D >= 1, got G={G}, "
                         f"D={D}")
    if _narrow(q, k) and D > NARROW_D_MAX:
        raise ValueError(f"the narrow instances take D <= {NARROW_D_MAX}, "
                         f"got D={D}")
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
    lengths int32[B], all contiguous on one card; any G ≥ 1 and D ≥ 1
    (16-byte copies where D % 4 == 0 and k and v are 16-byte aligned, 4-byte
    ones otherwise).
    ``flash_decode_certified.launches`` counts calls (each launches the chunk
    kernel once a tile of 8 query heads, then the combine kernel)."""
    B, S, H, G, D = _check_decode_args(q, k, v, lengths)
    kk, emax, emin = fmt_triple(fmt)
    out = torch.empty_like(q)
    part = _partials(B, S, H, G, D, q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), part.data_ptr(), B, S, H, G, D, D ** -0.5, kk,
            emax, emin, int(has_subnormals), int(saturating))
    if _narrow(q, k):
        rc = _lib_narrow(
            "flash_decode_certified_narrow",
            "repro_flash_decode_certified_narrow",
            [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I,
             _I, _I, _I, _I, _I, _I, _P])(
            *args, DTYPE_CODES[q.dtype], DTYPE_CODES[k.dtype],
            _build.stream_ptr(q.device))
    else:
        rc = _lib().repro_flash_decode_certified_f32(
            *args, _build.stream_ptr(q.device))
    _build.check(rc, "flash_decode_certified")
    flash_decode_certified.launches += 1
    BY_DTYPE["flash_decode_certified"][dtype_key(q, k)] += 1
    return out


flash_decode_certified.launches = 0
flash_decode_certified.launches_by_dtype = BY_DTYPE["flash_decode_certified"]


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


def flash_decode_ref(q, k, v, lengths, window: int = 0,
                     softcap: float = 0.0, scale: float = 0.0
                     ) -> torch.Tensor:
    """Plain version of :func:`flash_decode_attention` (the reference's
    ``ref.flash_decode_ref``, with the reference's composed window mask and
    softcap): q [B, K, G, D], k/v [B, S, K, D], lengths [B]; scores scaled
    by ``scale`` (0: D^-½), softcapped, masked, softmax in f32, returns
    [B, K, G, D]."""
    _check_window_softcap(window, softcap)
    D, S = q.shape[-1], k.shape[1]
    s = torch.einsum("bkgd,bskd->bkgs", q, k.to(q.dtype)) * (
        scale or D ** -0.5)
    s = _softcap(s, softcap)
    valid = _attended_mask(lengths, S, window, q.device)        # [B, S]
    s = torch.where(valid[:, None, None, :], s, NEG)
    p = torch.softmax(s.to(torch.float32), dim=-1)
    return torch.einsum("bkgs,bskd->bkgd", p,
                        v.to(torch.float32)).to(q.dtype)


def _lib_plain():
    lib = _build.load("flash_decode")
    if not getattr(lib, "_typed", False):
        lib.repro_flash_decode_f32.argtypes = [
            _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I,
            ctypes.c_float, ctypes.c_float, _P]
        lib.repro_flash_decode_f32.restype = _I
        lib._typed = True
    return lib


def _bf16(x: float) -> float:
    """A Python float rounded to bf16 (RNE), as the composed path's
    constants are (``bk.const`` / ``bk.scale`` in the compute dtype)."""
    return float(torch.tensor(float(x), dtype=torch.bfloat16))


def bf16_constants(D: int, scale: float = 0.0, softcap: float = 0.0):
    """(scale, cap, 1/cap, NEG_BIG), each rounded to bf16: the composed
    bf16 path's constants (0 for a cap of none)."""
    cap = float(softcap)
    return (_bf16(float(scale) or D ** -0.5), _bf16(cap) if cap else 0.0,
            _bf16(1.0 / cap) if cap else 0.0, _bf16(NEG_BIG))


def _rbf(t: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to bf16 and back (RNE)."""
    return t.to(torch.bfloat16).to(torch.float32)


def flash_decode_bf16_ref(q, k, v, lengths, window: int = 0,
                          softcap: float = 0.0,
                          scale: float = 0.0) -> torch.Tensor:
    """Plain version of kernel 4's bf16 instance: the reference's composed
    bf16 decode attention (scores, their scale, softcap and mask in bf16,
    softmax in f32 over the row, probabilities in bf16, p·v summed in f32,
    then bf16) in the kernel's order (``csrc/flash_decode_bf16.cu``): a
    score is each lane's chain over its dims then the 32-lane butterfly; a
    chunk's max and Σ exp(s − m_c) in position order; the chunks folded in
    order by m' = max(m, m_c), l = fmaf(exp(m − m'), l, exp(m_c − m')·l_c);
    p = bf16(exp(s − m) / l); each chunk's Σ p·v in position order, the
    chunks added in order. q [B, K, G, D] (bf16), k/v [B, S, K, D] (f32,
    bf16 or e4m3; read in bf16), lengths [B]; D ≤ 256. Returns [B, K, G, D]
    bf16. Bit for bit the kernel where exp, tanh and division are the
    card's, i.e. on the card; not on the serving path."""
    _check_window_softcap(window, softcap)
    B, H, G, D = q.shape
    S = k.shape[1]
    if D > NARROW_D_MAX:
        raise ValueError(f"D <= {NARROW_D_MAX}, got {D}")
    scb, capb, icb, negb = bf16_constants(D, scale, softcap)
    dev = q.device
    NP = 1 if D <= FD_PART else 2
    Dp = NP * FD_PART
    pad = lambda t: torch.nn.functional.pad(t, (0, Dp - D))
    qf = pad(q.to(torch.float32))                               # [B,H,G,Dp]
    kf = pad(_rbf(k.to(torch.float32)))                         # [B,S,H,Dp]
    prod = qf[:, :, :, None, :] * kf.permute(0, 2, 1, 3)[:, :, None]
    prod = prod.reshape(B, H, G, S, NP, 32, 4)                  # exact
    x = prod[..., 0, :, 0]
    for pt in range(NP):
        for u in range(4):
            if pt or u:
                x = x + prod[..., pt, :, u]
    for half in (16, 8, 4, 2, 1):
        x = x[..., :half] + x[..., half:2 * half]
    s = _rbf(_rbf(x[..., 0]) * scb)                             # [B,H,G,S]
    if softcap:
        s = _rbf(_rbf(torch.tanh(_rbf(s * icb))) * capb)
    lengths = lengths.to(device=dev, dtype=torch.int64)
    n = torch.where(lengths <= 0, S, lengths.clamp(max=S))
    lo = torch.clamp(n - window, min=0) if window else torch.zeros_like(n)
    lo = torch.where(lengths <= 0, 0, lo)
    pos = torch.arange(S, device=dev)
    att = (pos[None] < n[:, None]) & (pos[None] >= lo[:, None])   # read
    real = att & (lengths > 0)[:, None]                           # scored
    s = torch.where(real[:, None, None, :], s, negb)
    NC = -(-S // FD_CHUNK)
    sp = torch.nn.functional.pad(s, (0, NC * FD_CHUNK - S), value=negb)
    sp = sp.reshape(B, H, G, NC, FD_CHUNK)
    tc = (n[:, None] - torch.arange(NC, device=dev)[None] * FD_CHUNK).clamp(
        0, FD_CHUNK)                                            # [B, NC]
    inside = (torch.arange(FD_CHUNK, device=dev)[None, None]
              < tc[:, :, None])[:, None, None]                  # [B,1,1,NC,64]
    m_c = torch.where(inside, sp, negb).amax(-1).clamp_min(negb)
    e = torch.exp(sp - m_c[..., None])
    l_c = e[..., 0]
    for i in range(1, FD_CHUNK):
        l_c = torch.where(inside[..., i], l_c + e[..., i], l_c)
    nc = -(-n // FD_CHUNK)
    c_lo = lo // FD_CHUNK
    first = c_lo[:, None, None, None].expand(B, H, G, 1)
    m = m_c.gather(-1, first)[..., 0]
    l = l_c.gather(-1, first)[..., 0]
    for c in range(1, NC):
        live = ((c > c_lo) & (c < nc))[:, None, None]
        m2 = torch.maximum(m, m_c[..., c])
        l2 = fmaf_rn(torch.exp(m - m2), l, torch.exp(m_c[..., c] - m2)
                     * l_c[..., c])
        l = torch.where(live, l2, l)
        m = torch.where(live, m2, m)
    p = _rbf(torch.exp(s - m[..., None]) / l[..., None])        # [B,H,G,S]
    vf = _rbf(v.to(torch.float32)).permute(0, 2, 1, 3)         # [B,H,S,D]
    vf = torch.where(att[:, None, :, None], vf, 0.0)
    pv = p[..., None] * vf[:, :, None]                          # exact
    pv = torch.nn.functional.pad(pv, (0, 0, 0, NC * FD_CHUNK - S))
    pv = pv.reshape(B, H, G, NC, FD_CHUNK, D)
    inside_pv = (inside & torch.nn.functional.pad(
        att, (0, NC * FD_CHUNK - S)).reshape(B, 1, 1, NC, FD_CHUNK))
    acc_c = torch.zeros((B, H, G, NC, D), dtype=torch.float32, device=dev)
    for i in range(FD_CHUNK):
        acc_c = torch.where(inside_pv[..., i, None], acc_c + pv[..., i, :],
                            acc_c)
    acc = acc_c.gather(3, first[..., None].expand(B, H, G, 1, D))[..., 0, :]
    for c in range(1, NC):
        live = ((c > c_lo) & (c < nc))[:, None, None, None]
        acc = torch.where(live, acc + acc_c[..., c, :], acc)
    return acc.to(torch.bfloat16)


def flash_decode_attention(q, k, v, lengths, window: int = 0,
                           softcap: float = 0.0,
                           scale: float = 0.0) -> torch.Tensor:
    """The CUDA kernel of uncertified decode attention. q f32[B, K, G, D],
    k/v f32[B, S, K, D] with S ≥ 1, lengths int32[B], all contiguous on one
    card; any G ≥ 1 and D ≥ 1, as :func:`flash_decode_certified` (Qwen2-7B
    needs G=7, D=128); ``window``, ``softcap`` and ``scale`` as in the
    module's docstring (0: none, none, D^-½). A bf16 q (with an f32, bf16
    or e4m3 cache, D ≤ 256) launches the bf16 instance, the composed bf16
    path (:func:`flash_decode_bf16_ref`), and returns bf16; an f32 q with a
    bf16 or e4m3 cache (D ≤ 256) the f32 arithmetic on the upcast cache.
    ``flash_decode_attention.launches`` counts calls."""
    B, S, H, G, D = _check_decode_args(q, k, v, lengths)
    _check_window_softcap(window, softcap)
    out = torch.empty_like(q)
    cap = float(softcap)
    if q.dtype == torch.bfloat16:
        scb, capb, icb, negb = bf16_constants(D, scale, softcap)
        NC = -(-S // FD_CHUNK)
        scratch = torch.empty(B * H * G * (S + NC * (D + 2) + 2),
                              dtype=torch.float32, device=q.device)
        rc = _lib_narrow(
            "flash_decode_bf16", "repro_flash_decode_bf16",
            [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I,
             ctypes.c_float, ctypes.c_float, ctypes.c_float, _I, _P])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), B, S, H, G, D, scb,
            int(window), capb, icb, negb, DTYPE_CODES[k.dtype],
            _build.stream_ptr(q.device))
    else:
        part = _partials(B, S, H, G, D, q.device)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                out.data_ptr(), part.data_ptr(), B, S, H, G, D,
                float(scale) or D ** -0.5, int(window), cap,
                1.0 / cap if cap else 0.0)
        if _narrow(q, k):
            rc = _lib_narrow(
                "flash_decode_certified_narrow", "repro_flash_decode_narrow",
                [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float,
                 _I, ctypes.c_float, ctypes.c_float, _I, _P])(
                *args, DTYPE_CODES[k.dtype], _build.stream_ptr(q.device))
        else:
            rc = _lib_plain().repro_flash_decode_f32(
                *args, _build.stream_ptr(q.device))
    _build.check(rc, "flash_decode_attention")
    flash_decode_attention.launches += 1
    BY_DTYPE["flash_decode_attention"][dtype_key(q, k)] += 1
    return out


flash_decode_attention.launches = 0
flash_decode_attention.launches_by_dtype = BY_DTYPE["flash_decode_attention"]


# -- MLA's latent decode in bf16 ----------------------------------------------

LATENT_R_MAX = 2 * FD_PART      # the latent kernel's widest c (kv_rank)
LATENT_DR_MAX = FD_PART         # and rope key
_SMEM_MAX = 232448              # an H100 block's dynamic shared memory


def _warp_dots(q, k):
    """[B, H, s] dot products of q [B, H, Dp] with k [B, s, Dp] (Dp a
    multiple of FD_PART, zero past the width) in the kernels' order: lane
    l's chain over d = FD_PART·pt + 4l + u, then the 32-lane butterfly
    (products exact: bf16 operands)."""
    B, H, Dp = q.shape
    s = k.shape[1]
    NP = Dp // FD_PART
    prod = (q[:, :, None, :] * k[:, None, :, :]).reshape(B, H, s, NP, 32, 4)
    x = prod[..., 0, :, 0]
    for pt in range(NP):
        for u in range(4):
            if pt or u:
                x = x + prod[..., pt, :, u]
    for half in (16, 8, 4, 2, 1):
        x = x[..., :half] + x[..., half:2 * half]
    return x[..., 0]


def _pad_to_part(t):
    """``t`` [..., D] in f32, zero-padded to a multiple of FD_PART."""
    D = t.shape[-1]
    return torch.nn.functional.pad(t.to(torch.float32),
                                   (0, -(-D // FD_PART) * FD_PART - D))


def latent_decode_bf16_ref(q_lat, q_rope, c, k_rope, lengths,
                           scale: float, block: int = 1024) -> torch.Tensor:
    """Plain version of the latent kernel (``csrc/latent_decode_bf16.cu``):
    the composed bf16 path of MLA's absorbed decode attention in the
    kernel's order. Scores s = bf16(bf16(bf16(q_lat·c) + bf16(q_rope·k_rope))
    · bf16(scale)), each dot a lane's chain then the butterfly
    (:func:`_warp_dots`); positions at or past a lane's length are not
    scored (a lane of length ≤ 0 scores all S at bf16(NEG_BIG)); each
    chunk of FD_CHUNK positions' max m_c and Σ exp(s − m_c) in position
    order, folded in chunk order by m' = max(m, m_c), l = fmaf(exp(m − m'),
    l, exp(m_c − m')·l_c); p = bf16(exp(s − m) / l); each chunk's Σ p·c
    from +0 in position order, the chunks added in order, then bf16.
    q_lat [B, H, R] and q_rope [B, H, Dr] bf16; c [B, S, R] and k_rope
    [B, S, Dr] f32, bf16 or e4m3 (read in bf16); lengths [B]. Returns
    [B, H, R] bf16. ``block``: positions scored at a time (memory only).
    Bit for bit the kernel where exp and division are the card's, i.e. on
    the card; not on the serving path."""
    B, H, R = q_lat.shape
    S = c.shape[1]
    dev = q_lat.device
    scb, negb = _bf16(scale), _bf16(NEG_BIG)
    ql, qr = _pad_to_part(q_lat), _pad_to_part(q_rope)
    s = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    for p0 in range(0, S, block):
        cs = _pad_to_part(_rbf(c[:, p0:p0 + block].to(torch.float32)))
        rs = _pad_to_part(_rbf(k_rope[:, p0:p0 + block].to(torch.float32)))
        s[..., p0:p0 + block] = _rbf(_rbf(
            _rbf(_warp_dots(ql, cs)) + _rbf(_warp_dots(qr, rs))) * scb)
    lengths = lengths.to(device=dev, dtype=torch.int64)
    n = torch.where(lengths <= 0, S, lengths.clamp(max=S))
    pos = torch.arange(S, device=dev)
    att = pos[None] < n[:, None]                                # read
    real = att & (lengths > 0)[:, None]                         # scored
    s = torch.where(real[:, None, :], s, negb)
    NC = -(-S // FD_CHUNK)
    Sp = NC * FD_CHUNK
    sp = torch.nn.functional.pad(s, (0, Sp - S), value=negb)
    sp = sp.reshape(B, H, NC, FD_CHUNK)
    tc = (n[:, None] - torch.arange(NC, device=dev)[None] * FD_CHUNK).clamp(
        0, FD_CHUNK)                                            # [B, NC]
    inside = (torch.arange(FD_CHUNK, device=dev)[None, None]
              < tc[:, :, None])[:, None]                        # [B,1,NC,64]
    m_c = torch.where(inside, sp, negb).amax(-1).clamp_min(negb)
    e = torch.exp(sp - m_c[..., None])
    l_c = e[..., 0]
    for i in range(1, FD_CHUNK):
        l_c = torch.where(inside[..., i], l_c + e[..., i], l_c)
    nc = (-(-n // FD_CHUNK))[:, None]                           # [B, 1]
    m, l = m_c[..., 0], l_c[..., 0]
    for ch in range(1, NC):
        live = ch < nc
        m2 = torch.maximum(m, m_c[..., ch])
        l2 = fmaf_rn(torch.exp(m - m2), l, torch.exp(m_c[..., ch] - m2)
                     * l_c[..., ch])
        l = torch.where(live, l2, l)
        m = torch.where(live, m2, m)
    p = _rbf(torch.exp(sp - m[..., None, None]) / l[..., None, None])
    p = torch.where(inside, p, 0.0)                             # [B,H,NC,64]
    cf = torch.nn.functional.pad(_rbf(c.to(torch.float32)),
                                 (0, 0, 0, Sp - S)).reshape(B, NC, FD_CHUNK, R)
    acc_c = torch.zeros((B, H, NC, R), dtype=torch.float32, device=dev)
    for i in range(FD_CHUNK):
        step = p[..., i, None] * cf[:, None, :, i, :]          # exact
        acc_c = torch.where(inside[..., i, None], acc_c + step, acc_c)
    acc = acc_c[:, :, 0]
    for ch in range(1, NC):
        acc = torch.where((ch < nc)[..., None], acc + acc_c[:, :, ch], acc)
    return acc.to(torch.bfloat16)


def _check_latent_args(q_lat, q_rope, c, k_rope, lengths):
    """Shapes (B, S, H, R, Dr) of a latent-kernel call, after checking what
    the kernel takes; raises ValueError on anything else."""
    named = (("q_lat", q_lat, (torch.bfloat16,)),
             ("q_rope", q_rope, (torch.bfloat16,)),
             ("c", c, W_DTYPES), ("k_rope", k_rope, W_DTYPES))
    for name, t, dts in named:
        if t.dtype not in dts:
            raise ValueError(f"{name}: needs {[str(d) for d in dts]}, got "
                             f"{t.dtype}")
        if not t.is_contiguous() or t.dim() != 3:
            raise ValueError(f"{name}: needs a contiguous 3-d tensor")
    B, H, R = q_lat.shape
    S, Dr = c.shape[1], k_rope.shape[2]
    if (q_rope.shape[:2] != (B, H) or q_rope.shape[2] != Dr
            or c.shape != (B, S, R) or k_rope.shape != (B, S, Dr)
            or c.dtype != k_rope.dtype or S < 1):
        raise ValueError(f"shapes q_lat {tuple(q_lat.shape)}, q_rope "
                         f"{tuple(q_rope.shape)}, c {tuple(c.shape)} "
                         f"({c.dtype}), k_rope {tuple(k_rope.shape)} "
                         f"({k_rope.dtype}) do not fit")
    smem = 4 * max(H * (-(-R // FD_PART) * FD_PART + FD_PART + FD_CHUNK),
                   H * FD_CHUNK + FD_CHUNK * R)
    if R > LATENT_R_MAX or Dr > LATENT_DR_MAX or smem > _SMEM_MAX:
        raise ValueError(f"the latent kernel takes R <= {LATENT_R_MAX}, Dr "
                         f"<= {LATENT_DR_MAX} and {_SMEM_MAX} bytes of "
                         f"shared memory; got R={R}, Dr={Dr}, H={H}")
    for name, t, _ in named:
        if t.device.type != "cuda" or t.device != q_lat.device:
            raise ValueError(f"{name}: needs a CUDA tensor on q_lat's "
                             f"device, got one on {t.device}")
    if (lengths.dtype != torch.int32 or lengths.shape != (B,)
            or lengths.device != q_lat.device
            or not lengths.is_contiguous()):
        raise ValueError("lengths: needs a contiguous int32 [B] tensor on "
                         "q_lat's device")
    return B, S, H, R, Dr


def latent_decode_bf16(q_lat, q_rope, c, k_rope, lengths,
                       scale: float) -> torch.Tensor:
    """MLA's absorbed single-token decode attention in bf16: the CUDA
    kernel for tensors on the card, its plain version
    (:func:`latent_decode_bf16_ref`) for tensors on the CPU. q_lat bf16
    [B, H, R] (R ≤ 256), q_rope bf16 [B, H, Dr] (Dr ≤ 128), c [B, S, R]
    and k_rope [B, S, Dr] of one dtype (f32, bf16 or e4m3: the latent
    cache's k and v buffers, read in place), lengths int32 [B], all
    contiguous; ``scale`` the scores' factor (rounded to bf16). Returns
    [B, H, R] bf16. ``latent_decode_bf16.launches`` counts the kernel's
    calls."""
    if all(t.device.type == "cpu" for t in (q_lat, q_rope, c, k_rope)):
        return latent_decode_bf16_ref(q_lat, q_rope, c, k_rope, lengths,
                                      scale)
    B, S, H, R, Dr = _check_latent_args(q_lat, q_rope, c, k_rope, lengths)
    out = torch.empty_like(q_lat)
    NC = -(-S // FD_CHUNK)
    scratch = torch.empty(B * H * (S + NC * (R + 2) + 2),
                          dtype=torch.float32, device=q_lat.device)
    rc = _lib_narrow(
        "latent_decode_bf16", "repro_latent_decode_bf16",
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float,
         ctypes.c_float, _I, _P])(
        q_lat.data_ptr(), q_rope.data_ptr(), c.data_ptr(), k_rope.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, S, H, R,
        Dr, _bf16(scale), _bf16(NEG_BIG), DTYPE_CODES[c.dtype],
        _build.stream_ptr(q_lat.device))
    _build.check(rc, "latent_decode_bf16")
    latent_decode_bf16.launches += 1
    BY_DTYPE["latent_decode_bf16"][dtype_key(q_lat, c)] += 1
    return out


latent_decode_bf16.launches = 0
latent_decode_bf16.launches_by_dtype = BY_DTYPE["latent_decode_bf16"]
