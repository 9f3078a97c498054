"""Attention with a KV cache (PyTorch), the counterpart of the JAX
package's ``repro.models.attention``: grouped-query attention
(:func:`gqa_attention`) and multi-head latent attention
(:func:`mla_attention`, MiniCPM3).

Unlike the reference, whose arrays are immutable, the port writes new keys
and values INTO the cache buffers in place (``index_copy_`` along the
sequence axis, or one ``index_put_`` on (lane, position) when each lane
writes at its own offset): the returned cache holds the same storage, so a
full-width cache is never copied per layer or per step. On a mesh whose
"model" axis splits the cache's KV heads, a rank writes and attends its own
heads (``bk.kv_local``, the backend's decode hooks) and the composed path
reads the whole cache (``bk.kv_whole``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import dtypes
from repro_torch.models import layers as L


class KVCache(NamedTuple):
    k: torch.Tensor      # [B, Smax, K, Dh]  (MLA: the latent c [B, Smax, R])
    v: torch.Tensor      # [B, Smax, K, Dh]  (MLA: the rope key [B, Smax, Dr])
    index: torch.Tensor  # int32 tokens already present: 0-d (all lanes), or
    #                      [B] when lanes advance independently (continuous
    #                      batching)


def _cache_write(buf: torch.Tensor, upd: torch.Tensor, index: torch.Tensor):
    """Write ``upd`` [B, S, ...] into ``buf`` [B, Smax, ...] in place and
    without a host sync. A 0-d ``index`` writes every lane at that sequence
    offset; a [B] one writes lane b at ``index[b]`` (one ``index_put_`` on
    (lane, position)). The positions written must lie inside the buffer.
    The values are rounded into the cache's dtype (a bf16 or e4m3 cache:
    the reference's ``astype``, :func:`repro_torch.core.dtypes.cast`); an
    e4m3 cache is written as its bytes."""
    steps = torch.arange(upd.shape[1], device=buf.device)
    upd = dtypes.cast(upd, buf.dtype)
    if buf.dtype == dtypes.FP8:
        buf, upd = buf.view(torch.uint8), upd.view(torch.uint8)
    if index.dim() == 0:
        buf.index_copy_(1, index.to(torch.int64) + steps, upd)
        return
    pos = index.to(torch.int64)[:, None] + steps[None, :]          # [B, S]
    lanes = torch.arange(buf.shape[0], device=buf.device)[:, None]
    buf.index_put_((lanes.expand_as(pos), pos), upd)


def _mask5(mask: torch.Tensor) -> torch.Tensor:
    """Broadcast a [q, kv] (shared) or [B, q, kv] (per-lane) mask to the
    [B, K, G, q, s] score layout."""
    if mask.dim() == 3:
        return mask[:, None, None, :, :]
    return mask[None, None, None, :, :]


def gqa_attention(bk, x, p, *, n_heads: int, n_kv_heads: int, d_head: int,
                  cos, sin, mask, softcap: Optional[float] = None,
                  window: int = 0, qkv_bias: bool = False,
                  cache: Optional[KVCache] = None,
                  fused_decode: bool = False,
                  windowed_decode: bool = False):
    """Grouped-query attention. x: [B,S,d]. Returns (out, new_cache).

    With ``cache`` set, keys/values are written into the cache buffers in
    place at ``cache.index`` (0-d, or [B] per lane), and attention runs over
    the whole buffer under ``mask`` ([q, kv], or [B, q, kv] per lane).
    ``softcap`` caps the scaled scores (cap·tanh(s/cap), Gemma-2) before
    the mask. ``fused_decode`` (the caller's plain-causal S==1 step) offers
    the step to ``bk.decode_attention`` (the certificate-aware flash decode
    hook) with each lane's new length; a backend returning None takes the
    composed path. ``windowed_decode`` (the S==1 step of a model with a
    softcap or sliding windows, which the reference never offers to that
    hook) offers it to ``bk.windowed_decode_attention`` with the layer's
    ``window`` (0: none; ``mask`` carries the same rule) and ``softcap``:
    on the card that composed attention, unrounded, in the decode kernel's
    fixed order; on the CPU None, and it composes. The composed scores and
    probabilities are never rounded, as in the reference."""
    B, S, _ = bk.shape_of(x)
    G = n_heads // n_kv_heads

    q = bk.matmul(x, bk.param(p["wq"]))
    k = bk.matmul(x, bk.param(p["wk"]))
    v = bk.matmul(x, bk.param(p["wv"]))
    if qkv_bias:
        q = bk.add(q, bk.param(p["bq"]))
        k = bk.add(k, bk.param(p["bk"]))
        v = bk.add(v, bk.param(p["bv"]))

    q = bk.reshape(q, (B, S, n_heads, d_head))
    k = bk.reshape(k, (B, S, n_kv_heads, d_head))
    v = bk.reshape(v, (B, S, n_kv_heads, d_head))

    q = L.apply_rope(bk, q, cos, sin)
    k = L.apply_rope(bk, k, cos, sin)

    new_cache = None
    if cache is not None:
        _cache_write(cache.k, bk.kv_local(k, cache.k), cache.index)
        _cache_write(cache.v, bk.kv_local(v, cache.v), cache.index)
        new_cache = KVCache(cache.k, cache.v, cache.index + S)
        if S == 1 and (fused_decode or windowed_decode):
            lengths = new_cache.index.to(torch.int32)
            if lengths.dim() == 0:
                lengths = lengths.expand(B)
            lengths = lengths.contiguous()
            q4 = bk.reshape(q, (B, n_kv_heads, G, d_head))
            if windowed_decode:
                fused = bk.windowed_decode_attention(
                    q4, cache.k, cache.v, lengths, int(window or 0),
                    float(softcap or 0.0))
            else:
                fused = bk.decode_attention(q4, cache.k, cache.v, lengths)
            if fused is not None:
                out = bk.reshape(fused, (B, S, n_heads * d_head))
                return bk.matmul(out, bk.param(p["wo"])), new_cache
        k = bk.input(bk.kv_whole(cache.k, n_kv_heads))
        v = bk.input(bk.kv_whole(cache.v, n_kv_heads))

    if cache is None:
        q = bk.shard_hint(q, "q_seq")
    q = bk.reshape(q, (B, S, n_kv_heads, G, d_head))
    scores = bk.einsum("bqkgd,bskd->bkgqs", q, k)
    scores = bk.scale(scores, d_head ** -0.5)
    if softcap:
        scores = bk.softcap(scores, softcap)
    neg = bk.const(L.NEG_BIG, scores)
    scores = bk.where(_mask5(mask), scores, neg)
    probs = bk.softmax(scores, dim=-1)
    probs = bk.record("attn_probs", probs, kind="softmax")
    out = bk.einsum("bkgqs,bskd->bqkgd", probs, v)
    if bk.is_analysis:
        # convex-combination fact: Σ_s probs = 1, probs ≥ 0 ⇒ out lies in
        # the value hull (IA cannot see the simplex constraint)
        vlo = torch.amin(v.exact.lo, dim=1)[:, None, :, None, :]
        vhi = torch.amax(v.exact.hi, dim=1)[:, None, :, None, :]
        out = bk.clamp_range(out, vlo, vhi)
    out = bk.reshape(out, (B, S, n_heads * d_head))
    return bk.matmul(out, bk.param(p["wo"])), new_cache


def gqa_shapes(d: int, n_heads: int, n_kv_heads: int, d_head: int,
               qkv_bias: bool = False):
    """Parameter shapes of one GQA block (the reference's ``init_gqa``)."""
    shapes = {
        "wq": (d, n_heads * d_head),
        "wk": (d, n_kv_heads * d_head),
        "wv": (d, n_kv_heads * d_head),
        "wo": (n_heads * d_head, d),
    }
    if qkv_bias:
        shapes.update(bq=(n_heads * d_head,), bk=(n_kv_heads * d_head,),
                      bv=(n_kv_heads * d_head,))
    return shapes


# ---------------------------------------------------------------------------
# multi-head latent attention (MiniCPM3 / DeepSeek style)
# ---------------------------------------------------------------------------

def mla_attention(bk, x, p, *, n_heads: int, q_rank: int, kv_rank: int,
                  d_nope: int, d_rope: int, d_v: int, cos, sin, mask,
                  cache: Optional[KVCache] = None):
    """MLA: queries through a low-rank down/up projection, keys and values
    through one compressed latent ``c`` [B, S, kv_rank] shared by every
    head, plus one shared rope key [B, S, d_rope]. With ``cache`` set, c
    is written into ``cache.k`` and the rope key into ``cache.v`` in place
    at ``cache.index``, and attention runs over the whole buffers under
    ``mask`` ([q, kv], or [B, q, kv] per lane).

    Every step (prefill and decode) takes the reference's absorbed form:
    q_nope is carried into the latent space through W_uk, the scores are
    (q_lat·c + q_rope·k_rope)·(d_nope + d_rope)^-½, and the context is
    the probabilities' mix of c carried out through W_uv. These products
    are unrounded f32 on every serving backend, as the reference composes
    them (it never offers MLA to the fused decode hook). The two per-head
    weight products go through ``bk.per_head_matmul`` (the reference's
    einsums; on the card a single-token step's through the fixed-order
    ``f32_matmul``), and a single-token step with a cache offers the
    attention between them to ``bk.latent_decode_attention`` (on the card
    the fixed-order decode kernel; None composes it here). Under the analysis
    the latent mix is clamped to c's hull over the positions (the
    convex-combination fact)."""
    B, S, _ = bk.shape_of(x)
    H = n_heads

    qc = bk.matmul(x, bk.param(p["wq_a"]))                  # [B,S,q_rank]
    qc = L.rmsnorm(bk, qc, p["q_norm"])
    q = bk.matmul(qc, bk.param(p["wq_b"]))                  # [B,S,H*(dn+dr)]
    q = bk.reshape(q, (B, S, H, d_nope + d_rope))
    q_nope = bk.slice(q, (Ellipsis, slice(0, d_nope)))
    q_rope = bk.slice(q, (Ellipsis, slice(d_nope, d_nope + d_rope)))
    q_rope = L.apply_rope(bk, q_rope, cos, sin)

    ckv = bk.matmul(x, bk.param(p["wkv_a"]))                # [B,S,R+dr]
    c = bk.slice(ckv, (Ellipsis, slice(0, kv_rank)))
    k_rope = bk.slice(ckv, (Ellipsis, slice(kv_rank, kv_rank + d_rope)))
    c = L.rmsnorm(bk, c, p["kv_norm"])
    k_rope = L.apply_rope(bk, bk.reshape(k_rope, (B, S, 1, d_rope)), cos,
                          sin)
    k_rope = bk.reshape(k_rope, (B, S, d_rope))

    new_cache = None
    if cache is not None:
        _cache_write(cache.k, bk.value_of(c), cache.index)
        _cache_write(cache.v, bk.value_of(k_rope), cache.index)
        new_cache = KVCache(cache.k, cache.v, cache.index + S)
        c = bk.input(cache.k)
        k_rope = bk.input(cache.v)

    # wkv_b packs [R, H*(dn+dv)]: W_uk = [..., :dn], W_uv = [..., dn:]
    wkv_b = bk.reshape(bk.param(p["wkv_b"]), (kv_rank, H, d_nope + d_v))
    w_uk = bk.slice(wkv_b, (Ellipsis, slice(0, d_nope)))
    w_uv = bk.slice(wkv_b, (Ellipsis, slice(d_nope, d_nope + d_v)))
    q_lat = bk.per_head_matmul(q_nope, w_uk, into=True)     # [B,S,H,R]
    scale = (d_nope + d_rope) ** -0.5
    out_lat = None
    if cache is not None and S == 1:
        lengths = new_cache.index.to(torch.int32)
        if lengths.dim() == 0:
            lengths = lengths.expand(B)
        out_lat = bk.latent_decode_attention(
            q_lat, q_rope, cache.k, cache.v, lengths.contiguous(), scale)
    if out_lat is None:
        s_nope = bk.einsum("bqhr,bsr->bhqs", q_lat, c)
        s_rope = bk.einsum("bqhd,bsd->bhqs", q_rope, k_rope)
        scores = bk.scale(bk.add(s_nope, s_rope), scale)
        neg = bk.const(L.NEG_BIG, scores)
        mb = (mask[:, None, :, :] if mask.dim() == 3
              else mask[None, None, :, :])
        scores = bk.where(mb, scores, neg)
        probs = bk.softmax(scores, dim=-1)
        probs = bk.record("attn_probs", probs, kind="softmax")
        out_lat = bk.einsum("bhqs,bsr->bqhr", probs, c)      # [B,S,H,R]
        if bk.is_analysis:
            clo = torch.amin(c.exact.lo, dim=1)[:, None, None, :]
            chi = torch.amax(c.exact.hi, dim=1)[:, None, None, :]
            out_lat = bk.clamp_range(out_lat, clo, chi)
    out = bk.per_head_matmul(out_lat, w_uv, into=False)     # [B,S,H,dv]
    out = bk.reshape(out, (B, S, H * d_v))
    return bk.matmul(out, bk.param(p["wo"])), new_cache


def mla_shapes(d: int, n_heads: int, q_rank: int, kv_rank: int,
               d_nope: int, d_rope: int, d_v: int):
    """Parameter shapes of one MLA block (the reference's ``init_mla``):
    dense weights, and the q / kv latent norms' gains ``q_norm`` and
    ``kv_norm`` (ones)."""
    return {
        "wq_a": (d, q_rank),
        "wq_b": (q_rank, n_heads * (d_nope + d_rope)),
        "wkv_a": (d, kv_rank + d_rope),
        "wkv_b": (kv_rank, n_heads * (d_nope + d_v)),
        "wo": (n_heads * d_v, d),
        "q_norm": (q_rank,),
        "kv_norm": (kv_rank,),
    }
