"""Grouped-query attention with a KV cache (PyTorch), the counterpart of
``gqa_attention`` in the JAX package's ``repro.models.attention``.

Unlike the reference, whose arrays are immutable, the port writes new keys
and values INTO the cache buffers in place (``index_copy_`` along the
sequence axis, or one ``index_put_`` on (lane, position) when each lane
writes at its own offset): the returned cache holds the same storage, so a
full-width cache is never copied per layer or per step.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models import layers as L


class KVCache(NamedTuple):
    k: torch.Tensor      # [B, Smax, K, Dh]
    v: torch.Tensor      # [B, Smax, K, Dh]
    index: torch.Tensor  # int32 tokens already present: 0-d (all lanes), or
    #                      [B] when lanes advance independently (continuous
    #                      batching)


def _cache_write(buf: torch.Tensor, upd: torch.Tensor, index: torch.Tensor):
    """Write ``upd`` [B, S, ...] into ``buf`` [B, Smax, ...] in place and
    without a host sync. A 0-d ``index`` writes every lane at that sequence
    offset; a [B] one writes lane b at ``index[b]`` (one ``index_put_`` on
    (lane, position)). The positions written must lie inside the buffer."""
    steps = torch.arange(upd.shape[1], device=buf.device)
    upd = upd.to(buf.dtype)
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
                  cos, sin, mask, qkv_bias: bool = False,
                  cache: Optional[KVCache] = None,
                  fused_decode: bool = False):
    """Grouped-query attention. x: [B,S,d]. Returns (out, new_cache).

    With ``cache`` set, keys/values are written into the cache buffers in
    place at ``cache.index`` (0-d, or [B] per lane), and attention runs over
    the whole buffer under ``mask`` ([q, kv], or [B, q, kv] per lane).
    ``fused_decode`` offers the S==1 step to ``bk.decode_attention`` (the
    certificate-aware flash decode hook) with each lane's new length; a
    backend returning None takes the composed path. The composed prefill
    scores and probabilities are never rounded, as in the reference."""
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
        _cache_write(cache.k, k, cache.index)
        _cache_write(cache.v, v, cache.index)
        new_cache = KVCache(cache.k, cache.v, cache.index + S)
        if fused_decode and S == 1:
            lengths = new_cache.index.to(torch.int32)
            if lengths.dim() == 0:
                lengths = lengths.expand(B)
            lengths = lengths.contiguous()
            q4 = bk.reshape(q, (B, n_kv_heads, G, d_head))
            fused = bk.decode_attention(q4, cache.k, cache.v, lengths)
            if fused is not None:
                out = bk.reshape(fused, (B, S, n_heads * d_head))
                return bk.matmul(out, bk.param(p["wo"])), new_cache
        k = bk.input(cache.k)
        v = bk.input(cache.v)

    q = bk.reshape(q, (B, S, n_kv_heads, G, d_head))
    scores = bk.einsum("bqkgd,bskd->bkgqs", q, k)
    scores = bk.scale(scores, d_head ** -0.5)
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
