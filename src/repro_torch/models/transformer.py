"""LM backbone (PyTorch): the counterpart of the JAX package's
``repro.models.transformer`` for the GQA and recurrent families.

It covers the dense GQA models (Qwen2, Command-R), Gemma-2 (softcapped
scores and logits, √d embedding scale, even layers local with a sliding
window, odd ones global, tanh-GELU), the MoE ones (Mixtral with a sliding
window on every layer, Llama-4), RWKV6 (attention-free: time mix and
channel mix, an O(1) recurrent state) and Hymba (windowed GQA attention
beside Mamba heads, averaged). Parameters keep the reference's stacked
layout — a dict whose per-layer tensors carry a leading ``[L]`` axis — so
both packages compute the same thing on the same numbers. The other
families' features (MLA, encoder-decoder, modality frontends, LayerNorm)
are not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as SSM


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Field for field the reference's ``ArchConfig``."""

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None
    act: str = "silu"
    norm: str = "rmsnorm"
    qkv_bias: bool = False
    softcap_attn: Optional[float] = None
    softcap_final: Optional[float] = None
    window: Optional[int] = None
    local_global_period: Optional[int] = None
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    embed_scale: bool = False
    n_experts: Optional[int] = None
    top_k: Optional[int] = None
    moe_d_ff: Optional[int] = None
    mla: bool = False
    q_rank: int = 768
    kv_rank: int = 256
    d_nope: int = 64
    d_rope: int = 32
    d_v: int = 64
    rwkv: bool = False
    hybrid: bool = False
    ssm_state: int = 16
    mamba_expand: int = 2
    enc_dec: bool = False
    n_enc_layers: int = 0
    frontend: Optional[str] = None
    frontend_seq: int = 0
    frontend_dim: int = 0
    max_decode_seq: int = 448

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads


def check_supported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError for anything outside the GQA families with
    RMSNorm (dense or MoE MLPs, softcaps, sliding windows, embedding
    scale), RWKV and the attention + Mamba hybrid."""
    unported = {
        "mla": cfg.mla, "enc_dec": cfg.enc_dec,
        "frontend": cfg.frontend is not None,
        "layernorm": cfg.norm != "rmsnorm",
    }
    missing = sorted(k for k, v in unported.items() if v)
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported to repro_torch")


def param_shapes(cfg: ArchConfig) -> Dict[str, Any]:
    """The parameter tree's shapes (stacked ``[L, ...]`` per-layer)."""
    check_supported(cfg)
    d, dh, n = cfg.d_model, cfg.head_dim, cfg.n_layers
    stack = lambda shapes: {k: (n,) + s for k, s in shapes.items()}
    layers = {"ln1": (n, d), "ln2": (n, d)}
    if cfg.rwkv:
        layers["tmix"] = stack(SSM.rwkv_tmix_shapes(d, cfg.n_heads))
        layers["cmix"] = stack(SSM.rwkv_cmix_shapes(d, cfg.d_ff))
    else:
        layers["attn"] = stack(A.gqa_shapes(d, cfg.n_heads, cfg.n_kv_heads,
                                            dh, cfg.qkv_bias))
    if cfg.hybrid:
        layers["mamba"] = stack(SSM.mamba_shapes(
            d, cfg.mamba_expand * d, cfg.ssm_state))
    if cfg.family == "moe":
        layers["moe"] = stack(M.moe_shapes(d, cfg.moe_d_ff or cfg.d_ff,
                                           cfg.n_experts))
    elif not cfg.rwkv:
        layers["mlp"] = {"w_gate": (n, d, cfg.d_ff),
                         "w_up": (n, d, cfg.d_ff),
                         "w_down": (n, cfg.d_ff, d)}
    shapes = {"embed": (cfg.vocab, d), "layers": layers,
              "final_norm": (d,)}
    if not cfg.tie_embeddings:
        shapes["head"] = (cfg.vocab, d)
    return shapes


_SSM_BLOCKS = ("tmix", "cmix", "mamba")


def _init_value(path, shape, generator, device):
    """One tensor at ``path`` (its keys in the tree), filled in place on
    ``device`` with the reference's distributions: N(0, 1/fan_in) dense
    weights (the experts' too: fan_in is the second-to-last axis), N(0,
    0.02²) embeddings, ones for norm gains, zeros for biases; the leaves of
    the ``tmix``, ``cmix`` and ``mamba`` blocks (whose names collide with
    attention's) as :func:`repro_torch.models.ssm.init_leaf` draws them."""
    name = path[-1]
    if len(path) > 1 and path[-2] in _SSM_BLOCKS:
        return SSM.init_leaf(name, shape, generator=generator, device=device)
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if name in ("ln1", "ln2", "final_norm"):
        return t.fill_(1.0)
    if name in ("bq", "bk", "bv"):
        return t.zero_()
    std = 0.02 if name in ("embed", "head") else 1.0 / math.sqrt(shape[-2])
    return t.normal_(0.0, std, generator=generator)


def init_params(cfg: ArchConfig, *, generator: torch.Generator,
                device) -> Dict[str, Any]:
    """Random parameters from ``generator`` (which must live on ``device``),
    each tensor allocated and filled in place on the device — a 30 GB
    model never holds a second copy. The numbers differ from JAX's
    ``init_params`` (another generator); tests that compare the two
    packages convert the reference's params with
    :func:`repro_torch.convert.params_from_numpy` instead."""
    def build(tree, path=()):
        if isinstance(tree, dict):
            return {k: build(v, path + (k,)) for k, v in tree.items()}
        return _init_value(path, tree, generator, device)

    return build(param_shapes(cfg))


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, *,
               device, dtype=torch.float32,
               per_lane_idx: bool = False) -> Dict[str, torch.Tensor]:
    """Stacked per-layer decode cache: k/v [L, B, Smax, K, Dh], idx [L].
    RWKV: its O(1) state instead, S [L, B, H, C, C] and the token-shift
    rows x_tm / x_cm [L, B, d], no idx. A hybrid model: also the Mamba
    state h_ssm [L, B, d_inner, N].

    ``per_lane_idx=True`` gives each batch lane its own write index (idx
    [L, B]): the continuous-batching engine's cache, where lanes prefill
    and decode at independent positions."""
    check_supported(cfg)
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    Lh, d = cfg.n_layers, cfg.d_model
    if cfg.rwkv:
        C = d // cfg.n_heads
        return {"S": zeros(Lh, batch, cfg.n_heads, C, C),
                "x_tm": zeros(Lh, batch, d), "x_cm": zeros(Lh, batch, d)}
    shape = (Lh, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    idx = (Lh, batch) if per_lane_idx else (Lh,)
    out = {"k": zeros(*shape), "v": zeros(*shape),
           "idx": torch.zeros(idx, dtype=torch.int32, device=device)}
    if cfg.hybrid:
        out["h_ssm"] = zeros(Lh, batch, cfg.mamba_expand * d, cfg.ssm_state)
    return out


def analytic_params(cfg: ArchConfig, active: bool = False) -> int:
    """Closed-form parameter count, the reference's. ``active`` counts the
    parameters one token runs through: an MoE layer's router and its top-k
    experts (the others' weights are not read for it)."""
    check_supported(cfg)
    d, dh = cfg.d_model, cfg.head_dim
    emb = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    if cfg.rwkv:
        per_layer = 5 * d * d + d * 64 + 64 * d
        per_layer += d * cfg.d_ff + cfg.d_ff * d + d * d
        return emb + cfg.n_layers * per_layer
    per_layer = d * cfg.n_heads * dh + 2 * d * cfg.n_kv_heads * dh
    per_layer += cfg.n_heads * dh * d
    if cfg.hybrid:
        di = cfg.mamba_expand * d
        per_layer += 2 * d * di + di * (2 * cfg.ssm_state + 1) + di * d
    if cfg.family == "moe":
        e = cfg.n_experts if not active else cfg.top_k
        ff = cfg.moe_d_ff or cfg.d_ff
        per_layer += d * cfg.n_experts + e * (2 * d * ff + ff * d)
    else:
        per_layer += 3 * d * cfg.d_ff
    return emb + cfg.n_layers * per_layer


def forward(bk, params, cfg: ArchConfig, tokens: torch.Tensor, *,
            cache: Optional[Dict[str, torch.Tensor]] = None,
            q_offset: Union[int, torch.Tensor] = 0
            ) -> Tuple[torch.Tensor, Any]:
    """Returns (logits [B, S, V], new_cache). ``tokens``: [B, S] int.

    With a cache, the S new tokens sit at absolute positions
    ``q_offset + arange(S)``, their keys and values (and a recurrent
    model's state) are written into the cache in place, and the returned
    cache shares its storage with the one passed in. ``q_offset`` is one
    offset for the whole batch (an int), or a [B] device tensor of per-lane
    offsets (the ragged path of continuous batching, which needs a cache):
    rope rows and the causal mask are then per lane. The scopes "embed",
    "layer{i}"/"attn"|"mlp" and "head" are the keys certificates assign;
    an RWKV layer has no sub-scope, and Hymba's Mamba heads run in
    "layer{i}" itself.

    Gemma-2's even layers are local (window ``local_global_period``), its
    odd ones global; a ``window`` applies to every layer (Mixtral, Hymba).
    The loop is unrolled, so each layer's mask and window are chosen by a
    Python int. As in the reference, a single-token step of a model with a
    softcap or a window is not offered to ``bk.decode_attention``
    (``fused_ok``); it goes to ``bk.windowed_decode_attention``. RWKV has
    no attention, rope or mask: its state carries the context, and a cached
    step starts from the state the cache holds."""
    check_supported(cfg)
    dev = tokens.device
    with bk.scope("embed"):
        x = L.embed(bk, params["embed"], tokens)
        if cfg.embed_scale:
            x = bk.scale(x, math.sqrt(cfg.d_model))

    B, Sq, _ = bk.shape_of(x)
    ragged = isinstance(q_offset, torch.Tensor) and q_offset.dim() == 1
    if ragged and cache is None:
        raise ValueError("per-lane q_offset requires a KV cache")
    step = cache is not None and Sq == 1
    lgp = cfg.local_global_period
    # the fused decode hook only sees the plain-causal S==1 step
    fused_ok = (step and cfg.softcap_attn is None and cfg.window is None
                and lgp is None)
    if not cfg.rwkv:
        cos_q, sin_q, gmask, lmask = _rope_and_masks(
            cfg, Sq, cache["k"].shape[2] if cache is not None else Sq,
            q_offset, ragged, cache is not None, dev)

    def rwkv_layer(p, x, aux):
        h = L.rmsnorm(bk, x, p["ln1"])
        state = None
        if aux is not None:
            state = SSM.RwkvState(aux["S"],
                                  bk.value_of(bk.input(aux["x_tm"])))
        out, new_state = SSM.rwkv_tmix(bk, h, p["tmix"],
                                       n_heads=cfg.n_heads, state=state)
        x = bk.add(x, out)
        h2 = L.rmsnorm(bk, x, p["ln2"])
        x = bk.add(x, SSM.rwkv_cmix(bk, h2, p["cmix"],
                                    None if aux is None else aux["x_cm"]))
        if aux is not None:
            aux["S"].copy_(new_state.S)
            aux["x_tm"].copy_(new_state.x_prev)
            aux["x_cm"].copy_(bk.value_of(h2)[:, -1, :])
        return x

    def layer_fn(p, x, i, aux):
        if cfg.rwkv:
            return rwkv_layer(p, x, aux)
        local = lmask is not None and i % 2 == 0     # Gemma-2: even layers
        h = L.rmsnorm(bk, x, p["ln1"])
        kv = None if aux is None else A.KVCache(aux["k"], aux["v"],
                                                aux["idx"])
        with bk.scope("attn"):
            out, new_kv = A.gqa_attention(
                bk, h, p["attn"], n_heads=cfg.n_heads,
                n_kv_heads=cfg.n_kv_heads, d_head=cfg.head_dim,
                cos=cos_q, sin=sin_q, mask=lmask if local else gmask,
                softcap=cfg.softcap_attn,
                window=lgp if local else (cfg.window or 0),
                qkv_bias=cfg.qkv_bias, cache=kv, fused_decode=fused_ok,
                windowed_decode=step and not fused_ok)
        if cfg.hybrid:
            # the Mamba heads beside the attention, averaged with it
            m_out, h_fin = SSM.mamba_lite(
                bk, h, p["mamba"], d_state=cfg.ssm_state,
                h0=None if aux is None else aux["h_ssm"], return_state=True)
            out = bk.scale(bk.add(out, m_out), 0.5, exact_const=True)
            if aux is not None:
                aux["h_ssm"].copy_(h_fin)
        x = bk.add(x, out)
        h2 = L.rmsnorm(bk, x, p["ln2"])
        with bk.scope("mlp"):
            if cfg.family == "moe":
                mlp_out = M.moe_mlp(bk, h2, p["moe"],
                                    n_experts=cfg.n_experts,
                                    top_k=cfg.top_k, act=cfg.act)
            else:
                mlp_out = L.mlp_gated(bk, h2, p["mlp"]["w_gate"],
                                      p["mlp"]["w_up"], p["mlp"]["w_down"],
                                      cfg.act)
        return bk.add(x, mlp_out)

    x = bk.layer_loop(layer_fn, params["layers"], x, cfg.n_layers,
                      aux=cache)
    new_cache = None
    if cache is not None:
        new_cache = dict(cache)
        if "idx" in cache:
            new_cache["idx"] = cache["idx"] + Sq

    with bk.scope("head"):
        x = L.rmsnorm(bk, x, params["final_norm"])
        head = params["embed"] if cfg.tie_embeddings else params["head"]
        logits = L.logits_head(bk, x, head, cfg.softcap_final)
        logits = bk.record("logits", logits, kind="head")
    return logits, new_cache


def _rope_and_masks(cfg: ArchConfig, Sq: int, kv_len: int, q_offset,
                    ragged: bool, cached: bool, dev):
    """The rope rows of the Sq query positions and the (global, local)
    attention masks [q, kv] (or [B, q, kv] per lane when ``ragged``); the
    local mask is None unless the model alternates local and global
    layers."""
    if ragged:
        positions = (q_offset.to(torch.int64)[:, None]
                     + torch.arange(Sq, device=dev)[None, :])      # [B, Sq]
    else:
        positions = torch.arange(Sq, device=dev) + q_offset
    rope_positions = (torch.arange(kv_len, device=dev) if cached
                      else positions)
    cos_full, sin_full = L.rope_tables(rope_positions, cfg.head_dim,
                                       cfg.rope_theta)
    if cached:
        cos_q, sin_q = cos_full[positions], sin_full[positions]
    else:
        cos_q, sin_q = cos_full[-Sq:], sin_full[-Sq:]
    lgp = cfg.local_global_period
    if ragged:
        offs = q_offset.to(torch.int64)
        gmask = L.lane_causal_mask(Sq, kv_len, offs, cfg.window)
        lmask = L.lane_causal_mask(Sq, kv_len, offs, lgp) if lgp else None
    else:
        gmask = L.causal_mask(Sq, kv_len, q_offset, cfg.window, device=dev)
        lmask = (L.causal_mask(Sq, kv_len, q_offset, lgp, device=dev)
                 if lgp else None)
    return cos_q, sin_q, gmask, lmask
