"""LM backbone (PyTorch): the counterpart of the JAX package's
``repro.models.transformer``, for all ten of its architectures.

It covers the dense GQA models (Qwen2, Command-R), Gemma-2 (softcapped
scores and logits, √d embedding scale, even layers local with a sliding
window, odd ones global, tanh-GELU), the MoE ones (Mixtral with a sliding
window on every layer, Llama-4), RWKV6 (attention-free: time mix and
channel mix, an O(1) recurrent state), Hymba (windowed GQA attention
beside Mamba heads, averaged), MiniCPM3 (multi-head latent attention over
a compressed latent cache), Whisper (LayerNorm, an encoder over the audio
stub's frames and cross-attention in every decoder layer) and PaliGemma
(the vision stub's patches projected and prepended to the text).
Parameters keep the reference's stacked layout — a dict whose per-layer
tensors carry a leading ``[L]`` axis — so both packages compute the same
thing on the same numbers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.core import dtypes
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


def _layer_shapes(cfg: ArchConfig, n: int) -> Dict[str, Any]:
    """One stack of ``n`` layers' shapes (stacked ``[n, ...]``)."""
    d, dh = cfg.d_model, cfg.head_dim
    stack = lambda shapes: {k: (n,) + s for k, s in shapes.items()}
    layers = {"ln1": (n, d), "ln2": (n, d)}
    if cfg.norm == "layernorm":
        layers.update(ln1_b=(n, d), ln2_b=(n, d))
    if cfg.rwkv:
        layers["tmix"] = stack(SSM.rwkv_tmix_shapes(d, cfg.n_heads))
        layers["cmix"] = stack(SSM.rwkv_cmix_shapes(d, cfg.d_ff))
        return layers
    if cfg.mla:
        layers["attn"] = stack(A.mla_shapes(
            d, cfg.n_heads, cfg.q_rank, cfg.kv_rank, cfg.d_nope,
            cfg.d_rope, cfg.d_v))
    else:
        layers["attn"] = stack(A.gqa_shapes(d, cfg.n_heads, cfg.n_kv_heads,
                                            dh, cfg.qkv_bias))
    if cfg.hybrid:
        layers["mamba"] = stack(SSM.mamba_shapes(
            d, cfg.mamba_expand * d, cfg.ssm_state))
    if cfg.family == "moe":
        layers["moe"] = stack(M.moe_shapes(d, cfg.moe_d_ff or cfg.d_ff,
                                           cfg.n_experts))
    else:
        layers["mlp"] = {"w_gate": (n, d, cfg.d_ff),
                         "w_up": (n, d, cfg.d_ff),
                         "w_down": (n, cfg.d_ff, d)}
    return layers


def param_shapes(cfg: ArchConfig) -> Dict[str, Any]:
    """The parameter tree's shapes (stacked ``[L, ...]`` per-layer). An
    encoder-decoder model adds the encoder's dense layers ``enc_layers``
    (no MLA, RWKV or Mamba, as the reference builds them), ``enc_norm``
    and per decoder layer a ``cross`` GQA block; a modality frontend its
    ``frontend_proj`` [frontend_dim, d]."""
    d = cfg.d_model
    shapes = {"embed": (cfg.vocab, d),
              "layers": _layer_shapes(cfg, cfg.n_layers),
              "final_norm": (d,)}
    if not cfg.tie_embeddings:
        shapes["head"] = (cfg.vocab, d)
    if cfg.enc_dec:
        enc = dataclasses.replace(cfg, rwkv=False, hybrid=False, mla=False,
                                  family="dense")
        shapes["enc_layers"] = _layer_shapes(enc, cfg.n_enc_layers)
        shapes["enc_norm"] = (d,)
        shapes["cross"] = {k: (cfg.n_layers,) + s for k, s in A.gqa_shapes(
            d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim).items()}
    if cfg.frontend:
        shapes["frontend_proj"] = (cfg.frontend_dim, d)
    return shapes


_SSM_BLOCKS = ("tmix", "cmix", "mamba")


#: the trees whose leaves are stacked over layers, [L, ...]
_STACKS = ("layers", "enc_layers", "cross")


def _init_value(path, shape, generator, device, layer_slice=False):
    """One tensor at ``path`` (its keys in the tree), filled in place on
    ``device`` with the reference's distributions: N(0, 1/fan_in) dense
    weights (the experts' too: fan_in is the second-to-last axis), N(0,
    0.02²) embeddings, ones for norm gains (MLA's latent norms and the
    encoder's too), zeros for biases (LayerNorm's ``ln*_b`` too); the leaves of
    the ``tmix``, ``cmix`` and ``mamba`` blocks (whose names collide with
    attention's) as :func:`repro_torch.models.ssm.init_leaf` draws them.
    ``layer_slice``: one layer's slice ``shape[1:]`` of a stacked leaf
    ``shape``, with the whole leaf's distribution."""
    name = path[-1]
    if len(path) > 1 and path[-2] in _SSM_BLOCKS:
        return SSM.init_leaf(name, shape, generator=generator, device=device,
                             layer_slice=layer_slice)
    t = torch.empty(shape[1:] if layer_slice else shape,
                    dtype=torch.float32, device=device)
    if name in ("ln1", "ln2", "final_norm", "enc_norm", "q_norm",
                "kv_norm"):
        return t.fill_(1.0)
    if name in ("bq", "bk", "bv", "ln1_b", "ln2_b"):
        return t.zero_()
    std = 0.02 if name in ("embed", "head") else 1.0 / math.sqrt(shape[-2])
    return t.normal_(0.0, std, generator=generator)


def init_params(cfg: ArchConfig, *, generator: torch.Generator,
                device, dtype=torch.float32) -> Dict[str, Any]:
    """Random parameters from ``generator`` (which must live on ``device``),
    each tensor allocated and filled in place on the device — a 30 GB
    model never holds a second copy. The numbers differ from JAX's
    ``init_params`` (another generator); tests that compare the two
    packages convert the reference's params with
    :func:`repro_torch.convert.params_from_numpy` instead.

    ``dtype`` (f32, bf16 or e4m3: ``ServeConfig``'s param dtype) is the
    stored dtype. A stacked leaf (under ``layers`` / ``enc_layers``, [L,
    ...]) is filled one layer slice at a time in f32 and rounded into it
    (e4m3 by the reference's rounding, :func:`repro_torch.core.dtypes.
    cast`), so one slice is the largest f32 temporary (Gemma-2's stacked
    ``w_gate`` is 31.3 GB in f32), and every dtype draws the same numbers:
    a narrow init is the f32 init followed by the cast, bit for bit. A
    leaf outside the stack is filled whole, then cast."""
    def build(tree, path=()):
        if isinstance(tree, dict):
            return {k: build(v, path + (k,)) for k, v in tree.items()}
        if path[0] not in _STACKS:
            return dtypes.cast(_init_value(path, tree, generator, device),
                               dtype)
        out = torch.empty(tree, dtype=dtype, device=device)
        for i in range(tree[0]):
            out[i] = dtypes.cast(_init_value(path, tree, generator, device,
                                             layer_slice=True), dtype)
        return out

    return build(param_shapes(cfg))


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, *,
               device, dtype=torch.float32,
               per_lane_idx: bool = False) -> Dict[str, torch.Tensor]:
    """Stacked per-layer decode cache: k/v [L, B, Smax, K, Dh], idx [L].
    MLA: the compressed latent instead, k = c [L, B, Smax, kv_rank] and v =
    the rope key [L, B, Smax, d_rope]. RWKV: its O(1) state, S [L, B, H,
    C, C] and the token-shift rows x_tm / x_cm [L, B, d], no idx. A hybrid
    model: also the Mamba state h_ssm [L, B, d_inner, N].

    ``per_lane_idx=True`` gives each batch lane its own write index (idx
    [L, B]): the continuous-batching engine's cache, where lanes prefill
    and decode at independent positions."""
    return {name: torch.zeros(shape, dtype=torch.int32 if name == "idx"
                              else dtype, device=device)
            for name, shape in cache_shapes(cfg, batch, max_seq,
                                            per_lane_idx=per_lane_idx).items()}


def cache_shapes(cfg: ArchConfig, batch: int, max_seq: int, *,
                 per_lane_idx: bool = False) -> Dict[str, tuple]:
    """The shapes of :func:`init_cache`'s buffers (``idx`` is int32, the
    others in the cache dtype)."""
    Lh, d = cfg.n_layers, cfg.d_model
    if cfg.rwkv:
        C = d // cfg.n_heads
        return {"S": (Lh, batch, cfg.n_heads, C, C), "x_tm": (Lh, batch, d),
                "x_cm": (Lh, batch, d)}
    idx = (Lh, batch) if per_lane_idx else (Lh,)
    if cfg.mla:
        return {"k": (Lh, batch, max_seq, cfg.kv_rank),
                "v": (Lh, batch, max_seq, cfg.d_rope), "idx": idx}
    shape = (Lh, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    out = {"k": shape, "v": shape, "idx": idx}
    if cfg.hybrid:
        out["h_ssm"] = (Lh, batch, cfg.mamba_expand * d, cfg.ssm_state)
    return out


def analytic_params(cfg: ArchConfig, active: bool = False) -> int:
    """Closed-form parameter count, the reference's (norms, biases and the
    frontend projection are not counted, as there). ``active`` counts the
    parameters one token runs through: an MoE layer's router and its top-k
    experts (the others' weights are not read for it)."""
    d, dh = cfg.d_model, cfg.head_dim
    emb = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    if cfg.rwkv:
        per_layer = 5 * d * d + d * 64 + 64 * d
        per_layer += d * cfg.d_ff + cfg.d_ff * d + d * d
        return emb + cfg.n_layers * per_layer
    if cfg.mla:
        H = cfg.n_heads
        per_layer = d * cfg.q_rank + cfg.q_rank * H * (cfg.d_nope
                                                       + cfg.d_rope)
        per_layer += d * (cfg.kv_rank + cfg.d_rope)
        per_layer += cfg.kv_rank * H * (cfg.d_nope + cfg.d_v)
        per_layer += H * cfg.d_v * d
    else:
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
    n = emb + cfg.n_layers * per_layer
    if cfg.enc_dec:
        n += cfg.n_enc_layers * (4 * d * dh * cfg.n_heads + 3 * d * cfg.d_ff)
        n += cfg.n_layers * 4 * d * dh * cfg.n_heads
    return n


def _norm(bk, x, p, cfg: ArchConfig, which: str):
    """The layer's ``which`` norm (``ln1`` / ``ln2``): LayerNorm with its
    bias ``which + "_b"``, or RMSNorm."""
    if cfg.norm == "layernorm":
        return L.layernorm(bk, x, p[which], p[which + "_b"])
    return L.rmsnorm(bk, x, p[which])


def _mlp_or_moe(bk, x, p, cfg: ArchConfig):
    if cfg.family == "moe":
        return M.moe_mlp(bk, x, p["moe"], n_experts=cfg.n_experts,
                         top_k=cfg.top_k, act=cfg.act)
    return L.mlp_gated(bk, x, p["mlp"]["w_gate"], p["mlp"]["w_up"],
                       p["mlp"]["w_down"], cfg.act)


def _rope_dim(cfg: ArchConfig) -> int:
    return cfg.d_rope if cfg.mla else cfg.head_dim


def frontend_inputs(cfg: ArchConfig, batch: int, rng, device,
                    dtype=torch.float32):
    """The modality stub's inputs, [batch, frontend_seq, frontend_dim]
    drawn in f32 from ``rng`` (a ``np.random.RandomState``) as the reference
    draws them (Whisper's audio frames, ``enc_embeds``; PaliGemma's vision
    patches, ``frontend_embeds``), in ``dtype`` (the compute dtype), or
    None for a text-only arch."""
    if not cfg.frontend:
        return None
    x = rng.randn(batch, cfg.frontend_seq, cfg.frontend_dim)
    return torch.from_numpy(x.astype("float32")).to(device).to(dtype)


def forward(bk, params, cfg: ArchConfig, tokens: Optional[torch.Tensor] = None,
            *, embeds=None, frontend_embeds=None, enc_embeds=None,
            enc_out=None, cache: Optional[Dict[str, torch.Tensor]] = None,
            q_offset: Union[int, torch.Tensor] = 0
            ) -> Tuple[torch.Tensor, Any]:
    """Returns (logits [B, S, V], new_cache). ``tokens``: [B, S] int (or
    ``embeds`` [B, S, d] in their place).

    With a cache, the S new positions sit at absolute positions
    ``q_offset + arange(S)``, their keys and values (and a recurrent
    model's state) are written into the cache in place, and the returned
    cache shares its storage with the one passed in. ``q_offset`` is one
    offset for the whole batch (an int), or a [B] device tensor of per-lane
    offsets (the ragged path of continuous batching, which needs a cache):
    rope rows and the causal mask are then per lane. The scopes "embed",
    "layer{i}"/"attn"|"mlp" and "head" are the keys certificates assign;
    an RWKV layer has no sub-scope, and Hymba's Mamba heads and Whisper's
    cross-attention run in "layer{i}" itself.

    ``frontend_embeds`` [B, P, frontend_dim] (the vision stub's patches)
    are projected through ``frontend_proj`` and prepended to the text
    inside the "embed" scope: the sequence is then P + S long, and a cache
    holds the patches' keys after the prefill (decode passes no patches).
    An encoder-decoder model attends to ``enc_out`` [B, Se, d] in every
    decoder layer; without it, :func:`encode` runs first on
    ``enc_embeds`` [B, Se, frontend_dim] (the audio stub's frames). Serving
    encodes once at prefill and passes ``enc_out`` to every decode step.

    Gemma-2's even layers are local (window ``local_global_period``), its
    odd ones global; a ``window`` applies to every layer (Mixtral, Hymba).
    The loop is unrolled, so each layer's mask and window are chosen by a
    Python int. As in the reference, a single-token step of a model with a
    softcap or a window is not offered to ``bk.decode_attention``
    (``fused_ok``); it goes to ``bk.windowed_decode_attention``. MLA never
    reaches either hook: it composes its absorbed form. RWKV has no
    attention, rope or mask: its state carries the context, and a cached
    step starts from the state the cache holds."""
    with bk.scope("embed"):
        x = L.embed(bk, params["embed"], tokens) if embeds is None \
            else embeds
        if cfg.embed_scale:
            x = bk.scale(x, math.sqrt(cfg.d_model))
        if frontend_embeds is not None:
            fr = bk.matmul(bk.input(frontend_embeds),
                           bk.param(params["frontend_proj"]))
            x = bk.concat([fr, x], dim=1)
    dev = bk.value_of(x).device

    B, Sq, _ = bk.shape_of(x)
    ragged = isinstance(q_offset, torch.Tensor) and q_offset.dim() == 1
    if ragged and cache is None:
        raise ValueError("per-lane q_offset requires a KV cache")
    step = cache is not None and Sq == 1
    lgp = cfg.local_global_period
    # the fused decode hook only sees the plain-causal S==1 step
    fused_ok = (step and not cfg.mla and cfg.softcap_attn is None
                and cfg.window is None and lgp is None)
    if not cfg.rwkv:
        cos_q, sin_q, gmask, lmask = _rope_and_masks(
            cfg, Sq, cache["k"].shape[2] if cache is not None else Sq,
            q_offset, ragged, cache is not None, dev)
    if cfg.enc_dec and enc_out is None:
        enc_out = encode(bk, params, cfg, enc_embeds)

    def rwkv_layer(p, x, aux):
        h = _norm(bk, x, p, cfg, "ln1")
        state = None
        if aux is not None:
            state = SSM.RwkvState(aux["S"],
                                  bk.value_of(bk.input(aux["x_tm"])))
        out, new_state = SSM.rwkv_tmix(bk, h, p["tmix"],
                                       n_heads=cfg.n_heads, state=state)
        x = bk.add(x, out)
        h2 = _norm(bk, x, p, cfg, "ln2")
        x = bk.add(x, SSM.rwkv_cmix(bk, h2, p["cmix"],
                                    None if aux is None else aux["x_cm"]))
        if aux is not None:
            # stored in the cache's dtype, upcast at use (reference
            # ssm.py: the state may live in a narrower format)
            dtypes.copy_into(aux["S"], new_state.S)
            dtypes.copy_into(aux["x_tm"], new_state.x_prev)
            dtypes.copy_into(aux["x_cm"], bk.value_of(h2)[:, -1, :])
        return x

    def layer_fn(p, x, i, aux):
        if cfg.rwkv:
            return rwkv_layer(p, x, aux)
        local = lmask is not None and i % 2 == 0     # Gemma-2: even layers
        mask = lmask if local else gmask
        h = _norm(bk, x, p, cfg, "ln1")
        kv = None if aux is None else A.KVCache(aux["k"], aux["v"],
                                                aux["idx"])
        with bk.scope("attn"):
            if cfg.mla:
                out, _ = A.mla_attention(
                    bk, h, p["attn"], n_heads=cfg.n_heads, q_rank=cfg.q_rank,
                    kv_rank=cfg.kv_rank, d_nope=cfg.d_nope,
                    d_rope=cfg.d_rope, d_v=cfg.d_v, cos=cos_q, sin=sin_q,
                    mask=mask, cache=kv)
            else:
                out, _ = A.gqa_attention(
                    bk, h, p["attn"], n_heads=cfg.n_heads,
                    n_kv_heads=cfg.n_kv_heads, d_head=cfg.head_dim,
                    cos=cos_q, sin=sin_q, mask=mask,
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
                dtypes.copy_into(aux["h_ssm"], h_fin)
        x = bk.add(x, out)
        if cfg.enc_dec:
            hc = _norm(bk, x, p, cfg, "ln1")
            x = bk.add(x, _cross_attention(bk, hc, enc_out, p["cross"], cfg))
        h2 = _norm(bk, x, p, cfg, "ln2")
        with bk.scope("mlp"):
            mlp_out = _mlp_or_moe(bk, h2, p, cfg)
        return bk.add(x, mlp_out)

    lp = params["layers"]
    if cfg.enc_dec:
        lp = dict(lp, cross=params["cross"])
    x = bk.layer_loop(layer_fn, lp, x, cfg.n_layers, aux=cache)
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


def _cross_attention(bk, x, enc_out, p, cfg: ArchConfig):
    """Decoder-to-encoder attention (Whisper): queries from the decoder's
    ``x`` [B, Sq, d], keys and values projected from ``enc_out`` [B, Se,
    d] on every call, as the reference does; no rope and no mask (every
    frame is visible). Under the analysis the context is clamped to the
    values' hull over the frames (the convex-combination fact)."""
    B, Sq, _ = bk.shape_of(x)
    Se = bk.shape_of(enc_out)[1]
    q = bk.matmul(x, bk.param(p["wq"]))
    k = bk.matmul(enc_out, bk.param(p["wk"]))
    v = bk.matmul(enc_out, bk.param(p["wv"]))
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // K
    q = bk.reshape(q, (B, Sq, K, G, dh))
    k = bk.reshape(k, (B, Se, K, dh))
    v = bk.reshape(v, (B, Se, K, dh))
    scores = bk.scale(bk.einsum("bqkgd,bskd->bkgqs", q, k), dh ** -0.5)
    probs = bk.softmax(scores, dim=-1)
    out = bk.einsum("bkgqs,bskd->bqkgd", probs, v)
    if bk.is_analysis:
        vlo = torch.amin(v.exact.lo, dim=1)[:, None, :, None, :]
        vhi = torch.amax(v.exact.hi, dim=1)[:, None, :, None, :]
        out = bk.clamp_range(out, vlo, vhi)
    out = bk.reshape(out, (B, Sq, H * dh))
    return bk.matmul(out, bk.param(p["wo"]))


def encode(bk, params, cfg: ArchConfig, enc_embeds):
    """Whisper's encoder stack over the audio stub's frame embeddings
    ``enc_embeds`` [B, Se, frontend_dim]: projected through
    ``frontend_proj``, then bidirectional GQA attention (rope over the
    frames, no mask) and the MLP in each of the ``n_enc_layers`` dense
    layers, ending in an RMSNorm (``enc_norm``), as the reference does. Its
    layers run under the same ``layer{i}`` scopes as the decoder's (without
    "attn" / "mlp" sub-scopes), as in the reference, so that certificates
    cross between the packages. Without frames it raises ValueError, as the
    reference does (``certify_lm``'s uniform probe passes none)."""
    if enc_embeds is None:
        raise ValueError(f"{cfg.name}: the encoder needs the audio stub's "
                         "frames (enc_embeds), or pass its states (enc_out)")
    x = bk.matmul(bk.input(enc_embeds), bk.param(params["frontend_proj"]))
    Se = bk.shape_of(x)[1]
    dev = bk.value_of(x).device
    cos, sin = L.rope_tables(torch.arange(Se, device=dev), cfg.head_dim,
                             cfg.rope_theta)
    mask = torch.ones((Se, Se), dtype=torch.bool, device=dev)

    def layer_fn(p, x, i, aux):
        h = _norm(bk, x, p, cfg, "ln1")
        out, _ = A.gqa_attention(
            bk, h, p["attn"], n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, d_head=cfg.head_dim, cos=cos,
            sin=sin, mask=mask)
        x = bk.add(x, out)
        h2 = _norm(bk, x, p, cfg, "ln2")
        return bk.add(x, _mlp_or_moe(bk, h2, p, cfg))

    x = bk.layer_loop(layer_fn, params["enc_layers"], x, cfg.n_enc_layers)
    return L.rmsnorm(bk, x, params["enc_norm"])


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
    cos_full, sin_full = L.rope_tables(rope_positions, _rope_dim(cfg),
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


def next_token_loss(bk, params, cfg: ArchConfig, tokens, targets,
                    frontend_embeds=None, enc_embeds=None):
    """Mean next-token cross-entropy of ``forward``'s logits against
    ``targets`` [B, S]: in f32, logsumexp minus the target's logit. With a
    vision prefix the loss is taken on the text positions only (the
    suffix). The target's logit is gathered; the reference picks it with a
    one-hot einsum, which adds zeros to the same number."""
    logits, _ = forward(bk, params, cfg, tokens,
                        frontend_embeds=frontend_embeds,
                        enc_embeds=enc_embeds)
    logits = bk.value_of(logits)
    if frontend_embeds is not None:
        logits = logits[:, -targets.shape[1]:]
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, targets.to(torch.int64)[..., None])[..., 0]
    return (lse - picked).mean()
