"""LM backbone (PyTorch) for the dense GQA family: the counterpart of the
JAX package's ``repro.models.transformer``.

Parameters keep the reference's stacked layout — a dict whose per-layer
tensors carry a leading ``[L]`` axis — so both packages compute the same
thing on the same numbers. Features of the other families (MoE, MLA, RWKV,
hybrid, encoder-decoder, modality frontends, softcap, sliding windows) are
not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.models import attention as A
from repro_torch.models import layers as L


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
    """Raise NotImplementedError for anything outside the dense GQA family
    with RMSNorm and a gated SiLU MLP."""
    unported = {
        "moe": cfg.family == "moe" or cfg.n_experts is not None,
        "mla": cfg.mla, "rwkv": cfg.rwkv, "hybrid": cfg.hybrid,
        "enc_dec": cfg.enc_dec, "frontend": cfg.frontend is not None,
        "softcap": (cfg.softcap_attn is not None
                    or cfg.softcap_final is not None),
        "window": (cfg.window is not None
                   or cfg.local_global_period is not None),
        "norm": cfg.norm != "rmsnorm", "embed_scale": cfg.embed_scale,
    }
    missing = sorted(k for k, v in unported.items() if v)
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported to repro_torch")


def param_shapes(cfg: ArchConfig) -> Dict[str, Any]:
    """The parameter tree's shapes (stacked ``[L, ...]`` per-layer)."""
    check_supported(cfg)
    d, dh, n = cfg.d_model, cfg.head_dim, cfg.n_layers
    attn = A.gqa_shapes(d, cfg.n_heads, cfg.n_kv_heads, dh, cfg.qkv_bias)
    layers = {
        "ln1": (n, d), "ln2": (n, d),
        "attn": {k: (n,) + s for k, s in attn.items()},
        "mlp": {"w_gate": (n, d, cfg.d_ff), "w_up": (n, d, cfg.d_ff),
                "w_down": (n, cfg.d_ff, d)},
    }
    shapes = {"embed": (cfg.vocab, d), "layers": layers,
              "final_norm": (d,)}
    if not cfg.tie_embeddings:
        shapes["head"] = (cfg.vocab, d)
    return shapes


def _init_value(name: str, shape, generator, device):
    """One tensor, filled in place on ``device`` with the reference's
    distributions: N(0, 1/fan_in) dense weights, N(0, 0.02²) embeddings,
    ones for norm gains, zeros for biases."""
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
    def build(tree, name=""):
        if isinstance(tree, dict):
            return {k: build(v, k) for k, v in tree.items()}
        return _init_value(name, tree, generator, device)

    return build(param_shapes(cfg))


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, *,
               device, dtype=torch.float32,
               per_lane_idx: bool = False) -> Dict[str, torch.Tensor]:
    """Stacked per-layer decode cache: k/v [L, B, Smax, K, Dh], idx [L].

    ``per_lane_idx=True`` gives each batch lane its own write index (idx
    [L, B]): the continuous-batching engine's cache, where lanes prefill
    and decode at independent positions."""
    check_supported(cfg)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    idx = (cfg.n_layers, batch) if per_lane_idx else (cfg.n_layers,)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "idx": torch.zeros(idx, dtype=torch.int32, device=device),
    }


def analytic_params(cfg: ArchConfig) -> int:
    """Closed-form parameter count."""
    check_supported(cfg)
    d, dh = cfg.d_model, cfg.head_dim
    emb = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    per_layer = d * cfg.n_heads * dh + 2 * d * cfg.n_kv_heads * dh
    per_layer += cfg.n_heads * dh * d + 3 * d * cfg.d_ff
    return emb + cfg.n_layers * per_layer


def forward(bk, params, cfg: ArchConfig, tokens: torch.Tensor, *,
            cache: Optional[Dict[str, torch.Tensor]] = None,
            q_offset: Union[int, torch.Tensor] = 0
            ) -> Tuple[torch.Tensor, Any]:
    """Returns (logits [B, S, V], new_cache). ``tokens``: [B, S] int.

    With a cache, the S new tokens sit at absolute positions
    ``q_offset + arange(S)``, their keys and values are written into the
    cache in place, and the returned cache shares its k/v storage with the
    one passed in. ``q_offset`` is one offset for the whole batch (an int),
    or a [B] device tensor of per-lane offsets (the ragged path of
    continuous batching, which needs a cache): rope rows and the causal
    mask are then per lane. The scopes "embed", "layer{i}"/"attn"|"mlp" and
    "head" are the keys certificates assign."""
    check_supported(cfg)
    dev = tokens.device
    with bk.scope("embed"):
        x = L.embed(bk, params["embed"], tokens)

    B, Sq, _ = bk.shape_of(x)
    kv_len = cache["k"].shape[2] if cache is not None else Sq
    ragged = isinstance(q_offset, torch.Tensor) and q_offset.dim() == 1
    if ragged and cache is None:
        raise ValueError("per-lane q_offset requires a KV cache")
    if ragged:
        positions = (q_offset.to(torch.int64)[:, None]
                     + torch.arange(Sq, device=dev)[None, :])      # [B, Sq]
    else:
        positions = torch.arange(Sq, device=dev) + q_offset
    rope_positions = (torch.arange(kv_len, device=dev) if cache is not None
                      else positions)
    cos_full, sin_full = L.rope_tables(rope_positions, cfg.head_dim,
                                       cfg.rope_theta)
    if cache is None:
        cos_q, sin_q = cos_full[-Sq:], sin_full[-Sq:]
    else:
        cos_q, sin_q = cos_full[positions], sin_full[positions]
    if ragged:
        mask = L.lane_causal_mask(Sq, kv_len, q_offset.to(torch.int64))
    else:
        mask = L.causal_mask(Sq, kv_len, q_offset, device=dev)
    fused_ok = cache is not None and Sq == 1

    def layer_fn(p, x, i, aux):
        h = L.rmsnorm(bk, x, p["ln1"])
        kv = None if aux is None else A.KVCache(aux["k"], aux["v"],
                                                aux["idx"])
        with bk.scope("attn"):
            out, new_kv = A.gqa_attention(
                bk, h, p["attn"], n_heads=cfg.n_heads,
                n_kv_heads=cfg.n_kv_heads, d_head=cfg.head_dim,
                cos=cos_q, sin=sin_q, mask=mask, qkv_bias=cfg.qkv_bias,
                cache=kv, fused_decode=fused_ok)
        x = bk.add(x, out)
        h2 = L.rmsnorm(bk, x, p["ln2"])
        with bk.scope("mlp"):
            mlp_out = L.mlp_gated(bk, h2, p["mlp"]["w_gate"],
                                  p["mlp"]["w_up"], p["mlp"]["w_down"],
                                  cfg.act)
        return bk.add(x, mlp_out)

    x = bk.layer_loop(layer_fn, params["layers"], x, cfg.n_layers,
                      aux=cache)
    new_cache = None
    if cache is not None:
        new_cache = {"k": cache["k"], "v": cache["v"],
                     "idx": cache["idx"] + Sq}

    with bk.scope("head"):
        x = L.rmsnorm(bk, x, params["final_norm"])
        head = params["embed"] if cfg.tie_embeddings else params["head"]
        logits = L.logits_head(bk, x, head)
        logits = bk.record("logits", logits, kind="head")
    return logits, new_cache
