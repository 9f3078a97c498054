"""Backend-generic building blocks (PyTorch), the counterpart of the JAX
package's ``repro.models.layers`` for the dense GQA family.

Every function takes the arithmetic backend ``bk`` first; parameters arrive
as tensors and are wrapped with ``bk.param``. The op order of each block is
the reference's, so the certified serving backends round exactly the ops
the JAX package rounds (``bk.matmul``), and nothing else.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_BIG = -1e9  # mask value: exact constant, exp(-1e9) = 0


def dense_init(n_in: int, n_out: int, scale: Optional[float] = None, *,
               generator: torch.Generator, device=None) -> torch.Tensor:
    """N(0, 1)·scale weights [n_in, n_out] in f32 (scale 1/√n_in by
    default), drawn on the CPU from ``generator`` and moved to ``device``,
    so one seed gives the same weights on every device. (PyTorch cannot
    replay the reference's ``jax.random`` draws: tests hand the reference's
    weights over through numpy.)"""
    scale = scale if scale is not None else 1.0 / math.sqrt(n_in)
    w = torch.randn((n_in, n_out), generator=generator, dtype=torch.float32)
    return (w * scale).to(device)


def rmsnorm(bk, x, gamma, eps: float = 1e-6):
    """x * rsqrt(mean(x², -1) + eps) * γ.

    On the card the mean of squares is the fixed-order ``row_mean`` kernel
    (``TorchOps.mean``), so a lane's bits do not depend on its batch.

    Global insight injected for the analysis: |x_i|/√(mean(x²)+eps) ≤ √n
    always (x_i² ≤ n·mean(x²)) — IA alone pairs x_hi with 1/√eps and
    explodes; the clamp is the algebraic fact it cannot see. Outside the
    analysis ``clamp_range`` is the identity, and the bound is not
    computed."""
    g = bk.param(gamma)
    ms = bk.mean(bk.square(x), dim=-1, keepdim=True)
    inv = bk.rsqrt(bk.shift(ms, eps))
    y = bk.mul(bk.mul(x, inv), g)
    if not bk.is_analysis:
        return y
    n = bk.shape_of(x)[-1]
    bound = (math.sqrt(n) * 1.0000001) * gamma.to(torch.float64).abs()
    return bk.clamp_range(y, -bound, bound)


def embed(bk, table, ids):
    """Exact gather of stored rows."""
    return bk.take(bk.param(table), ids)


def logits_head(bk, x, table):
    """Final projection through ``bk.einsum``: the certified backends do not
    round it, so it stays an f32 product — on the card the row-invariant
    ``f32_matmul`` kernel (``TorchOps.einsum``: one fmaf order per logit,
    whatever the batch)."""
    return bk.einsum("bsd,vd->bsv", x, bk.param(table))


def mlp_gated(bk, x, w_gate, w_up, w_down, act: str = "silu"):
    """LLaMA-style gated MLP: down(act(x@Wg) * (x@Wu))."""
    g = bk.matmul(x, bk.param(w_gate))
    u = bk.matmul(x, bk.param(w_up))
    a = getattr(bk, act)(g)
    return bk.matmul(bk.mul(a, u), bk.param(w_down))


def rope_tables(positions: torch.Tensor, d_head: int,
                theta: float = 10000.0):
    """cos/sin tables for the given positions: [S, d_head//2] each, f32."""
    half = d_head // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / (theta ** (ar / half))
    ang = positions.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(bk, x, cos, sin):
    """x: [B, S, H, Dh]; tables [S, Dh/2], or [B, S, Dh/2] for the ragged
    decode path (per-lane absolute positions)."""
    dh = bk.shape_of(x)[-1]
    half = dh // 2
    x1 = bk.slice(x, (Ellipsis, slice(0, half)))
    x2 = bk.slice(x, (Ellipsis, slice(half, dh)))
    if cos.dim() == 3:                      # per-lane tables [B, S, Dh/2]
        c = bk.param(cos[:, :, None, :])
        s = bk.param(sin[:, :, None, :])
    else:
        c = bk.param(cos[None, :, None, :])
        s = bk.param(sin[None, :, None, :])
    r1 = bk.sub(bk.mul(x1, c), bk.mul(x2, s))
    r2 = bk.add(bk.mul(x2, c), bk.mul(x1, s))
    return bk.concat([r1, r2], dim=-1)


def causal_mask(q_len: int, kv_len: int, q_offset: int = 0, *, device=None):
    """Boolean [q_len, kv_len]: True = attendable; queries sit at absolute
    positions ``q_offset + arange(q_len)``."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    k_pos = torch.arange(kv_len, device=device)[None, :]
    return k_pos <= q_pos


def lane_causal_mask(q_len: int, kv_len: int, q_offsets: torch.Tensor):
    """Per-lane boolean [B, q_len, kv_len] for the ragged decode path: lane
    b's queries sit at absolute positions ``q_offsets[b] + arange(q_len)``.
    Exact integer logic, the attendability rule of :func:`causal_mask`."""
    dev = q_offsets.device
    q_pos = (q_offsets[:, None, None]
             + torch.arange(q_len, device=dev)[None, :, None])
    k_pos = torch.arange(kv_len, device=dev)[None, None, :]
    return k_pos <= q_pos
