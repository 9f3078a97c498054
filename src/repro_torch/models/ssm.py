"""State-space / linear-attention layers (PyTorch): RWKV6 ("Finch") and
Mamba-lite, the counterparts of the JAX package's ``repro.models.ssm``.

Prefill evaluates RWKV's recurrence in chunks of L tokens: intra-chunk
interactions are dense einsums whose decay exponents are all ≤ 0
(numerically stable by construction), and a [B, H, C, C] state is carried
between chunks. A decode step is the same code at T = 1. Mamba-lite's scan
runs step by step and projects the state down inside the loop, so the
[B, S, d_inner, N] states are never built outside the analysis. The
reference's ``lax.scan`` bodies are Python loops over chunks or steps here,
each body in the reference's operation order.

Under CAA analysis (``bk.is_analysis``) the recurrences are bounded through
``bk.ssm_scan``, the geometric fixpoint rule
(:func:`repro_torch.core.caa.scan_affine_fixpoint`): the data-dependent
decay w = exp(-exp(·)) ∈ (0, 1) contracts, so the error grows like
1/(1 − w̄), not linearly in T.

Parameters: ``*_shapes`` give one block's shapes and :func:`init_leaf` one
leaf's values, with the reference's distributions.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.models import layers as L

LORA_RANK = 64      # RWKV6's decay LoRA rank (the reference's default)
CLIP = 60.0         # decay exponents are clipped to [-CLIP, 0]


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

def rwkv_tmix_shapes(d: int, n_heads: int, lora_rank: int = LORA_RANK):
    """One RWKV6 time-mix block (the reference's ``init_rwkv_tmix``)."""
    shapes = {f"mu_{c}": (d,) for c in "rkvwg"}
    shapes.update({w: (d, d) for w in ("wr", "wk", "wv", "wg", "wo")})
    shapes.update(w0=(d,), wA=(d, lora_rank), wB=(lora_rank, d),
                  u=(n_heads, d // n_heads), ln_out=(d,))
    return shapes


def rwkv_cmix_shapes(d: int, d_ff: int):
    """One RWKV channel-mix block (the reference's ``init_rwkv_cmix``)."""
    return {"mu_k": (d,), "mu_r": (d,), "wk": (d, d_ff), "wv": (d_ff, d),
            "wr": (d, d)}


def mamba_shapes(d: int, d_inner: int, d_state: int = 16):
    """One Mamba-lite block (the reference's ``init_mamba``)."""
    return {"w_in": (d, d_inner), "w_gate": (d, d_inner),
            "w_B": (d_inner, d_state), "w_C": (d_inner, d_state),
            "w_dt": (d_inner, 1), "A_log": (d_state,), "D": (d_inner,),
            "w_out": (d_inner, d)}


def init_leaf(name: str, shape, *, generator: torch.Generator, device,
              layer_slice: bool = False):
    """One leaf of a ``tmix``, ``cmix`` or ``mamba`` block (any leading
    ``[L]`` axis), filled in place on ``device`` from ``generator`` (which
    must live there), with the reference's distributions: the token-shift
    mixes ``mu_*`` 0.5, ``w0`` −0.6, ``ln_out`` and ``D`` ones, ``A_log``
    log(1..N), ``u`` N(0, 0.3²), ``wB`` N(0, 0.01²), ``w_dt`` N(0, 0.1²)
    and every other dense weight N(0, 1/fan_in). ``layer_slice``: one
    layer's slice ``shape[1:]`` of the stacked leaf ``shape``."""
    t = torch.empty(shape[1:] if layer_slice else shape,
                    dtype=torch.float32, device=device)
    if name.startswith("mu_"):
        return t.fill_(0.5)
    if name == "w0":
        return t.fill_(-0.6)
    if name in ("ln_out", "D"):
        return t.fill_(1.0)
    if name == "A_log":
        n = shape[-1]
        return t.copy_(torch.log(torch.linspace(1.0, n, n, device=device)))
    std = {"u": 0.3, "wB": 0.01, "w_dt": 0.1}.get(
        name, 1.0 / math.sqrt(shape[-2]))
    return t.normal_(0.0, std, generator=generator)


# --------------------------------------------------------------------------
# RWKV6 time mix
# --------------------------------------------------------------------------

class RwkvState(NamedTuple):
    S: torch.Tensor        # [B, H, C, C] wkv state
    x_prev: torch.Tensor   # [B, d] last token (for token shift)


def _token_shift(bk, x, mu, x_prev=None):
    """lerp(x, shift(x, 1), mu): RWKV's 1-token lookback (exact gather)."""
    xv = bk.value_of(x)
    if x_prev is None:
        first = torch.zeros_like(xv[:, :1])
    else:
        first = x_prev.to(xv.dtype)[:, None, :]
    prev = bk.input(torch.cat([first, xv[:, :-1]], dim=1))
    m = bk.param(mu)
    return bk.add(bk.mul(x, m), bk.mul(prev, bk.shift(bk.neg(m), 1.0)))


def rwkv_tmix(bk, x, p, *, n_heads: int, chunk: int = 32,
              state: Optional[RwkvState] = None):
    """x: [B,S,d] → ([B,S,d], new_state). S=1 with state = decode step."""
    B, S, d = bk.shape_of(x)
    C = d // n_heads
    xp = state.x_prev if state is not None else None

    xr = _token_shift(bk, x, p["mu_r"], xp)
    xk = _token_shift(bk, x, p["mu_k"], xp)
    xv = _token_shift(bk, x, p["mu_v"], xp)
    xw = _token_shift(bk, x, p["mu_w"], xp)
    xg = _token_shift(bk, x, p["mu_g"], xp)

    r = bk.matmul(xr, bk.param(p["wr"]))
    k = bk.matmul(xk, bk.param(p["wk"]))
    v = bk.matmul(xv, bk.param(p["wv"]))
    g = bk.silu(bk.matmul(xg, bk.param(p["wg"])))

    # data-dependent decay (the Finch feature): w ∈ (0,1) per channel
    dw = bk.matmul(bk.tanh(bk.matmul(xw, bk.param(p["wA"]))),
                   bk.param(p["wB"]))
    w_log = bk.neg(bk.exp(bk.add(bk.param(p["w0"]), dw)))   # = log w (≤ 0)

    hsplit = lambda t: bk.reshape(t, (B, S, n_heads, C))
    r, k, v = hsplit(r), hsplit(k), hsplit(v)
    w_log = hsplit(w_log)
    u = bk.param(p["u"])

    if bk.is_analysis:
        out, new_S = _wkv_analysis(bk, r, k, v, w_log, u)
    else:
        out, new_S = _wkv_chunked(bk, r, k, v, w_log, u, chunk=chunk,
                                  S0=None if state is None else state.S)
    out = bk.reshape(out, (B, S, d))
    out = L.rmsnorm(bk, out, p["ln_out"])
    out = bk.mul(out, g)
    out = bk.matmul(out, bk.param(p["wo"]))
    xv_last = bk.value_of(x)[:, -1, :]
    return out, RwkvState(new_S, xv_last)


def _wkv_chunked(bk, r, k, v, w_log, u, *, chunk: int, S0=None):
    """Chunked WKV on plain tensors. All decay exponents ≤ 0 → stable.
    Returns (out [B, T, H, C], final state [B, H, C, C])."""
    r, k, v, w_log, u = map(bk.value_of, (r, k, v, w_log, u))
    B, T, H, C = r.shape
    Lc = min(chunk, T)
    n_chunks = (T + Lc - 1) // Lc
    pad = n_chunks * Lc - T
    if pad:
        zp = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
        r, k, v, w_log = zp(r), zp(k), zp(v), zp(w_log)  # w_log pads by 0
    chunks = lambda t: t.reshape(B, n_chunks, Lc, H, C)
    rs, ks, vs, ws = map(chunks, (r, k, v, w_log))

    S = (torch.zeros((B, H, C, C), dtype=r.dtype, device=r.device)
         if S0 is None else S0.to(r.dtype))
    causal = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool,
                                   device=r.device), diagonal=-1)  # i > j
    outs = []
    for n in range(n_chunks):
        rc, kc, vc, wc = rs[:, n], ks[:, n], vs[:, n], ws[:, n]  # [B,Lc,H,C]
        la = torch.cumsum(wc, dim=1)          # inclusive cumulative log-decay
        la_shift = la - wc                     # la_{i-1} (0 for i=0)
        # inter-chunk: r_i decayed from chunk start × carried state
        rdec = rc * torch.exp(la_shift)
        out = torch.einsum("blhc,bhcv->blhv", rdec, S)
        # intra-chunk: pairwise decay factors exp(la_{i-1} - la_j), i > j
        Dexp = torch.exp(torch.clamp(la_shift[:, :, None] - la[:, None, :],
                                     -CLIP, 0.0))  # [B,Lc(i),Lc(j),H,C]
        kD = kc[:, None, :, :, :] * Dexp
        scores = torch.einsum("bihc,bijhc->bijh", rc, kD)
        scores = scores * causal[None, :, :, None]
        out = out + torch.einsum("bijh,bjhv->bihv", scores, vc)
        # current-token bonus u
        diag = torch.einsum("bihc,bihc->bih", rc, u[None, None] * kc)
        out = out + diag[..., None] * vc
        # state update: S' = exp(la_L)⊙S + Σ_j exp(la_L - la_j) k_j ⊗ v_j
        dec_all = torch.exp(la[:, -1])                            # [B,H,C]
        kdec = kc * torch.exp(torch.clamp(la[:, -1][:, None] - la,
                                          -CLIP, 0.0))
        S = dec_all[..., None] * S + torch.einsum("bjhc,bjhv->bhcv",
                                                  kdec, vc)
        outs.append(out)
    out = torch.stack(outs, dim=1).reshape(B, n_chunks * Lc, H, C)
    if pad:
        out = out[:, :T]
    return out, S


def _wkv_analysis(bk, r, k, v, w_log, u):
    """CAA path: bound the recurrence by the geometric fixpoint rule."""
    B, S, H, C = bk.shape_of(r)
    w = bk.exp(w_log)                                # decay ∈ (0,1)
    drive = bk.mul(bk.reshape(k, (B, S, H, C, 1)),
                   bk.reshape(v, (B, S, H, 1, C)))
    states = bk.ssm_scan(bk.reshape(w, (B, S, H, C, 1)), drive, S,
                         time_axis=1)
    out = bk.einsum("bshc,bshcv->bshv", r, states)
    bonus = bk.mul(bk.mul(r, bk.broadcast_to(u, (B, S, H, C))), k)
    out = bk.add(out, bk.mul(bk.sum(bonus, dim=-1, keepdim=True), v))
    S_fin = torch.zeros((B, H, C, C), dtype=torch.float64,
                        device=bk.value_of(r).device)
    return out, S_fin


# --------------------------------------------------------------------------
# RWKV channel mix
# --------------------------------------------------------------------------

def rwkv_cmix(bk, x, p, x_prev=None):
    xk = _token_shift(bk, x, p["mu_k"], x_prev)
    xr = _token_shift(bk, x, p["mu_r"], x_prev)
    k = bk.relu(bk.matmul(xk, bk.param(p["wk"])))
    k = bk.square(k)
    kv = bk.matmul(k, bk.param(p["wv"]))
    return bk.mul(bk.sigmoid(bk.matmul(xr, bk.param(p["wr"]))), kv)


# --------------------------------------------------------------------------
# Mamba-lite (Hymba's SSM heads)
# --------------------------------------------------------------------------

def mamba_lite(bk, x, p, *, d_state: int = 16,
               h0: Optional[torch.Tensor] = None,
               return_state: bool = False):
    """Selective-SSM head (simplified): per-channel state of size d_state.

    x: [B,S,d] → y [B,S,d] (or (y, h_last [B,din,N]) if return_state)."""
    B, S, d = bk.shape_of(x)
    xin = bk.matmul(x, bk.param(p["w_in"]))              # [B,S,din]
    gate = bk.silu(bk.matmul(x, bk.param(p["w_gate"])))
    din = bk.shape_of(xin)[-1]

    # data-dependent dt > 0, per token/channel (softplus via exp/log)
    dt_raw = bk.matmul(xin, bk.param(p["w_dt"]))         # [B,S,1]
    dt = bk.log(bk.shift(bk.exp(dt_raw), 1.0))           # softplus
    Bm = bk.matmul(xin, bk.param(p["w_B"]))              # [B,S,N]
    Cm = bk.matmul(xin, bk.param(p["w_C"]))              # [B,S,N]

    # decay = exp(-dt·exp(A_log)) ∈ (0,1):   [B,S,1,N]
    A = bk.exp(bk.param(p["A_log"]))
    neg_dtA = bk.neg(bk.mul(bk.reshape(dt, (B, S, 1, 1)),
                            bk.reshape(A, (1, 1, 1, d_state))))
    decay = bk.exp(neg_dtA)
    # drive = dt · x ⊗ B:                    [B,S,din,N]
    drive = bk.mul(bk.reshape(bk.mul(xin, dt), (B, S, din, 1)),
                   bk.reshape(Bm, (B, S, 1, d_state)))

    if bk.is_analysis:
        hs = bk.ssm_scan(decay, drive, S, time_axis=1)   # [B,S,din,N]
        y = bk.einsum("bsdn,bsn->bsd", hs, Cm)
        h_fin = torch.zeros((B, din, d_state), dtype=torch.float64,
                            device=bk.value_of(xin).device)
    else:
        y, h_fin = _mamba_scan_project(bk.value_of(decay),
                                       bk.value_of(drive), bk.value_of(Cm),
                                       h0)
        y = bk.input(y)
    y = bk.add(y, bk.mul(xin, bk.param(p["D"])))
    y = bk.mul(y, gate)
    out = bk.matmul(y, bk.param(p["w_out"]))
    return (out, h_fin) if return_state else out


def _mamba_scan_project(decay, drive, C, h0=None):
    """Scan that projects the state down inside the loop (never
    materialises [B,S,din,N]). Returns (y [B,S,din], h_last [B,din,N])."""
    B, S, din, N = drive.shape
    h = (torch.zeros((B, din, N), dtype=drive.dtype, device=drive.device)
         if h0 is None else h0.to(drive.dtype))
    ys = []
    for t in range(S):
        h = decay[:, t] * h + drive[:, t]                # [B,din,N]
        ys.append(torch.einsum("bdn,bn->bd", h, C[:, t]))
    return torch.stack(ys, dim=1), h
