"""Mixture-of-Experts MLP (PyTorch): router + top-k dispatch, the
counterpart of the JAX package's ``repro.models.moe``.

Two of the reference's three execution modes:

* ``dense`` — every expert on every token, combined by the gates. Exact and
  backend-generic (CAA-analysable): the analysis path.
* ``dropping`` — capacity-bounded dispatch in token chunks: per chunk of
  Tc tokens each expert takes at most C = ceil(Tc·top_k/E·cf) tokens, in
  token order (the reference's cumsum over the chunk), and the rest are
  dropped (Switch semantics). The serving path. The reference dispatches
  and combines with one-hot einsums; here the same slots are filled by an
  index gather and read back by one, which selects the same values (a
  one-hot product is an exact select). The expert GEMMs are raw f32
  products outside every certified backend, as the reference's raw
  ``jnp.einsum`` are: ``torch.bmm``, unrounded.

The third, ``ep_shard_map`` (experts sharded over a mesh's "model" axis),
waits for the port's ``launch/mesh.py`` and ``parallel/``: asking for it
raises.

The router is ``bk.matmul``, so a certified serving backend rounds it like
every projection; its top-k is FP-dependent control flow, and under CAA
the route is fixed from the reference values and the decision margin
recorded (``CaaOps.top_k_mask``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

#: when a list, every ``dropping`` call appends the number of (token,
#: expert) assignments its capacity dropped (one host sync a call); None
#: (the default) counts nothing
drop_log: Optional[List[int]] = None

_ACT = {"silu": F.silu,
        "gelu": lambda a: F.gelu(a, approximate="tanh"),
        "relu": torch.relu}


def moe_shapes(d: int, d_ff: int, n_experts: int) -> Dict[str, tuple]:
    """Parameter shapes of one MoE block (the reference's ``init_moe``)."""
    return {"w_router": (d, n_experts),
            "w_gate": (n_experts, d, d_ff),
            "w_up": (n_experts, d, d_ff),
            "w_down": (n_experts, d_ff, d)}


def init_moe(d: int, d_ff: int, n_experts: int, *,
             generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Random parameters with the reference's distributions: N(0, 1/d) for
    the router, gate and up experts, N(0, 1/d_ff) for the down experts,
    filled in place on ``device`` from ``generator`` (which must live
    there)."""
    out = {}
    for name, shape in moe_shapes(d, d_ff, n_experts).items():
        t = torch.empty(shape, dtype=torch.float32, device=device)
        out[name] = t.normal_(0.0, 1.0 / math.sqrt(shape[-2]),
                              generator=generator)
    return out


def moe_mlp(bk, x, p, *, n_experts: int, top_k: int, act: str = "silu",
            capacity_factor: float = 1.25, chunk_tokens: int = 4096,
            mode: Optional[str] = None):
    """x: [B, S, d] → [B, S, d]. ``mode`` None: ``dense`` under analysis,
    ``dropping`` otherwise (the reference's single-device choice)."""
    if mode is None:
        mode = "dense" if bk.is_analysis else "dropping"
    if mode == "ep_shard_map":
        raise NotImplementedError(
            "ep_shard_map (expert parallelism over a mesh) is not ported to "
            "repro_torch: it waits for launch/mesh.py and parallel/")
    if mode not in ("dense", "dropping"):
        raise ValueError(f"unknown MoE mode {mode!r}")
    B, S, d = bk.shape_of(x)
    xt = bk.reshape(x, (B * S, d))
    logits = bk.matmul(xt, bk.param(p["w_router"]))
    probs = bk.softmax(logits, dim=-1)
    mask = bk.top_k_mask(probs, top_k)                      # [T,E] exact 0/1
    gates = bk.mul(probs, bk.input(mask) if bk.is_analysis else mask)
    denom = bk.sum(gates, dim=-1, keepdim=True)
    gates = bk.div(gates, denom)                            # renormalised

    if mode == "dense":
        y = _dense_experts(bk, xt, gates, p, act)
    else:
        y = bk.input(_dropping_experts(
            bk, xt, bk.value_of(gates), p, n_experts, top_k, act,
            capacity_factor, chunk_tokens))
    return bk.reshape(y, (B, S, d))


def _dense_experts(bk, xt, gates, p, act):
    """All experts on all tokens; gate-weighted combine. CAA-friendly."""
    h_g = bk.einsum("td,edf->tef", xt, bk.param(p["w_gate"]))
    h_u = bk.einsum("td,edf->tef", xt, bk.param(p["w_up"]))
    h = bk.mul(getattr(bk, act)(h_g), h_u)
    y_e = bk.einsum("tef,efd->ted", h, bk.param(p["w_down"]))
    return bk.einsum("ted,te->td", y_e, gates)


def capacity(tokens: int, top_k: int, n_experts: int,
             capacity_factor: float = 1.25) -> int:
    """The slots an expert has in a chunk of ``tokens`` tokens."""
    return max(1, math.ceil(tokens * top_k / n_experts * capacity_factor))


def _dropping_experts(bk, xt, gates, p, n_experts, top_k, act,
                      capacity_factor, chunk_tokens):
    """Capacity dispatch in token chunks (plain tensors, f32).

    Per chunk: token t routed to expert e (gate > 0) takes slot pos[t, e] =
    (the number of the chunk's tokens up to t routed to e) - 1, and is
    dropped if pos ≥ C. Slot (e, c) is then filled by a gather of its token
    (a zero row where no token took it), the experts run as batched f32
    products, and each token's output is Σ_e gate[t, e]·y[e, pos[t, e]]
    over its kept experts, in expert order."""
    xt = bk.value_of(xt)
    w_gate = bk.value_of(bk.param(p["w_gate"]))
    w_up = bk.value_of(bk.param(p["w_up"]))
    w_down = bk.value_of(bk.param(p["w_down"]))
    fn = _ACT[act]
    T, d = xt.shape
    E = n_experts
    Tc = min(chunk_tokens, T)
    n_chunks = -(-T // Tc)
    pad = n_chunks * Tc - T
    if pad:
        xt = F.pad(xt, (0, 0, 0, pad))
        gates = F.pad(gates, (0, 0, 0, pad))
    C = capacity(Tc, top_k, E, capacity_factor)
    dev = xt.device
    tok = torch.arange(Tc, device=dev)[:, None].expand(Tc, E)
    slot0 = (torch.arange(E, device=dev) * C)[None, :]
    dropped = []
    out = []
    for i in range(n_chunks):
        xc = xt[i * Tc:(i + 1) * Tc]                         # [Tc, d]
        gc = gates[i * Tc:(i + 1) * Tc]                      # [Tc, E]
        sel = gc > 0
        pos = torch.cumsum(sel.to(torch.int32), dim=0) * sel - 1
        keep = sel & (pos < C)
        # slot (e, c) ← its token; the dump slot E·C takes the rest
        slot = torch.where(keep, slot0 + pos, E * C)
        src = torch.full((E * C + 1,), Tc, dtype=torch.int64, device=dev)
        src.scatter_(0, slot.reshape(-1), tok.reshape(-1))
        rows = torch.cat([xc, xc.new_zeros(1, d)])           # row Tc: zero
        xe = rows[src[:E * C]].reshape(E, C, d)
        h = fn(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)
        ye = torch.bmm(h, w_down).reshape(E * C, d)
        yg = ye[torch.where(keep, slot0 + pos, 0)]           # [Tc, E, d]
        w = torch.where(keep, gc, 0.0)
        out.append((w[:, :, None] * yg).sum(dim=1))
        if drop_log is not None:
            dropped.append(sel.sum() - keep.sum())
    if dropped:
        drop_log.append(int(torch.stack(dropped).sum()))
    y = torch.cat(out)
    return y[:T] if pad else y


def aux_load_balance_loss(gates_probs: torch.Tensor, mask: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss."""
    density = mask.mean(dim=0)                 # fraction routed per expert
    router_prob = gates_probs.mean(dim=0)
    return n_experts * torch.sum(density * router_prob)
