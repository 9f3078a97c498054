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

The third, ``ep_shard_map`` — expert parallelism on a mesh whose
"model" axis divides the experts (the backend's ``mesh``, a DeviceMesh):
tokens are split over the data-parallel axes and the same on every
"model" rank; each rank routes them with the full router, runs its E/m
local experts with the reference's capacity and chunking, and one
all-reduce over "model" combines the ranks' partial outputs.

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
    """x: [B, S, d] → [B, S, d]. ``mode`` None: ``dense`` under analysis;
    ``ep_shard_map`` where the backend's mesh has a "model" axis > 1 that
    divides ``n_experts``; ``dropping`` otherwise (the reference's
    choice)."""
    if mode is None:
        if bk.is_analysis:
            mode = "dense"
        elif _ep_mesh(bk, n_experts) is not None:
            mode = "ep_shard_map"
        else:
            mode = "dropping"
    if mode == "ep_shard_map":
        return bk.input(_ep_experts(bk, bk.value_of(x), p, n_experts, top_k,
                                    capacity_factor, chunk_tokens))
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


def _ep_mesh(bk, n_experts: int):
    """The backend's mesh when its "model" axis (> 1) divides the experts,
    else None."""
    mesh = getattr(bk, "mesh", None)
    names = getattr(mesh, "mesh_dim_names", None) or ()
    if "model" not in names:
        return None
    m = mesh.shape[names.index("model")]
    return mesh if m > 1 and n_experts % m == 0 else None


def _local_experts(w, rank: int, e_loc: int):
    """This "model" rank's experts [e_loc, ...] of an expert weight (a
    DTensor split on its expert dim over "model", or any whole one)."""
    from repro_torch.core.backend import _is_dtensor, _whole

    if _is_dtensor(w):
        mesh = w.device_mesh
        split = [(mesh.mesh_dim_names[i], pl.dim)
                 for i, pl in enumerate(w.placements)
                 if pl.is_shard() and mesh.shape[i] > 1]
        if split == [("model", 0)]:
            return w.to_local()
        w = _whole(w)
    return w[rank * e_loc:(rank + 1) * e_loc]


def _ep_experts(bk, x, p, n_experts, top_k, capacity_factor, chunk_tokens):
    """Expert parallelism over the mesh's "model" axis, as the reference's
    ``shard_map`` body computes it on each rank: ``x`` [B_loc, S, d] is
    this data-parallel rank's block (the same on every "model" rank); the
    router is the full f32 product and softmax; the rank keeps its experts
    [r·E/m, (r+1)·E/m), takes at most C = max(1, int(Tc·top_k/E·cf)) tokens
    an expert in each chunk of Tc tokens, in token order, runs SiLU-gated
    experts (the reference's body applies SiLU whatever the config's act)
    and weights their outputs by the gates; one all-reduce over "model"
    sums the ranks' partial outputs."""
    import torch.distributed as dist
    from repro_torch.core.backend import _whole

    mesh = getattr(bk, "mesh", None)
    names = getattr(mesh, "mesh_dim_names", None) or ()
    if "model" not in names or n_experts % mesh.shape[
            names.index("model")]:
        raise ValueError("ep_shard_map needs a backend on a mesh whose "
                         f"'model' axis divides the {n_experts} experts")
    m = mesh.shape[names.index("model")]
    rank = mesh.get_coordinate()[names.index("model")]
    e_loc = n_experts // m
    B, S, d = x.shape
    wr = _whole(p["w_router"]).to(torch.float32)
    wg, wu, wd = (_local_experts(p[k], rank, e_loc).to(torch.float32)
                  for k in ("w_gate", "w_up", "w_down"))
    xt = x.reshape(B * S, d).to(torch.float32)
    probs = torch.softmax(xt @ wr, dim=-1)
    _, idx = torch.topk(probs, top_k)
    mask = F.one_hot(idx, n_experts).to(xt.dtype).sum(-2)
    gates = probs * mask
    gates = gates / gates.sum(-1, keepdim=True)
    lo = rank * e_loc
    gsel, msel = gates[:, lo:lo + e_loc], mask[:, lo:lo + e_loc]
    T = xt.shape[0]
    Tc = min(chunk_tokens, T)
    n_chunks = -(-T // Tc)
    C = max(1, int(Tc * top_k / n_experts * capacity_factor))
    pad = n_chunks * Tc - T
    if pad:
        xt, gsel, msel = (F.pad(t, (0, 0, 0, pad)) for t in (xt, gsel, msel))
    tok = torch.arange(Tc, device=xt.device)[:, None].expand(Tc, e_loc)
    slot0 = (torch.arange(e_loc, device=xt.device) * C)[None, :]
    out = []
    for i in range(n_chunks):
        xc, gc, mc = (t[i * Tc:(i + 1) * Tc] for t in (xt, gsel, msel))
        sel = mc > 0
        pos = torch.cumsum(sel.to(torch.int32), dim=0) * sel - 1
        keep = sel & (pos < C)
        slot = torch.where(keep, slot0 + pos, e_loc * C)
        src = torch.full((e_loc * C + 1,), Tc, dtype=torch.int64,
                         device=xt.device)
        src.scatter_(0, slot.reshape(-1), tok.reshape(-1))
        rows = torch.cat([xc, xc.new_zeros(1, d)])
        xe = rows[src[:e_loc * C]].reshape(e_loc, C, d)
        h = F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu)
        ye = torch.bmm(h, wd).reshape(e_loc * C, d)
        yg = ye[torch.where(keep, slot0 + pos, 0)]
        w = torch.where(keep, gc, 0.0)
        out.append((w[:, :, None] * yg).sum(dim=1))
    y = torch.cat(out)[:T]
    if m > 1:
        dist.all_reduce(y, group=mesh.get_group("model"))
    return y.reshape(B, S, d)


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
