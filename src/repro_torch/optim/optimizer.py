"""AdamW with optional 8-bit quantised moments (blockwise) — the
counterpart of the JAX package's ``repro.optim.optimizer``.

Plain functions on nested dicts of tensors (the reference's pytrees): the
same state (:class:`OptState`, the reference's field names), the same
schedule and the same per-element arithmetic in f32, op for op, so that on
the same gradients both packages take the same steps. The 8-bit mode packs
m and √v into int8 with one f32 scale a block of 128 (√v halves the
dynamic range int8 must span, so small second moments survive);
``torch.round`` rounds half to even, as ``jnp.round`` does.

``update(..., inplace=True)`` writes the new parameters and moments into
the tensors it was given, one leaf at a time (the reference's buffer
donation): the train step's peak memory is then one leaf's temporaries
above parameters, gradients and moments.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantized_moments: bool = False   # 8-bit blockwise m/v
    block: int = 128
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor  # int32 scalar: updates applied so far
    m: Any
    v: Any
    m_scale: Any        # per-block scales when quantized, else None
    v_scale: Any


# -- nested-dict trees --------------------------------------------------------

def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (``rest`` of the same
    structure), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_paths(tree, path=()):
    """(key path, leaf) pairs in the reference's order (dict keys
    sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], path + (k,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def tree_set(tree: Dict, path, value):
    """Put ``value`` at the key ``path`` of nested dicts, making them."""
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


# -- 8-bit blockwise codec ---------------------------------------------------

def _q8(x: torch.Tensor, block: int):
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dq8(q: torch.Tensor, scale: torch.Tensor, shape, block: int):
    flat = (q.to(torch.float32) * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


# -- init / update ------------------------------------------------------------

def init(params, cfg: AdamWConfig) -> OptState:
    dev = next(tree_paths(params))[1].device
    step = torch.zeros((), dtype=torch.int32, device=dev)

    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)

    if cfg.quantized_moments:
        def q(p):
            return _q8(zeros(p), cfg.block)[0]

        def s(p):
            return _q8(zeros(p), cfg.block)[1]

        return OptState(step, tree_map(q, params), tree_map(q, params),
                        tree_map(s, params), tree_map(s, params))
    return OptState(step, tree_map(zeros, params), tree_map(zeros, params),
                    None, None)


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_frac``; f32 as the
    reference computes it (``step`` an int or an int32 tensor)."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps).float()
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root, as XLA's. CUDA's ``sqrtf``
    is; PyTorch's CPU one is only faithful (one ulp off on some inputs),
    so on the CPU the root is taken in f64 and rounded once to f32: a
    faithful f64 root is closer to the exact one than any f32 rounding
    boundary of a root of an f32 number."""
    if x.is_cuda or x.dtype != torch.float32:
        return torch.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


#: the trees whose leaves are stacked over layers, [L, ...]
STACKS = ("layers", "enc_layers", "cross")


def is_stacked(path) -> bool:
    """Whether the leaf at key ``path`` is stacked over layers."""
    return any(k in STACKS for k in path)


def square_sum(t: torch.Tensor) -> torch.Tensor:
    """Σ t² in f32: one partial of :func:`global_norm`."""
    return torch.sum(torch.square(t.to(torch.float32)))


def partial_keys(tree):
    """(path, layer) of each partial of :func:`global_norm`, in the order
    they are added: the reference's leaf order, a stacked leaf one partial
    a layer (0, 1, ...), any other leaf one (None). A mesh step forms each
    partial from one layer's gradient while its backward holds it and adds
    them in this order, so both paths take the same norm."""
    for path, leaf in tree_paths(tree):
        if is_stacked(path):
            yield from ((path, i) for i in range(leaf.shape[0]))
        else:
            yield path, None


def norm_of_partials(partials) -> torch.Tensor:
    """√ of the partials added in the order given."""
    total = 0
    for part in partials:
        total = total + part
    return sqrt_rn(total)


def global_norm(tree) -> torch.Tensor:
    """The gradient tree's global norm, summed by :func:`partial_keys`."""
    def part(path, i):
        leaf = _get(tree, path)
        return square_sum(leaf if i is None else leaf[i])

    return norm_of_partials(part(*k) for k in partial_keys(tree))


def _adam_leaf(cfg, p, g, m, v, lr, bc1, bc2):
    """One leaf's moments and parameter, in the reference's op order."""
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * g * g
    u = (m / bc1) / (sqrt_rn(v / bc2) + cfg.eps)
    pf = p.to(torch.float32)
    newp = pf - lr * (u + cfg.weight_decay * pf)
    return newp.to(p.dtype), m, v


def step_scalars(step_count: torch.Tensor, cfg: AdamWConfig):
    """(step, lr, bc1, bc2) of the update after ``step_count`` updates: the
    new count and the schedule's scalars, computed on the host so that
    every device takes the same, then moved to the count's device."""
    step = step_count + 1
    stepf = step.cpu().to(torch.float32)
    lr, bc1, bc2 = (t.to(step.device) for t in (
        schedule(cfg, step.cpu()),
        1 - torch.pow(torch.tensor(cfg.b1), stepf),
        1 - torch.pow(torch.tensor(cfg.b2), stepf)))
    return step, lr, bc1, bc2


def clip_factor(grads, cfg: AdamWConfig) -> torch.Tensor:
    """The factor (≤ 1) that clips the gradient tree to ``grad_clip`` in
    global norm."""
    return clip_of_norm(global_norm(grads), cfg)


def clip_of_norm(gnorm: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """The clip factor of a gradient tree of global norm ``gnorm``."""
    return torch.clamp(
        torch.tensor(cfg.grad_clip, dtype=torch.float32,
                     device=gnorm.device) / (gnorm + 1e-9), max=1.0)


def update_leaf(cfg: AdamWConfig, p, g, m, v, ms, vs, lr, bc1, bc2):
    """One leaf's AdamW step on its clipped f32 gradient ``g``: a dict of
    the new "p", "m", "v" (and the 8-bit moments' scales "ms", "vs"; ``m``
    and ``v`` are then the payloads, ``ms`` and ``vs`` their scales)."""
    if not cfg.quantized_moments:
        newp, m, v = _adam_leaf(cfg, p, g, m, v, lr, bc1, bc2)
        return {"p": newp, "m": m, "v": v}
    m = _dq8(m, ms, p.shape, cfg.block)
    sv = _dq8(v, vs, p.shape, cfg.block)
    newp, m, v = _adam_leaf(cfg, p, g, m, sv * sv, lr, bc1, bc2)
    out = dict(zip(("p", "m", "ms"), (newp, *_q8(m, cfg.block))))
    out["v"], out["vs"] = _q8(sqrt_rn(v), cfg.block)
    return out


def update(params, grads, state: OptState, cfg: AdamWConfig,
           inplace: bool = False):
    """One AdamW step; returns (new_params, new_state). With ``inplace``
    the returned trees are ``params`` and ``state``'s own tensors, written
    leaf by leaf."""
    step, lr, bc1, bc2 = step_scalars(state.step, cfg)
    clip = clip_factor(grads, cfg)

    quant = cfg.quantized_moments
    trees = {"p": params, "m": state.m, "v": state.v, "ms": state.m_scale,
             "vs": state.v_scale}
    new = {name: {} for name in trees}
    for path, p in tree_paths(params):
        g = _get(grads, path).to(torch.float32) * clip
        out = update_leaf(cfg, p, g, *(
            None if trees[n] is None else _get(trees[n], path)
            for n in ("m", "v", "ms", "vs")), lr, bc1, bc2)
        for name, t in out.items():
            tree_set(new[name], path,
                 _get(trees[name], path).copy_(t) if inplace else t)
        del g, out
    if inplace:
        state.step.copy_(step)
        return params, state
    if quant:
        return new["p"], OptState(step, new["m"], new["v"], new["ms"],
                                  new["vs"])
    return new["p"], OptState(step, new["m"], new["v"], None, None)
