"""Sharding rules: map every tensor of the system onto the mesh — the
counterpart of the JAX package's ``repro.parallel.sharding``.

Each rule is a pure function of shapes and a mesh *shape* (axis names and
sizes: a ``DeviceMesh``, a ``{name: size}`` mapping or a JAX-style mesh;
:func:`repro_torch.launch.mesh.mesh_shape`) and returns a spec: a tuple with
one entry per tensor dim, None (not split), an axis name, or a tuple of
axis names — the reference's ``PartitionSpec`` as a tuple. The tree rules
return trees of specs. :func:`placements` turns a spec into DTensor
``Shard`` / ``Replicate`` placements on a ``DeviceMesh``, and :func:`place`
makes the DTensors from full tensors every rank holds.

Strategy (hybrid FSDP × TP × EP):
  * parameters: greedy largest-divisible-dims assignment — "model" goes to
    the biggest dim, "data" (and "pod") to the next: fully-sharded storage;
  * activations/batch: batch over ("pod", "data"); the sequence dim takes
    the axes the batch cannot absorb;
  * KV caches: batch over "data" when divisible else sequence; KV heads
    over "model" when divisible else sequence over "model".

The serving rules (:func:`serving_param_spec` and after) are the
bitwise-safe subset: column parallelism (each weight's OUTPUT dim over
"model") and lanes over "data", so every collective is a gather of exact
values and no reduction is split.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from repro_torch.launch.mesh import mesh_shape

Spec = tuple


def _axis_size(mesh, name: str) -> int:
    return mesh_shape(mesh).get(name, 1)


def _shape_of(leaf) -> tuple:
    if hasattr(leaf, "shape"):
        return tuple(int(s) for s in leaf.shape)
    if isinstance(leaf, (tuple, list)) and all(
            isinstance(s, int) for s in leaf):
        return tuple(leaf)
    return ()


def map_with_path(fn: Callable, tree, path=()):
    """``fn(path_keys, leaf)`` over a tree of nested dicts; a shape tuple
    or a tensor is a leaf."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(list(path), tree)


# -- the greedy rules --------------------------------------------------------

def _greedy_param_spec(shape, mesh, *, stacked: bool,
                       min_shard_bytes: int = 1 << 20, axes=None) -> Spec:
    """Assign mesh axes to tensor dims, biggest first. ``stacked``: the
    leading layer dim is never split. Tensors under ``min_shard_bytes``
    replicate. ``axes`` restricts the mesh axes used."""
    dims = list(shape)
    start = 1 if stacked and len(dims) > 1 else 0
    nbytes = math.prod(shape) * 4
    spec = [None] * len(dims)
    if nbytes < min_shard_bytes:
        return tuple(spec)
    order = sorted(range(start, len(dims)), key=lambda i: -dims[i])
    cand = axes if axes is not None else ("model", "data", "pod")
    for ax in [a for a in cand if _axis_size(mesh, a) > 1]:
        sz = _axis_size(mesh, ax)
        for i in order:
            if spec[i] is None and dims[i] % sz == 0 and dims[i] >= sz:
                spec[i] = ax
                break
    return tuple(spec)


def shard_params(params, mesh, *, model_only: bool = False):
    """Spec tree for a parameter tree. ``model_only`` keeps parameters on
    the "model" axis and replicated over data/pod (the serving policy: no
    per-step gathers over the data axis)."""
    def one(keys, leaf):
        shape = _shape_of(leaf)
        stacked = any(k in ("layers", "enc_layers", "cross") for k in keys)
        # expert weights: the expert dim over "model" (the ep_shard_map
        # path's layout), the next biggest dim over "data" unless model_only
        if "moe" in keys and keys[-1] in ("w_gate", "w_up", "w_down"):
            e_dim = 1 if stacked else 0
            m_sz = _axis_size(mesh, "model")
            if len(shape) > e_dim and shape[e_dim] % m_sz == 0 and m_sz > 1:
                spec = [None] * len(shape)
                spec[e_dim] = "model"
                if not model_only:
                    d_sz = _axis_size(mesh, "data")
                    for i in sorted(range(e_dim + 1, len(shape)),
                                    key=lambda i: -shape[i]):
                        if shape[i] % d_sz == 0 and d_sz > 1:
                            spec[i] = "data"
                            break
                return tuple(spec)
        return _greedy_param_spec(shape, mesh, stacked=stacked,
                                  axes=("model",) if model_only else None)

    return map_with_path(one, params)


def batch_spec(mesh, batch: int, seq: int) -> Spec:
    """[B, S] token batches: the batch over every DP axis that divides it;
    an axis it cannot absorb moves to the sequence dim."""
    dp = [a for a in ("pod", "data") if _axis_size(mesh, a) > 1]
    b_use, s_use = [], []
    rem_b, rem_s = batch, seq
    for a in dp:
        sz = _axis_size(mesh, a)
        if rem_b % sz == 0 and rem_b >= sz:
            b_use.append(a)
            rem_b //= sz
        elif rem_s % sz == 0 and rem_s >= sz:
            s_use.append(a)
            rem_s //= sz
    return (_entry(b_use), _entry(s_use))


def _entry(axes):
    """A spec entry as ``PartitionSpec`` normalises it: None for no axis,
    the name for one, a tuple for several."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def shard_batch(mesh, batch: int, seq: int) -> Spec:
    return batch_spec(mesh, batch, seq)


def cache_spec(mesh, cache_leaf_shape, kind: str) -> Spec:
    """Decode caches, stacked [L, B, Smax, ...]: gqa k/v [L, B, S, K, Dh];
    mla [L, B, S, R]; rwkv S [L, B, H, C, C]."""
    shape = list(cache_leaf_shape)
    spec = [None] * len(shape)
    if len(shape) < 3:
        return tuple(spec)
    d_sz = _axis_size(mesh, "data")
    m_sz = _axis_size(mesh, "model")
    B = shape[1]
    if B % d_sz == 0 and B >= d_sz:
        spec[1] = "data"
        seq_data = False
    else:
        seq_data = True
    if kind == "gqa":
        S, K = shape[2], shape[3]
        if K % m_sz == 0 and K >= m_sz:
            spec[3] = "model"
            if seq_data and S % d_sz == 0:
                spec[2] = "data"
        elif S % (m_sz * (d_sz if seq_data else 1)) == 0:
            spec[2] = ("data", "model") if seq_data else "model"
        elif S % m_sz == 0:
            spec[2] = "model"
    elif kind == "mla":
        S = shape[2]
        div = m_sz * (d_sz if seq_data else 1)
        if S % div == 0:
            spec[2] = ("data", "model") if seq_data else "model"
        elif S % m_sz == 0:
            spec[2] = "model"
    elif kind == "rwkv":
        if len(shape) >= 4 and shape[2] % m_sz == 0:
            spec[2] = "model"
        elif len(shape) == 3 and shape[2] % m_sz == 0:
            spec[2] = "model"
    return tuple(spec)


def shard_cache(cache, mesh, cfg) -> Dict[str, Spec]:
    def one(keys, leaf):
        key = keys[-1]
        if key in ("k", "v"):
            kind = "mla" if getattr(cfg, "mla", False) else "gqa"
        elif key in ("S", "h_ssm"):
            kind = "rwkv"
        else:
            return ()
        return cache_spec(mesh, _shape_of(leaf), kind)

    return map_with_path(one, cache)


def replicated(mesh) -> Spec:
    return ()


# -- serving (bitwise-safe) rules --------------------------------------------
#
# The engine holds a lane's tokens and logits bit for bit to the request
# served alone, which outlaws any split of a reduction (partial sums
# reassociate the accumulation): no contraction-dim weight split, no
# sequence-over-"model" cache (the distributed softmax), no split batched
# contraction. What remains is column parallelism (each weight's OUTPUT dim
# over "model") and lane parallelism (lanes over "data"): every collective
# is then a gather of exact values.

def serving_param_spec(path_keys, shape, mesh, *,
                       min_shard_bytes: int = 1 << 16) -> Spec:
    """Column-parallel spec for one serving parameter: ``embed`` / ``head``
    tables [vocab, d] split the vocab dim; every other ≥2-D weight its LAST
    dim (the product's output dim, never the contraction); a stacked
    tensor's layer dim is skipped; 1-D tensors replicate."""
    m_sz = _axis_size(mesh, "model")
    spec = [None] * len(shape)
    nbytes = math.prod(shape) * 4 if shape else 0
    if m_sz <= 1 or len(shape) < 2 or nbytes < min_shard_bytes:
        return tuple(spec)
    stacked = any(k in ("layers", "enc_layers", "cross") for k in path_keys)
    if path_keys and path_keys[-1] in ("embed", "head"):
        dim = 1 if stacked else 0
    else:
        dim = len(shape) - 1
    if shape[dim] % m_sz == 0 and shape[dim] >= m_sz:
        spec[dim] = "model"
    return tuple(spec)


def shard_params_serving(params, mesh, *, min_shard_bytes: int = 1 << 16):
    """Spec tree under the bitwise-safe serving rules."""
    return map_with_path(
        lambda keys, leaf: serving_param_spec(
            keys, _shape_of(leaf), mesh, min_shard_bytes=min_shard_bytes),
        params)


def lane_cache_spec(mesh, leaf_shape, key: str) -> Spec:
    """Per-lane cache spec, stacked [L, B, Smax, ...]: lanes over "data"
    when divisible, KV heads over "model" when divisible, never the
    sequence dim."""
    shape = list(leaf_shape)
    spec = [None] * len(shape)
    if len(shape) < 2:
        return tuple(spec)
    d_sz = _axis_size(mesh, "data")
    m_sz = _axis_size(mesh, "model")
    B = shape[1]
    if d_sz > 1 and B % d_sz == 0 and B >= d_sz:
        spec[1] = "data"
    if key in ("k", "v") and len(shape) == 5:       # gqa [L,B,S,K,Dh]
        K = shape[3]
        if m_sz > 1 and K % m_sz == 0 and K >= m_sz:
            spec[3] = "model"
    return tuple(spec)


def shard_cache_serving(cache, mesh) -> Dict[str, Spec]:
    return map_with_path(
        lambda keys, leaf: lane_cache_spec(mesh, _shape_of(leaf), keys[-1]),
        cache)


def lane_batch_sharding(mesh, n_lanes: int) -> Spec:
    """[B] / [B, 1] decode-lane vectors: lanes over "data" when
    divisible."""
    d_sz = _axis_size(mesh, "data")
    if d_sz > 1 and n_lanes % d_sz == 0 and n_lanes >= d_sz:
        return ("data",)
    return ()


# -- placements on a DeviceMesh ----------------------------------------------

def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(dim)`` on each
    mesh dim that splits tensor dim ``dim``, ``Replicate()`` on the rest."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec) if name in _axes(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def local_block(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` under ``spec`` (a view).
    A dim split over several axes is cut in the spec's axis order."""
    sizes = mesh_shape(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    out = t
    for d, entry in enumerate(spec):
        idx, n = 0, 1
        for ax in _axes(entry):
            idx, n = idx * sizes[ax] + coord[ax], n * sizes[ax]
        if n > 1:
            step = t.shape[d] // n
            out = out.narrow(d, idx * step, step)
    return out


def place_one(t: torch.Tensor, spec: Spec, mesh):
    """The DTensor of a full tensor ``t`` (the same values on every rank)
    under ``spec``: this rank keeps its block (``t`` itself where the block
    is all of it, a contiguous copy where it is not)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local_block(t, spec, mesh).contiguous(), mesh,
                              placements(spec, mesh), run_check=False,
                              shape=t.shape, stride=t.stride())


def place(tree, specs, mesh):
    """:func:`place_one` over a tree of full tensors and its spec tree."""
    return map_with_path(
        lambda keys, t: place_one(t, _lookup(specs, keys), mesh), tree)


def _lookup(tree, keys: Sequence[str]):
    for k in keys:
        tree = tree[k]
    return tree


def full(t):
    """The whole tensor of a DTensor (gathered over its split axes; no
    collective where it is whole on every rank); other tensors as they
    are."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return t
    if all(p.is_replicate() or n == 1
           for p, n in zip(t.placements, t.device_mesh.shape)):
        return t.to_local()
    return t.full_tensor()


def local(tree):
    """This rank's blocks of a tree of DTensors (other leaves as they
    are)."""
    from torch.distributed.tensor import DTensor

    return map_with_path(
        lambda keys, t: t.to_local() if isinstance(t, DTensor) else t, tree)
