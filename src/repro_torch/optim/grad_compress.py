"""Gradient compression with error feedback — the counterpart of the JAX
package's ``repro.optim.grad_compress``.

Int8 gradient payloads cut the data-parallel all-reduce's bytes 4×; error
feedback keeps convergence: the residual g − dequant(quant(g)) is carried
and added to the next step's gradient (EF-SGD). ``compress_tree`` is the
collective-free codec: the gradients it returns are exactly what a
receiving worker reconstructs, so training with them is training under
compressed communication. ``compressed_psum_grads`` is the all-reduce
itself over a mesh's data-parallel axes: int8 payloads summed as int32.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.optim.optimizer import tree_map


#: values a quantisation block of the flattened leaf (one f32 scale each)
BLOCK = 256


class EFState(NamedTuple):
    residual: Any   # same tree as the gradients


def init_ef(grads_like) -> EFState:
    return EFState(tree_map(
        lambda g: torch.zeros_like(g, dtype=torch.float32), grads_like))


def _quant_int8(x: torch.Tensor, block: int = BLOCK):
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant_int8(q, scale, shape, block: int = BLOCK):
    flat = (q.to(torch.float32) * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


def compress_leaf(g, r, block: int = BLOCK):
    """One leaf's error-feedback int8 round trip: (decompressed gradient,
    new residual) of gradient ``g`` and residual ``r``."""
    x = g.to(torch.float32) + r
    q, s = _quant_int8(x, block)
    d = _dequant_int8(q, s, g.shape, block)
    return d, x - d


def compress_tree(grads, ef: EFState,
                  block: int = BLOCK) -> Tuple[Any, EFState]:
    """Error-feedback int8 round trip: returns (decompressed grads, new
    EF state)."""
    pairs = tree_map(lambda g, r: compress_leaf(g, r, block), grads,
                     ef.residual)                 # (d, residual) leaves
    return (tree_map(lambda t: t[0], pairs),
            EFState(tree_map(lambda t: t[1], pairs)))


def compressed_psum_grads(local_grads, mesh, dp_axes=("data",),
                          block: int = BLOCK):
    """The data-parallel all-reduce with int8 payloads, on ``mesh`` (a
    DeviceMesh): each rank quantises its own gradient leaf, the int8
    payloads are summed as int32 over ``dp_axes`` (the wire format), the
    scales are summed too (a conservative bound), and both are divided by
    the rank count before the dequantisation — the reference's formula,
    with each rank passing its own gradients. The scales are gathered and
    added in rank order, so every rank gets the same bits in every run
    (an all-reduce may add them in any order). Axes of size 1 add nothing:
    on one rank a leaf makes the int8 round trip."""
    import torch.distributed as dist

    groups = [mesh.get_group(a) for a in dp_axes
              if a in mesh.mesh_dim_names
              and mesh.shape[mesh.mesh_dim_names.index(a)] > 1]
    n = 1
    for g in groups:
        n *= dist.get_world_size(g)

    def reduce_one(g):
        q, s = _quant_int8(g.to(torch.float32), block)
        qs, ss = q.to(torch.int32), s.clone()
        for group in groups:
            dist.all_reduce(qs, group=group)
            parts = [torch.empty_like(ss)
                     for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, ss, group=group)
            ss = parts[0]
            for part in parts[1:]:
                ss = ss + part
        n_t = torch.tensor(float(n), dtype=torch.float32, device=g.device)
        return _dequant_int8(qs.to(torch.float32) / n_t, ss / n_t, g.shape,
                             block)

    return tree_map(reduce_one, local_grads)
