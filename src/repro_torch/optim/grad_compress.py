"""Gradient compression with error feedback — the counterpart of the JAX
package's ``repro.optim.grad_compress``.

Int8 gradient payloads cut the data-parallel all-reduce's bytes 4×; error
feedback keeps convergence: the residual g − dequant(quant(g)) is carried
and added to the next step's gradient (EF-SGD). ``compress_tree`` is the
collective-free codec: the gradients it returns are exactly what a
receiving worker reconstructs, so training with them is training under
compressed communication. The all-reduce itself
(``compressed_psum_grads``) needs a data-parallel mesh and waits for the
port's ``launch/mesh.py`` and ``parallel/``.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.optim.optimizer import tree_map


class EFState(NamedTuple):
    residual: Any   # same tree as the gradients


def init_ef(grads_like) -> EFState:
    return EFState(tree_map(
        lambda g: torch.zeros_like(g, dtype=torch.float32), grads_like))


def _quant_int8(x: torch.Tensor, block: int = 256):
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant_int8(q, scale, shape, block: int = 256):
    flat = (q.to(torch.float32) * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


def compress_tree(grads, ef: EFState,
                  block: int = 256) -> Tuple[Any, EFState]:
    """Error-feedback int8 round trip: returns (decompressed grads, new
    EF state)."""
    def one(g, r):
        x = g.to(torch.float32) + r
        q, s = _quant_int8(x, block)
        d = _dequant_int8(q, s, g.shape, block)
        return d, x - d

    pairs = tree_map(one, grads, ef.residual)     # (d, residual) leaves
    return (tree_map(lambda t: t[0], pairs),
            EFState(tree_map(lambda t: t[1], pairs)))


def compressed_psum_grads(local_grads, mesh, dp_axes=("data",),
                          block: int = 256):
    """The data-parallel all-reduce with int8 payloads. Not ported yet: it
    needs a device mesh (``launch/mesh.py`` and ``parallel/``, the port's
    next slice)."""
    raise NotImplementedError(
        "compressed_psum_grads needs a data-parallel mesh: it waits for the "
        "mesh slice of repro_torch (launch/mesh.py, parallel/sharding.py)")
