"""Arithmetic back-ends: one model definition, several executions (PyTorch).

The counterpart of the JAX package's ``repro.core.backend``. Every model in
:mod:`repro_torch.models` is written against :class:`Backend`;
:class:`TorchOps` executes it as plain PyTorch, and the certified serving
backends (:mod:`repro_torch.launch.serve`) override ``matmul`` and
``decode_attention`` to round into a certificate's formats.

PyTorch runs eagerly and has no ``lax.scan``, so ``layer_loop`` is the
Python loop of :class:`UnrolledLayerLoop`: it pushes a static ``layer{i}``
scope per layer, and every per-scope knob resolves by name — the same
resolution the JAX package's unrolled baseline performs and is bitwise
against.
"""
from __future__ import annotations

from typing import Callable, List

import torch
import torch.nn.functional as F


def _tree_index(tree, i):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_index(v, i) for k, v in tree.items()}
    return tree[i]


class Backend:
    """Interface models are written against (the subset the ported models
    use). Tracks the model's scope path: ``layer_loop`` pushes
    ``layer{i}``, models push named blocks ("embed", "attn", "mlp",
    "head"); serving backends resolve per-scope formats against it."""

    @property
    def scope_path(self) -> List[str]:
        sp = getattr(self, "_scope", None)
        if sp is None:
            sp = self._scope = []
        return sp

    def scope(self, name: str):
        ops = self

        class _Scope:
            def __enter__(self):
                ops.scope_path.append(name)

            def __exit__(self, *exc):
                ops.scope_path.pop()

        return _Scope()

    def layer_loop(self, fn: Callable, stacked_params, x, n_layers: int,
                   aux=None):
        """Apply ``fn(layer_params, x, layer_index, aux_i) -> x`` across
        layers; returns x."""
        raise NotImplementedError

    def decode_attention(self, q, k, v, lengths):
        """Fused single-token decode attention hook: q [B,K,G,D] against
        the cache k/v [B,Smax,K,D] with valid ``lengths`` [B]. Return the
        [B,K,G,D] context, or None for the composed einsum/softmax path."""
        return None


class UnrolledLayerLoop:
    """Mixin: the per-layer ``layer_loop`` — a Python loop pushing a static
    ``layer{i}`` scope per layer. Parameters and ``aux`` are indexed along
    their leading ``[L]`` axis (views, no copies)."""

    def layer_loop(self, fn, stacked_params, x, n_layers: int, aux=None):
        for i in range(n_layers):
            with self.scope(f"layer{i}"):
                x = fn(_tree_index(stacked_params, i), x, i,
                       _tree_index(aux, i))
        return x


class TorchOps(UnrolledLayerLoop, Backend):
    """Plain PyTorch with a dtype policy — the counterpart of ``JOps``.

    Matmuls and einsums run in ``compute_dtype`` (f32 in this port); with
    the serve entry point's precision settings they are true f32 on the
    card (no TF32)."""

    def __init__(self, compute_dtype=torch.float32):
        self.compute_dtype = compute_dtype

    def param(self, w):
        return w.to(self.compute_dtype)

    def input(self, x):
        return x.to(self.compute_dtype)

    def const(self, c, like):
        return torch.tensor(c, dtype=self.compute_dtype, device=like.device)

    def add(self, a, b): return a + b
    def sub(self, a, b): return a - b
    def mul(self, a, b): return a * b

    def scale(self, a, c):
        return a * c

    def shift(self, a, c):
        return a + c

    def matmul(self, a, b):
        return torch.matmul(a, b).to(self.compute_dtype)

    def einsum(self, subscripts, a, b):
        return torch.einsum(subscripts, a, b).to(self.compute_dtype)

    def rsqrt(self, a): return torch.rsqrt(a)
    def square(self, a): return a * a
    def silu(self, a): return F.silu(a)

    def softmax(self, a, dim: int = -1):
        return torch.softmax(a.float(), dim=dim).to(self.compute_dtype)

    def mean(self, a, dim, keepdim=False):
        return a.mean(dim=dim, keepdim=keepdim)

    def where(self, mask, a, b): return torch.where(mask, a, b)
    def take(self, a, idx):
        """Rows of ``a`` (along dim 0) at integer ``idx`` of any shape."""
        return a[idx]

    def reshape(self, a, shape): return a.reshape(shape)
    def concat(self, parts, dim): return torch.cat(list(parts), dim=dim)
    def shape_of(self, a): return tuple(a.shape)
