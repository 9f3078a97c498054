"""Arithmetic back-ends: one model definition, several executions (PyTorch).

The counterpart of the JAX package's ``repro.core.backend``. Every model in
:mod:`repro_torch.models` is written against :class:`Backend`:

* :class:`TorchOps` executes it as plain PyTorch in a compute dtype (f32
  for serving; ``TorchOps(torch.float64)`` is the paper's "exact model");
  the certified serving backends (:mod:`repro_torch.launch.serve`)
  override ``matmul`` and ``decode_attention`` to round into a
  certificate's formats;
* :class:`CaaOps` executes it on :class:`repro_torch.core.caa.CaaTensor`s,
  producing rigorous absolute/relative error bounds in units of u and a
  per-layer trace (the analysis path).

Axes are named ``dim`` throughout (``softmax(a, dim)``, ``sum(a, dim,
keepdim)``, ``concat(parts, dim)``, ``take(a, idx, dim)``), and constants
take a tensor whose device they join (``const(c, like)``), so a model runs
unchanged under every backend.

PyTorch runs eagerly and has no ``lax.scan``, so ``layer_loop`` is the
Python loop of :class:`UnrolledLayerLoop`: it pushes a static ``layer{i}``
scope per layer, and every per-scope knob resolves by name — the same
resolution the JAX package's unrolled baseline performs and is bitwise
against.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import caa
from repro_torch.core import interval as iv
from repro_torch.core.caa import CaaConfig, CaaTensor, DEFAULT_CONFIG


def _tree_index(tree, i):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_index(v, i) for k, v in tree.items()}
    return tree[i]


@dataclasses.dataclass
class TraceRecord:
    name: str
    kind: str
    shape: tuple
    out_mag: float      # sup |exact range|
    max_dbar: float     # units of u
    max_ebar: float     # units of u
    extra: dict = dataclasses.field(default_factory=dict)


class Backend:
    """Interface models are written against; methods mirror the caa.py
    rules.

    Every backend tracks the model's scope path: ``layer_loop`` pushes
    ``layer{i}``, models push named blocks ("dense1", "attn", "mlp", ...).
    CaaOps uses it for trace names and sensitivity gating; serving
    backends resolve per-scope formats against it. ``seen_scopes`` records
    every distinct path entered, in first-seen order; subclasses react to
    pushes and pops through :meth:`_scope_changed`."""

    is_analysis: bool = False

    @property
    def scope_path(self) -> List[str]:
        sp = getattr(self, "_scope", None)
        if sp is None:
            sp = self._scope = []
        return sp

    @property
    def seen_scopes(self) -> List[str]:
        """Every distinct scope path entered, in first-seen order."""
        ss = getattr(self, "_seen_scopes", None)
        if ss is None:
            ss = self._seen_scopes = []
            self._seen_set = set()
        return ss

    def scope(self, name: str):
        ops = self

        class _Scope:
            def __enter__(self):
                ops.scope_path.append(name)
                ops._scope_changed()

            def __exit__(self, *exc):
                ops.scope_path.pop()
                ops._scope_changed()

        return _Scope()

    def _scope_changed(self):
        """Hook fired after every scope push/pop; the base keeps
        ``seen_scopes`` (membership through a companion set)."""
        if self.scope_path:
            path = "/".join(self._scope)
            seen = self.seen_scopes          # materialises the set too
            if path not in self._seen_set:
                self._seen_set.add(path)
                seen.append(path)

    # construction
    def param(self, w, exact: Optional[bool] = None): raise NotImplementedError
    def input(self, x): raise NotImplementedError
    def const(self, c, like): raise NotImplementedError

    # arithmetic
    def add(self, a, b): raise NotImplementedError
    def sub(self, a, b): raise NotImplementedError
    def mul(self, a, b): raise NotImplementedError
    def div(self, a, b): raise NotImplementedError
    def neg(self, a): raise NotImplementedError
    def scale(self, a, c, exact_const: bool = False): raise NotImplementedError
    def shift(self, a, c): raise NotImplementedError
    def matmul(self, a, b): raise NotImplementedError
    def einsum(self, subscripts, a, b): raise NotImplementedError

    # nonlinearities
    def tanh(self, a): raise NotImplementedError
    def sigmoid(self, a): raise NotImplementedError
    def exp(self, a): raise NotImplementedError
    def log(self, a): raise NotImplementedError
    def sqrt(self, a): raise NotImplementedError
    def rsqrt(self, a): raise NotImplementedError
    def square(self, a): raise NotImplementedError
    def relu(self, a): raise NotImplementedError
    def silu(self, a): raise NotImplementedError
    def gelu(self, a): raise NotImplementedError
    def softmax(self, a, dim: int = -1): raise NotImplementedError

    def softcap(self, a, cap: float):
        """tanh soft-capping (gemma2): cap * tanh(x / cap)."""
        return self.scale(self.tanh(self.scale(a, 1.0 / cap)), cap)

    # reductions
    def sum(self, a, dim, keepdim: bool = False): raise NotImplementedError
    def mean(self, a, dim, keepdim: bool = False): raise NotImplementedError
    def max(self, a, dim, keepdim: bool = False): raise NotImplementedError

    # selection / comparison
    def maximum(self, a, b): raise NotImplementedError
    def where(self, mask, a, b): raise NotImplementedError

    def top_k_mask(self, scores, k: int, name: str = "router"):
        raise NotImplementedError

    # data movement
    def reshape(self, a, shape): raise NotImplementedError
    def transpose(self, a, dims): raise NotImplementedError
    def broadcast_to(self, a, shape): raise NotImplementedError
    def concat(self, parts, dim): raise NotImplementedError
    def take(self, a, idx, dim: int = 0): raise NotImplementedError
    def slice(self, a, slices): raise NotImplementedError
    def shape_of(self, a) -> tuple: raise NotImplementedError
    def value_of(self, a) -> torch.Tensor: raise NotImplementedError

    # structure
    def layer_loop(self, fn: Callable, stacked_params, x, n_layers: int,
                   aux=None):
        """Apply ``fn(layer_params, x, layer_index, aux_i) -> x`` across
        layers; returns x."""
        raise NotImplementedError

    def ssm_scan(self, decay, drive, n_steps: int, time_axis: int = 1):
        """h_{t+1} = decay_t ⊙ h_t + drive_t over ``time_axis``."""
        raise NotImplementedError("ssm_scan comes with the SSM models")

    def record(self, name: str, a, kind: str = "layer", **extra):
        """Trace hook; identity outside the analysis."""
        return a

    def clamp_range(self, a, lo, hi):
        """Inject an externally-proven range bound (identity outside the
        analysis; a sound enclosure intersection under CaaOps)."""
        return a

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
    """Plain PyTorch with a dtype policy — the counterpart of ``JOps``, with
    the ops the port's models use.

    Matmuls and einsums run in ``compute_dtype`` (f32 for serving; with the
    serve entry point's precision settings they are true f32 on the card,
    no TF32). ``TorchOps(torch.float64)`` evaluates in f64 throughout."""

    def __init__(self, compute_dtype=torch.float32):
        self.compute_dtype = compute_dtype

    def param(self, w, exact: Optional[bool] = None):
        return w.to(self.compute_dtype)

    def input(self, x):
        return x.to(self.compute_dtype)

    def const(self, c, like):
        return torch.as_tensor(c, dtype=self.compute_dtype, device=like.device)

    def add(self, a, b): return a + b
    def sub(self, a, b): return a - b
    def mul(self, a, b): return a * b

    def scale(self, a, c, exact_const: bool = False):
        return a * c

    def shift(self, a, c):
        return a + c

    def matmul(self, a, b):
        return torch.matmul(a, b).to(self.compute_dtype)

    def einsum(self, subscripts, a, b):
        return torch.einsum(subscripts, a, b).to(self.compute_dtype)

    def tanh(self, a): return torch.tanh(a)
    def rsqrt(self, a): return torch.rsqrt(a)
    def square(self, a): return a * a
    def relu(self, a): return torch.relu(a)
    def silu(self, a): return F.silu(a)

    def softmax(self, a, dim: int = -1):
        """In f32, or in f64 for f64 inputs."""
        a = a if a.dtype == torch.float64 else a.float()
        return torch.softmax(a, dim=dim).to(self.compute_dtype)

    def mean(self, a, dim, keepdim=False):
        return a.mean(dim=dim, keepdim=keepdim)

    def maximum(self, a, b): return torch.maximum(a, b)
    def where(self, mask, a, b): return torch.where(mask, a, b)

    def reshape(self, a, shape): return a.reshape(shape)
    def broadcast_to(self, a, shape): return torch.broadcast_to(a, shape)
    def concat(self, parts, dim): return torch.cat(list(parts), dim=dim)

    def take(self, a, idx, dim: int = 0):
        """Entries of ``a`` along ``dim`` at integer ``idx`` of any shape."""
        return caa.take_along(a, idx, dim)

    def slice(self, a, slices): return a[slices]
    def shape_of(self, a): return tuple(a.shape)


class CaaOps(UnrolledLayerLoop, Backend):
    """Executes the model on CaaTensors, recording a per-layer trace.

    weights_exact: treat parameters as exactly representable in the target
      format (the paper's default: the stored weights *are* the reference);
      False additionally charges the re-quantisation (ε̄ = 1/2 per weight).
    """

    is_analysis = True

    def __init__(self, cfg: CaaConfig = DEFAULT_CONFIG,
                 weights_exact: bool = True):
        self.cfg = cfg
        self.weights_exact = weights_exact
        self.trace: List[TraceRecord] = []
        self._scope: List[str] = []

    # -- scoping / tracing --
    def _name(self, leaf: str) -> str:
        return "/".join(self._scope + [leaf]) if self._scope else leaf

    def record(self, name: str, a: CaaTensor, kind: str = "layer", **extra):
        self.trace.append(TraceRecord(
            name=self._name(name), kind=kind, shape=tuple(a.shape),
            out_mag=float(torch.max(iv.mag(a.exact))),
            max_dbar=float(torch.max(a.dbar)),
            max_ebar=float(torch.max(a.ebar)), extra=extra))
        return a

    # -- construction --
    def param(self, w, exact: Optional[bool] = None):
        exact = self.weights_exact if exact is None else exact
        return caa.weight(w, self.cfg, exact=exact)

    def input(self, x):
        if isinstance(x, CaaTensor):
            return x
        return caa.make(x)

    def const(self, c, like):
        return caa.const_exact(torch.as_tensor(c, dtype=torch.float64,
                                               device=like.device))

    # -- arithmetic --
    def add(self, a, b): return caa.add(a, b, self.cfg)
    def sub(self, a, b): return caa.sub(a, b, self.cfg)
    def mul(self, a, b): return caa.mul(a, b, self.cfg)
    def div(self, a, b): return caa.div(a, b, self.cfg)
    def neg(self, a): return caa.neg(a)

    def scale(self, a, c, exact_const: bool = False):
        return caa.scale_const(a, c, exact_const=exact_const, cfg=self.cfg)

    def shift(self, a, c): return caa.shift_const(a, c, self.cfg)
    def matmul(self, a, b): return caa.matmul(a, b, self.cfg)

    def einsum(self, subscripts, a, b):
        return caa.einsum(subscripts, a, b, self.cfg)

    def tanh(self, a): return caa.tanh(a, self.cfg)
    def sigmoid(self, a): return caa.sigmoid(a, self.cfg)
    def exp(self, a): return caa.exp(a, self.cfg)
    def log(self, a): return caa.log(a, self.cfg)
    def sqrt(self, a): return caa.sqrt(a, self.cfg)
    def rsqrt(self, a): return caa.rsqrt(a, self.cfg)
    def square(self, a): return caa.square(a, self.cfg)
    def relu(self, a): return caa.relu(a, self.cfg)
    def silu(self, a): return caa.silu(a, self.cfg)
    def gelu(self, a): return caa.gelu(a, self.cfg)
    def softmax(self, a, dim: int = -1): return caa.softmax(a, dim, self.cfg)

    def sum(self, a, dim, keepdim=False):
        return caa.reduce_sum(a, dim, keepdim, self.cfg)

    def mean(self, a, dim, keepdim=False):
        return caa.reduce_mean(a, dim, keepdim, self.cfg)

    def max(self, a, dim, keepdim=False):
        return caa.reduce_max(a, dim, keepdim, self.cfg)

    def maximum(self, a, b): return caa.maximum(a, b, self.cfg)
    def where(self, mask, a, b): return caa.where(mask, a, b)

    def top_k_mask(self, scores: CaaTensor, k: int, name: str = "router"):
        """Fix the route from reference values; record the decision margin
        (the route is safe against rounding iff the gap between the k-th
        chosen and the best rejected logit exceeds twice the logit error)."""
        vals, idx = torch.topk(scores.val, k)
        mask = F.one_hot(idx, scores.shape[-1]).to(scores.val.dtype).sum(-2)
        rejected = torch.where(mask > 0, -torch.inf, scores.val)
        margin = torch.amin(vals, -1) - torch.amax(rejected, -1)
        # per-run certified error: sup distance from the emulated value to
        # the ideal range (finite even when the parametric bound saturates)
        dist = torch.maximum((scores.val - scores.exact.lo).abs(),
                             (scores.val - scores.exact.hi).abs())
        err_val = torch.minimum(
            torch.max(caa._eff_dbar(scores)) * self.cfg.u_max,
            torch.max(dist))
        min_margin = float(torch.min(margin))
        self.trace.append(TraceRecord(
            name=self._name(name), kind="router", shape=tuple(scores.shape),
            out_mag=float(torch.max(iv.mag(scores.exact))),
            max_dbar=float(torch.max(scores.dbar)),
            max_ebar=float(torch.max(scores.ebar)),
            extra={"min_margin": min_margin,
                   "flip_safe_if_u_le": min_margin / (2 * float(err_val)
                                                      + 1e-300)}))
        return mask

    def reshape(self, a, shape): return caa.reshape(a, shape)
    def transpose(self, a, dims): return caa.transpose(a, dims)
    def broadcast_to(self, a, shape): return caa.broadcast_to(a, shape)
    def concat(self, parts, dim): return caa.concatenate(list(parts), dim)
    def take(self, a, idx, dim: int = 0): return caa.take(a, idx, dim)
    def slice(self, a, slices): return caa.slice_(a, slices)
    def shape_of(self, a): return tuple(a.shape)
    def value_of(self, a): return a.val

    def clamp_range(self, a, lo, hi):
        return caa.clamp_exact(a, lo, hi)
