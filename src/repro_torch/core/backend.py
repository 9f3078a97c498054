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
import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core import caa
from repro_torch.core import interval as iv
from repro_torch.core.caa import CaaConfig, CaaTensor, DEFAULT_CONFIG
from repro_torch.core.scopes import STACK_SCOPE, resolve_scope_value
from repro_torch.kernels import row_order

_HEAD = "bsd,vd->bsv"     # the LM head's einsum (models/layers.logits_head)


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
        self._head_t = None     # (key, transposed table) of the LM head

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
        """On the card, the LM head ("bsd,vd->bsv" of f32 tensors) runs
        through the fixed-order ``f32_matmul`` kernel
        (:mod:`repro_torch.kernels.row_order`), so a lane's logits do not
        depend on its batch; it reads a transposed copy of the table, made
        once per table and kept while the backend lives. Everything else,
        and everything on the CPU, is ``torch.einsum``."""
        if (subscripts == _HEAD and a.is_cuda
                and a.dtype == b.dtype == torch.float32):
            return row_order.lm_head_dispatch(a, self._table_t(b))
        return torch.einsum(subscripts, a, b).to(self.compute_dtype)

    def _table_t(self, table):
        key = (table.data_ptr(), tuple(table.shape), table.device,
               table._version)
        if self._head_t is None or self._head_t[0] != key:
            self._head_t = None          # free the old copy first
            self._head_t = (key, row_order.transposed(table))
        return self._head_t[1]

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
        """On the card, the mean over the last dim with keepdim of an f32
        tensor (the rmsnorm's) runs through the fixed-order ``row_mean``
        kernel (:mod:`repro_torch.kernels.row_order`); everything else is
        ``Tensor.mean``."""
        if (a.is_cuda and a.dtype == torch.float32 and keepdim
                and dim in (-1, a.dim() - 1)):
            return row_order.row_mean_dispatch(a)
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


# ---------------------------------------------------------------------------
# per-scope IA magnitude enclosures — the range analysis behind custom
# (k, emin, emax) format certification
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RangeStat:
    """Magnitude enclosure of every FP value a scope produces.

    ``max_abs`` is a rigorous upper bound on |v̂| over every intermediate
    (IA range inflated by the value's own FP error at u_max) — the quantity
    the smallest overflow-free ``emax`` is certified from. ``min_nonzero``
    is the smallest positive element-wise mignitude seen (+inf if none):
    when it clears the format's ``min_normal``, no provably-nonzero value
    can go subnormal. ``crosses_zero`` records whether some enclosure
    touches 0 — those values may underflow, which is what the
    λ·2^{emin-(k-1)} absolute term (CaaConfig.round_abs) charges for.
    """

    max_abs: float = 0.0
    min_nonzero: float = math.inf
    crosses_zero: bool = False
    n_ops: int = 0

    def merge(self, other: "RangeStat") -> "RangeStat":
        return RangeStat(
            max_abs=max(self.max_abs, other.max_abs),
            min_nonzero=min(self.min_nonzero, other.min_nonzero),
            crosses_zero=self.crosses_zero or other.crosses_zero,
            n_ops=self.n_ops + other.n_ops,
        )

    def to_dict(self) -> dict:
        return {"max_abs": self.max_abs, "min_nonzero": self.min_nonzero,
                "crosses_zero": self.crosses_zero, "n_ops": self.n_ops}


def _range_row(lo: torch.Tensor, hi: torch.Tensor, shape,
               is_op: bool) -> torch.Tensor:
    """(max_abs, min_nonzero, crosses_zero, n_ops) of one observed
    enclosure as an f64 [4] tensor on its device (no host sync)."""
    lo = torch.broadcast_to(lo, shape).reshape(-1)
    hi = torch.broadcast_to(hi, shape).reshape(-1)
    mag = torch.amax(torch.maximum(lo.abs(), hi.abs()))
    mig = torch.clamp(torch.maximum(lo, -hi), min=0.0)
    min_nz = torch.amin(torch.where(mig > 0, mig, math.inf))
    crossed = torch.any(mig <= 0).to(torch.float64)
    return torch.stack([mag, min_nz, crossed,
                        torch.full_like(mag, 1.0 if is_op else 0.0)])


def _row_stat(row) -> RangeStat:
    return RangeStat(max_abs=float(row[0]), min_nonzero=float(row[1]),
                     crosses_zero=bool(row[2] > 0), n_ops=int(row[3]))


_ACC_INIT = (0.0, math.inf, 0.0, 0.0)


def _merge_acc(acc: torch.Tensor, stat: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.maximum(acc[0], stat[0]),
                        torch.minimum(acc[1], stat[1]),
                        torch.maximum(acc[2], stat[2]), acc[3] + stat[3]])


def _lane_stats(lanes: torch.Tensor, sublanes: Sequence[str],
                out: Dict[str, RangeStat]) -> None:
    """Fold concretised [L, S, 4] lanes into ``out`` by key: ``layer{i}``
    for lane 0, ``layer{i}/{sub}`` for the sub-layer lanes a layer entered;
    a key already present (a second stack) merges."""
    arr = lanes.cpu().tolist()
    for i, row in enumerate(arr):
        for j, cell in enumerate(row):
            s = _row_stat(cell)
            if (j > 0 and s.n_ops == 0 and s.max_abs == 0.0
                    and s.min_nonzero == math.inf):
                continue  # sub-lane never entered
            key = f"layer{i}" if j == 0 else f"layer{i}/{sublanes[j - 1]}"
            out[key] = s if key not in out else out[key].merge(s)


class RangeCaaOps(CaaOps):
    """CaaOps that additionally accumulates per-scope magnitude enclosures.

    Every op result (and every param/input/const — weights must be
    representable in a scope's format too) updates ``scope_ranges`` at the
    current scope path. Each observation is reduced on the device and read
    back as floats at once (one host sync an op), so ``scope_ranges`` is
    always current. Observation is side-effect-only — the returned tensors
    are the parent class's, and method dispatch goes through ``super()`` so
    the wrappers compose with subclasses that redefine scope behaviour.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.scope_ranges: Dict[str, RangeStat] = {}

    def _observe(self, out, is_op: bool = True):
        if not isinstance(out, CaaTensor):
            return out
        rng = out.fp_range(self.cfg.u_max)
        stat = _row_stat(_range_row(rng.lo, rng.hi, out.shape,
                                    is_op).tolist())
        key = "/".join(self._scope) if self._scope else ""
        prev = self.scope_ranges.get(key)
        self.scope_ranges[key] = stat if prev is None else prev.merge(stat)
        return out


_RANGE_TRACKED_OPS = (
    "param", "input", "const", "add", "sub", "mul", "div", "neg", "scale",
    "shift", "matmul", "einsum", "tanh", "sigmoid", "exp", "log", "sqrt",
    "rsqrt", "square", "relu", "silu", "gelu", "softmax", "sum", "mean",
    "max", "maximum", "where", "concat", "clamp_range", "ssm_scan",
)


def _make_range_wrapper(cls, name: str):
    def method(self, *args, **kwargs):
        out = getattr(super(cls, self), name)(*args, **kwargs)
        # operands cross scope boundaries: a matmul in scope s quantises
        # values produced elsewhere INTO s's format, so every consumed
        # tensor belongs to s's enclosure too (n_ops counts outputs only)
        for a in args:
            if isinstance(a, CaaTensor):
                self._observe(a, is_op=False)
        self._observe(out)
        return out
    method.__name__ = name
    method.__qualname__ = f"{cls.__name__}.{name}"
    return method


def _install_range_wrappers(cls):
    """Wrap every value-producing op of ``cls`` with the ``_observe`` hook
    (dispatch goes through super(cls), so observation composes with any
    scope/knob behaviour of the base class)."""
    for name in _RANGE_TRACKED_OPS:
        setattr(cls, name, _make_range_wrapper(cls, name))
    return cls


_install_range_wrappers(RangeCaaOps)


# ---------------------------------------------------------------------------
# layer-stacked analysis — the stack as one wildcard scope with [L] lanes
# ---------------------------------------------------------------------------

def _canon_caa(c: CaaTensor) -> CaaTensor:
    """Broadcast every field to val's shape (f64 views): the stack's carry
    keeps one shape across layers, while CAA rules freely return
    scalar-broadcast dbar/ebar."""
    shape = c.shape
    b = lambda t: torch.broadcast_to(torch.as_tensor(
        t, dtype=torch.float64, device=c.device), shape)
    return CaaTensor(c.val, iv.Interval(b(c.exact.lo), b(c.exact.hi)),
                     b(c.dbar), b(c.ebar))


def _lane(values) -> torch.Tensor:
    """An [L] knob lane on the host (the layer loop is a Python loop, so a
    layer's entry is read as a float without touching the card)."""
    return torch.tensor([float(v) for v in values], dtype=torch.float64)


class StackedCaaOps(CaaOps):
    """Layer-stacked CAA: ``layer_loop`` runs the stack as ONE scope, the
    :data:`repro_torch.core.scopes.STACK_SCOPE` wildcard, whose per-layer
    knobs come from ``[L]`` lanes — the PyTorch form of the reference's
    ``lax.scan`` analysis (PyTorch has no scan: the body runs once per
    layer in a Python loop, and the lanes are indexed by the loop's layer
    index where the reference gathers by the scan carry's).

    Scope-dependent knobs: at loop entry each layer's
    ``round_scale``/``round_abs`` is resolved by name against
    ``scope_scales``/``scope_abs`` (values may be floats, or ``[L]``
    tensors under a ``layer*`` key), stacked into ``[L]`` lanes, one pair
    per sub-layer suffix met (``layer*/attn``, ...), and read at the
    layer index. Outside the stack the knobs resolve from the scope path.
    With empty maps and unit defaults this is the uniform analysis (bounds
    equal the eager unroll's).

    What the stacked form reports, as the reference's does: one
    ``layer*/...`` trace record per name (its numbers NaN: per-layer
    values are not concretised inside the stack), ``seen_scopes`` with the
    wildcard instead of concrete layer names (expand with
    :func:`repro_torch.core.scopes.expand_stacked`), and per-layer (δ̄, ε̄)
    maxima of the carry after every layer as the ``layer_stats`` ``[L]``
    tensors.
    """

    def __init__(self, cfg: CaaConfig = DEFAULT_CONFIG,
                 scope_scales: Optional[Dict[str, Any]] = None,
                 scope_abs: Optional[Dict[str, Any]] = None,
                 default_scale=1.0, default_abs=None,
                 weights_exact: bool = True):
        self._scales = dict(scope_scales or {})
        self._abs = dict(scope_abs or {})
        self._default_scale = default_scale
        self._default_abs = (cfg.round_abs if default_abs is None
                             else default_abs)
        self._base_cfg = cfg
        self._in_stack = False
        self._layer_index = None
        self._stack_ctx = None      # (outer_path, n_layers) in the stack
        self._lane_cache: Dict[tuple, tuple] = {}
        self.layer_stats: Optional[Dict[str, torch.Tensor]] = None
        super().__init__(cfg, weights_exact=weights_exact)
        self._apply_static()

    # -- knob resolution ----------------------------------------------------
    def _apply_static(self):
        s = resolve_scope_value(self._scope, self._scales,
                                self._default_scale)
        ra = resolve_scope_value(self._scope, self._abs, self._default_abs)
        self.cfg = dataclasses.replace(
            self._base_cfg,
            round_scale=self._base_cfg.round_scale * float(s),
            round_abs=float(ra))

    def _scope_changed(self):
        super()._scope_changed()
        if self._in_stack:
            # inside the stack the knobs follow the sub-layer suffix
            # (layer*/attn, layer*/mlp, ...): each distinct suffix gets its
            # own [L] lane, resolved by name like the per-layer lane
            self._apply_stack_lane()
        elif self._stack_ctx is None:
            # (entering the stack scope itself resolves nothing: each layer
            # pins its own lane)
            self._apply_static()

    def _stack_suffix(self) -> tuple:
        """Scope segments below the stack wildcard."""
        outer, _ = self._stack_ctx
        return tuple(self._scope[len(outer) + 1:])

    def _stack_lanes(self, suffix: tuple):
        """[L] knob lanes for one sub-layer suffix, cached per suffix."""
        cached = self._lane_cache.get(suffix)
        if cached is None:
            outer, n_layers = self._stack_ctx

            def vec(mapping, default):
                return _lane(resolve_scope_value(
                    outer + [f"layer{i}", *suffix], mapping, default)
                    for i in range(n_layers))

            cached = (vec(self._scales, self._default_scale),
                      vec(self._abs, self._default_abs))
            self._lane_cache[suffix] = cached
        return cached

    def _apply_stack_lane(self):
        scale_vec, abs_vec = self._stack_lanes(self._stack_suffix())
        i = self._layer_index
        base = self._base_cfg
        self.cfg = dataclasses.replace(
            base, round_scale=base.round_scale * float(scale_vec[i]),
            round_abs=float(abs_vec[i]))

    def record(self, name: str, a: CaaTensor, kind: str = "layer", **extra):
        if not self._in_stack:
            return super().record(name, a, kind, **extra)
        if self._layer_index == 0:
            nan = math.nan
            self.trace.append(TraceRecord(
                name=self._name(name), kind=kind, shape=tuple(a.shape),
                out_mag=nan, max_dbar=nan, max_ebar=nan, extra=extra))
        return a

    # -- stack-state hooks (the range subclass keeps its lanes here) --------
    def _stack_state_init(self, n_layers: int, device):
        pass

    def _finish_stack_state(self):
        pass

    def layer_loop(self, fn, stacked_params, x, n_layers: int, aux=None):
        if self._in_stack:
            # nested stacks are out of scope for the stacked form: the
            # inner loop runs as the eager unroll
            return super().layer_loop(fn, stacked_params, x, n_layers, aux)
        abs_u, rel_u = [], []
        self._stack_ctx = (list(self._scope), n_layers)
        self._lane_cache = {}
        with self.scope(STACK_SCOPE):
            self._stack_state_init(n_layers, x.device)
            self._in_stack = True
            try:
                x = _canon_caa(x)
                for i in range(n_layers):
                    self._layer_index = i
                    # per-layer knob lane (suffix ()); sub-layer scope
                    # pushes inside fn re-pin to their suffix lane
                    self._apply_stack_lane()
                    x = _canon_caa(fn(_tree_index(stacked_params, i), x, i,
                                      _tree_index(aux, i)))
                    abs_u.append(torch.max(x.dbar))
                    rel_u.append(torch.max(x.ebar))
            finally:
                self._in_stack = False
                self._layer_index = None
                self._stack_ctx = None
            self._finish_stack_state()
        self.layer_stats = {"abs_u": torch.stack(abs_u),
                            "rel_u": torch.stack(rel_u)}
        return x


class StackedRangeCaaOps(StackedCaaOps):
    """Layer-stacked range analysis: per-scope IA magnitude enclosures as
    ``[L, S, 4]`` lanes on the device — (max_abs, min_nonzero,
    crosses_zero, n_ops) for S = one layer-direct lane plus one per
    ``sublanes`` name — updated by indexed writes at the layer index, and
    one ``[4]`` accumulator per scope path for the ops outside the stack.
    Nothing is read back before :meth:`collect_ranges`, which concretises
    them to the ``{scope_key: RangeStat}`` shape the eager path produces."""

    def __init__(self, *args, sublanes: Sequence[str] = (), **kwargs):
        # sublanes: sub-layer scope names (e.g. ("attn", "mlp")) that get
        # their own accumulator lane inside the stack; everything else in a
        # layer lands on lane 0. With () the lanes are per layer.
        self._sublanes = tuple(sublanes)
        self._sub_map = {s: j + 1 for j, s in enumerate(self._sublanes)}
        self._outer_accs = None
        self._lane_acc = None
        self._done_lanes: List[torch.Tensor] = []
        super().__init__(*args, **kwargs)
        self._outer_accs: Dict[str, torch.Tensor] = {}

    def _sub_idx(self) -> int:
        """Accumulator-lane index of the current sub-layer scope."""
        if self._stack_ctx is None or not self._sub_map:
            return 0
        suffix = self._stack_suffix()
        return self._sub_map.get(suffix[0], 0) if suffix else 0

    def _observe(self, out, is_op: bool = True):
        if not isinstance(out, CaaTensor) or self._outer_accs is None:
            return out
        rng = out.fp_range(self.cfg.u_max)
        stat = _range_row(rng.lo, rng.hi, out.shape, is_op)
        if self._in_stack and self._lane_acc is not None:
            i, j = self._layer_index, self._sub_idx()
            self._lane_acc[i, j] = _merge_acc(self._lane_acc[i, j], stat)
        else:
            key = "/".join(self._scope) if self._scope else ""
            prev = self._outer_accs.get(key)
            if prev is None:
                prev = torch.tensor(_ACC_INIT, dtype=torch.float64,
                                    device=stat.device)
            self._outer_accs[key] = _merge_acc(prev, stat)
        return out

    def _stack_state_init(self, n_layers: int, device):
        self._lane_acc = torch.tensor(
            _ACC_INIT, dtype=torch.float64, device=device).repeat(
            n_layers, 1 + len(self._sublanes), 1)

    def _finish_stack_state(self):
        self._done_lanes.append(self._lane_acc)
        self._lane_acc = None

    def collect_ranges(self) -> Dict[str, RangeStat]:
        """Concretise the lanes: ``layer{i}`` / ``layer{i}/{sub}`` per lane,
        the paths outside the stack keyed by their scope string (plus
        ``""`` for unscoped ops) — the key shape the eager
        :class:`RangeCaaOps` + aggregate_ranges path produces. Stacks from
        repeated layer_loops merge by layer name."""
        out: Dict[str, RangeStat] = {}
        for lanes in self._done_lanes:
            _lane_stats(lanes, self._sublanes, out)
        for key, acc in self._outer_accs.items():
            # the wildcard path holds ops observed between scope entry and
            # the first layer (none today): fold it into the default
            key = "" if key.startswith(STACK_SCOPE) else key
            s = _row_stat(acc.cpu().tolist())
            out[key] = s if key not in out else out[key].merge(s)
        out.setdefault("", RangeStat())
        return out


_install_range_wrappers(StackedRangeCaaOps)


# ---------------------------------------------------------------------------
# affine-arithmetic range analysis — finite enclosures where IA saturates
# ---------------------------------------------------------------------------
#
# The IA range pass bounds |v̂| through the CAA error terms: at coarse
# emulated precision the parametric accumulation bounds (CaaConfig.gamma)
# saturate to ∞ and every enclosure downstream is ∞. The affine pass
# FORWARD-PROPAGATES an enclosure of the rounded values themselves, through
# TWO channels per tensor (:class:`AffTensor`):
#
#   * an affine form (interval.AffineForm) — center + noise-symbol terms —
#     that survives elementwise linear ops exactly, so correlated paths
#     (residual adds, gating products) cancel instead of compounding;
#   * a plain interval, advanced by outward-rounded interval rules with an
#     operational rounding inflation (1+u/2)^n — this channel keeps the
#     sign/structure facts a symmetric form cannot represent (x² ≥ 0,
#     softmax ∈ [0,1], clamp bounds), so norm denominators never swallow 0.
#
# The enclosure of a tensor is the channels' intersection; both are sound
# for the same rounded-value set. Every rounding charge is the operational
# growth model (1+u/2)^n − 1 plus n·η — finite at EVERY precision. The pass
# proves nothing about (δ̄, ε̄); it exists to tighten RangeStat range
# evidence, and is sound to min-combine with the IA pass.

_AFF_INF = math.inf


class AffTensor:
    """Two-channel rounded-value enclosure for the affine range pass.

    Exposes the CaaTensor surface the models (and caa's shape ops) touch
    under ``is_analysis``: ``val`` is the f64 reference value (the form's
    center), ``exact`` the channel intersection — an enclosure of the
    ROUNDED values; unlike CaaTensor, whose ``exact`` holds ideal values
    and whose FP deviation lives in (dbar, ebar), here the deviation is
    inside the enclosure and the error channels read zero."""

    __slots__ = ("form", "ivl")

    def __init__(self, form: iv.AffineForm,
                 ivl: Optional[iv.Interval] = None):
        self.form = form
        self.ivl = iv.aff_interval(form) if ivl is None else ivl

    @property
    def val(self) -> torch.Tensor:
        return self.form.center

    @property
    def exact(self) -> iv.Interval:
        a = iv.aff_interval(self.form)
        shape = self.form.shape
        lo = torch.maximum(torch.broadcast_to(a.lo, shape),
                           torch.broadcast_to(self.ivl.lo, shape))
        hi = torch.minimum(torch.broadcast_to(a.hi, shape),
                           torch.broadcast_to(self.ivl.hi, shape))
        return iv.Interval(lo, hi)

    @property
    def dbar(self) -> torch.Tensor:
        return torch.zeros(self.form.shape, dtype=torch.float64,
                           device=self.device)

    ebar = dbar

    @property
    def shape(self) -> tuple:
        return tuple(self.form.shape)

    @property
    def ndim(self) -> int:
        return len(self.form.shape)

    @property
    def device(self):
        return self.form.center.device


def _aff_struct(f: iv.AffineForm, fn) -> iv.AffineForm:
    """Apply a shape-only op: fn(tensor, is_terms) on center/rad and the
    axis-shifted terms."""
    return iv.AffineForm(fn(f.center, False), fn(f.terms, True), f.ids,
                         fn(f.rad, False))


def _einsum_contract_length(subscripts: str, sa, sb) -> int:
    """Number of products summed per output element of a two-operand
    einsum — the n of the accumulation-rounding charge."""
    ins, out = subscripts.replace(" ", "").split("->")
    A, B = ins.split(",")
    dims = {}
    for ch, d in zip(A, sa):
        dims[ch] = int(d)
    for ch, d in zip(B, sb):
        dims[ch] = int(d)
    n = 1
    for ch, d in dims.items():
        if ch not in out:
            n *= d
    return max(n, 1)


def _reduced_count(shape, dim) -> int:
    if dim is None:
        n = 1
        for d in shape:
            n *= int(d)
        return max(n, 1)
    dims = dim if isinstance(dim, (tuple, list)) else (dim,)
    n = 1
    for ax in dims:
        n *= int(shape[ax])
    return max(n, 1)


def _all_dims(t: torch.Tensor, dim):
    return tuple(range(t.dim())) if dim is None else dim


class AffineRangeCaaOps(UnrolledLayerLoop, Backend):
    """Eager affine range pass over per-scope FP formats.

    ``scope_fmts[s]`` is the :class:`repro_torch.core.formats.FpFormat`
    scope ``s`` runs in (resolved with the scopes matcher — ``layer3``,
    ``layer*``, ``layer*/attn`` keys all work); each op charges roundings
    of half-width ``(u_s/2)·|v| + η_s`` at the scope it executes in.
    Observations land in ``scope_ranges`` exactly like :class:`RangeCaaOps`
    (operands observed into the consuming scope, enclosures inflated by one
    re-quantisation into that scope's format), so
    :func:`repro_torch.core.analyze.aggregate_ranges` consumes either pass.
    Noise-symbol ids come from one counter in op order (0 marks an empty
    slot), as the reference hands them out. Each observation is read back
    at once (one host sync an op)."""

    is_analysis = True

    def __init__(self, scope_fmts: Dict[str, Any], default_fmt,
                 budget: int = iv.AFF_DEFAULT_BUDGET,
                 weights_exact: bool = True,
                 condense_rank: str = iv.AFF_DEFAULT_RANK):
        self._fmts = dict(scope_fmts or {})
        self._default_fmt = default_fmt
        self.budget = int(budget)
        self.condense_rank = str(condense_rank)
        self.weights_exact = weights_exact
        self._scope: List[str] = []
        self._knobs: Dict[tuple, tuple] = {}
        self._sym_counter = 1  # 0 marks the empty slot
        self.scope_ranges: Dict[str, RangeStat] = {}

    # -- knobs / symbols -----------------------------------------------------
    def _hu_eta(self):
        """(u_s/2, η_s) of the current scope's format."""
        key = tuple(self._scope)
        got = self._knobs.get(key)
        if got is None:
            fmt = resolve_scope_value(self._scope, self._fmts,
                                      self._default_fmt)
            got = (0.5 * fmt.u, fmt.underflow_unit)
            self._knobs[key] = got
        return got

    def _next_id(self) -> int:
        i = self._sym_counter
        self._sym_counter = i + 1
        return i

    # -- lift / rounding charges / observe -----------------------------------
    def _lift(self, x, observe: bool = True) -> AffTensor:
        if isinstance(x, AffTensor):
            t = x
        elif isinstance(x, CaaTensor):
            # a CaaTensor reaching this backend carries exact reference
            # values (inputs built by caa.make) — enclose its fp range at
            # the coarsest unit it may run under (u = 2·hu of this scope)
            hu, _ = self._hu_eta()
            rng = x.fp_range(2.0 * hu)
            form = iv.aff_from_interval(rng, self.budget,
                                        center=x.val.to(torch.float64))
            t = AffTensor(form, rng)
        else:
            t = AffTensor(iv.aff_make(x, self.budget))
        if observe:
            self._observe(t, is_op=False)
        return t

    def _round_iv(self, I: iv.Interval, rounds) -> iv.Interval:
        """Widen an ideal-result enclosure by ``rounds`` elementary
        roundings at this scope's format: relative growth (1+u/2)^n − 1
        (plus the f64 slop) and n·η absolute — the operational model,
        finite at every precision."""
        hu, eta = self._hu_eta()
        grow = (math.pow(1.0 + hu, float(rounds))
                * (1.0 + 8.0 * iv._gamma_f64(8)) - 1.0)
        add = float(rounds) * eta * (1.0 + grow)
        lo = iv._down(I.lo - (grow * I.lo.abs() + add))
        hi = iv._up(I.hi + (grow * I.hi.abs() + add))
        # rounding is monotone with rd(0) = 0: a provably-nonnegative
        # quantity stays nonnegative under FP evaluation (likewise ≤ 0), so
        # the η slop must not push an enclosure across zero — that spurious
        # crossing is what lets mean(x²)+eps reach rsqrt with lo < 0
        lo = torch.where(I.lo >= 0.0, torch.clamp(lo, min=0.0), lo)
        hi = torch.where(I.hi <= 0.0, torch.clamp(hi, max=0.0), hi)
        bad = torch.isnan(lo) | torch.isnan(hi)
        return iv.Interval(torch.where(bad, -_AFF_INF, lo),
                           torch.where(bad, _AFF_INF, hi))

    def _sym(self, f: iv.AffineForm, rounds) -> iv.AffineForm:
        """Charge ``rounds`` output roundings on the form channel as one
        fresh per-element noise symbol."""
        hu, eta = self._hu_eta()
        coeff = float(rounds) * (hu * (f.center.abs() + iv.aff_tot(f))
                                 + eta)
        return iv.aff_append_symbol(f, coeff, self._next_id(), self.budget,
                                    self.condense_rank)

    def _refit(self, I: iv.Interval, center) -> iv.AffineForm:
        """Terms-free form recentred on the reference value (nonlinear ops
        and contractions drop their symbols; the interval channel carries
        the asymmetric part the form cannot)."""
        c = center.to(torch.float64)
        return iv.aff_from_interval(
            I, self.budget, center=torch.where(torch.isfinite(c), c, 0.0))

    def _out(self, f: iv.AffineForm, I: iv.Interval,
             is_op: bool = True) -> AffTensor:
        t = AffTensor(f, I)
        self._observe(t, is_op=is_op)
        return t

    def _requant_interval(self, t: AffTensor) -> iv.Interval:
        """Channel intersection inflated by one re-quantisation into this
        scope's format — the envelope a value must fit when scope s
        consumes or produces it ((1 ± u/2)·v ± η)."""
        return self._round_iv(t.exact, 1)

    def _observe(self, t: AffTensor, is_op: bool):
        ivl = self._requant_interval(t)
        stat = _row_stat(_range_row(ivl.lo, ivl.hi, t.shape,
                                    is_op).tolist())
        key = "/".join(self._scope) if self._scope else ""
        prev = self.scope_ranges.get(key)
        self.scope_ranges[key] = stat if prev is None else prev.merge(stat)

    # -- construction --------------------------------------------------------
    def param(self, w, exact: Optional[bool] = None):
        exact = self.weights_exact if exact is None else exact
        f = iv.aff_make(w, self.budget)
        if not exact:
            f = self._sym(f, 1)
        return self._out(f, iv.aff_interval(f))

    def input(self, x):
        if isinstance(x, AffTensor):
            self._observe(x, is_op=False)
            return x
        t = self._lift(x, observe=False)
        self._observe(t, is_op=True)
        return t

    def const(self, c, like):
        f = iv.aff_make(torch.as_tensor(c, dtype=torch.float64,
                                        device=like.device), self.budget)
        return self._out(f, iv.aff_interval(f))

    # -- elementwise arithmetic (form terms survive — correlations cancel) --
    def add(self, a, b):
        A, B = self._lift(a), self._lift(b)
        f = self._sym(iv.aff_add(A.form, B.form, self.budget,
                                 self.condense_rank), 1)
        I = self._round_iv(iv.add(A.exact, B.exact), 1)
        return self._out(f, I)

    def sub(self, a, b):
        A, B = self._lift(a), self._lift(b)
        f = self._sym(iv.aff_sub(A.form, B.form, self.budget,
                                 self.condense_rank), 1)
        I = self._round_iv(iv.sub(A.exact, B.exact), 1)
        return self._out(f, I)

    def mul(self, a, b):
        A, B = self._lift(a), self._lift(b)
        f = self._sym(iv.aff_mul(A.form, B.form, self.budget,
                                 self.condense_rank), 1)
        I = self._round_iv(iv.mul(A.exact, B.exact), 1)
        return self._out(f, I)

    def neg(self, a):
        A = self._lift(a)
        return self._out(iv.aff_neg(A.form), iv.neg(A.exact))

    def scale(self, a, c, exact_const: bool = False):
        A = self._lift(a)
        f = iv.aff_scale(A.form, c)
        I = iv.scale(A.exact, torch.as_tensor(c, dtype=torch.float64,
                                              device=A.device))
        if not exact_const:
            f = self._sym(f, 1)
            I = self._round_iv(I, 1)
        return self._out(f, I)

    def shift(self, a, c):
        A = self._lift(a)
        f = self._sym(iv.aff_shift(A.form, c), 1)
        I = self._round_iv(iv.shift(A.exact, torch.as_tensor(
            c, dtype=torch.float64, device=A.device)), 1)
        return self._out(f, I)

    def square(self, a):
        A = self._lift(a)
        f = self._sym(iv.aff_mul(A.form, A.form, self.budget,
                                 self.condense_rank), 1)
        Iq = iv.square(A.exact)
        # squares are exactly nonnegative; iv.square's outward rounding
        # turns a 0 endpoint negative, which would defeat _round_iv's sign
        # preservation and ultimately the norm rsqrt guards
        I = self._round_iv(iv.Interval(torch.clamp(Iq.lo, min=0.0), Iq.hi),
                           1)
        return self._out(f, I)

    def div(self, a, b):
        A, B = self._lift(a), self._lift(b)
        I = self._round_iv(iv.div(A.exact, B.exact), 1)
        return self._out(self._refit(I, A.val / B.val), I)

    # -- nonlinear unaries (interval rule; form refits on the reference) ----
    def _fb_unary(self, a, ivl_fn, val_fn, rounds=1):
        A = self._lift(a)
        I = self._round_iv(ivl_fn(A.exact), rounds)
        return self._out(self._refit(I, val_fn(A.val)), I)

    def tanh(self, a): return self._fb_unary(a, iv.tanh, torch.tanh)
    def sigmoid(self, a): return self._fb_unary(a, iv.sigmoid, torch.sigmoid)
    def exp(self, a): return self._fb_unary(a, iv.exp, torch.exp)
    def log(self, a): return self._fb_unary(a, iv.log, torch.log)
    def sqrt(self, a): return self._fb_unary(a, iv.sqrt, torch.sqrt)

    def rsqrt(self, a):
        return self._fb_unary(a, lambda t: iv.recip(iv.sqrt(t)),
                              torch.rsqrt, rounds=2)

    def relu(self, a):
        # exact in FP: selection, no rounding
        A = self._lift(a)
        I = iv.clamp_min(A.exact, 0.0)
        return self._out(self._refit(I, torch.relu(A.val)), I)

    def silu(self, a): return self._fb_unary(a, iv.silu, F.silu, rounds=3)

    def gelu(self, a):
        return self._fb_unary(
            a, iv.gelu_tanh, lambda x: F.gelu(x, approximate="tanh"),
            rounds=4)

    def softmax(self, a, dim: int = -1):
        A = self._lift(a)
        # max-shift + exp + sum + div per output: 4 elementary roundings
        I = self._round_iv(iv.softmax_range(A.exact, axis=dim), 4)
        c = torch.softmax(A.val.to(torch.float64), dim=dim)
        return self._out(self._refit(I, c), I)

    # -- contractions (symbols of distinct elements mix → interval rule) ----
    def matmul(self, a, b):
        A, B = self._lift(a), self._lift(b)
        Ia = self._round_iv(A.exact, 1)   # operand requant into this scope
        Ib = self._round_iv(B.exact, 1)
        n = int(A.shape[-1])
        I = self._round_iv(iv.matmul(Ia, Ib), n + 2)
        return self._out(self._refit(I, torch.matmul(A.val, B.val)), I)

    def einsum(self, subscripts, a, b):
        A, B = self._lift(a), self._lift(b)
        Ia = self._round_iv(A.exact, 1)
        Ib = self._round_iv(B.exact, 1)
        n = _einsum_contract_length(subscripts, A.shape, B.shape)
        I = self._round_iv(iv.einsum_ball(subscripts, Ia, Ib), n + 2)
        return self._out(
            self._refit(I, torch.einsum(subscripts, A.val, B.val)), I)

    def sum(self, a, dim, keepdim: bool = False):
        A = self._lift(a)
        Ia = self._round_iv(A.exact, 1)
        n = _reduced_count(A.shape, dim)
        I = self._round_iv(iv.sum_(Ia, axis=dim, keepdims=keepdim), n + 1)
        c = torch.sum(A.val, dim=_all_dims(A.val, dim), keepdim=keepdim)
        return self._out(self._refit(I, c), I)

    def mean(self, a, dim, keepdim: bool = False):
        # sum-then-scale: the accumulation's n·η absolute slop must be
        # charged on the SUM and divided down with it — charging it on the
        # mean directly is n× too wide, enough to push mean(x²)+eps through
        # zero and blow up every norm's rsqrt
        A = self._lift(a)
        Ia = self._round_iv(A.exact, 1)
        n = _reduced_count(A.shape, dim)
        Is = self._round_iv(iv.sum_(Ia, axis=dim, keepdims=keepdim), n - 1)
        I = self._round_iv(iv.scale(Is, 1.0 / n), 1)
        c = torch.mean(A.val, dim=_all_dims(A.val, dim), keepdim=keepdim)
        return self._out(self._refit(I, c), I)

    def max(self, a, dim, keepdim: bool = False):
        A = self._lift(a)
        I = iv.max_(A.exact, axis=dim, keepdims=keepdim)
        c = torch.amax(A.val.to(torch.float64), dim=_all_dims(A.val, dim),
                       keepdim=keepdim)
        return self._out(self._refit(I, c), I)

    def maximum(self, a, b):
        A, B = self._lift(a), self._lift(b)
        I = iv.maximum(A.exact, B.exact)
        return self._out(self._refit(I, torch.maximum(A.val, B.val)), I)

    def where(self, mask, a, b):
        m = mask.val if isinstance(mask, (AffTensor, CaaTensor)) else mask
        A, B = self._lift(a), self._lift(b)
        f = iv.aff_where(m, A.form, B.form, self.budget,
                         self.condense_rank)
        Ea, Eb = A.exact, B.exact
        I = iv.Interval(torch.where(m, Ea.lo, Eb.lo),
                        torch.where(m, Ea.hi, Eb.hi))
        return self._out(f, I)

    def top_k_mask(self, scores, k: int, name: str = "router"):
        s = self._lift(scores, observe=False)
        _, idx = torch.topk(s.val, k)
        return F.one_hot(idx, int(s.shape[-1])).to(torch.float64).sum(-2)

    # -- structure (exact movement: both channels shuffled in place) --------
    def _struct_out(self, a, fn) -> AffTensor:
        A = self._lift(a, observe=False)
        f = iv._aff_broadcast(A.form, A.shape)
        lo = torch.broadcast_to(A.ivl.lo, A.shape)
        hi = torch.broadcast_to(A.ivl.hi, A.shape)
        return self._out(_aff_struct(f, fn),
                         iv.Interval(fn(lo, False), fn(hi, False)))

    def reshape(self, a, shape):
        shape = tuple(shape)
        return self._struct_out(a, lambda t, terms: t.reshape(
            (t.shape[0],) + shape if terms else shape))

    def transpose(self, a, dims):
        dims = tuple(dims)
        tdims = (0,) + tuple(d + 1 for d in dims)
        return self._struct_out(a, lambda t, terms: t.permute(
            tdims if terms else dims))

    def broadcast_to(self, a, shape):
        A = self._lift(a, observe=False)
        return self._out(
            iv._aff_broadcast(A.form, shape),
            iv.Interval(torch.broadcast_to(A.ivl.lo, shape),
                        torch.broadcast_to(A.ivl.hi, shape)))

    def take(self, a, idx, dim: int = 0):
        tdim = dim + 1 if dim >= 0 else dim  # terms lead with the slot dim
        return self._struct_out(a, lambda t, terms: caa.take_along(
            t, idx, tdim if terms else dim))

    def slice(self, a, slices):
        sl = (tuple(slices) if isinstance(slices, (tuple, list))
              else (slices,))
        return self._struct_out(
            a, lambda t, terms: t[(slice(None),) + sl if terms else sl])

    def concat(self, parts, dim):
        ts = [self._lift(p) for p in parts]
        forms = [iv._aff_broadcast(t.form, t.shape) for t in ts]
        out = forms[0]
        tdim = dim + 1 if dim >= 0 else dim
        for f in forms[1:]:
            ids, ta, tb = iv._aff_common(out, f)
            out = iv.aff_condense(iv.AffineForm(
                torch.cat([out.center, f.center], dim=dim),
                torch.cat([ta, tb], dim=tdim), ids,
                torch.cat([out.rad, f.rad], dim=dim)), self.budget,
                self.condense_rank)
        I = iv.Interval(
            torch.cat([torch.broadcast_to(t.ivl.lo, t.shape) for t in ts],
                      dim=dim),
            torch.cat([torch.broadcast_to(t.ivl.hi, t.shape) for t in ts],
                      dim=dim))
        return self._out(out, I)

    def shape_of(self, a):
        return tuple(self._lift(a, observe=False).shape)

    def value_of(self, a):
        return self._lift(a, observe=False).val

    def clamp_range(self, a, lo, hi):
        A = self._lift(a, observe=False)
        lo = torch.as_tensor(lo, dtype=torch.float64, device=A.device)
        hi = torch.as_tensor(hi, dtype=torch.float64, device=A.device)
        f = iv.aff_intersect(A.form, iv.Interval(lo, hi))
        nlo = torch.maximum(torch.broadcast_to(A.ivl.lo, A.shape), lo)
        nhi = torch.minimum(torch.broadcast_to(A.ivl.hi, A.shape), hi)
        bad = nlo > nhi   # wrong external bound: keep the original channel
        I = iv.Interval(torch.where(bad, A.ivl.lo, nlo),
                        torch.where(bad, A.ivl.hi, nhi))
        return self._out(f, I)

    def record(self, name: str, a, kind: str = "layer", **extra):
        return a


def _canon_aff(t: AffTensor) -> AffTensor:
    """Broadcast every field to center's shape (views) — the stack's carry
    keeps one shape across layers (the affine twin of :func:`_canon_caa`)."""
    f = t.form
    shape = f.shape
    form = iv.AffineForm(
        f.center.to(torch.float64),
        torch.broadcast_to(f.terms.to(torch.float64), (f.budget,) + shape),
        f.ids.to(torch.int32),
        torch.broadcast_to(f.rad.to(torch.float64), shape))
    I = iv.Interval(torch.broadcast_to(t.ivl.lo.to(torch.float64), shape),
                    torch.broadcast_to(t.ivl.hi.to(torch.float64), shape))
    return AffTensor(form, I)


class StackedAffineRangeCaaOps(AffineRangeCaaOps):
    """Layer-stacked affine range pass: ``layer_loop`` runs the stack as
    the one wildcard scope, its range evidence in ``[L, S, 4]`` lanes on
    the device (S = one layer-direct lane plus one per ``sublanes`` name)
    and its formats in per-suffix ``[L]`` (u/2, η) lanes, as in
    :class:`StackedRangeCaaOps` / :class:`StackedCaaOps`; ops outside the
    stack run eagerly into ``scope_ranges`` as in the parent class. The one
    symbol counter runs on through the stack in op order, so every layer's
    roundings get ids of their own (the reference's scan threads the same
    counter through its carry: aliased ids across layers would cancel
    independent errors)."""

    def __init__(self, scope_fmts: Dict[str, Any], default_fmt,
                 budget: int = iv.AFF_DEFAULT_BUDGET,
                 weights_exact: bool = True,
                 sublanes: Sequence[str] = (),
                 condense_rank: str = iv.AFF_DEFAULT_RANK):
        super().__init__(scope_fmts, default_fmt, budget=budget,
                         weights_exact=weights_exact,
                         condense_rank=condense_rank)
        self._sublanes = tuple(sublanes)
        self._sub_map = {s: j + 1 for j, s in enumerate(self._sublanes)}
        self._in_stack = False
        self._layer_index = None
        self._stack_ctx = None
        self._lane_cache: Dict[tuple, tuple] = {}
        self._lane_acc = None
        self._done_lanes: List[torch.Tensor] = []

    # -- stack plumbing ------------------------------------------------------
    def _stack_suffix(self) -> tuple:
        outer, _ = self._stack_ctx
        return tuple(self._scope[len(outer) + 1:])

    def _sub_idx(self) -> int:
        if self._stack_ctx is None or not self._sub_map:
            return 0
        suffix = self._stack_suffix()
        return self._sub_map.get(suffix[0], 0) if suffix else 0

    def _fmt_lanes(self, suffix: tuple):
        """Per-layer (u/2, η) lanes for one sub-layer suffix."""
        cached = self._lane_cache.get(suffix)
        if cached is None:
            outer, n_layers = self._stack_ctx
            fmts = [resolve_scope_value(outer + [f"layer{i}", *suffix],
                                        self._fmts, self._default_fmt)
                    for i in range(n_layers)]
            cached = (_lane(0.5 * f.u for f in fmts),
                      _lane(f.underflow_unit for f in fmts))
            self._lane_cache[suffix] = cached
        return cached

    def _hu_eta(self):
        if self._in_stack and self._stack_ctx is not None:
            hu_vec, eta_vec = self._fmt_lanes(self._stack_suffix())
            i = self._layer_index
            return float(hu_vec[i]), float(eta_vec[i])
        return super()._hu_eta()

    def _observe(self, t: AffTensor, is_op: bool):
        if not self._in_stack:
            return super()._observe(t, is_op)
        ivl = self._requant_interval(t)
        stat = _range_row(ivl.lo, ivl.hi, t.shape, is_op)
        i, j = self._layer_index, self._sub_idx()
        self._lane_acc[i, j] = _merge_acc(self._lane_acc[i, j], stat)

    # -- the stack -----------------------------------------------------------
    def layer_loop(self, fn, stacked_params, x, n_layers: int, aux=None):
        if self._in_stack:
            return super().layer_loop(fn, stacked_params, x, n_layers, aux)
        outer = list(self._scope)
        x = _canon_aff(self._lift(x, observe=False))
        with self.scope(STACK_SCOPE):
            self._stack_ctx = (outer, n_layers)
            self._lane_cache = {}
            self._lane_acc = torch.tensor(
                _ACC_INIT, dtype=torch.float64, device=x.device).repeat(
                n_layers, 1 + len(self._sublanes), 1)
            self._in_stack = True
            try:
                for i in range(n_layers):
                    self._layer_index = i
                    new_x = fn(_tree_index(stacked_params, i), x, i,
                               _tree_index(aux, i))
                    x = _canon_aff(self._lift(new_x, observe=False))
            finally:
                self._in_stack = False
                self._layer_index = None
                self._stack_ctx = None
            self._done_lanes.append(self._lane_acc)
            self._lane_acc = None
        return x

    def collect_ranges(self) -> Dict[str, RangeStat]:
        """Concretised lanes (``layer{i}`` / ``layer{i}/{sub}`` keys)
        merged with the eager outside-the-stack ``scope_ranges``."""
        out: Dict[str, RangeStat] = {}
        for lanes in self._done_lanes:
            _lane_stats(lanes, self._sublanes, out)
        for key, s in self.scope_ranges.items():
            key = "" if key.startswith(STACK_SCOPE) else key
            out[key] = s if key not in out else out[key].merge(s)
        out.setdefault("", RangeStat())
        return out
