"""Training step builder and entry point (PyTorch) — the counterpart of
the JAX package's ``repro.launch.train``.

``build_train_step(cfg, tc, device)`` returns ``(step_fn, init_fn)``: the
loss (:func:`repro_torch.models.transformer.next_token_loss`) and its
gradients by autograd, optional int8 error-feedback gradient compression
(:mod:`repro_torch.optim.grad_compress`), then AdamW with f32 or 8-bit
moments (:mod:`repro_torch.optim.optimizer`). With ``remat`` (the default,
as in the reference) each layer is checkpointed
(``torch.utils.checkpoint``, non-reentrant): its activations are recomputed
in the backward pass, bit for bit, instead of being kept.

The step runs under ``torch.use_deterministic_algorithms(True)`` (restored
on exit), so that a run, a resumed run and a rematerialised layer give the
same bits on the card: the embedding's backward (an accumulating index
put) is otherwise not deterministic on CUDA. cuBLAS is given its
deterministic workspace setting (``CUBLAS_WORKSPACE_CONFIG``) by ``main``
before any work on the card; a program that drives the step itself sets
it likewise. On the card the model's
kernel routes step aside under autograd
(:func:`repro_torch.core.backend.kernel_route_ok`): training launches none
of the port's kernels, as the reference trains through plain XLA ops.

The data stream is :mod:`repro_torch.data.pipeline`'s, the reference's bit
for bit; checkpoints are :mod:`repro_torch.checkpoint.checkpointing`'s, in
the reference's layout. A checkpoint is labelled with the number of steps
it holds (its ``opt.step``), and ``--resume`` continues the stream from
there.

On a mesh (``build_train_step(..., mesh=)``, a DeviceMesh from
:mod:`repro_torch.launch.mesh`) each rank keeps its block of every leaf of
the state, placed by the reference's rules: ``param_sharding`` "fsdp"
splits the params over every axis (``shard_params``), "tp" over "model"
only (``model_only``), "auto" picks "tp" for a dense model up to 40e9
params and "fsdp" otherwise; the moments follow their params
(:func:`opt_specs`, the reference's ``_opt_shardings``). A step runs the
loss on this rank's rows of the batch (``shard_batch``) and differentiates
it with respect to this rank's blocks, as the reference's scan does: a
stacked leaf's layer slice is gathered whole inside that layer's
checkpointed region (:class:`MeshRematTorchOps`; the recompute gathers it
again), the other leaves once before the loss; each gather's backward
averages the whole gradient over the data-parallel axes, runs it through
the EF codec with its residual's slice, keeps its norm partials and
hands back this rank's block (:class:`MeshGrads`). The remat carry is
kept split over "model" (the reference's ``_residual_constraint``). Then
the clip from the partials, in the meshless order, and AdamW on this
rank's blocks (:func:`update_blocks`). Both codecs quantise blocks of the
flattened leaf (256 values for EF, 128 for 8-bit moments): a stacked leaf
whose layer slice is whole blocks is coded a layer at a time, any other
leaf whole. ``main`` trains on one device, without a mesh.

CLI (``--device cpu`` on the CPU; a missing card raises otherwise)::

    python -m repro_torch.launch.train --size full --max-layers 2 \\
        --seq 512 --global-batch 4 --steps 6 --checkpoint-dir /tmp/ck \\
        --checkpoint-every 3
    python -m repro_torch.launch.train ... --resume
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
import os
import statistics
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch import configs
from repro_torch.checkpoint.checkpointing import Checkpointer
from repro_torch.core.backend import TorchOps, gather_over
from repro_torch.data import pipeline
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.serve import configure_precision, resolve_device
from repro_torch.models import transformer as T
from repro_torch.optim import grad_compress as gc
from repro_torch.optim import optimizer as opt
from repro_torch.parallel import sharding


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Field for field the reference's ``TrainConfig``."""

    arch: str = "qwen2_7b"
    smoke: bool = True
    seq: int = 128
    global_batch: int = 8
    steps: int = 50
    compute_dtype: str = "float32"
    remat: bool = True
    quantized_moments: bool = False
    grad_compression: bool = False
    # "fsdp" / "tp" / "auto": the params' placement on a mesh
    param_sharding: str = "auto"
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 20
    seed: int = 0


class RematTorchOps(TorchOps):
    """TorchOps whose layer loop checkpoints each layer (full remat): the
    counterpart of the reference's ``RematJOps``. Under autograd a layer's
    forward keeps only its inputs, and the backward recomputes it; outside
    autograd the loop is the plain one. The residual between layers and
    the queries pass the reference's sharding hints (``act_batch``,
    ``q_seq``; :meth:`Backend.shard_hint`)."""

    def layer_loop(self, fn, stacked_params, x, n_layers: int, aux=None):
        if not torch.is_grad_enabled():
            return super().layer_loop(fn, stacked_params, x, n_layers, aux)
        for i in range(n_layers):
            with self.scope(f"layer{i}"):
                x = torch.utils.checkpoint.checkpoint(
                    fn, self.layer_params(stacked_params, i), x, i,
                    self.layer_params(aux, i), use_reentrant=False)
            x = self.shard_hint(x, "act_batch")
        return x


class MeshRematTorchOps(RematTorchOps):
    """RematTorchOps in a mesh step (:func:`build_train_step`): each
    layer's params are gathered inside its checkpointed region
    (:class:`LayerBlocks`), so a layer's whole params live only while its
    forward or its recompute runs, and the region keeps this rank's slice
    of the residual carry's feature dim when "model" (> 1) divides it (the
    reference's ``_residual_constraint``), gathered whole again for the
    recompute: exact. The layer's output stays whole: every model rank
    computes it. The mesh is kept as ``train_mesh``: the serving paths
    (MoE's ``ep_shard_map``) read a backend's ``mesh``."""

    def __init__(self, compute_dtype=torch.float32, *, mesh):
        super().__init__(compute_dtype)
        self.train_mesh = mesh

    def layer_loop(self, fn, stacked_params, x, n_layers: int, aux=None):
        if not torch.is_grad_enabled():
            return super().layer_loop(fn, stacked_params, x, n_layers, aux)
        for i in range(n_layers):
            part = self._carry_part(x)
            held = {"x": x, "split": part is not None}
            with self.scope(f"layer{i}"):
                x = torch.utils.checkpoint.checkpoint(
                    self._layer, fn, stacked_params,
                    x if part is None else part, i, aux, held,
                    use_reentrant=False)
            x = self.shard_hint(x, "act_batch")
        return x

    def _carry_part(self, x):
        """This rank's slice of the carry's feature dim, or None where
        "model" does not split it."""
        m = meshlib.axis_size(self.train_mesh, "model")
        d = x.shape[-1]
        if x.dim() != 3 or m <= 1 or d % m:
            return None
        names = self.train_mesh.mesh_dim_names
        r = self.train_mesh.get_coordinate()[names.index("model")]
        return x.detach()[..., r * (d // m):(r + 1) * (d // m)].clone()

    def _layer(self, fn, stacked_params, part, i, aux, held):
        # the forward reads the carry itself; the recompute gets its saved
        # part (checkpoint keeps its tensor arguments), gathered whole
        x = held.pop("x", None)
        if x is None:
            x = part
            if held["split"]:
                x = gather_over(part, part.dim() - 1, self.train_mesh,
                                "model").requires_grad_(True)
        return fn(self.layer_params(stacked_params, i), x, i,
                  self.layer_params(aux, i))


def _backend(tc: TrainConfig, remat: Optional[bool] = None,
             mesh=None) -> TorchOps:
    dt = torch.bfloat16 if tc.compute_dtype == "bfloat16" else torch.float32
    if not (tc.remat if remat is None else remat):
        return TorchOps(dt)
    if mesh is not None:
        return MeshRematTorchOps(dt, mesh=mesh)
    return RematTorchOps(dt)


def make_loss_fn(arch_cfg, tc: TrainConfig, mesh=None):
    """The loss of a train state's params and a batch; ``mesh``: the loss
    of a mesh step (:class:`MeshRematTorchOps` under remat)."""
    bk = _backend(tc, mesh=mesh)

    def loss_fn(params, batch):
        kwargs = {}
        if arch_cfg.frontend == "audio":
            kwargs["enc_embeds"] = batch["frontend"]
        elif arch_cfg.frontend == "vision":
            kwargs["frontend_embeds"] = batch["frontend"]
        return T.next_token_loss(bk, params, arch_cfg, batch["tokens"],
                                 batch["targets"], **kwargs)

    return loss_fn


# cuBLAS reads its workspace setting once, at its first call in the
# process; PyTorch's deterministic mode refuses a GEMM on the card unless
# the variable holds a deterministic setting. ``main`` sets it first thing.
CUBLAS_WORKSPACE_CONFIG = ":4096:8"


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` inside, the previous
    setting restored on exit. On the card the process must have set
    ``CUBLAS_WORKSPACE_CONFIG`` (to CUBLAS_WORKSPACE_CONFIG) before its
    first cuBLAS call, as ``main`` does."""
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def loss_and_grads(loss_fn, params, batch):
    """(loss, grads) of ``loss_fn(params, batch)`` by autograd; ``grads``
    has the structure of ``params``."""
    paths = list(opt.tree_paths(params))
    leaves = [p.detach().requires_grad_(True) for _, p in paths]
    live: Dict[str, Any] = {}
    for (path, _), leaf in zip(paths, leaves):
        opt.tree_set(live, path, leaf)
    loss = loss_fn(live, batch)
    grads: Dict[str, Any] = {}
    for (path, _), g in zip(paths, torch.autograd.grad(loss, leaves)):
        opt.tree_set(grads, path, g)
    return loss.detach(), grads


def sharding_mode(arch_cfg, tc: TrainConfig) -> str:
    """``tc.param_sharding``, "auto" resolved as the reference resolves it:
    "tp" for a dense model up to 40e9 params, else "fsdp"."""
    mode = tc.param_sharding
    if mode == "auto":
        dense_small = (arch_cfg.family != "moe"
                       and T.analytic_params(arch_cfg) <= 40e9)
        mode = "tp" if dense_small else "fsdp"
    if mode not in ("fsdp", "tp"):
        raise ValueError(f"unknown param_sharding {tc.param_sharding!r}")
    return mode


def opt_specs(opt_state: opt.OptState, p_specs, mesh) -> opt.OptState:
    """The optimizer state's specs (the reference's ``_opt_shardings``):
    moments take their params' specs where the ranks match; quantised
    payloads and scales ([blocks, block]) the greedy rule; the step count
    is whole."""
    def for_tree(ms, like_params: bool):
        def one(keys, leaf):
            if like_params:
                ref = p_specs
                for k in keys:
                    ref = ref[k]
                if len(ref) == leaf.dim():
                    return ref
            return sharding._greedy_param_spec(tuple(leaf.shape), mesh,
                                               stacked=False)
        return sharding.map_with_path(one, ms)

    quant = opt_state.m_scale is not None
    return opt.OptState(
        step=(), m=for_tree(opt_state.m, not quant),
        v=for_tree(opt_state.v, not quant),
        m_scale=None if not quant else for_tree(opt_state.m_scale, False),
        v_scale=None if not quant else for_tree(opt_state.v_scale, False))


def state_specs(state: dict, arch_cfg, tc: TrainConfig, mesh) -> dict:
    """Specs of a train state: params by ``param_sharding``, the
    optimizer by :func:`opt_specs`, the EF residuals as the params."""
    p_specs = sharding.shard_params(state["params"], mesh,
                                    model_only=sharding_mode(arch_cfg, tc)
                                    == "tp")
    return {"params": p_specs,
            "opt": opt_specs(state["opt"], p_specs, mesh),
            "ef": None if state["ef"] is None else p_specs}


def _state_map(fn, state, specs=None):
    """``fn(leaf, spec)`` over a train state's tensor leaves (``spec``
    None without a spec tree)."""
    def tree(t, sp):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: tree(t[k], None if sp is None else sp[k]) for k in t}
        return fn(t, sp)

    o = state["opt"]
    so = None if specs is None else specs["opt"]
    return {"params": tree(state["params"],
                           None if specs is None else specs["params"]),
            "opt": opt.OptState(*(tree(getattr(o, f), None if so is None
                                       else getattr(so, f))
                                  for f in opt.OptState._fields)),
            "ef": None if state["ef"] is None else gc.EFState(tree(
                state["ef"].residual, None if specs is None
                else specs["ef"]))}


def place_state(state: dict, specs: dict, mesh) -> dict:
    """The train state as DTensors on ``mesh``: each rank keeps its block of
    every leaf (the step count whole)."""
    return _state_map(lambda t, spec: sharding.place_one(t, spec, mesh),
                      state, specs)


def _dp_mean(t, mesh, axes):
    """The mean of ``t`` over the data-parallel ``axes`` (sum, then one
    division by the rank count), in a copy; ``t`` itself where they have
    size 1."""
    import torch.distributed as dist

    live = [ax for ax in axes if meshlib.axis_size(mesh, ax) > 1]
    if not live:
        return t
    t = t.clone()
    n = 1
    for ax in live:
        dist.all_reduce(t, group=mesh.get_group(ax))
        n *= meshlib.axis_size(mesh, ax)
    return t.div_(n)


def whole_of(block, spec, mesh):
    """The whole tensor of this rank's ``block`` under ``spec``: gathered
    over each axis of size > 1 that splits it (a dim split over several
    axes innermost first, as :func:`sharding.local_block` cuts it), in
    rank order: exact. ``block`` itself where no such axis splits it."""
    out = block
    for d, entry in enumerate(spec):
        for ax in reversed(sharding._axes(entry)):
            out = gather_over(out, d, mesh, ax)
    return out


class MeshGrads:
    """One mesh step's gradient pass, run slice by slice inside the
    backward (:class:`_Gather`): a param's or a layer slice's whole
    gradient averaged over the data-parallel axes, through the EF codec
    with that slice of its residual (``ef``: the residual tree, or None),
    its norm partials kept (one a layer, as :func:`opt.global_norm` forms
    them: every rank forms the same), and this rank's block handed
    back. :meth:`loss_and_grads` builds the loss's param tree from this
    rank's blocks."""

    def __init__(self, mesh, ef=None):
        self.mesh = mesh
        self.dp = meshlib.data_axes(mesh)
        self.ef = ef
        self.partials: Dict[tuple, torch.Tensor] = {}

    def per_layer(self, path, leaf) -> bool:
        """Whether the stacked leaf at ``path`` is gathered a layer at a
        time: always without EF, else where its layer slice is whole
        codec blocks. Any other leaf is gathered whole once."""
        if not opt.is_stacked(path):
            return False
        return (self.ef is None
                or math.prod(leaf.shape[1:]) % gc.BLOCK == 0)

    def loss_and_grads(self, loss_fn, params, batch):
        """(loss on this rank's rows, this rank's blocks of the processed
        gradients) of ``loss_fn`` over the placed ``params``."""
        paths = list(opt.tree_paths(params))
        blocks = [p.to_local().detach().requires_grad_(True)
                  for _, p in paths]
        live: Dict[str, Any] = {}
        for (path, p), b in zip(paths, blocks):
            spec = _spec_of(p)
            if self.per_layer(path, p):
                leaf = LayerBlocks(b, self, path, spec[1:])
            else:
                leaf = _Gather.apply(b, self, path, None, spec)
            opt.tree_set(live, path, leaf)
        loss = loss_fn(live, batch)
        del live
        grads: Dict[str, Any] = {}
        for (path, _), g in zip(paths, torch.autograd.grad(loss, blocks)):
            opt.tree_set(grads, path, g)
        return loss.detach(), grads

    def reduce(self, g, path, layer, spec):
        """This rank's block of the whole gradient ``g`` of ``path`` (of
        its layer ``layer``, or the whole leaf for None), processed."""
        g = _dp_mean(g.contiguous(), self.mesh, self.dp)
        if self.ef is not None:
            r = opt._get(self.ef, path).to_local()
            if layer is not None:
                r = r[layer]
            g, new_r = gc.compress_leaf(g, whole_of(r, spec, self.mesh))
            r.copy_(sharding.local_block(new_r, spec, self.mesh))
        if layer is None and opt.is_stacked(path):
            for i in range(g.shape[0]):
                self.partials[(path, i)] = opt.square_sum(g[i])
        else:
            self.partials[(path, layer)] = opt.square_sum(g)
        block = sharding.local_block(g, spec, self.mesh)
        return block.clone() if block.numel() < g.numel() else block

    def norm(self, params) -> torch.Tensor:
        """The global norm from the partials, added in the meshless order
        (:func:`opt.partial_keys`). A slice whose gather fed nothing has
        no partial; the meshless sum adds its exact zero."""
        return opt.norm_of_partials(self.partials[k]
                                    for k in opt.partial_keys(params)
                                    if k in self.partials)


class LayerBlocks:
    """A stacked leaf in a mesh step's loss: this rank's block, of which
    indexing layer ``i`` (the backend's ``layer_params``) gathers that
    layer's slice whole (:class:`_Gather`)."""

    def __init__(self, block, grads: MeshGrads, path, spec):
        self.block, self.grads, self.path, self.spec = (block, grads, path,
                                                        spec)

    def __getitem__(self, i: int):
        return _Gather.apply(self.block[i], self.grads, self.path, i,
                             self.spec)


class _Gather(torch.autograd.Function):
    """Forward: this rank's block whole (:func:`whole_of`). Backward: the
    whole gradient through the step's gradient pass
    (:meth:`MeshGrads.reduce`), which hands back this rank's block."""

    @staticmethod
    def forward(ctx, block, grads, path, layer, spec):
        ctx.args = (grads, path, layer, spec)
        whole = whole_of(block, spec, grads.mesh)
        return block.view_as(block) if whole is block else whole

    @staticmethod
    def backward(ctx, g):
        grads, path, layer, spec = ctx.args
        return (grads.reduce(g, path, layer, spec),) + (None,) * 4


def build_train_step(arch_cfg, tc: TrainConfig, device,
                     adam_cfg: Optional[opt.AdamWConfig] = None, mesh=None):
    """Returns (step_fn, init_fn). ``init_fn(generator)`` draws the
    parameters with the port's ``init_params`` (``generator`` on
    ``device``) and zero optimizer (and EF) state. ``step_fn(state,
    batch)`` returns (state, loss); it updates ``state``'s tensors in place
    (the reference donates them). Its phases are profiler ranges
    (``train::loss_and_grads``, ``train::compress``, ``train::update``):
    ``tools/train_step_split.py`` splits a step's device time by them.

    With ``mesh`` the state's leaves are DTensors placed by
    ``param_sharding`` (:func:`state_specs`); a step takes the whole
    ``batch`` (the same on every rank) and runs this rank's rows of it,
    gathering a layer at a time (:class:`MeshGrads`); the EF codec runs
    inside its backward, under ``train::loss_and_grads``."""
    adam_cfg = adam_cfg or opt.AdamWConfig(
        quantized_moments=tc.quantized_moments, total_steps=tc.steps)
    loss_fn = make_loss_fn(arch_cfg, tc)
    mesh_loss_fn = None if mesh is None else make_loss_fn(arch_cfg, tc,
                                                          mesh=mesh)

    def init_fn(generator: torch.Generator):
        params = T.init_params(arch_cfg, generator=generator, device=device)
        state = init_state(params, tc, adam_cfg)
        if mesh is None:
            return state
        return place_state(state, state_specs(state, arch_cfg, tc, mesh),
                           mesh)

    def update(state, batch):
        with record_function("train::loss_and_grads"):
            loss, grads = loss_and_grads(loss_fn, state["params"], batch)
        if tc.grad_compression:
            with record_function("train::compress"):
                grads, state["ef"] = gc.compress_tree(grads, state["ef"])
        with record_function("train::update"):
            opt.update(state["params"], grads, state["opt"], adam_cfg,
                       inplace=True)
        return loss

    def mesh_update(state, batch):
        rows = sharding.batch_spec(mesh, tc.global_batch, tc.seq)[0]
        mine = {k: sharding.local_block(v, (rows,), mesh)
                for k, v in batch.items()}
        ef = state["ef"]
        grads_pass = MeshGrads(mesh, None if ef is None else ef.residual)
        with record_function("train::loss_and_grads"):
            loss, grads = grads_pass.loss_and_grads(mesh_loss_fn,
                                                    state["params"], mine)
        loss = _dp_mean(loss, mesh, grads_pass.dp)
        clip = opt.clip_of_norm(grads_pass.norm(state["params"]), adam_cfg)
        with record_function("train::update"):
            update_blocks(state, grads, clip, adam_cfg, mesh)
        return loss

    def step_fn(state, batch):
        with deterministic():
            loss = (update if mesh is None else mesh_update)(state, batch)
        return state, loss

    return step_fn, init_fn


def update_blocks(state: dict, grads, clip, adam_cfg: opt.AdamWConfig,
                  mesh):
    """AdamW on a placed train state, in place, from this rank's blocks of
    the processed gradients ``grads`` and the clip factor ``clip``: each
    leaf on this rank's blocks of its param, gradient and f32 moments.
    8-bit moments are quantised in blocks of the flattened leaf, which do
    not follow the leaf's split: a stacked leaf whose layer slice is whole
    blocks is gathered and updated a layer at a time (the slices of param
    and gradient, the rows of payloads and scales), any other leaf whole;
    each rank keeps its blocks. Bit for bit ``opt.update`` of the whole
    state."""
    o = state["opt"]
    count = o.step.to_local()
    step, lr, bc1, bc2 = opt.step_scalars(count, adam_cfg)
    trees = {"p": state["params"], "m": o.m, "v": o.v, "ms": o.m_scale,
             "vs": o.v_scale}
    for path, p in opt.tree_paths(state["params"]):
        dst = {n: opt._get(t, path) for n, t in trees.items()
               if t is not None}
        g = opt._get(grads, path)
        if not adam_cfg.quantized_moments:
            src = {n: t.to_local() for n, t in dst.items()}
            out = opt.update_leaf(adam_cfg, src["p"],
                                  g.to(torch.float32) * clip, src["m"],
                                  src["v"], None, None, lr, bc1, bc2)
            for n, t in out.items():
                src[n].copy_(t)
            continue
        spec = _spec_of(p)
        per = math.prod(p.shape[1:])
        if opt.is_stacked(path) and per % adam_cfg.block == 0:
            rows = per // adam_cfg.block
            for i in range(p.shape[0]):
                _update_8bit(adam_cfg, dst, g[i], clip, spec[1:], i,
                             i * rows, rows, mesh, lr, bc1, bc2)
        else:
            _update_8bit(adam_cfg, dst, g, clip, spec, None, 0,
                         dst["m"].shape[0], mesh, lr, bc1, bc2)
    count.copy_(step)


def _update_8bit(cfg, dst, g, clip, spec, layer, row0, rows, mesh, lr, bc1,
                 bc2):
    """One leaf's (or one layer's slice's) 8-bit AdamW step: the param
    slice and its gradient ``g`` (this rank's blocks under ``spec``) and
    the payloads' and scales' rows [row0, row0 + rows) gathered whole,
    updated, and this rank's blocks of them kept."""
    p_loc = dst["p"].to_local()
    if layer is not None:
        p_loc = p_loc[layer]
    moments = ("m", "v", "ms", "vs")
    out = opt.update_leaf(
        cfg, whole_of(p_loc, spec, mesh),
        whole_of(g, spec, mesh).to(torch.float32) * clip,
        *(_gather_rows(dst[n], row0, row0 + rows) for n in moments),
        lr, bc1, bc2)
    p_loc.copy_(sharding.local_block(out["p"], spec, mesh))
    for n in moments:
        _keep_rows(dst[n], out[n], row0)


def _row_split(t):
    """(the mesh axis that splits a DTensor's dim 0, or None; the rows a
    rank holds; this rank's index along that axis)."""
    mesh = t.device_mesh
    axes = [a for a in sharding._axes(_spec_of(t)[0])
            if meshlib.axis_size(mesh, a) > 1]
    if not axes:
        return None, t.shape[0], 0
    if len(axes) > 1:
        raise NotImplementedError(f"dim 0 split over {axes}")
    n = meshlib.axis_size(mesh, axes[0])
    j = mesh.get_coordinate()[mesh.mesh_dim_names.index(axes[0])]
    return axes[0], t.shape[0] // n, j


def _gather_rows(t, a: int, b: int):
    """Rows [a, b) of the DTensor ``t``, whole: this rank's rows of the
    range gathered over the axes that split the other dims, then each
    holder's piece broadcast over the axis that splits the rows (exact)."""
    import torch.distributed as dist

    mesh = t.device_mesh
    rest = (None,) + _spec_of(t)[1:]
    ax, per, j = _row_split(t)
    loc = t.to_local()
    lo, hi = max(a, j * per), min(b, (j + 1) * per)
    mine = (whole_of(loc[lo - j * per:hi - j * per], rest, mesh)
            if hi > lo else None)
    if ax is None:
        return mine
    group = mesh.get_group(ax)
    pieces = []
    for k in range(a // per, (b - 1) // per + 1):
        if k == j:
            buf = mine.contiguous()
        else:
            n = min(b, (k + 1) * per) - max(a, k * per)
            buf = torch.empty((n,) + tuple(t.shape[1:]), dtype=loc.dtype,
                              device=loc.device)
        dist.broadcast(buf, src=dist.get_global_rank(group, k), group=group)
        pieces.append(buf)
    return torch.cat(pieces)


def _keep_rows(t, rows, a: int):
    """Write this rank's block of the whole rows ``rows`` (rows a, a + 1,
    ... of the DTensor ``t``) into ``t``."""
    mesh = t.device_mesh
    rest = (None,) + _spec_of(t)[1:]
    _, per, j = _row_split(t)
    lo, hi = max(a, j * per), min(a + rows.shape[0], (j + 1) * per)
    if hi > lo:
        t.to_local()[lo - j * per:hi - j * per].copy_(
            sharding.local_block(rows[lo - a:hi - a], rest, mesh))


def _spec_of(t) -> tuple:
    """A DTensor's spec, read back from its placements."""
    spec = [[] for _ in range(t.dim())]
    for name, p in zip(t.device_mesh.mesh_dim_names, t.placements):
        if p.is_shard():
            spec[p.dim].append(name)
    return tuple(sharding._entry(a) for a in spec)


def init_state(params, tc: TrainConfig, adam_cfg: opt.AdamWConfig) -> dict:
    """The train state {"params", "opt", "ef"} around ``params``."""
    return {"params": params, "opt": opt.init(params, adam_cfg),
            "ef": gc.init_ef(params) if tc.grad_compression else None}


def state_template(arch_cfg, tc: TrainConfig, adam_cfg: opt.AdamWConfig):
    """The train state's structure on the meta device (no memory): the
    template a checkpoint is restored into."""
    params = opt.tree_map(lambda shape: torch.empty(shape, device="meta"),
                          T.param_shapes(arch_cfg))
    return init_state(params, tc, adam_cfg)


def batch_for(arch_cfg, dc: pipeline.DataConfig, step: int, device) -> dict:
    """The step's batch: the stateless stream's tokens and, for a modality
    frontend, the stub's inputs drawn from ``RandomState(step)`` as the
    reference's `main` draws them."""
    batch = pipeline.batch_at(dc, step, device)
    if arch_cfg.frontend:
        batch["frontend"] = T.frontend_inputs(
            arch_cfg, dc.global_batch, np.random.RandomState(step), device)
    return batch


@dataclasses.dataclass
class TrainResult:
    losses: Dict[int, float]          # step → loss, the steps this run ran
    step_s: List[float]               # host seconds a step (synchronised)
    tokens_per_s: float               # over the steps after the first
    peak_gb: Optional[float]          # peak device memory (card only)
    state: dict                       # the final train state
    start_step: int = 0
    restore_s: Optional[float] = None
    checkpoints: List[dict] = dataclasses.field(default_factory=list)


def main(argv=None) -> TrainResult:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen2_7b")
    ap.add_argument("--size", choices=("smoke", "full"), default="smoke",
                    help="the arch's SMOKE or FULL (published) config")
    ap.add_argument("--max-layers", type=int, default=None,
                    help="cap the config's layer count (depth cut for "
                         "memory; widths stay the config's)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=20,
                    help="save after every N steps (asynchronously)")
    ap.add_argument("--resume", nargs="?", const="latest", default=None,
                    metavar="STEP",
                    help="restore the latest checkpoint (or STEP's) from "
                         "--checkpoint-dir and continue the stream there")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--quantized-moments", action="store_true")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the weights' generator and the data stream")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.resume and not args.checkpoint_dir:
        ap.error("--resume needs --checkpoint-dir")

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE_CONFIG)
    dev = resolve_device(args.device)
    configure_precision()
    mod = configs.get(args.arch)
    arch_cfg = mod.FULL if args.size == "full" else mod.SMOKE
    if args.max_layers is not None:
        arch_cfg = dataclasses.replace(
            arch_cfg, n_layers=min(args.max_layers, arch_cfg.n_layers))
    tc = TrainConfig(arch=args.arch, smoke=args.size == "smoke",
                     seq=args.seq, global_batch=args.global_batch,
                     steps=args.steps,
                     grad_compression=args.grad_compression,
                     quantized_moments=args.quantized_moments,
                     checkpoint_dir=args.checkpoint_dir,
                     checkpoint_every=args.checkpoint_every, seed=args.seed)
    adam_cfg = opt.AdamWConfig(quantized_moments=tc.quantized_moments,
                               total_steps=tc.steps)
    dc = pipeline.DataConfig(vocab=arch_cfg.vocab, seq=tc.seq,
                             global_batch=tc.global_batch, seed=tc.seed)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    step_fn, init_fn = build_train_step(arch_cfg, tc, dev, adam_cfg)
    ck = Checkpointer(tc.checkpoint_dir) if tc.checkpoint_dir else None
    start, restore_s = 0, None
    if args.resume:
        t0 = time.perf_counter()
        state, manifest = ck.restore(
            state_template(arch_cfg, tc, adam_cfg),
            None if args.resume == "latest" else int(args.resume), dev)
        if cuda:
            torch.cuda.synchronize(dev)
        restore_s = time.perf_counter() - t0
        start = manifest["step"]
        print(f"restored step {start} from {tc.checkpoint_dir} "
              f"({restore_s:.1f}s)")
    else:
        state = init_fn(torch.Generator(device=dev).manual_seed(tc.seed))

    losses: Dict[int, float] = {}
    step_s: List[float] = []
    t_start = time.perf_counter()
    for step in range(start, tc.steps):
        t0 = time.perf_counter()
        state, loss = step_fn(state, batch_for(arch_cfg, dc, step, dev))
        losses[step] = float(loss)          # synchronises the step
        step_s.append(time.perf_counter() - t0)
        if step % 10 == 0 or step == tc.steps - 1:
            print(f"step {step:5d}  loss {losses[step]:.4f}  "
                  f"({time.perf_counter() - t_start:.1f}s)")
        done = step + 1
        if ck and done % tc.checkpoint_every == 0:
            ck.save(done, state, blocking=False)
    if ck:
        ck.wait()
    timed = step_s[1:] or step_s
    tokens = tc.global_batch * tc.seq
    return TrainResult(
        losses=losses, step_s=step_s,
        tokens_per_s=tokens / statistics.median(timed) if timed else 0.0,
        peak_gb=(torch.cuda.max_memory_allocated(dev) / 1e9 if cuda
                 else None),
        state=state, start_step=start, restore_s=restore_s,
        checkpoints=list(ck.stats) if ck else [])


if __name__ == "__main__":
    main()
