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
there. The mesh and its sharding policies (``param_sharding``) wait for the
port's ``launch/mesh.py`` and ``parallel/``: on one device the option has
no effect.

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
import os
import statistics
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch import configs
from repro_torch.checkpoint.checkpointing import Checkpointer
from repro_torch.core.backend import TorchOps, _tree_index
from repro_torch.data import pipeline
from repro_torch.launch.serve import configure_precision, resolve_device
from repro_torch.models import transformer as T
from repro_torch.optim import grad_compress as gc
from repro_torch.optim import optimizer as opt


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
    # "fsdp" / "tp" / "auto" in the reference; no effect on one device
    param_sharding: str = "auto"
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 20
    seed: int = 0


class RematTorchOps(TorchOps):
    """TorchOps whose layer loop checkpoints each layer (full remat): the
    counterpart of the reference's ``RematJOps``. Under autograd a layer's
    forward keeps only its inputs, and the backward recomputes it; outside
    autograd the loop is the plain one. The reference's sharding
    constraints on the residual and the query sequence wait for the
    mesh."""

    def layer_loop(self, fn, stacked_params, x, n_layers: int, aux=None):
        if not torch.is_grad_enabled():
            return super().layer_loop(fn, stacked_params, x, n_layers, aux)
        for i in range(n_layers):
            with self.scope(f"layer{i}"):
                x = torch.utils.checkpoint.checkpoint(
                    fn, _tree_index(stacked_params, i), x, i,
                    _tree_index(aux, i), use_reentrant=False)
        return x


def _backend(tc: TrainConfig, remat: Optional[bool] = None) -> TorchOps:
    dt = torch.bfloat16 if tc.compute_dtype == "bfloat16" else torch.float32
    cls = RematTorchOps if (tc.remat if remat is None else remat) \
        else TorchOps
    return cls(dt)


def make_loss_fn(arch_cfg, tc: TrainConfig):
    bk = _backend(tc)

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


def build_train_step(arch_cfg, tc: TrainConfig, device,
                     adam_cfg: Optional[opt.AdamWConfig] = None):
    """Returns (step_fn, init_fn). ``init_fn(generator)`` draws the
    parameters with the port's ``init_params`` (``generator`` on
    ``device``) and zero optimizer (and EF) state. ``step_fn(state,
    batch)`` returns (state, loss); it updates ``state``'s tensors in place
    (the reference donates them). Its phases are profiler ranges
    (``train::loss_and_grads``, ``train::compress``, ``train::update``):
    ``tools/train_step_split.py`` splits a step's device time by them."""
    adam_cfg = adam_cfg or opt.AdamWConfig(
        quantized_moments=tc.quantized_moments, total_steps=tc.steps)
    loss_fn = make_loss_fn(arch_cfg, tc)

    def init_fn(generator: torch.Generator):
        params = T.init_params(arch_cfg, generator=generator, device=device)
        return init_state(params, tc, adam_cfg)

    def step_fn(state, batch):
        with deterministic():
            with record_function("train::loss_and_grads"):
                loss, grads = loss_and_grads(loss_fn, state["params"], batch)
            if tc.grad_compression:
                with record_function("train::compress"):
                    grads, state["ef"] = gc.compress_tree(grads, state["ef"])
            with record_function("train::update"):
                opt.update(state["params"], grads, state["opt"], adam_cfg,
                           inplace=True)
        return state, loss

    return step_fn, init_fn


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
