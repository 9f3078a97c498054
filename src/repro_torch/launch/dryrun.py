"""Dry run (PyTorch): prove the distribution config holds together at
production size — the counterpart of the JAX package's
``repro.launch.dryrun``.

For every (architecture × input-shape) cell of :mod:`repro_torch.configs`
on the single-pod (16 × 16 = data × model, 256 ranks) and multi-pod
(2 × 16 × 16 = pod × data × model, 512 ranks) production meshes, one step
of the cell's program runs as rank 0 of a fake process group: the port's
own serving steps (:func:`repro_torch.launch.serve.build_serve_steps`) or
training step (:func:`repro_torch.launch.train.build_train_step`), on its
own placements (:mod:`repro_torch.parallel.sharding`), with every tensor
a fake one (``FakeTensorMode``: shapes, dtypes and strides, no storage).
This is the PyTorch counterpart of ``jit(...).lower(...).compile()`` on
512 fake devices: a placement that does not fit, a shape that does not
divide or a collective the step cannot issue raises, and the cell is an
``error``. There is no compiler to ask, so the record is read from the
step as it runs (as rank 0 sees it):

* ``memory`` — ``argument_bytes``: the local blocks of params, optimizer
  state, error-feedback residuals, cache and batch, exact from their
  shapes and dtypes (by part in ``argument_parts``); ``peak_bytes``:
  ``argument_bytes`` plus the most bytes the step's own tensors held at
  once (``torch.distributed._tools.mem_tracker.MemTracker``, which follows
  every storage an op creates until it is freed); ``fits``: whether
  ``peak_bytes`` is at most one NVIDIA H100 SXM's 80 GB (``H100_BYTES``);
* ``cost`` — ``flops``: products only (matmuls, convolutions, attention,
  as ``torch.utils.flop_counter`` counts them; XLA's count also has the
  elementwise work), of the ops on this rank's own tensors; an op on a
  DTensor would count its global shape, so it is counted apart
  (``dtensor_ops``, not in ``flops``); ``bytes_accessed``: each dispatched
  op's operand and result bytes summed, an unfused upper bound;
* ``collectives`` — ``bytes_by_kind``, ``count_by_kind``,
  ``total_bytes``: the collectives the step issues (the explicit
  ``dist.all_gather`` / ``all_reduce`` of the mesh backend and the
  training step, DTensor redistributions' functional collectives), each
  by the bytes of its result on this rank. There is no HLO to parse.

Dry runs need a process group of the mesh's size and nothing else: no
card, no kernel (on fake CPU tensors every backend takes its plain
versions). The fake group is process-global, so a dry run runs in a
process of its own: the CLI, or :func:`run_isolated` (a spawned process).
The same counters run a step on real tensors (``fake=False``) under a real
group, which is how the tests hold the fake census to a gloo run.

CLI::

    python -m repro_torch.launch.dryrun --both-meshes       # 80 records
    python -m repro_torch.launch.dryrun --arch qwen2_7b --shape decode_32k
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch import configs
from repro_torch.configs import SHAPES, ShapeSpec, skip_reason
from repro_torch.core import dtypes
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.serve import ServeConfig, build_serve_steps
from repro_torch.launch.train import TrainConfig, build_train_step
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding

#: one NVIDIA H100 SXM's device memory (80 GB, the data sheet's decimal GB)
H100_BYTES = 80 * 10 ** 9

# archs large enough to need 8-bit Adam moments to fit (the reference's)
_BIG = {"mixtral_8x22b", "llama4_maverick", "gemma2_27b", "command_r_35b"}


def effective_shape(cfg, shape: ShapeSpec) -> ShapeSpec:
    """Architectural caps: Whisper's decoder context is 448, so its cells
    run at the cap (the reference's documented reinterpretation)."""
    if cfg.enc_dec:
        return ShapeSpec(shape.name, shape.kind,
                         min(shape.seq, cfg.max_decode_seq), shape.batch)
    return shape


def _cache_len(cfg, shape: ShapeSpec) -> int:
    """Cached positions of a serving cell: its sequence, after a vision
    prefix's patches."""
    return shape.seq + (cfg.frontend_seq if cfg.frontend == "vision" else 0)


def _spec(shape, dtype):
    """A stand-in of ``shape`` and ``dtype`` (the meta device: no
    storage), the port's ``ShapeDtypeStruct``."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(arch: str, shape_name: str, *, cache_dtype=torch.bfloat16,
                cfg=None, shape: Optional[ShapeSpec] = None,
                cache_len: Optional[int] = None) -> Dict[str, Any]:
    """Stand-ins (meta tensors) for every model input of the cell, the
    reference's shapes and dtypes: ``kind``, ``batch`` and, for serving,
    the ``cache`` (sized for a vision prefix's patches too, or to
    ``cache_len``). ``cfg`` / ``shape``: another config or shape than the
    arch's FULL and ``SHAPES[shape_name]``."""
    cfg = cfg or configs.get(arch).FULL
    shape = effective_shape(cfg, shape or SHAPES[shape_name])
    B, S = shape.batch, shape.seq
    bf16, i32 = torch.bfloat16, torch.int32
    frontend = (_spec((B, cfg.frontend_seq, cfg.frontend_dim), bf16)
                if cfg.frontend else None)
    out: Dict[str, Any] = {"kind": shape.kind}
    if shape.kind == "train":
        out["batch"] = {"tokens": _spec((B, S), i32),
                        "targets": _spec((B, S), i32)}
        if frontend is not None:
            out["batch"]["frontend"] = frontend
        return out
    if cache_len is None:
        cache_len = _cache_len(cfg, shape)
    out["cache"] = {k: _spec(s, i32 if k == "idx" else cache_dtype)
                    for k, s in T.cache_shapes(cfg, B, cache_len).items()}
    if shape.kind == "prefill":
        out["batch"] = {"tokens": _spec((B, S), i32)}
        if frontend is not None:
            out["batch"]["frontend"] = frontend
    else:
        out["batch"] = {"tokens": _spec((B, 1), i32), "pos": _spec((), i32)}
        if cfg.frontend == "audio":
            # decode reuses the prefill-computed encoder states
            out["batch"]["enc_out"] = _spec((B, cfg.frontend_seq,
                                             cfg.d_model), bf16)
    return out


# -- the census of one step -----------------------------------------------

_COLLECTIVE_KINDS = (("all_gather", "all-gather"), ("allgather", "all-gather"),
                     ("reduce_scatter", "reduce-scatter"),
                     ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
                     ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
                     ("broadcast", "broadcast"), ("send", "send"),
                     ("recv", "recv"))


def _collective_kind(func) -> Optional[str]:
    """The kind of a c10d or functional collective op; None for any other
    op (``wait_tensor`` included: it moves nothing)."""
    ns = func.namespace
    if ns not in ("c10d", "_c10d_functional", "c10d_functional"):
        return None
    name = func._overloadpacket.__name__
    for key, kind in _COLLECTIVE_KINDS:
        if key in name:
            return kind
    return None


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class StepCensus(TorchDispatchMode):
    """Counts what one step dispatches: FLOPs of products on plain tensors
    (``torch.utils.flop_counter``'s formulas), the operand and result
    bytes of every op, and each collective's kind and result bytes. An op
    on a DTensor is counted apart (``dtensor_ops``): its shapes are
    global, and the local op under it is not dispatched through this
    mode."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flops = flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.dtensor_ops = 0
        self.bytes_by_kind: Dict[str, int] = {}
        self.count_by_kind: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        if any(_is_dtensor(t) for t in ins):
            self.dtensor_ops += 1
            return out
        outs = _tensors(out)
        kind = _collective_kind(func)
        if kind is not None:
            got = sum(_nbytes(t) for t in outs)
            self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + got
            self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + 1
            return out
        self.bytes_accessed += sum(_nbytes(t) for t in ins + outs)
        count = self._flops.get(func._overloadpacket)
        if count is not None:
            self.flops += int(count(*args, **kwargs, out_val=out))
        return out

    def collectives(self) -> Dict[str, Any]:
        return {"bytes_by_kind": dict(self.bytes_by_kind),
                "count_by_kind": dict(self.count_by_kind),
                "total_bytes": sum(self.bytes_by_kind.values())}


def _local_bytes(tree) -> int:
    """Bytes of this rank's blocks of a tree of tensors and DTensors (meta
    and fake ones by their shapes)."""
    total = 0
    for t in _tensors(tree):
        if _is_dtensor(t):
            t = t.to_local()
        total += _nbytes(t)
    return total


def measured_step(fn, parts: Dict[str, Any], fake: bool):
    """Runs ``fn()`` (one step) under the counters; ``parts`` {name: tree}
    are its arguments, counted by their local blocks. Returns the
    ``memory``, ``cost`` and ``collectives`` records."""
    from torch.distributed._tools.mem_tracker import MemTracker

    arg_parts = {name: _local_bytes(tree) for name, tree in parts.items()}
    census = StepCensus()
    tracker = MemTracker()
    with tracker, census:
        fn()
    temp = 0
    for per_dev in tracker.get_tracker_snapshot("peak").values():
        temp = max(temp, int(per_dev["Total"]))
    args = sum(arg_parts.values())
    peak = args + temp
    return {"memory": {"argument_bytes": args, "argument_parts": arg_parts,
                       "temp_bytes": temp, "peak_bytes": peak,
                       "fits": peak <= H100_BYTES},
            "cost": {"flops": census.flops, "flops_counted": "products only",
                     "bytes_accessed": census.bytes_accessed,
                     "bytes_accessed_is": "unfused upper bound",
                     "dtensor_ops": census.dtensor_ops,
                     "fake_tensors": fake},
            "collectives": census.collectives()}


# -- the mesh and the process group ----------------------------------------

def make_mesh(shape: Tuple[int, ...], device: str = "cpu"):
    """A DeviceMesh of ``shape`` (2-d: ("data", "model"); 3-d: ("pod",
    "data", "model")) over the process group's ranks, which must number
    exactly its size: the production meshes through
    :func:`repro_torch.launch.mesh.make_production_mesh`."""
    from torch.distributed.device_mesh import DeviceMesh

    if tuple(shape) in ((16, 16), (2, 16, 16)):
        return meshlib.make_production_mesh(multi_pod=len(shape) == 3,
                                            device=device)
    need = math.prod(shape)
    if dist.get_world_size() != need:
        raise RuntimeError(f"a {tuple(shape)} mesh needs {need} ranks; the "
                           f"process group has {dist.get_world_size()}")
    return DeviceMesh(device, torch.arange(need).reshape(tuple(shape)),
                      mesh_dim_names=("pod", "data", "model")[-len(shape):])


@contextlib.contextmanager
def fake_group(world_size: int, rank: int = 0):
    """A fake process group of ``world_size`` ranks, this process being
    ``rank``, for the block: collectives return at once and move nothing.
    Refuses to start in a process that already has a group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a dry run needs a process of its own: this one "
                           "already has a process group")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# -- one cell --------------------------------------------------------------

def _cell_name(mesh_shape) -> str:
    return {(16, 16): "single", (2, 16, 16): "multi"}.get(
        tuple(mesh_shape), "x".join(str(n) for n in mesh_shape))


def _train_step(cfg, shape: ShapeSpec, arch: str, mesh, tpol, specs, dev):
    tc = TrainConfig(arch=arch, seq=shape.seq, global_batch=shape.batch,
                     compute_dtype="bfloat16", remat=True,
                     quantized_moments=arch in _BIG,
                     param_sharding=tpol.get("param_sharding", "fsdp"),
                     grad_compression=tpol.get("grad_compression", False))
    step_fn, init_fn = build_train_step(cfg, tc, dev, mesh=mesh)
    state = init_fn(torch.Generator(device=dev).manual_seed(0))
    batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
             for k, v in specs["batch"].items()}
    rows = sharding.batch_spec(mesh, shape.batch, shape.seq)[0]
    local_batch = {k: sharding.local_block(v, (rows,), mesh)
                   for k, v in batch.items()}
    parts = {"params": state["params"], "opt": state["opt"],
             "ef": state["ef"], "batch": local_batch}
    return (lambda: step_fn(state, batch)), parts


def _serve_step(cfg, shape: ShapeSpec, arch: str, mesh, pol, specs, dev,
                cache_len):
    compute = torch.bfloat16
    sc = ServeConfig(arch=arch, batch=shape.batch, max_seq=cache_len,
                     prefill_len=shape.seq, compute_dtype="bfloat16",
                     cache_dtype=pol.get("cache_dtype", "bfloat16"),
                     param_dtype=pol.get("param_dtype", "same"),
                     params_resident=pol.get("params_resident", False),
                     device=dev)
    prefill, decode, place = build_serve_steps(cfg, sc, mesh)
    _, cache_dt, param_dt = sc.dtypes
    params = T.init_params(cfg, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev, dtype=param_dt)
    placed = sharding.place(params, place["params"], mesh)
    del params
    cache = sharding.local(sharding.place(
        T.init_cache(cfg, shape.batch, cache_len, device=dev,
                     dtype=cache_dt), place["cache"], mesh))
    batch = {k: torch.zeros(v.shape, dtype=compute if v.is_floating_point()
                            else v.dtype, device=dev)
             for k, v in specs["batch"].items() if k != "pos"}
    rows = sharding.batch_spec(mesh, shape.batch, 1)[0]
    parts = {"params": placed, "cache": cache,
             "batch": {k: sharding.local_block(v, (rows,), mesh)
                       for k, v in batch.items()}}
    if shape.kind == "prefill":
        return (lambda: prefill(placed, cache, batch)), parts
    batch["pos"] = cache_len - 1
    return (lambda: decode(placed, cache, batch)), parts


def dryrun_cell(arch: str, shape_name: Optional[str] = None, *,
                multi_pod: bool = False, mesh_shape=None,
                shape: Optional[ShapeSpec] = None, cfg=None,
                cache_len: Optional[int] = None,
                serve_policy: Optional[Dict[str, Any]] = None,
                train_policy: Optional[Dict[str, Any]] = None,
                fake: bool = True, device: str = "cpu") -> Dict[str, Any]:
    """One cell's record. The process group must be running with the
    mesh's number of ranks (:func:`fake_group`, or a real one with
    ``fake=False``). ``mesh_shape`` (default the production mesh of
    ``multi_pod``), ``shape`` (default ``SHAPES[shape_name]``), ``cfg``
    (default the arch's FULL) and ``cache_len`` (default the shape's seq,
    plus a vision prefix) size other cells, down to 1 × 1. Serving cells
    run in bf16 compute with ``serve_policy``'s ``cache_dtype`` (bf16),
    ``param_dtype`` ("same") and ``params_resident`` (False: the greedy
    FSDP baseline), as the reference's; train cells bf16 compute, remat,
    8-bit moments for the four largest archs, ``train_policy``'s
    ``param_sharding`` ("fsdp") and ``grad_compression`` (False)."""
    cfg = cfg or configs.get(arch).FULL
    base = shape or SHAPES[shape_name]
    shape_name = base.name
    shape = effective_shape(cfg, base)
    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    rec = {"arch": arch, "shape": shape_name, "effective_seq": shape.seq,
           "effective_batch": shape.batch, "mesh": _cell_name(mesh_shape),
           "mesh_shape": list(mesh_shape)}
    reason = skip_reason(cfg, base)
    if reason:
        return dict(rec, status="skipped", reason=reason)
    pol = dict(serve_policy or {})
    if cache_len is None:
        cache_len = _cache_len(cfg, shape)
    specs = input_specs(arch, shape_name, cfg=cfg, shape=base,
                        cache_len=cache_len,
                        cache_dtype=dtypes.cache_dtype(
                            pol.get("cache_dtype", "bfloat16")))
    t0 = time.perf_counter()
    mesh = make_mesh(tuple(mesh_shape), device)
    mode = contextlib.nullcontext()
    if fake:
        from torch._subclasses.fake_tensor import FakeTensorMode

        mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode, torch.no_grad() if shape.kind != "train" else \
            contextlib.nullcontext():
        if shape.kind == "train":
            fn, parts = _train_step(cfg, shape, arch, mesh,
                                    train_policy or {}, specs, device)
        else:
            fn, parts = _serve_step(cfg, shape, arch, mesh, pol, specs,
                                    device, cache_len)
        t_build = time.perf_counter() - t0
        measured = measured_step(fn, parts, fake)
    rec.update(status="ok", build_s=round(t_build, 2),
               step_s=round(time.perf_counter() - t0 - t_build, 2),
               **measured)
    if shape.kind != "train":
        rec["cache_len"] = cache_len
    return rec


def _error_record(arch, shape, mesh_shape, exc) -> Dict[str, Any]:
    return {"arch": arch, "shape": shape, "mesh": _cell_name(mesh_shape),
            "mesh_shape": list(mesh_shape), "status": "error",
            "error": f"{type(exc).__name__}: {exc}",
            "trace": traceback.format_exc()[-2000:]}


def dryrun_cells(jobs, world_size: int, rank: int = 0) -> list:
    """Each job ({"arch", "shape" (a name, or a ShapeSpec's fields),
    ``dryrun_cell``'s keywords}) dry-run as ``rank`` of one fake group of
    ``world_size`` ranks; a job that raises is an ``error`` record."""
    out = []
    with fake_group(world_size, rank):
        for job in jobs:
            job = dict(job)
            arch = job.pop("arch")
            shape = job.pop("shape")
            if isinstance(shape, dict):
                job["shape"] = ShapeSpec(**shape)
                shape = shape["name"]
            try:
                out.append(dryrun_cell(arch, shape, **job))
            except Exception as exc:  # noqa: BLE001  (a cell's failure)
                out.append(_error_record(arch, shape, job.get(
                    "mesh_shape", (16, 16)), exc))
    return out


def _isolated(groups, conn):
    os.environ["CUDA_VISIBLE_DEVICES"] = ""      # a dry run uses no card
    torch.set_num_threads(1)
    try:
        conn.send(("ok", [dryrun_cells(jobs, world, rank)
                          for world, rank, jobs in groups]))
    except BaseException as exc:  # noqa: BLE001  (handed to the parent)
        conn.send(("error", f"{type(exc).__name__}: {exc}\n"
                   + traceback.format_exc()[-4000:]))
    finally:
        conn.close()


def run_isolated(groups, timeout: Optional[float] = None) -> list:
    """:func:`dryrun_cells` of each (world size, rank, jobs) of ``groups``,
    one fake group after the other, in a freshly spawned process (the fake
    group is process-global; one torch thread); returns their records, a
    list a group. Raises if the process fails or outlasts ``timeout``
    seconds (it is then killed)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=_isolated, args=(groups, send), daemon=True)
    proc.start()
    send.close()
    try:
        if not recv.poll(timeout):
            raise TimeoutError(f"the dry run did not end in {timeout} s")
        status, got = recv.recv()
    finally:
        if proc.is_alive():
            proc.kill()
        proc.join(10)
        recv.close()
    if status != "ok":
        raise RuntimeError(f"the dry run's process failed: {got}")
    return got


# -- CLI -------------------------------------------------------------------

def _summary_line(rec) -> str:
    if rec["status"] == "ok":
        return (f" step={rec['step_s']}s flops={rec['cost']['flops']:.3g} "
                f"coll={rec['collectives']['total_bytes']:.3g}B "
                f"peak={rec['memory']['peak_bytes'] / 2 ** 30:.2f}GiB "
                f"fits={rec['memory']['fits']}")
    if rec["status"] == "error":
        return " " + rec["error"][:200]
    return ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="one arch (default: all)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES),
                    help="one shape (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true", help="ignore cache")
    ap.add_argument("--serve-policy", default=None,
                    help='JSON, e.g. \'{"params_resident": true, '
                         '"param_dtype": "fp8"}\'')
    ap.add_argument("--train-policy", default=None,
                    help='JSON, e.g. \'{"param_sharding": "tp"}\'')
    ap.add_argument("--device", default="cpu",
                    help="the fake mesh's device type (no device is used)")
    args = ap.parse_args(argv)
    serve_policy = json.loads(args.serve_policy) if args.serve_policy else None
    train_policy = json.loads(args.train_policy) if args.train_policy else None

    os.makedirs(args.out, exist_ok=True)
    archs = [args.arch] if args.arch else configs.ARCHS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    results = []
    for mp in meshes:
        with fake_group(512 if mp else 256):
            for arch in archs:
                for shape in shapes:
                    tag = f"{arch}_{shape}_{'multi' if mp else 'single'}"
                    path = os.path.join(args.out, tag + ".json")
                    if os.path.exists(path) and not args.force:
                        with open(path) as f:
                            rec = json.load(f)
                        print(f"[cached] {tag}: {rec['status']}")
                        results.append(rec)
                        continue
                    print(f"[dryrun] {tag} ...", flush=True)
                    try:
                        rec = dryrun_cell(arch, shape, multi_pod=mp,
                                          serve_policy=serve_policy,
                                          train_policy=train_policy,
                                          device=args.device)
                    except Exception as exc:  # noqa: BLE001  (a cell)
                        rec = _error_record(arch, shape, (2, 16, 16) if mp
                                            else (16, 16), exc)
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
                    print(f"[done]   {tag}: {rec['status']}"
                          f"{_summary_line(rec)}", flush=True)
                    results.append(rec)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\n=== dry-run summary: {n_ok} ok, {n_skip} skipped (documented), "
          f"{n_err} errors ===")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
