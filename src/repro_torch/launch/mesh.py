"""Device meshes (PyTorch) — the counterpart of the JAX package's
``repro.launch.mesh``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the process group, one device a rank, with the reference's axis names:

  single-pod: (16, 16)      axes ("data", "model")   — 256 ranks
  multi-pod:  (2, 16, 16)   axes ("pod", "data", "model") — 512 ranks;
              "pod" is pure data parallelism, kept outermost.

Functions, not module constants, so importing this module touches no
process group. Without a process group, :func:`make_host_mesh` and
:func:`make_serving_mesh` start a one-rank group themselves (an in-memory
``HashStore``; NCCL on the card, gloo on the CPU), so that a plain
``python -m ...`` needs no launcher. A multi-rank run starts its group
first (``torch.distributed.init_process_group`` with its address, world
size and rank) and the meshes take its ranks. The entry points take the
card unless ``device="cpu"`` is asked for; a card mesh without a card
raises.

:func:`mesh_shape` reads the axis names and sizes of a ``DeviceMesh``, of
a plain ``{name: size}`` mapping or of a JAX-style mesh (``axis_names``,
``devices.shape``): the sharding rules take any of them.
"""
from __future__ import annotations

import atexit
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist


def _device_type(device: str) -> str:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "for a mesh on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev.type


def ensure_process_group(device: str = "cuda") -> None:
    """Start a one-rank process group when none is running: NCCL on the
    card, gloo on the CPU, rendezvous through an in-memory store; it is
    destroyed when the process exits."""
    if dist.is_initialized():
        return
    kind = _device_type(device)
    if kind == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    atexit.register(_end_group)


def _end_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _mesh(device: str, ranks, names):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(_device_type(device), torch.as_tensor(ranks),
                      mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod", "data",
    "model"): the process group must hold exactly 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for n in shape:
        need *= n
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != need:
        raise RuntimeError(
            f"the production mesh {shape} over {axes} needs {need} ranks; "
            f"the process group has {have}")
    return _mesh(device, torch.arange(need).reshape(shape), axes)


def make_host_mesh(device: str = "cuda"):
    """A 1×1 ("data", "model") mesh on this process's one device."""
    ensure_process_group(device)
    if dist.get_world_size() != 1:
        raise RuntimeError(
            f"the host mesh is one rank; the process group has "
            f"{dist.get_world_size()}: build a serving mesh over them")
    return _mesh(device, [[0]], ("data", "model"))


def make_serving_mesh(data: Optional[int] = None,
                      model: Optional[int] = None, *,
                      devices: Optional[Sequence[int]] = None,
                      device: str = "cuda"):
    """A (data, model) mesh over the process group's ranks (``devices``: a
    subset of them, in order). With both factors None every rank goes to
    "data" (lane parallelism, the bitwise-safe default for continuous
    batching); with one given the other takes the rest."""
    ensure_process_group(device)
    ranks = list(devices if devices is not None
                 else range(dist.get_world_size()))
    n = len(ranks)
    if data is None and model is None:
        data, model = n, 1
    elif data is None:
        if n % model:
            raise ValueError(f"{n} ranks do not divide by model={model}")
        data = n // model
    elif model is None:
        if n % data:
            raise ValueError(f"{n} ranks do not divide by data={data}")
        model = n // data
    if data * model > n:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"ranks; {n} are given")
    grid = torch.as_tensor(ranks[: data * model]).reshape(data, model)
    return _mesh(device, grid, ("data", "model"))


def device_count() -> int:
    """The ranks of the process group (one device each); 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh, a mapping, or a mesh with
    ``axis_names`` and ``devices.shape``."""
    if isinstance(mesh, dict):
        return {str(k): int(v) for k, v in mesh.items()}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(s) for s in mesh.shape)))
    return dict(zip(mesh.axis_names, (int(s) for s in mesh.devices.shape)))


def data_axes(mesh) -> tuple:
    """All axes that carry pure data parallelism."""
    return ("pod", "data") if "pod" in mesh_shape(mesh) else ("data",)


def axis_size(mesh, name: str) -> int:
    return mesh_shape(mesh).get(name, 1)
