"""Gloo ranks of ``tests/test_torch_dryrun.py``: the dry run's census on
real tensors under a real process group, to hold the fake census to. Imports
neither ``jax`` nor ``repro``.

Run as ``mp.start_processes(run, args=(world, mesh_shape, port, out_dir,
jobs), nprocs=world, start_method="spawn")``: rank r runs every job with
``dryrun_cell(..., fake=False)`` on a ``mesh_shape`` mesh over a gloo group
and writes its records to ``out_dir/rank{r}.json``; a job that raises
stores its traceback instead.
"""
import json
import traceback

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.configs import ShapeSpec
from repro_torch.launch import dryrun


def run(rank, world, mesh_shape, port, out_dir, jobs):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    out = []
    try:
        for job in jobs:
            try:
                out.append(dryrun.dryrun_cell(
                    job["arch"], shape=ShapeSpec(**job["shape"]),
                    cfg=configs.get(job["arch"]).SMOKE,
                    mesh_shape=mesh_shape, fake=False))
            except Exception:  # noqa: BLE001  (reported to the test)
                out.append({"status": "error",
                            "error": traceback.format_exc()})
        with open(f"{out_dir}/rank{rank}.json", "w") as fh:
            json.dump(out, fh)
    finally:
        dist.destroy_process_group()


def refuses_a_second_group():
    """In a fresh process with a one-rank gloo group: the fake group
    refuses to start (a dry run needs a process of its own)."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with dryrun.fake_group(4):
            return False
    except RuntimeError as exc:
        return "process of its own" in str(exc)
    finally:
        dist.destroy_process_group()
