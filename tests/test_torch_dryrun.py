"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's (``repro.launch.dryrun``) and against real runs, on the CPU.

* The cells: ``SHAPES``, ``cells``, ``skip_reason`` and ``effective_shape``
  equal the reference's for all 40 (arch × shape) cells, and
  ``input_specs`` gives the reference's shapes and dtypes.
* Per-device bytes on the production meshes (16 × 16 and 2 × 16 × 16, as
  duck-typed meshes, no process group): the params' bytes under the port's
  serving placements equal those under the reference's ``shard_params``
  specs in every serving cell; the cache's equal those under its
  ``shard_cache`` specs except in the cells named in ``CACHE_DIFFERS``,
  where the port's ``serving_cache_specs`` keeps the sequence dim and a
  recurrent state's heads whole and splits the batch as the rank's rows
  (over "pod" too). Exact.
* A fake-group dry run equals a real run: on 1 × 1 its argument bytes and
  product FLOPs equal the meshless step's on real CPU tensors (FLOPs by
  ``torch.utils.flop_counter.FlopCounterMode``, an independent count);
  on a 2 × 2 gloo mesh every rank's local bytes, FLOPs and collectives
  (counts and bytes by kind) equal the fake census of that rank. Exact.
* A handful of FULL cells (one a kind: GQA decode, MoE prefill, an
  encoder-decoder's decode, a recurrent long decode, MLA decode, a train
  step) dry-run to ``ok`` on 16 × 16, their argument bytes those of the
  placements above; the CLI writes a cell's record and the summary line.

The reference's ``dryrun`` module sets ``XLA_FLAGS`` (512 host devices) as
it is imported; it is imported here only after this worker's JAX backend
is up, and the variable is restored. Every dry run runs in a spawned
process (the fake group is process-global), each under a time limit.
"""
import _torch_test_setup  # noqa: F401  (before any reference compile)

import functools
import json
import math
import multiprocessing as mp
import os
import socket
import subprocess
import sys
import tempfile
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.parallel import sharding as JS
from repro_torch import configs as tconfigs
from repro_torch.configs import ShapeSpec
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as TT
from repro_torch.parallel import sharding as TS

import _torch_dryrun_worker as W

MESHES = {"single": (("data", "model"), (16, 16)),
          "multi": (("pod", "data", "model"), (2, 16, 16))}
SERVE_CELLS = [(a, s) for a, s, skip in tconfigs.cells()
               if not skip and tconfigs.SHAPES[s].kind != "train"]
# the serving cells whose cache the port places otherwise than the
# reference's shard_cache: a sequence split or a recurrent state's head
# split not taken; on 2 × 16 × 16 also the batch split over "pod"
_SEQ_OR_HEADS = {(a, s) for a, s in SERVE_CELLS} - {
    ("gemma2_27b", "prefill_32k"), ("gemma2_27b", "decode_32k"),
    ("whisper_medium", "prefill_32k"), ("whisper_medium", "decode_32k")}
CACHE_DIFFERS = {"single": _SEQ_OR_HEADS, "multi": set(SERVE_CELLS)}
ISOLATED_S = 240          # a spawned dry run's time limit
FULL_S = 420              # the FULL cells' (about 60 s of dry runs)

_DT = {jnp.dtype(jnp.float32): torch.float32,
       jnp.dtype(jnp.bfloat16): torch.bfloat16,
       jnp.dtype(jnp.int32): torch.int32,
       jnp.dtype(jnp.float8_e4m3fn): torch.float8_e4m3fn}


@functools.lru_cache(maxsize=None)
def reference_dryrun():
    """The reference's ``repro.launch.dryrun``, imported after this
    process's JAX backend is up (its ``XLA_FLAGS`` line then changes no
    device count), ``XLA_FLAGS`` restored."""
    jax.devices()
    flags = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jd
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
    return jd


# -------------------------------------------------------------- the cells

def test_shapes_cells_and_skips_equal_the_reference():
    """SHAPES field for field; the 40 cells and their skip reasons;
    ``effective_shape`` of every cell."""
    jd = reference_dryrun()
    assert {k: tuple(vars(v).values()) for k, v in tconfigs.SHAPES.items()} \
        == {k: tuple(vars(v).values()) for k, v in jconfigs.SHAPES.items()}
    mine = {(a, s): r for a, s, r in tconfigs.cells()}
    theirs = {(a, s): r for a, s, r in jconfigs.cells()}
    assert len(mine) == 40 and mine == theirs
    for a, s in mine:
        tcfg, jcfg = tconfigs.get(a).FULL, jconfigs.get(a).FULL
        assert tconfigs.skip_reason(tcfg, tconfigs.SHAPES[s]) == \
            jconfigs.skip_reason(jcfg, jconfigs.SHAPES[s])
        assert tuple(vars(tdry.effective_shape(
            tcfg, tconfigs.SHAPES[s])).values()) == tuple(vars(
                jd.effective_shape(jcfg, jconfigs.SHAPES[s])).values())


def _shapes_dtypes(tree):
    if isinstance(tree, dict):
        return {k: _shapes_dtypes(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape), tree.dtype
    return tuple(tree.shape), _DT[jnp.dtype(tree.dtype)]


@pytest.mark.parametrize("shape", list(tconfigs.SHAPES))
def test_input_specs_equal_the_reference(shape):
    """Every arch's stand-ins of the cell's inputs: batch and cache, shape
    and dtype, leaf for leaf (a bf16 cache and an e4m3 one)."""
    jd = reference_dryrun()
    for arch in tconfigs.ARCHS:
        for tdt, jdt in ((torch.bfloat16, jnp.bfloat16),
                         (torch.float8_e4m3fn, jnp.float8_e4m3fn)):
            got = tdry.input_specs(arch, shape, cache_dtype=tdt)
            want = jd.input_specs(arch, shape, cache_dtype=jdt)
            assert got["kind"] == want["kind"]
            for part in ("batch", "cache"):
                assert (part in got) == (part in want)
                if part in got:
                    assert _shapes_dtypes(got[part]) == \
                        _shapes_dtypes(want[part]), (arch, shape, part)


# ---------------------------------------------------- per-device bytes

def _local_bytes(shape, spec, sizes, itemsize) -> int:
    n = itemsize
    for d, dim in enumerate(shape):
        e = spec[d] if d < len(spec) else None
        axes = () if e is None else ((e,) if isinstance(e, str)
                                     else tuple(e))
        div = math.prod(sizes[a] for a in axes)
        assert dim % div == 0, (shape, spec)
        n *= dim // div
    return n


def _tree_bytes(shapes, specs, sizes, itemsize) -> int:
    total = 0
    for keys, shape in _leaves(shapes):
        spec = specs
        for k in keys:
            spec = spec[k]
        total += _local_bytes(shape, tuple(spec), sizes, itemsize)
    return total


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tuple(tree.shape if hasattr(tree, "shape") else tree)


def _cache_len(cfg, shape):
    return shape.seq + (cfg.frontend_seq if cfg.frontend == "vision" else 0)


def port_serving_bytes(arch, shape_name, mesh_name):
    """(params, cache) bytes a rank holds under the port's serving
    placements (``build_serve_steps`` on a {name: size} mesh), bf16."""
    sizes = dict(zip(*MESHES[mesh_name]))
    cfg = tconfigs.get(arch).FULL
    shape = tdry.effective_shape(cfg, tconfigs.SHAPES[shape_name])
    n = _cache_len(cfg, shape)
    sc = tserve.ServeConfig(arch=arch, batch=shape.batch, max_seq=n,
                            prefill_len=shape.seq, compute_dtype="bfloat16",
                            cache_dtype="bfloat16", params_resident=False,
                            device="cpu")
    _, _, place = tserve.build_serve_steps(cfg, sc, sizes)
    cache = TT.cache_shapes(cfg, shape.batch, n)
    cache_bytes = sum(_local_bytes(s, place["cache"][k], sizes,
                                   4 if k == "idx" else 2)
                      for k, s in cache.items())
    return (_tree_bytes(TT.param_shapes(cfg), place["params"], sizes, 2),
            cache_bytes)


@pytest.fixture
def spec_only(monkeypatch):
    monkeypatch.setattr(JS, "NamedSharding", lambda mesh, spec: spec)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_and_cache_bytes_per_device_equal_the_references(spec_only,
                                                               mesh_name):
    """Every serving cell (bf16 params and cache, the greedy FSDP baseline
    the reference's dry run serves): params equal; the cache equal except
    in CACHE_DIFFERS, where it differs."""
    names, shape_ = MESHES[mesh_name]
    jmesh = types.SimpleNamespace(axis_names=names,
                                  devices=np.empty(shape_, dtype=object))
    sizes = dict(zip(names, shape_))
    differs = set()
    for arch, shape_name in SERVE_CELLS:
        jcfg = jconfigs.get(arch).FULL
        shape = tdry.effective_shape(tconfigs.get(arch).FULL,
                                     tconfigs.SHAPES[shape_name])
        n = _cache_len(jcfg, shape)
        pshapes = jax.eval_shape(lambda: JT.init_params(
            jax.random.PRNGKey(0), jcfg))
        jparams = _tree_bytes(pshapes, JS.shard_params(
            pshapes, jmesh, model_only=False), sizes, 2)
        jc = jax.eval_shape(lambda: JT.init_cache(jcfg, shape.batch, n,
                                                  jnp.bfloat16))
        jspecs = JS.shard_cache(jc, jmesh, jcfg)
        jcache = sum(_local_bytes(v.shape, tuple(jspecs[k]), sizes,
                                  v.dtype.itemsize) for k, v in jc.items())
        params, cache = port_serving_bytes(arch, shape_name, mesh_name)
        assert params == jparams, (arch, shape_name)
        if cache != jcache:
            differs.add((arch, shape_name))
    assert differs == CACHE_DIFFERS[mesh_name]


# ------------------------------------------- fake dry runs and real runs

SMALL = {"prefill": ShapeSpec("smoke_prefill", "prefill", 12, 4),
         "decode": ShapeSpec("smoke_decode", "decode", 20, 4),
         "train": ShapeSpec("smoke_train", "train", 16, 4)}
ONE_BY_ONE = [("qwen2_7b", "train"), ("qwen2_7b", "prefill"),
              ("qwen2_7b", "decode"), ("mixtral_8x22b", "prefill"),
              ("whisper_medium", "decode"), ("minicpm3_4b", "decode"),
              ("rwkv6_1p6b", "decode")]


def _job(arch, kind, **kw):
    return dict(arch=arch, shape=vars(SMALL[kind]), **kw)


@functools.lru_cache(maxsize=None)
def fake_one_by_one():
    """The ONE_BY_ONE cells dry-run at SMOKE on a fake 1 × 1 mesh."""
    jobs = [_job(a, k, cfg=tconfigs.get(a).SMOKE, mesh_shape=(1, 1))
            for a, k in ONE_BY_ONE]
    [recs] = tdry.run_isolated([(1, 0, jobs)], timeout=ISOLATED_S)
    return {(a, k): r for (a, k), r in zip(ONE_BY_ONE, recs)}


def _nbytes(tree):
    return sum(t.numel() * t.element_size() for t in _flat(tree))


def _flat(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _flat(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _flat(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def meshless_step(arch, kind):
    """The cell's step without a mesh on real CPU tensors, as the dry run
    builds it: (argument bytes, product FLOPs)."""
    cfg = tconfigs.get(arch).SMOKE
    shape = tdry.effective_shape(cfg, SMALL[kind])
    specs = tdry.input_specs(arch, shape.name, cfg=cfg, shape=SMALL[kind])
    gen = torch.Generator().manual_seed(0)
    batch = {k: torch.zeros(v.shape, dtype=torch.bfloat16
                            if v.is_floating_point() else v.dtype)
             for k, v in specs["batch"].items() if k != "pos"}
    flops = FlopCounterMode(display=False)
    if kind == "train":
        tc = ttrain.TrainConfig(arch=arch, seq=shape.seq,
                                global_batch=shape.batch,
                                compute_dtype="bfloat16", remat=True,
                                param_sharding="fsdp")
        step_fn, init_fn = ttrain.build_train_step(cfg, tc, "cpu")
        state = init_fn(gen)
        args = sum(_nbytes(x) for x in (state["params"], state["opt"],
                                        batch))
        with flops:
            step_fn(state, batch)
        return args, flops.get_total_flops()
    n = _cache_len(cfg, shape)
    sc = tserve.ServeConfig(arch=arch, batch=shape.batch, max_seq=n,
                            prefill_len=shape.seq, compute_dtype="bfloat16",
                            cache_dtype="bfloat16", device="cpu")
    bk = tserve._backend(sc)
    params = TT.init_params(cfg, generator=gen, device="cpu",
                            dtype=torch.bfloat16)
    cache = TT.init_cache(cfg, shape.batch, n, device="cpu",
                          dtype=torch.bfloat16)
    args = sum(_nbytes(x) for x in (params, cache, batch))
    with torch.no_grad(), flops:
        if kind == "prefill":
            enc = tserve.encode_step(bk, params, cfg, batch.get("frontend"))
            tserve.prefill_step(bk, params, cfg, cache, batch["tokens"],
                                batch.get("frontend"), enc)
        else:
            tserve.decode_step(bk, params, cfg, cache, batch["tokens"],
                               n - 1, batch.get("enc_out"))
    return args, flops.get_total_flops()


@pytest.mark.parametrize("arch,kind", ONE_BY_ONE,
                         ids=[f"{a}-{k}" for a, k in ONE_BY_ONE])
def test_fake_one_by_one_equals_the_meshless_step(arch, kind):
    """1 × 1: the fake dry run's argument bytes and product FLOPs equal
    the meshless step's on real tensors; nothing is collective."""
    rec = fake_one_by_one()[(arch, kind)]
    assert rec["status"] == "ok", rec.get("error")
    args, flops = meshless_step(arch, kind)
    assert rec["memory"]["argument_bytes"] == args
    assert rec["cost"]["flops"] == flops
    assert rec["collectives"]["total_bytes"] == 0
    assert rec["memory"]["peak_bytes"] >= args


GLOO_JOBS = [("qwen2_7b", "train"), ("qwen2_7b", "prefill"),
             ("qwen2_7b", "decode"), ("mixtral_8x22b", "prefill"),
             ("rwkv6_1p6b", "decode")]
_GLOO = {}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def gloo_and_fake():
    """Each rank's records of GLOO_JOBS at SMOKE on a 2 × 2 mesh: a gloo
    run on real tensors and the fake census of the same rank."""
    if not _GLOO:
        jobs = [_job(a, k) for a, k in GLOO_JOBS]
        out = tempfile.mkdtemp(prefix="dryrun_gloo_")
        ctx = torch.multiprocessing.start_processes(
            W.run, args=(4, (2, 2), _free_port(), out, jobs), nprocs=4,
            join=False, start_method="spawn")
        deadline = time.monotonic() + ISOLATED_S
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise TimeoutError("the 4-rank gloo dry run")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        real = []
        for r in range(4):
            with open(f"{out}/rank{r}.json") as fh:
                real.append(json.load(fh))
        fake_jobs = [_job(a, k, cfg=tconfigs.get(a).SMOKE, mesh_shape=(2, 2))
                     for a, k in GLOO_JOBS]
        fake = tdry.run_isolated([(4, r, fake_jobs) for r in range(4)],
                                 timeout=ISOLATED_S)
        _GLOO["recs"] = real, fake
    return _GLOO["recs"]


@pytest.mark.parametrize("arch,kind", GLOO_JOBS,
                         ids=[f"{a}-{k}" for a, k in GLOO_JOBS])
def test_fake_census_equals_a_gloo_run(arch, kind):
    """2 × 2: every rank's argument bytes by part, product FLOPs and
    collectives (count and bytes by kind) equal the fake census of that
    rank; the mesh's collectives did run."""
    real, fake = gloo_and_fake()
    i = GLOO_JOBS.index((arch, kind))
    for rank in range(4):
        a, b = real[rank][i], fake[rank][i]
        assert a["status"] == "ok", a.get("error")
        assert b["status"] == "ok", b.get("error")
        assert a["memory"]["argument_parts"] == b["memory"]["argument_parts"]
        assert a["cost"]["flops"] == b["cost"]["flops"]
        assert a["collectives"] == b["collectives"], rank
        assert a["cost"]["fake_tensors"] is False
        assert b["cost"]["fake_tensors"] is True
    assert real[0][i]["collectives"]["total_bytes"] > 0


def test_a_dry_run_refuses_a_process_with_a_group():
    ctx = mp.get_context("spawn")
    with ctx.Pool(1) as pool:
        assert pool.apply_async(W.refuses_a_second_group).get(ISOLATED_S)


# ------------------------------------------ the mesh step, layer by layer

# Qwen2-7B at the mesh tests' training width (tests/_torch_mesh_worker.py:
# the greedy rules split the MLP weights and the tables), 4 layers
STEP_CFG = dict(d_model=256, d_ff=1024, vocab=1024, n_layers=4)
STEP_SHAPE = ShapeSpec("step_train", "train", 16, 4)
STEP_MESHES = ((1, 4), (2, 2))


def _step_cfg():
    import dataclasses

    return dataclasses.replace(tconfigs.get("qwen2_7b").SMOKE, **STEP_CFG)


@functools.lru_cache(maxsize=None)
def fake_mesh_steps():
    """The STEP_CFG train step dry-run (fsdp) on fake meshes of 4 ranks."""
    job = dict(arch="qwen2_7b", shape=vars(STEP_SHAPE), cfg=_step_cfg(),
               train_policy={"param_sharding": "fsdp"})
    groups = [(4, 0, [dict(job, mesh_shape=m)]) for m in STEP_MESHES]
    recs = tdry.run_isolated(groups, timeout=ISOLATED_S)
    return {m: r[0] for m, r in zip(STEP_MESHES, recs)}


def _split_axes(spec, sizes) -> int:
    return sum(sizes.get(a, 1) > 1 for e in spec if e is not None
               for a in ((e,) if isinstance(e, str) else e))


def gather_count(cfg, sizes) -> int:
    """All-gathers of one f32 train step (no EF, f32 moments) on a mesh of
    ``sizes``: a(leaf) = the axes of size > 1 that split a param leaf
    under the fsdp rule; each unstacked leaf is gathered once, before the
    loss; each stacked leaf's layer slice twice a layer (the forward and
    the remat recompute); and the carry once a layer (its recompute) when
    "model" > 1 divides d:
    Σ_unstacked a + 2·L·Σ_stacked a + L·[model > 1, d % model = 0]."""
    specs = TS.shard_params(TT.param_shapes(cfg), sizes)
    n = 0
    for keys, shape in _leaves(TT.param_shapes(cfg)):
        spec = specs
        for k in keys:
            spec = spec[k]
        a = _split_axes(spec, sizes)
        n += 2 * cfg.n_layers * a if keys[0] == "layers" else a
    m = sizes.get("model", 1)
    return n + (cfg.n_layers if m > 1 and cfg.d_model % m == 0 else 0)


@pytest.mark.parametrize("mesh_shape", STEP_MESHES,
                         ids=[f"{d}x{m}" for d, m in STEP_MESHES])
def test_mesh_step_gathers_a_layer_at_a_time(mesh_shape):
    """The census of a train step on a fake mesh: its all-gathers are
    exactly :func:`gather_count`, and its all-reduces one a gradient slice
    (every unstacked leaf, every stacked leaf's layer) and the loss, over
    each data axis of size > 1."""
    rec = fake_mesh_steps()[mesh_shape]
    assert rec["status"] == "ok", rec.get("error")
    cfg, sizes = _step_cfg(), dict(zip(("data", "model"), mesh_shape))
    counts = rec["collectives"]["count_by_kind"]
    assert counts.get("all-gather", 0) == gather_count(cfg, sizes), counts
    shapes = list(_leaves(TT.param_shapes(cfg)))
    slices = sum(cfg.n_layers if k[0] == "layers" else 1 for k, _ in shapes)
    dp = int(sizes["data"] > 1)
    assert counts.get("all-reduce", 0) == dp * (slices + 1), counts
    assert set(counts) <= {"all-gather", "all-reduce"}, counts


def test_mesh_step_holds_one_layer_of_gathered_params():
    """Per-rank memory: on a fake (1, 4) mesh (the batch whole on every
    rank) the step's peak (argument bytes plus MemTracker's peak) lies
    under the meshless step's on real tensors by at least (1 − 1/n) of the
    split stacked leaves' param and gradient bytes S, less one layer's
    slice of them (S / L): a rank holds its blocks and one layer's params
    and gradient gathered whole, not the whole tree."""
    rec = fake_mesh_steps()[(1, 4)]
    assert rec["status"] == "ok", rec.get("error")
    cfg, n = _step_cfg(), 4
    sizes = {"data": 1, "model": n}
    specs = TS.shard_params(TT.param_shapes(cfg), sizes)
    split = sum(2 * 4 * math.prod(shape) for keys, shape in
                _leaves(TT.param_shapes(cfg)) if keys[0] == "layers"
                and _split_axes(functools.reduce(lambda t, k: t[k], keys,
                                                 specs), sizes))
    tc = ttrain.TrainConfig(arch="qwen2_7b", seq=STEP_SHAPE.seq,
                            global_batch=STEP_SHAPE.batch,
                            compute_dtype="bfloat16", remat=True,
                            param_sharding="fsdp")
    step_fn, init_fn = ttrain.build_train_step(cfg, tc, "cpu")
    state = init_fn(torch.Generator().manual_seed(0))
    batch = {k: torch.zeros((STEP_SHAPE.batch, STEP_SHAPE.seq),
                            dtype=torch.int32)
             for k in ("tokens", "targets")}
    alone = tdry.measured_step(lambda: step_fn(state, batch),
                               {"params": state["params"],
                                "opt": state["opt"], "batch": batch},
                               fake=False)["memory"]
    mesh = rec["memory"]
    assert split > 0
    saved = alone["peak_bytes"] - mesh["peak_bytes"]
    print(f"peak a rank: meshless {alone['peak_bytes']:,} B, (1, 4) "
          f"{mesh['peak_bytes']:,} B; saved {saved:,} B, the bound "
          f"{(1 - 1 / n) * split - split / cfg.n_layers:,.0f} B")
    assert saved >= (1 - 1 / n) * split - split / cfg.n_layers


# ------------------------------------------------------- FULL, 16 × 16

FULL_CELLS = [("qwen2_7b", "decode_32k"), ("mixtral_8x22b", "prefill_32k"),
              ("whisper_medium", "decode_32k"), ("rwkv6_1p6b", "long_500k"),
              ("minicpm3_4b", "decode_32k"), ("qwen2_7b", "train_4k")]


@functools.lru_cache(maxsize=None)
def full_cells():
    jobs = [dict(arch=a, shape=s, mesh_shape=(16, 16)) for a, s in
            FULL_CELLS]
    [recs] = tdry.run_isolated([(256, 0, jobs)], timeout=FULL_S)
    return dict(zip(FULL_CELLS, recs))


@pytest.mark.parametrize("arch,shape", FULL_CELLS,
                         ids=[f"{a}-{s}" for a, s in FULL_CELLS])
def test_full_cells_dry_run_on_the_single_pod_mesh(arch, shape):
    """``ok`` with every field of the record; a serving cell's params and
    cache bytes those of its placements (test above), a train cell's
    params f32 under the fsdp rule with 16 rows a rank."""
    rec = full_cells()[(arch, shape)]
    assert rec["status"] == "ok", rec.get("error")
    mem, cost = rec["memory"], rec["cost"]
    assert mem["argument_bytes"] == sum(mem["argument_parts"].values())
    assert mem["peak_bytes"] >= mem["argument_bytes"]
    assert mem["fits"] == (mem["peak_bytes"] <= tdry.H100_BYTES)
    assert cost["flops"] > 0 and cost["bytes_accessed"] > 0
    assert cost["dtensor_ops"] == 0
    assert set(rec["collectives"]) == {"bytes_by_kind", "count_by_kind",
                                       "total_bytes"}
    if tconfigs.SHAPES[shape].kind == "train":
        cfg = tconfigs.get(arch).FULL
        want = _tree_bytes(TT.param_shapes(cfg), TS.shard_params(
            TT.param_shapes(cfg), {"data": 16, "model": 16}),
            {"data": 16, "model": 16}, 4)
        assert mem["argument_parts"]["params"] == want
        assert mem["argument_parts"]["batch"] == 2 * 16 * 4096 * 4
        # gathered a layer at a time: 204.7 GB a rank, where gathering
        # the whole params held 247.4 GB; the loss's logits and a layer's
        # attention scores still hold it over 80 GB (ROADMAP)
        assert mem["peak_bytes"] < 247.4e9 and not mem["fits"]
        assert rec["collectives"]["count_by_kind"]["all-gather"] == \
            gather_count(cfg, {"data": 16, "model": 16})
        return
    params, cache = port_serving_bytes(arch, shape, "single")
    assert mem["argument_parts"]["params"] == params
    assert mem["argument_parts"]["cache"] == cache


def test_roofline_calibration_on_the_full_cells():
    """The roofline's analytic FLOPs (``repro_torch.benchmarks.roofline``)
    against the census of the FULL cells above: each ratio of the
    census's whole-step FLOPs a rank × 256 ranks to the analytic step
    FLOPs is printed. The decode_32k cells take the reference's bounds
    (0.05–40) on that ratio over the 16 model ranks: under the greedy
    serving placement a rank gathers its weights whole and runs its data
    rows' products at full width (the serving design), so each model rank
    repeats the others' products, where XLA partitions them. Whisper's is
    not held, as the reference holds it not: each decode step projects the
    cross-attention's keys and values from all 1,500 encoder frames, which
    the analytic decode term leaves out.
    A train cell's ratio lies in [16, 16·8/3]: its 16 model ranks each
    repeat their data rows' products at full width (the compute half of
    the reference's mesh training is still to port), remat recomputes the
    forward (8·N a token against the analytic 6·N), and the attention
    scores are computed whole under the causal mask (4/3 to 8/3 in all)."""
    from repro_torch.benchmarks import roofline as R

    for (arch, shape), rec in full_cells().items():
        assert rec["status"] == "ok", rec.get("error")
        cfg = tconfigs.get(arch).FULL
        a = R.analytic_terms(cfg, tdry.effective_shape(
            cfg, tconfigs.SHAPES[shape]))
        ratio = rec["cost"]["flops"] * R.CHIPS / a["flops"]
        print(f"roofline calibration {arch} × {shape}: census / analytic "
              f"FLOPs {ratio:.4g}")
        if shape == "decode_32k" and arch != "whisper_medium":
            assert 0.05 < ratio / R.M_AX < 40, (arch, shape, ratio)
        elif tconfigs.SHAPES[shape].kind == "train":
            assert 16 <= ratio <= 16 * 8 / 3, (arch, shape, ratio)


def test_cli_writes_a_record_and_the_summary(tmp_path):
    """``python -m repro_torch.launch.dryrun`` for one cell: its JSON file
    and the reference's summary line; a second run reads the cache."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           "hymba_1p5b", "--shape", "long_500k", "--out", str(tmp_path)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
    got = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         timeout=ISOLATED_S)
    assert got.returncode == 0, got.stderr[-3000:]
    assert "=== dry-run summary: 1 ok, 0 skipped (documented), 0 errors ===" \
        in got.stdout
    rec = json.loads((tmp_path / "hymba_1p5b_long_500k_single.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "single"
    again = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           timeout=ISOLATED_S)
    assert "[cached] hymba_1p5b_long_500k_single: ok" in again.stdout
