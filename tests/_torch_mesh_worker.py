"""Worker processes of ``tests/test_torch_mesh_dist.py``: one ``mp.spawn``
of gloo ranks on the CPU runs every check of a world size and hands its
results back in a file. Imports neither ``jax`` nor ``repro`` (each rank
would pay JAX's start-up); the reference's results come from the parent.

Run as ``mp.spawn(run, args=(world, port, out_dir), nprocs=world)``: rank
r writes ``out_dir/rank{r}.pt``, a dict {case: result}; a check that
raises stores its traceback under its case instead.
"""
import dataclasses
import hashlib
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.core.backend import MeshTorchOps
from repro_torch.data import pipeline
from repro_torch.launch import batching, serve, train
from repro_torch.launch import mesh as meshlib
from repro_torch.models import moe as TM
from repro_torch.models import transformer as T
from repro_torch.optim import grad_compress as gc
from repro_torch.optim import optimizer as opt
from repro_torch.parallel import sharding

FMT_MAP = {"": {"k": 11, "emax": 15, "emin": -14},
           "layer*/attn": {"k": 8, "emax": 15, "emin": -14},
           "layer0/mlp": {"k": 9, "emax": 7, "emin": -6}}
PATHS = {"format": dict(precision_layer_format=FMT_MAP),
         "k12": dict(precision_k=12)}
ENGINE = dict(n_lanes=4, max_seq=64, page_size=16, queue_depth=8)
# the training checks' width: wide enough that the greedy rules split the
# layers' weights (tensors under 1 MiB replicate)
TRAIN_CFG = dict(d_model=256, d_ff=1024, vocab=1024)
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 16, 4, 2
# the 2 x 2 checks' depth: 3 layers, so that a layer's rows of the 8-bit
# payloads (split over "model" in halves) lie on both model ranks
TRAIN_LAYERS_2X2 = 3
TRAIN_ADAM = opt.AdamWConfig(warmup_steps=0)
# param_sharding and the state's other options of each training check
TRAIN_MODES = {"fsdp": ("fsdp", {}), "tp": ("tp", {}),
               "fsdp_8bit": ("fsdp", {"quantized_moments": True}),
               "fsdp_ef": ("fsdp", {"grad_compression": True})}
PSUM_SHAPES = {"a": (3, 300), "b": (1000,), "c": (2, 4, 128)}
EP_ARCHS = ("mixtral_8x22b", "llama4_maverick")
EP_TOKENS = 24


def engine_requests(vocab, n=6, seed=3):
    rng = np.random.RandomState(seed)
    return [batching.Request(
        rid=i, prompt=rng.randint(0, vocab, int(rng.randint(5, 20))).tolist(),
        max_new_tokens=int(rng.randint(4, 9)), arrival_step=i)
        for i in range(n)]


def qwen_params():
    cfg = configs.get("qwen2_7b").SMOKE
    return cfg, T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                              device="cpu")


def run_engine(path, mesh=None):
    """Every request's (tokens, logit rows) from the engine, by id."""
    cfg, params = qwen_params()
    sc = serve.ServeConfig(batch=ENGINE["n_lanes"],
                           max_seq=ENGINE["max_seq"], device="cpu",
                           **PATHS[path])
    eng = batching.ContinuousBatchingEngine(cfg, sc, params, device="cpu",
                                            keep_logits=True, mesh=mesh,
                                            **ENGINE)
    out = eng.run(engine_requests(cfg.vocab))
    return {r["id"]: (r["tokens"], r["logits"].numpy()) for r in out}


def train_cfg(n_layers=None):
    cfg = dataclasses.replace(configs.get("qwen2_7b").SMOKE, **TRAIN_CFG)
    return cfg if n_layers is None else dataclasses.replace(
        cfg, n_layers=n_layers)


def run_train(mode, mesh=None, n_layers=None, check_update=False):
    """Losses of TRAIN_STEPS steps, the gradients each step clipped (whole,
    averaged over the ranks), and the params (whole) before and after.
    No warm-up: every step moves the params by about lr. ``check_update``
    (a mesh run): each step's update replayed (:func:`replayed_update`),
    its mismatches under "replay"."""
    cfg = train_cfg(n_layers)
    sharded, kw = TRAIN_MODES[mode]
    tc = train.TrainConfig(seq=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                           steps=TRAIN_STEPS, param_sharding=sharded, **kw)
    adam = dataclasses.replace(TRAIN_ADAM,
                               quantized_moments=tc.quantized_moments)
    step_fn, init_fn = train.build_train_step(cfg, tc, "cpu", adam,
                                              mesh=mesh)
    state = init_fn(torch.Generator().manual_seed(0))
    dc = pipeline.DataConfig(vocab=cfg.vocab, seq=TRAIN_SEQ,
                             global_batch=TRAIN_BATCH)
    whole = lambda: {"/".join(k): sharding.full(v).detach().numpy().copy()
                     for k, v in opt.tree_paths(state["params"])}
    before, losses, grads = whole(), [], []
    clip_factor, update_blocks = opt.clip_factor, train.update_blocks

    def spy(tree, cfg):             # the meshless step clips whole grads
        if mesh is None:
            grads.append({"/".join(k): g.detach().numpy().copy()
                          for k, g in opt.tree_paths(tree)})
        return clip_factor(tree, cfg)

    replay = []

    def spy_blocks(state, tree, clip, cfg, mesh):
        # the mesh step's clipped gradients are this rank's blocks: read
        # them whole; replay its update on the whole state
        params = dict(opt.tree_paths(state["params"]))
        grads.append({"/".join(k): train.whole_of(
            g, train._spec_of(params[k]), mesh).detach().numpy().copy()
            for k, g in opt.tree_paths(tree)})
        before = whole_state(state) if check_update else None
        out = update_blocks(state, tree, clip, cfg, mesh)
        if check_update:
            replay.append(replayed_update(before, grads[-1],
                                          whole_state(state), cfg))
        return out

    opt.clip_factor, train.update_blocks = spy, spy_blocks
    try:
        for step in range(TRAIN_STEPS):
            state, loss = step_fn(state, train.batch_for(cfg, dc, step,
                                                         "cpu"))
            losses.append(float(loss))
    finally:
        opt.clip_factor, train.update_blocks = clip_factor, update_blocks
    split = sum(any(p.is_shard() for p in v.placements)
                for _, v in opt.tree_paths(state["params"])
                if hasattr(v, "placements"))
    return {"losses": losses, "grads": grads, "before": before,
            "params": whole(), "split_leaves": split,
            "lr": float(opt.schedule(TRAIN_ADAM, 1)), "replay": replay}


def whole_state(state):
    """A placed train state's params and optimizer state, every leaf
    whole: (params, OptState)."""
    o = state["opt"]
    whole = lambda tree: None if tree is None else opt.tree_map(  # noqa
        lambda t: sharding.full(t).detach().clone(), tree)
    return whole(state["params"]), opt.OptState(*(
        whole(getattr(o, f)) for f in opt.OptState._fields))


def replayed_update(before, grads, after, cfg):
    """The mismatches of a mesh step's update against the meshless
    ``opt.update`` of the whole state ``before`` and the whole clipped
    ``grads`` ({path: array}): every param, moment, payload and scale of
    ``after`` must be its bits."""
    g = {}
    for name, a in grads.items():
        opt.tree_set(g, tuple(name.split("/")), torch.from_numpy(a))
    params, new = opt.update(before[0], g, before[1], cfg)
    bad = [] if torch.equal(new.step, after[1].step) else ["step"]
    for field, tree in (("params", params), *((f, getattr(new, f)) for f in (
            "m", "v", "m_scale", "v_scale"))):
        if tree is None:
            continue
        want = after[0] if field == "params" else getattr(after[1], field)
        bad += [f"{field} {'/'.join(k)}" for k, t in opt.tree_paths(tree)
                if not torch.equal(t, opt._get(want, k))]
    return bad


def digest(tree) -> str:
    """sha256 of a result's arrays and numbers, in key order."""
    h = hashlib.sha256()

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                h.update(str(k).encode())
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        elif isinstance(t, np.ndarray):
            h.update(t.tobytes())
        else:
            h.update(repr(t).encode())

    walk(tree)
    return h.hexdigest()


def rank0_arrays(result):
    """``result`` whole on rank 0; on the other ranks its digest and the
    mesh run's replay mismatches and split count only (the 2 × 2 results
    are large, and every rank must hold the same)."""
    out = {"digest": digest(result), "replay": result["mesh"]["replay"],
           "split_leaves": result["mesh"]["split_leaves"]}
    return dict(result, **out) if dist.get_rank() == 0 else out


def psum_grads(rank, same: bool):
    """A gradient tree: the same on every rank, or the rank's own."""
    rng = np.random.RandomState(0 if same else 100 + rank)
    return {k: torch.from_numpy((rng.randn(*s) * 10.0 ** rng.randint(
        -3, 2)).astype(np.float32)) for k, s in PSUM_SHAPES.items()}


def ep_inputs(arch):
    """SMOKE MoE layer weights and tokens of which most lie along expert
    0's router column, so it overflows its capacity."""
    cfg = configs.get(arch).SMOKE
    rng = np.random.RandomState(11)
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"w_router": rng.randn(d, E) / np.sqrt(d),
         "w_gate": rng.randn(E, d, ff) / np.sqrt(d),
         "w_up": rng.randn(E, d, ff) / np.sqrt(d),
         "w_down": rng.randn(E, ff, d) / np.sqrt(ff)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    col = p["w_router"][:, 0] / np.linalg.norm(p["w_router"][:, 0])
    x = 0.3 * rng.randn(2, EP_TOKENS // 2, d).astype(np.float32)
    x[:, :-3] += 3.0 * col
    return cfg, x, p


def run_ep(arch, mesh, model):
    """The port's ep_shard_map on this rank's block (the whole batch: the
    mesh has data 1), with the expert weights placed by ``shard_params``
    (the expert dim over "model")."""
    cfg, x, p = ep_inputs(arch)
    bk = MeshTorchOps(mesh=mesh)
    specs = sharding.shard_params({"layers": {"moe": {
        k: v[None] for k, v in p.items()}}}, mesh)["layers"]["moe"]
    placed = {k: sharding.place({"w": torch.from_numpy(v)},
                                {"w": specs[k][1:]}, mesh)["w"]
              for k, v in p.items()}
    with torch.no_grad():
        y = TM.moe_mlp(bk, torch.from_numpy(x), placed,
                       n_experts=cfg.n_experts, top_k=cfg.top_k,
                       chunk_tokens=8)
    split = [str(placed[k].placements) for k in ("w_gate", "w_up",
                                                  "w_down")]
    return {"y": y.numpy(), "placements": split,
            "mode": "ep_shard_map" if TM._ep_mesh(bk, cfg.n_experts)
            is not None else "other"}


def checks(world):
    """{case: callable} of a world size; each returns numpy-able data."""
    out = {}
    if world == 2:
        meshes = {"2x1": (2, 1), "1x2": (1, 2)}
    else:
        meshes = {"2x2": (2, 2), "1x4": (1, 4)}
    for name, (d, m) in meshes.items():
        for path in PATHS:
            out[f"engine-{name}-{path}"] = (
                lambda d=d, m=m, path=path: {
                    "mesh": run_engine(path, meshlib.make_serving_mesh(
                        d, m, device="cpu")),
                    "alone": run_engine(path)})
    if world == 2:
        for name, (d, m) in meshes.items():
            for resident in ("on", "off"):
                out[f"serve-{name}-{resident}"] = (
                    lambda d=d, m=m, resident=resident: _serve(
                        meshlib.make_serving_mesh(d, m, device="cpu"),
                        resident))
            for mode in TRAIN_MODES:
                if "_" in mode and name != "1x2":
                    continue
                out[f"train-{name}-{mode}"] = (
                    lambda d=d, m=m, mode=mode: {
                        "mesh": run_train(mode, meshlib.make_serving_mesh(
                            d, m, device="cpu")),
                        "alone": run_train(mode)})
    if world == 4:
        for mode in TRAIN_MODES:
            out[f"train-2x2-{mode}"] = (
                lambda mode=mode: rank0_arrays({
                    "mesh": run_train(mode, meshlib.make_serving_mesh(
                        2, 2, device="cpu"), TRAIN_LAYERS_2X2, True),
                    "alone": run_train(mode, n_layers=TRAIN_LAYERS_2X2)}))
    mesh_dp = meshlib.make_serving_mesh(world, 1, device="cpu")
    for same in (True, False):
        out[f"psum-{world}-{'same' if same else 'own'}"] = (
            lambda same=same: {
                "rank": dist.get_rank(),
                "in": {k: v.numpy() for k, v in psum_grads(
                    dist.get_rank(), same).items()},
                "out": {k: v.numpy() for k, v in gc.compressed_psum_grads(
                    psum_grads(dist.get_rank(), same), mesh_dp).items()}})
    mesh_ep = meshlib.make_serving_mesh(1, world, device="cpu")
    for arch in EP_ARCHS:
        out[f"ep-{arch}-{world}"] = (
            lambda arch=arch: run_ep(arch, mesh_ep, world))
    return out


def _serve(mesh, resident):
    res = serve.main(["--device", "cpu", "--batch", "2", "--prefill-len",
                      "8", "--decode-steps", "3", "--precision-k", "12",
                      "--params-resident", resident], mesh=mesh)
    return {"tokens": res.tokens.numpy(),
            "prefill": res.prefill_logits.numpy(),
            "decode": np.stack([t.numpy() for t in res.decode_logits]),
            "resident": res.config.params_resident}


def run(rank, world, port, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    results = {}
    try:
        for case, fn in checks(world).items():
            try:
                results[case] = fn()
            except Exception:                      # reported by the test
                results[case] = {"error": traceback.format_exc()}
    finally:
        torch.save(results, f"{out_dir}/rank{rank}.pt")
        dist.destroy_process_group()
