"""Worker processes of ``tests/test_torch_mesh_dist.py``: one ``mp.spawn``
of gloo ranks on the CPU runs every check of a world size and hands its
results back in a file. Imports neither ``jax`` nor ``repro`` (each rank
would pay JAX's start-up); the reference's results come from the parent.

Run as ``mp.spawn(run, args=(world, port, out_dir), nprocs=world)``: rank
r writes ``out_dir/rank{r}.pt``, a dict {case: result}; a check that
raises stores its traceback under its case instead.
"""
import dataclasses
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


def train_cfg():
    return dataclasses.replace(configs.get("qwen2_7b").SMOKE, **TRAIN_CFG)


def run_train(mode, mesh=None):
    """Losses of TRAIN_STEPS steps, the gradients each step clipped (whole,
    averaged over the ranks), and the params (whole) before and after.
    No warm-up: every step moves the params by about lr."""
    cfg = train_cfg()
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
    clip_factor = opt.clip_factor

    def spy(tree, cfg):             # both paths clip the whole gradients
        grads.append({"/".join(k): g.detach().numpy().copy()
                      for k, g in opt.tree_paths(tree)})
        return clip_factor(tree, cfg)

    opt.clip_factor = spy
    try:
        for step in range(TRAIN_STEPS):
            state, loss = step_fn(state, train.batch_for(cfg, dc, step,
                                                         "cpu"))
            losses.append(float(loss))
    finally:
        opt.clip_factor = clip_factor
    split = sum(any(p.is_shard() for p in v.placements)
                for _, v in opt.tree_paths(state["params"])
                if hasattr(v, "placements"))
    return {"losses": losses, "grads": grads, "before": before,
            "params": whole(), "split_leaves": split,
            "lr": float(opt.schedule(TRAIN_ADAM, 1))}


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
