"""The port on device meshes (``launch/mesh.py``, ``parallel/sharding.py``
and the paths that take a mesh) on the CPU: gloo ranks in worker processes,
one ``mp.spawn`` of 4 ranks and one of 2 for the whole module
(``tests/_torch_mesh_worker.py`` runs every check of a world and hands the
results back; the tests here hold them, one case each).

* The continuous-batching engine on (data, model) meshes (2, 1), (1, 2),
  (2, 2), (1, 4), SMOKE Qwen2-7B under a format map and at k = 12: every
  request's tokens equal the meshless port's, every rank holds the same
  results, and the logits are bitwise the meshless port's or within the
  GEMM rule, one f32 ulp plus 2·√K·2⁻²⁴·Σ|x̂||ŵ| of the LM head (its inputs
  taken from a forward of the request's tokens). Which of the two held is
  reported: a column split keeps every bit on the CPU; a lane split changes
  the rows of the CPU's library products, whose bits depend on them.
* ``serve.main`` on 2-rank meshes with ``params_resident`` on and off:
  tokens equal the meshless port's; logits bitwise on (1, 2), within the
  k = 12 parity rule (1e-3) where the batch is split over "data".
* Two training steps with ``param_sharding`` "fsdp" and "tp" on 2-rank
  meshes, at a width where the greedy rules split the layers, with no
  warm-up (every step moves each param by about lr), and on (1, 2) also
  with 8-bit moments and with error-feedback compression: the CPU training
  tests' rule against the meshless port, losses within 1e-5 relative and
  each gradient leaf the step clips within 1e-4 of its max |g|; each
  param's change within 1e-2 of that change's size (a rank that skipped
  the gradient mean, trained on other rows or did not update moves it by
  about its size). On (1, 2) no rank splits the batch, so the steps are
  the meshless ones bit for bit, the split state's blocks included.
* ``compressed_psum_grads`` at 2 and 4 ranks: with the same gradients on
  every rank bit for bit the reference's; with each rank's own, within one
  ulp of the formula computed in this process.
* ``ep_shard_map`` for SMOKE Mixtral and Llama-4 at model = 2 and 4 against
  the reference's ``_ep_experts`` on a JAX mesh of the same shape (run in a
  subprocess with forced host devices), within ``test_torch_moe``'s 1e-6 of
  max|y| (the capacity drops tokens in token order in both).
* On a 1 × 1 mesh every path is the meshless port's, bit for bit.
"""
import _torch_test_setup  # noqa: F401  (before any reference compile)
import math
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_mesh_worker as W
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import grad_compress as gc

SPAWN_TIMEOUT_S = 600
ENGINE_CASES = [f"{m}-{p}" for m in ("2x1", "1x2", "2x2", "1x4")
                for p in W.PATHS]
SERVE_CASES = [f"{m}-{r}" for m in ("2x1", "1x2") for r in ("on", "off")]
TRAIN_CASES = [f"{m}-{s}" for m in ("2x1", "1x2") for s in ("fsdp", "tp")
               ] + ["1x2-fsdp_8bit", "1x2-fsdp_ef"]
TRAIN_CASES_2X2 = [f"2x2-{m}" for m in W.TRAIN_MODES]
PSUM_CASES = [f"{w}-{s}" for w in (2, 4) for s in ("same", "own")]
EP_CASES = [f"{a}-{m}" for a in W.EP_ARCHS for m in (2, 4)]
Y_REL = 1e-6
LOSS_REL = 1e-5
GRAD_REL = 1e-4
DELTA_REL = 1e-2

_SPAWNED = {}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawned(world: int):
    """Every rank's results of the ``world``-rank spawn (run once)."""
    if world not in _SPAWNED:
        out = tempfile.mkdtemp(prefix=f"mesh{world}_")
        ctx = mp.start_processes(W.run, args=(world, _free_port(), out),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world}-rank spawn")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        _SPAWNED[world] = [torch.load(f"{out}/rank{r}.pt",
                                      weights_only=False)
                           for r in range(world)]
        shutil.rmtree(out, ignore_errors=True)
    return _SPAWNED[world]


def results(world: int, case: str):
    """Each rank's result of ``case``; a rank's exception fails the test."""
    got = [r[case] for r in spawned(world)]
    for rank, r in enumerate(got):
        assert "error" not in r, f"rank {rank}:\n{r['error']}"
    return got


def _world(mesh_name: str) -> int:
    return math.prod(int(n) for n in mesh_name.split("x"))


# -- the engine ---------------------------------------------------------------

def head_bound(path, tokens, prompt):
    """One f32 ulp of each logit plus 2·√K·2⁻²⁴·(|x̂|@|ŵ|ᵀ) of the LM head,
    its inputs those of a forward of the request's tokens."""
    cfg, params = W.qwen_params()
    seq = list(prompt) + list(tokens[:-1])
    seen = []
    head = L.logits_head

    def spy(bk, x, table, softcap=None):
        seen.append(x)
        return head(bk, x, table, softcap)

    sc = serve.ServeConfig(device="cpu", **W.PATHS[path])
    L.logits_head = spy
    try:
        with torch.no_grad():
            logits, _ = T.forward(serve._backend(sc), params, cfg,
                                  torch.tensor([seq]))
    finally:
        L.logits_head = head
    x = seen[0][0, len(prompt) - 1:]
    w = params["embed"] if cfg.tie_embeddings else params["head"]
    K = x.shape[-1]
    mag = x.abs() @ w.abs().T
    ulp = torch.finfo(torch.float32).eps * logits[0, len(prompt) - 1:].abs()
    return (ulp + 2 * math.sqrt(K) * 2.0 ** -24 * mag).numpy()


@pytest.mark.parametrize("case", ENGINE_CASES)
def test_engine_on_a_mesh_serves_the_meshless_tokens(case):
    mesh_name, path = case.split("-")
    got = results(_world(mesh_name), f"engine-{case}")
    reqs = {r.rid: r for r in W.engine_requests(W.qwen_params()[0].vocab)}
    bitwise = True
    for rank, r in enumerate(got):
        mesh, alone = r["mesh"], r["alone"]
        assert sorted(mesh) == sorted(alone) == sorted(reqs)
        for rid in alone:
            assert mesh[rid][0] == alone[rid][0], (rank, rid)
            np.testing.assert_array_equal(mesh[rid][1], got[0]["mesh"][rid][1])
            if np.array_equal(mesh[rid][1], alone[rid][1]):
                continue
            bitwise = False
            tol = head_bound(path, alone[rid][0], reqs[rid].prompt)
            diff = np.abs(mesh[rid][1] - alone[rid][1])
            assert (diff <= tol).all(), (rank, rid, float(diff.max()))
    print(f"engine {case}: logits "
          f"{'bitwise' if bitwise else 'within the GEMM rule'}")
    if mesh_name in ("1x2", "1x4"):
        assert bitwise          # columns and heads split: exact gathers


# -- serve.main ---------------------------------------------------------------

SERVE_ARGV = ["--device", "cpu", "--batch", "2", "--prefill-len", "8",
              "--decode-steps", "3", "--precision-k", "12"]


def meshless_serve():
    """``serve.main``'s run without a mesh: its params, prompt, backend
    and loop."""
    cfg = serve.configs.get("qwen2_7b").SMOKE
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    sc = serve.ServeConfig(batch=2, max_seq=12, prefill_len=8,
                           precision_k=12, device="cpu")
    cache = T.init_cache(cfg, 2, sc.max_seq, device="cpu")
    prompt = torch.from_numpy(
        np.random.RandomState(0).randint(0, cfg.vocab, (2, 8)))
    bk = serve._backend(sc)
    with torch.no_grad():
        logits, cache = serve.prefill_step(bk, params, cfg, cache, prompt)
        tok = torch.argmax(logits[:, -1], -1)
        toks, rows = [tok], []
        for i in range(3):
            tok, last, cache = serve.decode_step(bk, params, cfg, cache,
                                                 tok[:, None], 8 + i)
            toks.append(tok)
            rows.append(last)
    return {"tokens": torch.stack(toks, 1).numpy(), "prefill":
            logits.numpy(), "decode": torch.stack(rows).numpy()}


@pytest.mark.parametrize("case", SERVE_CASES)
def test_serve_main_on_two_ranks(case):
    """Tokens equal; logits bitwise where the batch is whole on every rank
    (a column split), else within the k = 12 serving rule of the parity
    tests (1e-3: a product rounded at k may land an ulp at k apart once the
    CPU's rows change)."""
    mesh_name, resident = case.split("-")
    want = meshless_serve()
    for rank, r in enumerate(results(2, f"serve-{case}")):
        assert r["resident"] is (resident == "on")
        np.testing.assert_array_equal(r["tokens"], want["tokens"])
        for key in ("prefill", "decode"):
            if mesh_name == "1x2":
                np.testing.assert_array_equal(r[key], want[key],
                                              err_msg=f"rank {rank} {key}")
            else:
                np.testing.assert_allclose(r[key], want[key], rtol=0,
                                           atol=1e-3,
                                           err_msg=f"rank {rank} {key}")


# -- training -----------------------------------------------------------------

def hold_training(mesh, alone):
    """The CPU training tests' rule, mesh run against meshless run: each
    step's loss within 1e-5 relative, each step's gradient leaf (whole,
    averaged over the ranks, as the step clips it) within 1e-4 of its max
    |g|; and each param's change over the steps within DELTA_REL of that
    change's max, which is at least lr/2 (no warm-up: the steps move every
    leaf)."""
    for a, b in zip(mesh["losses"], alone["losses"]):
        assert abs(a - b) <= LOSS_REL * abs(b), (a, b)
    assert len(mesh["grads"]) == len(alone["grads"]) == W.TRAIN_STEPS
    for step, (gm, ga) in enumerate(zip(mesh["grads"], alone["grads"])):
        assert sorted(gm) == sorted(ga)
        for name, g in ga.items():
            d = float(np.abs(gm[name] - g).max())
            assert d <= GRAD_REL * float(np.abs(g).max()), (step, name, d)
    worst = 0.0
    for name, p0 in alone["before"].items():
        np.testing.assert_array_equal(mesh["before"][name], p0)
        want = alone["params"][name] - p0
        size = float(np.abs(want).max())
        assert size >= 0.5 * alone["lr"], (name, size)
        d = float(np.abs(mesh["params"][name] - p0 - want).max()) / size
        assert d <= DELTA_REL, (name, d)
        worst = max(worst, d)
    return worst


@pytest.mark.parametrize("case", TRAIN_CASES_2X2)
def test_training_steps_on_four_ranks(case):
    """2 × 2 (batch and layers split), 3 layers, so that the 8-bit
    payloads' layer rows lie on both model ranks. Every step's update is
    the meshless ``opt.update`` of the run's own state and clipped
    gradients, bit for bit. "fsdp" and "tp" hold the training rule. The
    codecs (8-bit moments, EF) round to int8 codes, so a gradient an ulp
    apart (the rows are split) can take the neighbouring code: their
    losses hold the training rule, the 8-bit case's gradients too (they
    are coded after the clip), and the param change is reported."""
    mode = case.split("-")[1]
    got = results(4, f"train-{case}")
    for rank, r in enumerate(got):      # ranks > 0 send their digest
        assert r["digest"] == got[0]["digest"], rank
        assert not any(r["replay"]), (rank, r["replay"])
        assert r["split_leaves"] > 0, mode
    r = got[0]
    assert len(r["mesh"]["replay"]) == W.TRAIN_STEPS
    if mode in ("fsdp", "tp"):
        worst = hold_training(r["mesh"], r["alone"])
        print(f"train {case}: param change within {worst:.3g} of its size")
        return
    for a, b in zip(r["mesh"]["losses"], r["alone"]["losses"]):
        assert abs(a - b) <= LOSS_REL * abs(b), (a, b)
    if mode == "fsdp_8bit":
        for gm, ga in zip(r["mesh"]["grads"], r["alone"]["grads"]):
            for name, g in ga.items():
                d = float(np.abs(gm[name] - g).max())
                assert d <= GRAD_REL * float(np.abs(g).max()), (name, d)
    worst = max(float(np.abs(r["mesh"]["params"][n] - p
                             - (r["alone"]["params"][n] - p)).max())
                / float(np.abs(r["alone"]["params"][n] - p).max())
                for n, p in r["alone"]["before"].items())
    print(f"train {case}: param change within {worst:.3g} of its size "
          "(codes apart; not held)")


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_training_steps_on_two_ranks(case):
    mesh_name, mode = case.split("-")
    for rank, r in enumerate(results(2, f"train-{case}")):
        worst = hold_training(r["mesh"], r["alone"])
        if mesh_name == "1x2":
            assert r["mesh"]["losses"] == r["alone"]["losses"]
            for name, p in r["alone"]["params"].items():
                np.testing.assert_array_equal(r["mesh"]["params"][name], p)
        print(f"train {case} rank {rank}: param change within "
              f"{worst:.3g} of its size")
        # fsdp splits the layers' weights on any mesh; tp only over model
        want_split = mode.startswith("fsdp") or mesh_name == "1x2"
        assert (r["mesh"]["split_leaves"] > 0) == want_split, \
            r["mesh"]["split_leaves"]


REF_STEP_SCRIPT = """
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
import repro
from repro import configs as jconfigs
from repro.data import pipeline as jpipe
from repro.launch import train as jtrain
from repro.optim import optimizer as jopt
sys.path.insert(0, {tests!r})
import _torch_mesh_worker as W
before = dict(np.load({inp!r}))
cfg = dataclasses.replace(jconfigs.get("qwen2_7b").SMOKE, **W.TRAIN_CFG,
                          n_layers=W.TRAIN_LAYERS_2X2)
tc = jtrain.TrainConfig(seq=W.TRAIN_SEQ, global_batch=W.TRAIN_BATCH,
                        steps=W.TRAIN_STEPS, param_sharding="fsdp")
adam = jopt.AdamWConfig(warmup_steps=W.TRAIN_ADAM.warmup_steps)
dc = jpipe.DataConfig(vocab=cfg.vocab, seq=W.TRAIN_SEQ,
                      global_batch=W.TRAIN_BATCH)
def fresh():
    params = {{}}
    for name, a in before.items():
        *keys, last = name.split("/")
        d = params
        for k in keys:
            d = d.setdefault(k, {{}})
        d[last] = jnp.asarray(a.copy())
    return params
flat = lambda tree: {{"/".join(str(k.key) for k in path): np.asarray(a)
                     for path, a in jax.tree_util.tree_flatten_with_path(
                         tree)[0]}}
out = {{}}
for tag, shape in (("mesh", (2, 2)), ("one", (1, 1))):
    mesh = Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape),
                ("data", "model"))
    step_fn, _, sh = jtrain.build_train_step(cfg, tc, mesh, adam)
    vg = jax.jit(jax.value_and_grad(jtrain.make_loss_fn(cfg, tc, mesh=mesh)),
                 in_shardings=(sh["state"]["params"], sh["batch"]))
    batch = jax.device_put(jpipe.batch_at(dc, 0), sh["batch"])
    _, g = vg(jax.device_put(fresh(), sh["state"]["params"]), batch)
    out.update({{f"{{tag}}/grad/{{k}}": v for k, v in flat(g).items()}})
    params = fresh()
    state = jax.device_put({{"params": params,
                            "opt": jopt.init(params, adam), "ef": None}},
                           sh["state"])
    losses = []
    for step in range(W.TRAIN_STEPS):
        state, loss = step_fn(state, jax.device_put(
            jpipe.batch_at(dc, step), sh["batch"]))
        losses.append(float(loss))
    out[f"{{tag}}/losses"] = np.array(losses)
    out.update({{f"{{tag}}/after/{{k}}": v for k, v in flat(
        state["params"]).items()}})
np.savez({out!r}, **out)
"""


def test_mesh_step_matches_reference_mesh_step():
    """The reference's ``build_train_step`` on a 2 × 2 JAX host mesh (Auto
    axes, 4 forced host devices, in a subprocess) from the port's 2 × 2
    "fsdp" run's own params, through numpy: the port's losses within 1e-5
    relative of the reference's, and the first step's gradients (whole,
    averaged) within GRAD_REL of each leaf's max against the reference's
    gradients on its mesh. Each param's change is reported beside the
    spread of the reference's own 2 × 2 step against its 1 × 1 step, and
    not held: AdamW's m / (√v + ε) turns a gradient's last bits into a
    large part of the update of an element whose gradient is near ε, and
    the reference's two steps differ by more than DELTA_REL of the change
    on some leaves themselves. The update itself is held bit for bit to
    the meshless ``opt.update`` (:func:`test_training_steps_on_four_ranks`)
    and ``opt.update`` to the reference's (``test_torch_optim``)."""
    r = results(4, "train-2x2-fsdp")[0]["mesh"]           # rank 0's arrays
    tests = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="ref_step_")
    inp, out = os.path.join(tmp, "before.npz"), os.path.join(tmp, "ref.npz")
    np.savez(inp, **r["before"])
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    subprocess.run([sys.executable, "-c", REF_STEP_SCRIPT.format(
        tests=tests, inp=inp, out=out)], env=env, check=True, timeout=600)
    ref = dict(np.load(out))
    assert len(r["losses"]) == len(ref["mesh/losses"]) == W.TRAIN_STEPS
    for a, b in zip(r["losses"], ref["mesh/losses"]):
        assert abs(a - b) <= LOSS_REL * abs(b), (a, b)
    for name, g in r["grads"][0].items():
        want = ref[f"mesh/grad/{name}"]
        d = float(np.abs(g - want).max())
        assert d <= GRAD_REL * float(np.abs(want).max()), (name, d)
    worst = {}
    for name, p0 in r["before"].items():
        change = ref[f"mesh/after/{name}"] - p0
        size = float(np.abs(change).max())
        assert size >= 0.5 * r["lr"], (name, size)
        d = float(np.abs(r["params"][name] - p0 - change).max()) / size
        spread = float(np.abs(ref[f"one/after/{name}"] - p0 - change).max()
                       ) / size
        worst[name] = (round(d, 5), round(spread, 5))
    print(f"2x2 fsdp vs the reference's mesh step: losses {r['losses']} / "
          f"{ref['mesh/losses'].tolist()}; param change (port, the "
          f"reference's 1x1) against it: {worst}")


# -- compressed_psum_grads ----------------------------------------------------

def _ulp(x):
    return np.spacing(np.abs(x).astype(np.float32))


@pytest.mark.parametrize("case", PSUM_CASES)
def test_compressed_psum_grads(case):
    world, kind = case.split("-")
    got = results(int(world), f"psum-{case}")
    ins = [r["in"] for r in got]
    if kind == "same":
        import jax
        import jax.numpy as jnp
        from jax.sharding import Mesh
        from repro.optim import grad_compress as jgc

        mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
        want = jgc.compressed_psum_grads(
            {k: jnp.asarray(v) for k, v in ins[0].items()}, mesh)
        for r in got:
            for k, v in want.items():
                np.testing.assert_array_equal(r["out"][k], np.asarray(v))
        return
    n = len(got)
    for k in W.PSUM_SHAPES:
        qs = [gc._quant_int8(torch.from_numpy(g[k])) for g in ins]
        q = sum(a.to(torch.int32) for a, _ in qs)
        s = sum(b for _, b in qs)
        want = gc._dequant_int8(q.to(torch.float32) / n, s / n,
                                ins[0][k].shape).numpy()
        for r in got:
            assert (np.abs(r["out"][k] - want) <= _ulp(want)).all(), k


# -- ep_shard_map -------------------------------------------------------------

_EP_REF = {}

EP_REF_SCRIPT = """
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
import repro
from repro.core.backend import JOps
from repro.models import moe as JM
sys.path.insert(0, {tests!r})
import _torch_mesh_worker as W
out = {{}}
for arch in W.EP_ARCHS:
    cfg, x, p = W.ep_inputs(arch)
    for m in (2, 4):
        mesh = Mesh(np.array(jax.devices()[:m]).reshape(1, m),
                    ("data", "model"))
        bk = JOps(jnp.float32, jnp.float32, mesh=mesh)
        y = JM._ep_experts(bk, jnp.asarray(x),
                           {{k: jnp.asarray(v) for k, v in p.items()}},
                           cfg.n_experts, cfg.top_k, cfg.act, 1.25, 8)
        out[f"{{arch}}-{{m}}"] = np.asarray(y)
np.savez({path!r}, **out)
"""


def ep_reference():
    """The reference's ``_ep_experts`` on (1, 2) and (1, 4) JAX meshes, in a
    process with 8 forced host devices."""
    if not _EP_REF:
        tests = os.path.dirname(os.path.abspath(__file__))
        path = os.path.join(tempfile.mkdtemp(prefix="ep_ref_"), "ep.npz")
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=8")
        subprocess.run([sys.executable, "-c", EP_REF_SCRIPT.format(
            tests=tests, path=path)], env=env, check=True, timeout=600)
        _EP_REF.update(np.load(path))
    return _EP_REF


@pytest.mark.parametrize("case", EP_CASES)
def test_ep_shard_map_matches_reference(case):
    arch, m = case.rsplit("-", 1)
    want = ep_reference()[case]
    scale = float(np.abs(want).max())
    for rank, r in enumerate(results(int(m), f"ep-{case}")):
        assert r["mode"] == "ep_shard_map"
        assert all("Shard(dim=0)" in p for p in r["placements"]), r
        np.testing.assert_allclose(r["y"], want, rtol=0, atol=Y_REL * scale,
                                   err_msg=f"rank {rank}")
    # the capacity binds: some chunk routes more tokens to an expert than
    # it has slots, so both packages dropped (the same) assignments
    cfg, x, p = W.ep_inputs(arch)
    xt = x.reshape(-1, x.shape[-1]).astype(np.float64)
    logits = xt @ p["w_router"]
    top = np.argsort(-logits, axis=-1, kind="stable")[:, :cfg.top_k]
    C = max(1, int(8 * cfg.top_k / cfg.n_experts * 1.25))
    counts = [np.bincount(top[s:s + 8].ravel(), minlength=cfg.n_experts)
              for s in range(0, len(top), 8)]
    assert max(int(c.max()) for c in counts) > C


# -- the 1 × 1 mesh -----------------------------------------------------------

ONE_CASES = ["engine-format", "engine-k12", "serve", "train-fsdp",
             "train-tp", "train-fsdp_8bit", "train-fsdp_ef"]


@pytest.mark.parametrize("case", ONE_CASES)
def test_one_by_one_mesh_is_the_meshless_port(case):
    mesh = meshlib.make_serving_mesh(1, 1, device="cpu")
    kind, _, arg = case.partition("-")
    if kind == "engine":
        got, want = W.run_engine(arg, mesh), W.run_engine(arg)
        for rid in want:
            assert got[rid][0] == want[rid][0]
            np.testing.assert_array_equal(got[rid][1], want[rid][1])
    elif kind == "serve":
        res = serve.main(SERVE_ARGV, mesh=mesh)
        want = meshless_serve()
        np.testing.assert_array_equal(res.tokens.numpy(), want["tokens"])
        np.testing.assert_array_equal(res.prefill_logits.numpy(),
                                      want["prefill"])
        np.testing.assert_array_equal(
            np.stack([t.numpy() for t in res.decode_logits]),
            want["decode"])
    else:
        got, want = W.run_train(arg, mesh), W.run_train(arg)
        assert got["losses"] == want["losses"]
        for gm, ga in zip(got["grads"], want["grads"]):
            for name, g in ga.items():
                np.testing.assert_array_equal(gm[name], g)
        for name, p in want["params"].items():
            np.testing.assert_array_equal(got["params"][name], p)
