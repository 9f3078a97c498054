"""The port's training path (``repro_torch.launch.train``,
``models.transformer.next_token_loss``) against the JAX package's, on the
CPU, at the SMOKE configs cut to 2 layers, seq 16, batch 2.

The reference's step is built from its ``make_loss_fn(..., mesh=None)``,
``jax.value_and_grad`` and ``opt.update``: its ``build_train_step`` does
not run on this JAX (``with_sharding_constraint`` at
``models/transformer.py:522`` refuses the Explicit axes of
``make_host_mesh``).

* Loss and gradients, all ten archs, on the reference's parameters carried
  across (``params_from_numpy``) and the same batch (the stateless
  stream, bit for bit the reference's; the stub's inputs drawn as the
  reference's `main` draws them): the loss within 1e-5 relative, each
  gradient leaf within 1e-4 of that leaf's max |g|. One leaf is held to
  the whole tree's max |g| instead: Llama-4's router under top-1, whose
  gradient is zero analytically (the renormalised gate of one expert is
  p / p = 1), so that both packages give rounding noise; its entries
  must also stay below 1e-6 of the tree's max in both.
* Three whole steps of each mode (f32, 8-bit moments, error-feedback
  compression): the losses within 1e-5 relative. Parameters are not held
  after a step: Adam turns a noise-level gradient into a ±lr step, so an
  entry whose gradient's sign differs between the packages moves 2·lr
  apart (the optimizer itself is held on the reference's own gradients
  in ``tests/test_torch_optim.py``).
* Remat (each layer checkpointed, recomputed in the backward) gives the
  same gradients as no remat, bit for bit, for all ten archs.
* The port's own restart: three steps, a checkpoint, a restore (into a
  template on the meta device) and three more steps equal six
  uninterrupted steps bit for bit, losses, parameters and moments; the
  same through the CLI (``main`` with ``--checkpoint-every 3`` then
  ``--resume 3``).
* The route rule: under autograd every card kernel route of ``TorchOps``
  steps aside (``kernel_route_ok``) and the ops keep their ``grad_fn``;
  without a gradient the routes are taken (a tensor that reports
  ``is_cuda`` and recording dispatchers stand in for the card).
"""
import _torch_test_setup  # noqa: F401  (before any reference compile)
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipe
from repro.launch import train as jtrain
from repro.models import transformer as JT
from repro.optim import grad_compress as jgc
from repro.optim import optimizer as jopt
from repro_torch import configs as tconfigs
from repro_torch.checkpoint.checkpointing import Checkpointer, _items
from repro_torch.convert import params_from_numpy
from repro_torch.core import backend as tbackend
from repro_torch.core.backend import TorchOps, kernel_route_ok
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as TT
from repro_torch.optim import optimizer as topt

B, S, LAYERS = 2, 16, 2
# leaves whose gradient is zero analytically (rounding noise in both)
ZERO_GRAD = {"llama4_maverick": {("layers", "moe", "w_router")}}


def configs_for(arch):
    jcfg = dataclasses.replace(jconfigs.get(arch).SMOKE, n_layers=LAYERS)
    tcfg = dataclasses.replace(tconfigs.get(arch).SMOKE, n_layers=LAYERS)
    if jcfg.enc_dec:
        jcfg = dataclasses.replace(jcfg, n_enc_layers=LAYERS)
        tcfg = dataclasses.replace(tcfg, n_enc_layers=LAYERS)
    return jcfg, tcfg


def batches(jcfg, tcfg, step):
    """The reference's batch and the port's for ``step``: the stream's
    tokens and the stub's inputs from ``RandomState(step)``."""
    tb = ttrain.batch_for(tcfg, tpipe.DataConfig(
        vocab=tcfg.vocab, seq=S, global_batch=B), step, "cpu")
    jb = dict(jpipe.batch_at(jpipe.DataConfig(
        vocab=jcfg.vocab, seq=S, global_batch=B), step))
    if "frontend" in tb:
        jb["frontend"] = tb["frontend"].numpy()
    return jb, tb


def j_leaves(tree):
    return {tuple(p.key for p in path): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_loss_and_grads_match_reference(arch):
    jcfg, tcfg = configs_for(arch)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    jb, tb = batches(jcfg, tcfg, 0)
    tc_j = jtrain.TrainConfig(seq=S, global_batch=B)
    jl, jg = jax.value_and_grad(jtrain.make_loss_fn(jcfg, tc_j,
                                                    mesh=None))(jp, jb)
    tl, tg = ttrain.loss_and_grads(
        ttrain.make_loss_fn(tcfg, ttrain.TrainConfig(seq=S, global_batch=B)),
        tp, tb)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    jg, tg = j_leaves(jg), dict(topt.tree_paths(tg))
    assert sorted(jg) == sorted(tg)
    tree_max = max(float(np.abs(g).max()) for g in jg.values())
    for path, g in jg.items():
        got = tg[path].numpy()
        scale = float(np.abs(g).max())
        if path in ZERO_GRAD.get(arch, ()):
            assert scale <= 1e-6 * tree_max
            assert float(np.abs(got).max()) <= 1e-6 * tree_max
            scale = tree_max
        assert np.all(np.isfinite(got)), path
        assert float(np.abs(got - g).max()) <= 1e-4 * scale, path


@pytest.mark.parametrize("mode", ["f32", "8bit", "ef"])
def test_three_steps_losses_match_reference(mode):
    jcfg, tcfg = configs_for("qwen2_7b")
    kw = dict(seq=S, global_batch=B, steps=3,
              quantized_moments=mode == "8bit",
              grad_compression=mode == "ef")
    vg = jax.jit(jax.value_and_grad(jtrain.make_loss_fn(
        jcfg, jtrain.TrainConfig(**kw), mesh=None)))
    ocfg = jopt.AdamWConfig(quantized_moments=mode == "8bit", total_steps=3)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    js, ef = jopt.init(jp, ocfg), jgc.init_ef(jp)
    tc = ttrain.TrainConfig(**kw)
    step_fn, _ = ttrain.build_train_step(tcfg, tc, "cpu")
    state = ttrain.init_state(tp, tc, topt.AdamWConfig(
        quantized_moments=mode == "8bit", total_steps=3))
    for i in range(3):
        jb, tb = batches(jcfg, tcfg, i)
        jl, g = vg(jp, jb)
        if mode == "ef":
            g, ef = jgc.compress_tree(g, ef)
        jp, js = jopt.update(jp, g, js, ocfg)
        state, tl = step_fn(state, tb)
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl)), i
    assert int(state["opt"].step) == 3


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_remat_grads_bitwise_equal_plain(arch):
    _, tcfg = configs_for(arch)
    params = TT.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    _, tb = batches(tcfg, tcfg, 1)
    out = {}
    for remat in (True, False):
        tc = ttrain.TrainConfig(seq=S, global_batch=B, remat=remat)
        out[remat] = ttrain.loss_and_grads(ttrain.make_loss_fn(tcfg, tc),
                                           params, tb)
    assert torch.equal(out[True][0], out[False][0])
    a, b = (dict(topt.tree_paths(out[r][1])) for r in (True, False))
    for path, g in a.items():
        assert torch.equal(g, b[path]), path


def state_leaves(state):
    return dict(_items(state))


@pytest.mark.parametrize("mode", ["f32", "8bit", "ef"])
def test_restart_bitexact(tmp_path, mode):
    """Kill-and-restore mid-run reproduces the uninterrupted run (the
    stateless pipeline and the whole state in the checkpoint): the port's
    own ``test_training_restart_bitexact``, held to itself."""
    _, tcfg = configs_for("qwen2_7b")
    tc = ttrain.TrainConfig(seq=S, global_batch=B, steps=6,
                            quantized_moments=mode == "8bit",
                            grad_compression=mode == "ef")
    adam = topt.AdamWConfig(quantized_moments=tc.quantized_moments,
                            total_steps=tc.steps)
    dc = tpipe.DataConfig(vocab=tcfg.vocab, seq=S, global_batch=B)
    step_fn, init_fn = ttrain.build_train_step(tcfg, tc, "cpu", adam)
    s = init_fn(torch.Generator().manual_seed(0))
    losses_a = [float(step_fn(s, tpipe.batch_at(dc, i))[1])
                for i in range(6)]
    ck = Checkpointer(str(tmp_path))
    s = init_fn(torch.Generator().manual_seed(0))
    for i in range(3):
        step_fn(s, tpipe.batch_at(dc, i))
    ck.save(3, s)
    del s
    s2, manifest = ck.restore(ttrain.state_template(tcfg, tc, adam),
                              device="cpu")
    assert manifest["step"] == 3 and int(s2["opt"].step) == 3
    losses_b = [float(step_fn(s2, tpipe.batch_at(dc, i))[1])
                for i in range(3, 6)]
    assert losses_a[3:] == losses_b
    s = init_fn(torch.Generator().manual_seed(0))
    for i in range(6):
        step_fn(s, tpipe.batch_at(dc, i))
    want, got = state_leaves(s), state_leaves(s2)
    assert sorted(want) == sorted(got)
    for k, t in want.items():
        assert torch.equal(t, got[k]), k


def test_main_resume_is_bitexact(tmp_path, capsys):
    argv = ["--device", "cpu", "--steps", "6", "--seq", "16",
            "--global-batch", "2", "--checkpoint-dir", str(tmp_path),
            "--checkpoint-every", "3"]
    a = ttrain.main(argv)
    assert sorted(a.losses) == list(range(6)) and a.start_step == 0
    assert [c["step"] for c in a.checkpoints] == [3, 6]
    assert all(c["bytes"] > 0 and c["write_s"] >= 0 for c in a.checkpoints)
    out = capsys.readouterr().out
    assert "step     0  loss " in out and "step     5  loss " in out
    b = ttrain.main(argv + ["--resume", "3"])
    assert b.start_step == 3 and b.restore_s is not None
    assert [b.losses[i] for i in (3, 4, 5)] == [a.losses[i] for i in (3, 4, 5)]
    want, got = state_leaves(a.state), state_leaves(b.state)
    for k, t in want.items():
        assert torch.equal(t, got[k]), k
    # --resume alone takes the latest checkpoint: step 6, nothing to run
    c = ttrain.main(argv + ["--resume"])
    assert c.start_step == 6 and c.losses == {}


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_main_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--steps", "1"])


# -- the route rule --------------------------------------------------------

class OnCard(torch.Tensor):
    """A CPU tensor that reports ``is_cuda``: it takes the card's routes."""

    @property
    def is_cuda(self):
        return True


@pytest.fixture
def dispatchers(monkeypatch):
    """The card's dispatchers replaced by recording library versions."""
    calls = []
    ro = tbackend.row_order

    def record(name, fn):
        def run(*a):
            calls.append(name)
            return fn(*a)
        monkeypatch.setattr(ro, name, run)

    record("row_mean_dispatch", lambda a: a.mean(-1, keepdim=True))
    record("matmul_dispatch", lambda a, b: a @ b)
    record("lm_head_dispatch", lambda a, t: a @ t)
    record("transposed", lambda t: t.t().contiguous())
    record("block_diagonal", lambda w: torch.block_diag(*w))
    return calls


def test_kernel_route_ok():
    x, w = torch.ones(2, 3), torch.ones(3, 4, requires_grad=True)
    assert kernel_route_ok(x) and not kernel_route_ok(x, w)
    with torch.no_grad():
        assert kernel_route_ok(x, w)


def test_routes_step_aside_under_autograd(dispatchers):
    bk = TorchOps()
    x = torch.randn(2, 1, 6).as_subclass(OnCard).requires_grad_(True)
    w = torch.randn(6, 5).as_subclass(OnCard).requires_grad_(True)
    table = torch.randn(9, 6).as_subclass(OnCard).requires_grad_(True)
    wh = torch.randn(4, 2, 3).as_subclass(OnCard).requires_grad_(True)
    outs = [bk.mean(bk.square(x), dim=-1, keepdim=True), bk.matmul(x, w),
            bk.einsum("bsd,vd->bsv", x, table),
            bk.per_head_matmul(x.reshape(2, 1, 2, 3), wh, into=True)]
    assert dispatchers == [] and bk._head_t is None
    for out in outs:
        assert out.grad_fn is not None
    sum(o.sum() for o in outs).backward()
    for t in (x, w, table, wh):
        assert t.grad is not None and torch.isfinite(t.grad).all()
    q = torch.randn(2, 1, 2, 3).as_subclass(OnCard).requires_grad_(True)
    kv = torch.randn(2, 5, 1, 3).as_subclass(OnCard)
    assert bk.decode_attention(q, kv, kv, torch.tensor([5, 5])) is None
    assert bk.windowed_decode_attention(q, kv, kv, torch.tensor([5, 5]),
                                        2, 0.0) is None


def test_routes_are_taken_without_a_gradient(dispatchers):
    bk = TorchOps()
    x = torch.randn(2, 1, 6).as_subclass(OnCard)
    w = torch.randn(6, 5, requires_grad=True).as_subclass(OnCard)
    with torch.no_grad():
        bk.mean(bk.square(x), dim=-1, keepdim=True)
        bk.matmul(x, w)
        bk.einsum("bsd,vd->bsv", x, torch.randn(9, 6).as_subclass(OnCard))
        bk.per_head_matmul(x.reshape(2, 1, 2, 3),
                           torch.randn(4, 2, 3).as_subclass(OnCard),
                           into=True)
    assert dispatchers == ["row_mean_dispatch", "matmul_dispatch",
                           "transposed", "lm_head_dispatch",
                           "block_diagonal", "matmul_dispatch"]
