"""The port's MoE (``repro_torch.models.moe``) and the MoE archs' analysis
and certification, against the JAX package's ``repro.models.moe`` on the
CPU, with the reference's weights and inputs made from a seed in numpy.

* ``moe_mlp`` in its two single-device modes, ``dense`` and ``dropping``,
  with JOps / TorchOps, top-1 and top-2, SiLU and tanh-GELU, on a batch
  built so that one expert overflows its capacity (tokens aligned with its
  router column) and cut into token chunks with a padded last one: the
  same assignments dropped (counted by ``moe.drop_log`` and recomputed from
  the reference's gates), the outputs within 1e-6 of max|y| (f32 products
  of the same terms in other orders: XLA's one-hot einsums against the
  port's gathers and batched products). Where the two packages' routes
  differ (a route flip) the test reports it and asserts that the
  reference's top-k margin there is below the router probabilities'
  tolerance, 1e-6: it does not pick inputs to avoid flips.
* ``aux_load_balance_loss``; ``ep_shard_map`` on a one-rank mesh against
  the reference's on a one-device mesh, and refused without a mesh.
* TorchOps' ops that the MoE and Gemma-2 paths added, against JOps.
* Mixtral's and Llama-4's ``CaaOps`` forward (router records included) and
  ``certify_lm`` decisions, with the tolerances of ``tests/
  test_torch_zoo.py``; the router records' ``flip_safe_if_u_le`` within
  1e-6 (it divides the margin by the distance from the emulated value to
  the exact enclosure, whose f64 interval sums add in other orders in the
  two packages: 1.6e-7 measured), their ``min_margin`` within 1e-9.
* ``python -m repro_torch.launch.analyze --routers`` on Mixtral.
"""
import _torch_test_setup  # noqa: F401  (before any reference compile)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.backend import JOps
from repro.models import moe as JM
from repro_torch.core.backend import MeshTorchOps, TorchOps
from repro_torch.models import moe as TM
from test_torch_zoo import (caa_traces, certify_both, check_decisions,
                            check_traces)

PROB_TOL = 1e-6
Y_REL = 1e-6


def moe_inputs(seed, T=20, d=16, E=4, ff=24, hot=0):
    """Weights with the reference's init shapes, and T tokens of which all
    but a few lie along expert ``hot``'s router column, so that expert
    overflows its capacity."""
    rng = np.random.RandomState(seed)
    p = {"w_router": rng.randn(d, E) / np.sqrt(d),
         "w_gate": rng.randn(E, d, ff) / np.sqrt(d),
         "w_up": rng.randn(E, d, ff) / np.sqrt(d),
         "w_down": rng.randn(E, ff, d) / np.sqrt(ff)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    col = p["w_router"][:, hot] / np.linalg.norm(p["w_router"][:, hot])
    x = 0.3 * rng.randn(1, T, d).astype(np.float32)
    x[0, : T - 3] += 3.0 * col
    return x, p


def _jax_gates(x, p, top_k):
    xt = jnp.asarray(x.reshape(-1, x.shape[-1]))
    probs = jax.nn.softmax(xt @ jnp.asarray(p["w_router"]), axis=-1)
    mask = JOps().top_k_mask(probs, top_k)
    g = probs * mask
    return np.asarray(probs), np.asarray(g / g.sum(-1, keepdims=True))


def _dropped(gates, top_k, E, Tc):
    """Assignments the reference's capacity rule drops, chunk by chunk."""
    T = gates.shape[0]
    C = TM.capacity(Tc, top_k, E)
    out = 0
    for s in range(0, T, Tc):
        sel = gates[s:s + Tc] > 0
        pos = np.cumsum(sel, axis=0) * sel - 1
        out += int((sel & (pos >= C)).sum())
    return out


def _route_flips(probs, tprobs, top_k):
    """Tokens whose top-k sets differ between the packages; asserts each
    lies within PROB_TOL of a tie in the reference's probabilities."""
    flips = []
    for t in range(probs.shape[0]):
        a = set(np.argsort(-probs[t], kind="stable")[:top_k])
        b = set(np.argsort(-tprobs[t], kind="stable")[:top_k])
        if a != b:
            srt = np.sort(probs[t])[::-1]
            margin = float(srt[top_k - 1] - srt[top_k])
            assert margin <= PROB_TOL, (t, margin)
            flips.append((t, margin))
    return flips


@pytest.mark.parametrize("act", ("silu", "gelu"))
@pytest.mark.parametrize("top_k", (1, 2))
@pytest.mark.parametrize("mode", ("dense", "dropping"))
def test_moe_mlp_matches_reference_with_an_overflowing_expert(mode, top_k,
                                                              act,
                                                              monkeypatch):
    x, p = moe_inputs(7 + top_k)
    E, Tc = p["w_router"].shape[1], 8
    kw = dict(n_experts=E, top_k=top_k, act=act, chunk_tokens=Tc, mode=mode)
    want = np.asarray(JM.moe_mlp(JOps(jnp.float32, jnp.float32),
                                 jnp.asarray(x),
                                 jax.tree_util.tree_map(jnp.asarray, p),
                                 **kw))
    log = []
    monkeypatch.setattr(TM, "drop_log", log)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    with torch.no_grad():
        got = TM.moe_mlp(TorchOps(), torch.from_numpy(x), tp, **kw).numpy()
    assert got.shape == want.shape == x.shape
    probs, gates = _jax_gates(x, p, top_k)
    tprobs = torch.softmax(torch.from_numpy(x.reshape(-1, 16))
                           @ tp["w_router"], -1).numpy()
    flips = _route_flips(probs, tprobs, top_k)
    if flips:
        print(f"route flips (token, reference margin): {flips}")
    scale = float(np.abs(want).max())
    ok = np.abs(got - want) <= Y_REL * scale
    flipped = {t for t, _ in flips}
    bad = [t for t in range(x.shape[1]) if not ok[0, t].all()
           and t not in flipped]
    assert not bad, (bad, float(np.abs(got - want).max()))
    if mode == "dropping":
        n_drop = _dropped(gates, top_k, E, Tc)
        assert n_drop > 0                    # the hot expert overflows
        assert log == [n_drop]
    else:
        assert log == []


def test_dropping_drops_in_token_order():
    """With capacity 1 a chunk's first token routed to an expert keeps it
    and every later one is dropped (output 0 for a top-1 token)."""
    x, p = moe_inputs(3, T=6)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    with torch.no_grad():
        y = TM.moe_mlp(TorchOps(), torch.from_numpy(x), tp, n_experts=4,
                       top_k=1, capacity_factor=0.5, chunk_tokens=6,
                       mode="dropping")[0]
    _, gates = _jax_gates(x, p, 1)
    e = gates.argmax(-1)
    for t in range(6):
        first = all(e[s] != e[t] for s in range(t))
        assert bool((y[t] != 0).any()) == first, t


def test_aux_loss_and_unported_mode():
    rng = np.random.RandomState(0)
    probs = rng.rand(12, 4).astype(np.float32)
    mask = (rng.rand(12, 4) > 0.5).astype(np.float32)
    want = float(JM.aux_load_balance_loss(jnp.asarray(probs),
                                          jnp.asarray(mask), 4))
    got = float(TM.aux_load_balance_loss(torch.from_numpy(probs),
                                         torch.from_numpy(mask), 4))
    assert abs(got - want) <= 1e-6 * abs(want)
    # ep_shard_map on a one-rank mesh (every expert local) against the
    # reference's on a one-device mesh; without a mesh it is refused (the
    # multi-rank cases are in tests/test_torch_mesh_dist.py)
    from jax.sharding import Mesh
    from repro_torch.launch import mesh as tmesh

    x, p = moe_inputs(0)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    with pytest.raises(ValueError, match="mesh"):
        TM.moe_mlp(TorchOps(), torch.from_numpy(x), tp, n_experts=4,
                   top_k=2, mode="ep_shard_map")
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                 ("data", "model"))
    want = np.asarray(JM.moe_mlp(
        JOps(jnp.float32, jnp.float32, mesh=jmesh), jnp.asarray(x),
        jax.tree_util.tree_map(jnp.asarray, p), n_experts=4, top_k=2,
        chunk_tokens=8, mode="ep_shard_map"))
    bk = MeshTorchOps(mesh=tmesh.make_serving_mesh(1, 1, device="cpu"))
    with torch.no_grad():
        y = TM.moe_mlp(bk, torch.from_numpy(x), tp, n_experts=4, top_k=2,
                       chunk_tokens=8, mode="ep_shard_map").numpy()
    np.testing.assert_allclose(y, want, rtol=0,
                               atol=Y_REL * float(np.abs(want).max()))
    shapes = TM.moe_shapes(16, 24, 4)
    init = TM.init_moe(16, 24, 4, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    assert {k: tuple(v.shape) for k, v in init.items()} == shapes
    assert shapes == {k: v.shape for k, v in p.items()}


def test_torch_ops_added_for_the_zoo_match_jops():
    rng = np.random.RandomState(1)
    a = rng.randn(3, 5, 8).astype(np.float32)
    b = rng.rand(3, 5, 8).astype(np.float32) + 0.5
    j, t = JOps(jnp.float32, jnp.float32), TorchOps()
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    pairs = [
        (j.gelu(ja), t.gelu(ta)), (j.div(ja, jb), t.div(ta, tb)),
        (j.neg(ja), t.neg(ta)), (j.exp(ja), t.exp(ta)),
        (j.sigmoid(ja), t.sigmoid(ta)), (j.sum(ja, -1, True),
                                         t.sum(ta, -1, True)),
        (j.max(ja, 1), t.max(ta, 1)),
        (j.transpose(ja, (2, 0, 1)), t.transpose(ta, (2, 0, 1))),
        (j.top_k_mask(ja, 3), t.top_k_mask(ta, 3)),
        (j.softcap(ja, 2.0), t.softcap(ta, 2.0)),
    ]
    # two implementations of one formula round at other places: a few f32
    # ulps of the output's scale (tanh-GELU's cancellation for x < 0 makes
    # a small output's relative error large)
    for want, got in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(
            got.numpy(), want, rtol=1e-6,
            atol=4 * 2.0 ** -24 * float(np.abs(want).max()))
    assert t.value_of(ta) is ta


@pytest.mark.parametrize("arch", ("mixtral_8x22b", "llama4_maverick"))
def test_caa_forward_and_router_records_match_reference(arch):
    jbk, jl, tbk, tl = caa_traces(arch)
    routers = [r for r in tbk.trace if r.kind == "router"]
    assert [r.name for r in routers] == ["layer0/mlp/router",
                                         "layer1/mlp/router"]
    check_traces(jbk, jl, tbk, tl, extra_rel={"flip_safe_if_u_le": 1e-6})


@pytest.mark.parametrize("arch", ("mixtral_8x22b", "llama4_maverick"))
def test_certify_lm_decisions_match_reference(arch, tmp_path):
    """The uniform search against the reference (whose trace summary, like
    the port's, ranks the router records with the layers); then the port's
    layer-stacked mixed pipeline on the same params, whose trace summary
    keeps the router records out (``certify/lm.py``, as the reference's
    stacked pipeline does; the reference's own stacked run compiles the
    whole MoE layer as one XLA scan body, minutes at SMOKE, so it is not
    run here)."""
    js, ts = certify_both(arch, tmp_path)
    check_decisions(js, ts)
    from repro_torch import certify as tcertify
    from test_torch_zoo import both

    _, _, tcfg, tp = both(arch)
    ms = tcertify.certify_lm(arch, tcfg, tp, seq=6, batch=2, seed=0,
                             k_max=53, mixed=True,
                             store=tcertify.CertificateStore(
                                 str(tmp_path / "mixed")))
    cert = ms.certificates[0]
    assert cert.required_k is not None and cert.layer_k
    names = [r["name"] for r in cert.trace_summary]
    assert names and not any(n.endswith("/router") for n in names)


def test_analyze_cli_prints_router_records(capsys):
    from repro_torch.launch.analyze import main

    out = main(["--device", "cpu", "--arch", "mixtral_8x22b", "--k", "10",
                "--seq", "16", "--routers"])
    text = capsys.readouterr().out
    assert "router records (2):" in text
    assert len(out["routers"]) == 2
    for r in out["routers"]:
        assert r.extra["min_margin"] >= 0
        assert f"{r.name}: min margin" in text
