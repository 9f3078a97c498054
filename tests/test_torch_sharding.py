"""The port's mesh shapes and sharding rules (``repro_torch.launch.mesh``,
``repro_torch.parallel.sharding``) against the JAX package's, spec for
spec, on the CPU without a process group.

Every rule is a pure function of shapes and a mesh shape, so both packages
are asked on duck-typed meshes (``axis_names``, ``devices.shape``) of the
sizes a deployment uses, up to the multi-pod 2 × 16 × 16: the reference's
tree rules wrap each spec in ``NamedSharding``, which needs a real mesh,
so within each test that name is replaced by one returning the spec. The
trees are every SMOKE arch's parameters and caches (lock-step and per-lane
index) and Qwen2-7B's and Mixtral's FULL ones, as shapes only
(``jax.eval_shape`` and the port's ``param_shapes`` / meta-device caches).
One case per (rule, mesh shape); each compares every tree.
"""
import _torch_test_setup  # noqa: F401  (before any reference compile)
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import mesh as jmesh
from repro.models import transformer as JT
from repro.parallel import sharding as JS
from repro_torch import configs as tconfigs
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as TT
from repro_torch.parallel import sharding as TS

MESHES = {
    "1x1": (("data", "model"), (1, 1)),
    "2x1": (("data", "model"), (2, 1)),
    "1x2": (("data", "model"), (1, 2)),
    "2x2": (("data", "model"), (2, 2)),
    "4x2": (("data", "model"), (4, 2)),
    "16x16": (("data", "model"), (16, 16)),
    "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
}
TREES = [(a, "SMOKE") for a in tconfigs.ARCHS] + [
    ("qwen2_7b", "FULL"), ("mixtral_8x22b", "FULL")]
CACHE_B, CACHE_S = 4, 64
BATCHES = [(8, 128), (1, 4096), (2, 16), (4, 1), (32, 2048), (3, 7),
           (256, 512), (512, 8)]
LANES = (1, 2, 3, 4, 8, 16, 32, 64)


def jax_mesh(name):
    names, shape = MESHES[name]
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, dtype=object))


def torch_mesh(name):
    names, shape = MESHES[name]
    return dict(zip(names, shape))


@pytest.fixture
def spec_only(monkeypatch):
    monkeypatch.setattr(JS, "NamedSharding", lambda mesh, spec: spec)


def _as_tuple(spec):
    return tuple(spec)


@functools.lru_cache(maxsize=None)
def jax_params(arch, size):
    cfg = getattr(jconfigs.get(arch), size)
    return jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), cfg))


@functools.lru_cache(maxsize=None)
def jax_cache(arch, size, per_lane):
    cfg = getattr(jconfigs.get(arch), size)
    return jax.eval_shape(lambda: JT.init_cache(
        cfg, CACHE_B, CACHE_S, jnp.float32, per_lane_idx=per_lane))


def torch_params(arch, size):
    return TT.param_shapes(getattr(tconfigs.get(arch), size))


def torch_cache(arch, size, per_lane):
    return TT.init_cache(getattr(tconfigs.get(arch), size), CACHE_B,
                         CACHE_S, device="meta", per_lane_idx=per_lane)


def jax_specs(tree):
    return jax.tree_util.tree_map(
        _as_tuple, tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def assert_same_tree(got, want, what):
    flat_w = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, tuple))[0]
    flat_g = jax.tree_util.tree_flatten_with_path(
        got, is_leaf=lambda x: isinstance(x, tuple))[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w], what
    bad = [(jax.tree_util.keystr(p), g, w)
           for (p, g), (_, w) in zip(flat_g, flat_w) if g != w]
    assert not bad, (what, bad[:5])


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("model_only", (False, True))
def test_shard_params_matches_reference(mesh, model_only, spec_only):
    for arch, size in TREES:
        want = jax_specs(JS.shard_params(jax_params(arch, size),
                                         jax_mesh(mesh),
                                         model_only=model_only))
        got = TS.shard_params(torch_params(arch, size), torch_mesh(mesh),
                              model_only=model_only)
        assert_same_tree(got, want, (arch, size))


@pytest.mark.parametrize("mesh", MESHES)
def test_shard_params_serving_matches_reference(mesh, spec_only):
    for arch, size in TREES:
        want = jax_specs(JS.shard_params_serving(jax_params(arch, size),
                                                 jax_mesh(mesh)))
        got = TS.shard_params_serving(torch_params(arch, size),
                                      torch_mesh(mesh))
        assert_same_tree(got, want, (arch, size))


@pytest.mark.parametrize("mesh", MESHES)
def test_greedy_param_spec_matches_reference(mesh):
    shapes = [(64,), (4096, 4096), (3584, 152064), (28, 3584, 18944),
              (56, 8, 6144, 16384), (7, 5, 3), (512, 512), (1, 1 << 20),
              (3, 1000, 1000)]
    for shape in shapes:
        for stacked in (False, True):
            for axes in (None, ("model",), ("data",)):
                want = JS._greedy_param_spec(shape, jax_mesh(mesh),
                                             stacked=stacked, axes=axes)
                got = TS._greedy_param_spec(shape, torch_mesh(mesh),
                                            stacked=stacked, axes=axes)
                assert got == tuple(want), (shape, stacked, axes)


@pytest.mark.parametrize("mesh", MESHES)
def test_batch_spec_and_shard_batch_match_reference(mesh, spec_only):
    for b, s in BATCHES:
        want = tuple(JS.batch_spec(jax_mesh(mesh), b, s))
        assert TS.batch_spec(torch_mesh(mesh), b, s) == want, (b, s)
        assert TS.shard_batch(torch_mesh(mesh), b, s) == tuple(
            JS.shard_batch(jax_mesh(mesh), b, s)), (b, s)


@pytest.mark.parametrize("mesh", MESHES)
def test_shard_cache_matches_reference(mesh, spec_only):
    for arch, size in TREES:
        cfg = getattr(tconfigs.get(arch), size)
        for per_lane in (False, True):
            want = jax_specs(JS.shard_cache(jax_cache(arch, size, per_lane),
                                            jax_mesh(mesh), cfg))
            got = TS.shard_cache(torch_cache(arch, size, per_lane),
                                 torch_mesh(mesh), cfg)
            assert_same_tree(got, want, (arch, size, per_lane))
    for shape, kinds in [
            ((2, 4, 64, 8, 128), ("gqa", "rwkv")),
            ((2, 3, 64, 8, 128), ("gqa",)), ((2, 4, 64, 3, 128), ("gqa",)),
            ((2, 1, 4096, 1, 64), ("gqa",)), ((2, 4, 64, 288), ("mla",)),
            ((2, 3, 4096, 288), ("mla",)), ((2, 4, 16, 64, 64), ("rwkv",)),
            ((2, 4, 2048), ("rwkv", "other")), ((2, 8), ("gqa", "other"))]:
        for kind in kinds:
            assert TS.cache_spec(torch_mesh(mesh), shape, kind) == tuple(
                JS.cache_spec(jax_mesh(mesh), shape, kind)), (shape, kind)


@pytest.mark.parametrize("mesh", MESHES)
def test_shard_cache_serving_matches_reference(mesh, spec_only):
    for arch, size in TREES:
        for per_lane in (False, True):
            want = jax_specs(JS.shard_cache_serving(
                jax_cache(arch, size, per_lane), jax_mesh(mesh)))
            got = TS.shard_cache_serving(torch_cache(arch, size, per_lane),
                                         torch_mesh(mesh))
            assert_same_tree(got, want, (arch, size, per_lane))


@pytest.mark.parametrize("mesh", MESHES)
def test_lane_batch_sharding_and_replicated_match_reference(mesh,
                                                           spec_only):
    for n in LANES:
        assert TS.lane_batch_sharding(torch_mesh(mesh), n) == tuple(
            JS.lane_batch_sharding(jax_mesh(mesh), n)), n
    assert TS.replicated(torch_mesh(mesh)) == tuple(
        JS.replicated(jax_mesh(mesh)))


@pytest.mark.parametrize("mesh", MESHES)
def test_axis_size_and_data_axes_match_reference(mesh):
    jm, tm = jax_mesh(mesh), torch_mesh(mesh)
    for name in ("pod", "data", "model", "expert"):
        assert tmesh.axis_size(tm, name) == jmesh.axis_size(jm, name)
        assert TS._axis_size(tm, name) == JS._axis_size(jm, name)
    assert tmesh.data_axes(tm) == jmesh.data_axes(jm)
    # a JAX-style mesh is read the same way
    assert tmesh.mesh_shape(jm) == tm


def test_production_mesh_needs_its_rank_count():
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="needs 512 ranks"):
        tmesh.make_production_mesh(multi_pod=True, device="cpu")
