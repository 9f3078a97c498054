"""The port's batched certificate pipeline (``repro_torch.certify``:
``batch``, ``mixed``, ``pipeline``) and the store's write side against the
JAX package's, on the reference's params carried across through numpy.

Model: the 10→12→8→3 MLP of ``tests/test_certify.py`` (three classes of
interval inputs). Equal in both packages: ``required_k``, ``satisfied_by``,
``layer_k``, the ``probes`` list and the store key (the entry's file
name); within 1e-9 relative: ``final_abs_u`` / ``final_rel_u`` (inf equal
to inf). The port's probe ladder is the eager analysis (the reference's is
one compiled executable), so the port reports ``ladder_compiles`` 0.

The store's write side is held against the reference's on the same
directory: gc by age, by count and both; invalidation by params digest;
the persisted lifetime stats (each package folds its counters into the
sidecar the other wrote); the on-disk summary; writers of both packages
racing on one key. Entries certified by either package are hits for the
other.

The nano LM's uniform certification (``certify_lm``, k_max 24; the helper
``tests/_torch_nano.py``) is held here too, with the cross-package hits of
``serving_certificate`` and the port's certification on a miss; its mixed
descent is in ``tests/test_torch_certify_lm.py``."""
import _torch_test_setup  # noqa: F401  (before any reference compile)
import json
import math
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro import certify as jcertify
from repro.certify import pipeline as jpipeline
from repro.models import paper_models as JPM
from repro_torch import certify as tcertify
from repro_torch.certify import pipeline as tpipeline
from repro_torch.certify import store as tstore
from repro_torch.convert import params_from_numpy
from repro_torch.models import paper_models as TPM
from _torch_nano import PROFILE, certify_both, same_lm_sets, trained_nano

RTOL = 1e-9


@pytest.fixture(scope="module")
def mlp():
    jp = JPM.init_digits(jax.random.PRNGKey(0), d_in=10, h1=12, h2=8,
                         n_classes=3)
    rng = np.random.RandomState(1)
    los = [rng.rand(10) * 0.3 for _ in range(3)]
    his = [lo + 0.04 for lo in los]
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jp, tp, los, his


def _both(mlp, tmp_path_factory, **kw):
    """The same request through both packages, each into its own store."""
    jp, tp, los, his = mlp
    roots = [str(tmp_path_factory.mktemp(n)) for n in ("jax", "torch")]
    js = jcertify.certify(JPM.digits_forward, jp, los, his,
                          model_id="test/mlp",
                          store=jcertify.CertificateStore(roots[0]), **kw)
    ts = tcertify.certify(TPM.digits_forward, tp, los, his,
                          model_id="test/mlp",
                          store=tcertify.CertificateStore(roots[1]), **kw)
    return js, ts, roots


@pytest.fixture(scope="module")
def uniform(mlp, tmp_path_factory):
    return _both(mlp, tmp_path_factory, p_star=0.6)


@pytest.fixture(scope="module")
def tolerance(mlp, tmp_path_factory):
    return _both(mlp, tmp_path_factory, abs_tol=1e-3)


@pytest.fixture(scope="module")
def mixed(mlp, tmp_path_factory):
    return _both(mlp, tmp_path_factory, p_star=0.6, k_max=24, mixed=True)


def _close(a, b):
    return a == b or (math.isfinite(a) and math.isfinite(b)
                      and abs(a - b) <= RTOL * max(abs(a), abs(b)))


def _same_sets(js, ts):
    assert len(js.certificates) == len(ts.certificates)
    for a, b in zip(js.certificates, ts.certificates):
        assert a.class_key == b.class_key
        assert a.required_k == b.required_k
        assert a.satisfied_by == b.satisfied_by
        assert a.layer_k == b.layer_k
        assert a.layer_format == b.layer_format
        assert a.bounds_u_max == b.bounds_u_max
        assert _close(a.final_abs_u, b.final_abs_u), (a.final_abs_u,
                                                      b.final_abs_u)
        assert _close(a.final_rel_u, b.final_rel_u), (a.final_rel_u,
                                                      b.final_rel_u)
    assert js.meta["probes"] == ts.meta["probes"]
    assert js.serving_k == ts.serving_k


@pytest.mark.parametrize("case", ["uniform", "tolerance", "mixed"])
def test_certify_decisions_and_bounds_equal_reference(case, request):
    js, ts, roots = request.getfixturevalue(case)
    _same_sets(js, ts)
    assert ts.meta["from_store"] is False and ts.meta["batched"]
    assert ts.meta["ladder_compiles"] == 0
    # the same request lands under the same content address
    assert os.listdir(roots[0]) == os.listdir(roots[1])


def test_certify_uniform_is_certified_and_traced(uniform):
    js, ts, _ = uniform
    assert all(c.required_k is not None for c in ts.certificates)
    for a, b in zip(js.certificates, ts.certificates):
        assert [r["name"] for r in a.trace_summary] == \
            [r["name"] for r in b.trace_summary]


def test_mixed_plan_equals_reference(mixed):
    js, ts, _ = mixed
    jm, tm = js.meta["mixed"], ts.meta["mixed"]
    assert tm["applied"] and jm["layer_k"] == tm["layer_k"]
    assert jm["uniform_k"] == tm["uniform_k"]
    assert jm["probes"] == tm["probes"]
    assert math.isclose(jm["mean_k_flop_weighted"],
                        tm["mean_k_flop_weighted"])
    for s, v in jm["sensitivity_abs_u"].items():
        assert _close(v, tm["sensitivity_abs_u"][s])


@pytest.mark.parametrize("case", ["uniform", "mixed"])
def test_entries_are_hits_across_packages(mlp, case, request):
    """Each package's stored set is a hit for the other's identical
    request, and reads back as the set that was stored."""
    jp, tp, los, his = mlp
    js, ts, roots = request.getfixturevalue(case)
    kw = ({"p_star": 0.6} if case == "uniform"
          else {"p_star": 0.6, "k_max": 24, "mixed": True})
    from_jax = tcertify.certify(TPM.digits_forward, tp, los, his,
                                model_id="test/mlp",
                                store=tcertify.CertificateStore(roots[0]),
                                **kw)
    from_port = jcertify.certify(JPM.digits_forward, jp, los, his,
                                 model_id="test/mlp",
                                 store=jcertify.CertificateStore(roots[1]),
                                 **kw)
    assert from_jax.meta["from_store"] and from_port.meta["from_store"]
    _same_sets(from_jax, js)
    _same_sets(from_port, ts)


def test_ladder_search_equals_eager_search(mlp):
    jp, tp, los, his = mlp
    x = tcertify.stack_class_ranges(los, his)
    feas = tcertify.margin_feasibility(0.6)
    lad = tcertify.ProbeLadder(TPM.digits_forward, tp, x)
    ks_l, _ = tcertify.required_k_batched(TPM.digits_forward, tp, x, feas,
                                          ladder=lad)
    ks_e, _ = tcertify.required_k_batched(TPM.digits_forward, tp, x, feas)
    assert np.array_equal(ks_l, ks_e)
    assert lad.compiles == 0 and len(lad.ks_probed) >= 1
    jx = jcertify.stack_class_ranges(los, his)
    jks, _ = jcertify.required_k_batched(
        JPM.digits_forward, jp, jx, jcertify.margin_feasibility(0.6))
    assert np.array_equal(ks_e, np.asarray(jks))


def test_reverifier_equals_reference(mlp):
    jp, tp, _, _ = mlp
    x = np.random.RandomState(3).rand(16, 10)
    jpred, jsafe = jcertify.make_reverifier(JPM.digits_forward, jp,
                                            "float16")(x)
    tpred, tsafe = tcertify.make_reverifier(TPM.digits_forward, tp,
                                            "float16")(torch.from_numpy(x))
    assert np.array_equal(np.asarray(jpred), tpred.numpy())
    assert np.array_equal(np.asarray(jsafe), tsafe.numpy())
    assert tsafe.any()


def test_certify_requires_exactly_one_target(mlp):
    _, tp, los, his = mlp
    with pytest.raises(ValueError):
        tcertify.certify(TPM.digits_forward, tp, los, his, model_id="m")
    with pytest.raises(ValueError):
        tcertify.certify(TPM.digits_forward, tp, los, his, p_star=0.6,
                         abs_tol=1e-3, model_id="m")


def test_range_digest_equals_reference(mlp):
    _, _, los, his = mlp
    from repro.certify.pipeline import range_digest as jrd
    assert tcertify.range_digest(los, his) == jrd(los, his)


# ---------------------------------------------------------------------------
# the store's write side, both packages on one directory
# ---------------------------------------------------------------------------

def _set(spec_mod, digest, tag):
    from repro.core.caa import CaaConfig as JC
    cfg = JC() if spec_mod is jcertify.spec else tcertify.spec.CaaConfig()
    return spec_mod.CertificateSet(
        model_id="m", params_digest=digest,
        certificates=[spec_mod.Certificate(
            model_id="m", params_digest=digest, class_key=tag, cfg=cfg,
            bounds_u_max=2.0 ** -7, final_abs_u=1.0, final_rel_u=2.0,
            required_k=10, satisfied_by=["binary32"], p_star=0.6)],
        p_star=0.6, meta={"tag": tag})


def _fill(root, n=6):
    """n entries, written alternately by the two packages, with mtimes
    one hour apart (entry 0 the oldest)."""
    now = time.time()
    keys = []
    for i in range(n):
        pkg, store_cls = ((jcertify.spec, jcertify.CertificateStore)
                          if i % 2 else
                          (tcertify.spec, tcertify.CertificateStore))
        key = f"{i:02d}" + "e" * 62
        store_cls(root).put(key, _set(pkg, ("a" if i < 3 else "b") * 64,
                                      f"c{i}"))
        os.utime(os.path.join(root, f"{key}.json"),
                 (now - 3600 * (n - i), now - 3600 * (n - i)))
        keys.append(key)
    return keys


@pytest.mark.parametrize("policy", [
    {"max_age_days": 2.5 / 24},
    {"max_entries": 2},
    {"max_age_days": 4.5 / 24, "max_entries": 1},
    {"max_entries": 10},
])
def test_gc_equals_reference(tmp_path, policy):
    roots = [str(tmp_path / n) for n in ("j", "t")]
    for r in roots:
        os.makedirs(r)
        _fill(r)
    j = jcertify.CertificateStore(roots[0])
    t = tcertify.CertificateStore(roots[1])
    assert t.gc(**policy) == j.gc(**policy)
    assert sorted(os.listdir(roots[0])) == sorted(os.listdir(roots[1]))
    assert t.stats.evicted == j.stats.evicted
    assert len(t) == len(j)


def test_invalidate_params_equals_reference(tmp_path):
    roots = [str(tmp_path / n) for n in ("j", "t")]
    for r in roots:
        os.makedirs(r)
        _fill(r)
    assert (tcertify.CertificateStore(roots[1]).invalidate_params("a" * 64)
            == jcertify.CertificateStore(roots[0]).invalidate_params(
                "a" * 64) == 3)
    assert sorted(os.listdir(roots[0])) == sorted(os.listdir(roots[1]))


def test_persisted_stats_fold_across_packages(tmp_path):
    """Each package folds its session counters into the sidecar the other
    wrote; a second persist never double-counts; the on-disk summary is
    the reference's."""
    root = str(tmp_path)
    keys = _fill(root, 4)
    t = tcertify.CertificateStore(root)
    assert t.get(keys[0]) is not None and t.get("f" * 64) is None
    first = t.persist_stats()
    assert first["hits_disk"] == 1 and first["misses"] == 1
    j = jcertify.CertificateStore(root)
    j.get(keys[1])
    j.get(keys[1])
    merged = j.persist_stats()
    assert merged["hits_disk"] == 2 and merged["hits_mem"] == 1
    assert t.persist_stats() == merged          # nothing new to fold
    assert t.read_persistent_stats() == j.read_persistent_stats()
    assert t.entry_summary() == j.entry_summary()
    assert t.entry_summary()["by_schema"] == {"v3": 4}
    assert "_stats.json" in os.listdir(root) and len(t) == 4


def test_concurrent_writers_of_both_packages(tmp_path):
    """Writers of both packages race on one key and readers poll it: every
    read finds a complete entry of one of the writers."""
    root = str(tmp_path)
    key = "c" * 64
    stop = threading.Event()
    seen, bad = set(), []

    def writer(pkg, store_cls, tag):
        s = store_cls(root)
        for i in range(25):
            s.put(key, _set(pkg, "d" * 64, f"{tag}{i}"))

    def reader():
        while not stop.is_set():
            try:
                with open(os.path.join(root, f"{key}.json")) as f:
                    payload = json.load(f)
                seen.add(payload["certificate_set"]["meta"]["tag"][0])
            except FileNotFoundError:
                pass
            except (json.JSONDecodeError, KeyError) as e:
                bad.append(repr(e))

    threads = [threading.Thread(target=writer, args=a) for a in (
        (jcertify.spec, jcertify.CertificateStore, "j"),
        (tcertify.spec, tcertify.CertificateStore, "t"))]
    r = threading.Thread(target=reader)
    r.start()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    stop.set()
    r.join(timeout=30)
    assert not any(th.is_alive() for th in threads + [r])
    assert not bad
    assert seen <= {"j", "t"} and seen
    assert not [n for n in os.listdir(root) if n.endswith(".tmp")]
    for store_cls in (jcertify.CertificateStore, tcertify.CertificateStore):
        assert store_cls(root).get(key).meta["tag"][0] in "jt"


def test_gc_cli_equals_reference(tmp_path):
    from repro.certify.__main__ import main as jmain
    from repro_torch.certify.__main__ import main as tmain

    roots = [str(tmp_path / n) for n in ("j", "t")]
    for r in roots:
        os.makedirs(r)
        _fill(r, 3)
    assert tmain(["gc", "--store", roots[1], "--max-entries", "0",
                  "--stats"]) == jmain(["gc", "--store", roots[0],
                                        "--max-entries", "0", "--stats"]) == 3
    assert os.listdir(roots[1]) == ["_stats.json"]
    assert (tstore.CertificateStore(roots[1]).read_persistent_stats()
            == jcertify.CertificateStore(roots[0]).read_persistent_stats())


# ---------------------------------------------------------------------------
# the nano LM's uniform certificate
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nano():
    return trained_nano()


@pytest.fixture(scope="module")
def lm_uniform(nano, tmp_path_factory):
    return certify_both(jcertify, tcertify, nano,
                        [str(tmp_path_factory.mktemp(n))
                         for n in ("jlm", "tlm")], k_max=24)


def test_lm_uniform_certificate_equals_reference(lm_uniform):
    js, ts, roots, _ = lm_uniform
    same_lm_sets(js, ts)
    assert ts.certificates[0].required_k == 5
    assert ts.meta["probes"] == [4, 5, 6, 9, 14, 24]
    assert os.listdir(roots[0]) == os.listdir(roots[1])


def test_lm_serving_certificate_hits_across_packages(nano, lm_uniform):
    """The port's ``serving_certificate`` serves what the JAX package
    stored, and the JAX package's serves what the port stored."""
    jcfg, jp, tcfg, tp = nano
    js, ts, roots, kw = lm_uniform
    got_t = tpipeline.serving_certificate("qwen2_7b", tcfg, tp, roots[0],
                                          **PROFILE, **kw)
    got_j = jpipeline.serving_certificate("qwen2_7b", jcfg, jp, roots[1],
                                          **PROFILE, **kw)
    assert got_t.meta["from_store"] and got_j.meta["from_store"]
    same_lm_sets(js, got_t)
    same_lm_sets(got_j, ts)
    assert got_t.serving_k == got_j.serving_k == js.serving_k


def test_lm_serving_certificate_certifies_on_a_miss(nano, lm_uniform,
                                                    tmp_path):
    _, _, tcfg, tp = nano
    js, _, _, kw = lm_uniform
    first = tpipeline.serving_certificate("qwen2_7b", tcfg, tp,
                                          str(tmp_path), **PROFILE, **kw)
    assert first.meta["from_store"] is False
    same_lm_sets(js, first)
    again = tpipeline.serving_certificate("qwen2_7b", tcfg, tp,
                                          str(tmp_path), **PROFILE, **kw)
    assert again.meta["from_store"] is True
    assert again.certificates[0].to_dict() == \
        first.certificates[0].to_dict()
