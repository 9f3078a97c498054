"""The port's certificate store (repro_torch.certify.store / pipeline)
against the JAX package's: the same params digest for the same numbers,
the same request keys, entries written by one package read by the other,
the same stats for the same sequence of reads, and the same ServeConfig
resolved from a store hit. A miss certifies on first use and persists."""
import _torch_test_setup  # noqa: F401  (before any reference compile)
import dataclasses
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from repro import certify as jcertify
from repro.certify import pipeline as jpipeline
from repro.certify import spec as jspec
from repro.core import formats as jformats
from repro.core.caa import CaaConfig as JCaaConfig
from repro.launch import serve as jserve
from repro.models import paper_models as JPM
from repro_torch.certify import pipeline as tpipeline
from repro_torch.certify import spec as tspec
from repro_torch.certify import store as tstore
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT
from _torch_serve_parity import JCFG, TCFG, both_params

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "v1_certificate_set.json")


@pytest.fixture(scope="module")
def params():
    return both_params()


def _fmt(k, e):
    return jformats.from_bits(k, e).to_dict()


def _jax_set(digest, *, required_k=(11, 13), layer_k=True, formats=True):
    certs = []
    for i, req in enumerate(required_k):
        certs.append(jspec.Certificate(
            model_id="lm/qwen2_7b", params_digest=digest,
            class_key=f"profile{i}", cfg=JCaaConfig(u_max=2.0 ** -9),
            bounds_u_max=2.0 ** -9, final_abs_u=12.5 + i,
            final_rel_u=float("inf"), required_k=req,
            satisfied_by=["binary32"], p_star=None,
            layer_k={"layer0": 14, "layer1/mlp": 10} if layer_k else None,
            layer_format=({"": _fmt(12, 5), "layer*/attn": _fmt(10, 5),
                           "layer0/mlp": _fmt(14, 6)} if formats else None),
            meta={"i": i}))
    return jspec.CertificateSet(model_id="lm/qwen2_7b", params_digest=digest,
                                certificates=certs, p_star=None,
                                meta={"from_store": False})


# ---------------------------------------------------------------------------
# digest and keys
# ---------------------------------------------------------------------------

def test_params_digest_of_converted_params_equals_reference(params):
    jp, tp = params
    assert tstore.params_digest(tp) == jcertify.params_digest(jp)


def test_params_digest_covers_structure_dtypes_and_scalars():
    """A tree with lists, tuples, None, int/float leaves, f64/int32/bool
    arrays and a Fortran-ordered one, and the Digits model's params."""
    rng = np.random.RandomState(0)
    tree = {"b": [rng.randn(3).astype(np.float32),
                  (np.arange(4, dtype=np.int32),)],
            "a": {"z": np.asfortranarray(rng.randn(3, 2)), "y": None,
                  "x": 3, "w": 0.5, "v": np.array([True, False])},
            "c": (rng.randn(2, 2).astype(np.float32), 7),
            "e": np.float32(2.5)}
    want = jcertify.params_digest(tree)
    assert tstore.params_digest(tree) == want
    conv = params_from_numpy(
        {"b": [tree["b"][0], (tree["b"][1][0],)],
         "a": {**tree["a"], "z": np.ascontiguousarray(tree["a"]["z"]),
               "v": tree["a"]["v"]},
         "c": (tree["c"][0], 7), "e": np.array(2.5, np.float32)}, "cpu")
    assert tstore.params_digest(conv) == want
    digits = JPM.init_digits(jax.random.PRNGKey(0), d_in=10, h1=12, h2=8,
                             n_classes=3)
    np_digits = jax.tree_util.tree_map(np.asarray, digits)
    assert tstore.params_digest(params_from_numpy(np_digits, "cpu")) == \
        jcertify.params_digest(digits)
    # a changed byte, dtype or structure is another digest
    changed = dict(np_digits)
    changed["w1"] = np_digits["w1"].copy()
    changed["w1"][0, 0] += 1.0
    assert tstore.params_digest(changed) != jcertify.params_digest(digits)
    assert tstore.params_digest(
        {k: v.astype(np.float64) for k, v in np_digits.items()}) != \
        jcertify.params_digest(digits)


@pytest.mark.parametrize("target", [None, {"p_star": 0.6},
                                    {"argmax_safe": True, "k_max": 24}])
def test_request_key_equals_reference(target):
    for cfg in (dict(), dict(u_max=2.0 ** -23, emulate_k=24),
                dict(acc_order="pairwise", round_abs=1.5e-3)):
        want = jcertify.request_key("lm/qwen2_7b", "ab" * 32, "class0",
                                    JCaaConfig(**cfg), target=target)
        got = tstore.request_key("lm/qwen2_7b", "ab" * 32, "class0",
                                 tspec.CaaConfig(**cfg), target=target)
        assert got == want


SERVING_KW = [
    {}, {"k_max": 20}, {"mixed": True, "k_max": 53},
    {"formats": True, "k_max": 53},
    {"mixed": True, "formats": True, "profiles": [16, 8, 16],
     "format_opts": {"keep": 1}, "seq": 4, "batch": 2, "seed": 3,
     "k_min": 6, "k_max": 40},
]


@pytest.mark.parametrize("kw", SERVING_KW)
def test_serving_certificate_key_equals_reference(params, tmp_path,
                                                   monkeypatch, kw):
    """The reference's key is captured by a store whose ``get`` records it
    and returns a fixture set; the port's must be the same string, and the
    port must serve the same fixture from it."""
    jp, tp = params
    digest = jcertify.params_digest(jp)
    fixture = _jax_set(digest)
    seen = {}

    class Recording(jcertify.CertificateStore):
        def get(self, key, expect_params_digest=None):
            seen["key"], seen["digest"] = key, expect_params_digest
            return fixture

    monkeypatch.setattr(jpipeline, "CertificateStore", Recording)
    jpipeline.serving_certificate("qwen2_7b", JCFG, jp, str(tmp_path), **kw)
    key, request = tpipeline.serving_request(
        "qwen2_7b", TCFG, tstore.params_digest(tp), **kw)
    assert key == seen["key"] and seen["digest"] == digest
    assert request["model_id"] == "lm/qwen2_7b"
    jcertify.CertificateStore(str(tmp_path)).put(key, fixture)
    got = tpipeline.serving_certificate("qwen2_7b", TCFG, tp, str(tmp_path),
                                        **kw)
    assert got.meta["from_store"] is True
    assert dataclasses.replace(got, meta=fixture.meta).to_json() == \
        tspec.CertificateSet.from_json(fixture.to_json()).to_json()


def test_store_miss_raises(params, tmp_path):
    """A miss no longer raises: ``serving_certificate`` certifies on first
    use and persists the set under the same key; the second call, and
    ``apply_certificates``, are store hits."""
    _, tp = params
    cs = tpipeline.serving_certificate("qwen2_7b", TCFG, tp, str(tmp_path))
    assert cs.meta["from_store"] is False and cs.serving_k is not None
    key, _ = tpipeline.serving_request("qwen2_7b", TCFG,
                                       tstore.params_digest(tp))
    assert os.listdir(tmp_path) == [f"{key}.json"]
    again = tpipeline.serving_certificate("qwen2_7b", TCFG, tp,
                                          str(tmp_path))
    assert again.meta["from_store"] is True
    assert dataclasses.replace(again, meta=cs.meta).to_json() == cs.to_json()
    sc = tserve.ServeConfig(device="cpu", certificates=str(tmp_path))
    sc2, hit = tserve.apply_certificates(sc, TCFG, tp)
    assert hit.meta["from_store"] is True
    assert sc2.precision_k == cs.serving_k


# ---------------------------------------------------------------------------
# entries across the two packages
# ---------------------------------------------------------------------------

def test_entry_written_by_jax_reads_in_port_and_back(tmp_path):
    cs = _jax_set("cd" * 32)
    jcertify.CertificateStore(str(tmp_path)).put("k" * 64, cs,
                                                 request={"r": 1})
    port = tstore.CertificateStore(str(tmp_path))
    got = port.get("k" * 64, expect_params_digest="cd" * 32)
    assert got.to_json() == cs.to_json()
    assert port.stats.hits_disk == 1
    # the port's put is read by the JAX store, byte for byte
    port.put("p" * 64, got, request={"r": 2})
    back = jcertify.CertificateStore(str(tmp_path)).get("p" * 64)
    assert back.to_json() == cs.to_json()
    with open(port.path_for("p" * 64)) as fa, \
            open(jcertify.CertificateStore(str(tmp_path)).path_for(
                "k" * 64)) as fb:
        a, b = fa.read(), fb.read()
    assert a.replace("p" * 64, "k" * 64).replace('"r": 2', '"r": 1') == b
    assert sorted(port.keys()) == ["k" * 64, "p" * 64] and len(port) == 2


def _read_sequence(store_cls, root, spec_mod):
    """hit (disk), hit (memory), miss, corrupt, stale, v1, then a put and
    a memory hit; returns the stats dict."""
    shutil.copy(FIXTURE, os.path.join(root, "v1" * 32 + ".json"))
    cs = spec_mod.CertificateSet.from_json(_jax_set("cd" * 32).to_json())
    writer = store_cls(root)
    writer.put("a" * 64, cs)
    with open(os.path.join(root, "b" * 64 + ".json"), "w") as f:
        f.write("{truncated")
    store = store_cls(root, lru_size=2)
    assert store.get("a" * 64) is not None
    assert store.get("a" * 64) is not None
    assert store.get("c" * 64) is None
    assert store.get("b" * 64) is None
    assert store.get("a" * 64, expect_params_digest="ee" * 32) is None
    assert store.get("v1" * 32).serving_k == 12
    store.put("d" * 64, cs)
    assert store.get("d" * 64) is not None
    return store.stats.to_dict()


def test_same_reads_give_same_stats(tmp_path):
    os.makedirs(tmp_path / "j")
    os.makedirs(tmp_path / "t")
    want = _read_sequence(jcertify.CertificateStore, str(tmp_path / "j"),
                          jspec)
    got = _read_sequence(tstore.CertificateStore, str(tmp_path / "t"), tspec)
    assert got == want
    assert want == {"hits_mem": 3, "hits_disk": 2, "misses": 1, "puts": 1,
                    "rejected_stale": 1, "corrupt": 1, "read_v1": 1,
                    "evicted": 0}


# ---------------------------------------------------------------------------
# apply_certificates
# ---------------------------------------------------------------------------

RESOLUTIONS = {
    "v3": dict(required_k=(11, 13)),
    "v2": dict(required_k=(11, 13), formats=False),
    "v1": dict(required_k=(11, 13), layer_k=False, formats=False),
    "format_only": dict(required_k=(None, 13)),
}


@pytest.mark.parametrize("case", sorted(RESOLUTIONS))
@pytest.mark.parametrize("kw", [{}, {"formats": True, "k_max": 53}])
def test_apply_certificates_resolves_like_reference(params, tmp_path, case,
                                                    kw):
    jp, tp = params
    digest = jcertify.params_digest(jp)
    key, _ = tpipeline.serving_request("qwen2_7b", TCFG, digest, **kw)
    cs = _jax_set(digest, **RESOLUTIONS[case])
    jcertify.CertificateStore(str(tmp_path)).put(key, cs)
    jsc, jcs = jserve.apply_certificates(
        jserve.ServeConfig(arch="qwen2_7b", certificates=str(tmp_path)),
        JCFG, jp, **kw)
    tsc, tcs = tserve.apply_certificates(
        tserve.ServeConfig(device="cpu", certificates=str(tmp_path)),
        TCFG, tp, **kw)
    for field in ("precision_k", "precision_layer_k",
                  "precision_layer_format"):
        assert getattr(tsc, field) == getattr(jsc, field), field
    assert tcs.error_bars() == jcs.error_bars()
    if case == "format_only":
        assert tsc.precision_k is None and tsc.precision_layer_format[""]


def test_apply_certificates_without_precision_raises_like_reference(
        params, tmp_path):
    jp, tp = params
    digest = jcertify.params_digest(jp)
    key, _ = tpipeline.serving_request("qwen2_7b", TCFG, digest)
    jcertify.CertificateStore(str(tmp_path)).put(
        key, _jax_set(digest, required_k=(None,), formats=False))
    with pytest.raises(RuntimeError):
        jserve.apply_certificates(jserve.ServeConfig(
            certificates=str(tmp_path)), JCFG, jp)
    with pytest.raises(RuntimeError, match="no certifiable precision"):
        tserve.apply_certificates(tserve.ServeConfig(
            device="cpu", certificates=str(tmp_path)), TCFG, tp)


def test_serve_main_serves_from_the_store(tmp_path):
    """``--certificates`` on the serve CLI: the set stored for the CLI's
    own seeded params (found by their digest) is served, with its error
    bars (a miss certifies: ``test_store_miss_raises``)."""
    tp = TT.init_params(TCFG, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    digest = tstore.params_digest(tp)
    key, request = tpipeline.serving_request("qwen2_7b", TCFG, digest,
                                             formats=True, k_max=53)
    cs = tspec.CertificateSet.from_json(_jax_set(digest).to_json())
    argv = ["--device", "cpu", "--batch", "1", "--prefill-len", "4",
            "--decode-steps", "2", "--certificates", str(tmp_path),
            "--certify-formats"]
    tstore.CertificateStore(str(tmp_path)).put(key, cs, request=request)
    res = tserve.main(argv)
    assert res.config.precision_layer_format == cs.serving_layer_format
    assert res.responses[0]["certificate"]["params_digest"] == digest
    assert len(res.responses[0]["tokens"]) == 3
