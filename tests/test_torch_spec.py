"""The port's certificate schema (repro_torch.certify.spec) against the JAX
package's: the v1 fixture and v2/v3 sets written by the reference load and
write back byte for byte, and the serving decisions agree."""
import _torch_test_setup  # noqa: F401  (before any reference compile)
import json
import os

import pytest

from repro.certify import spec as jspec
from repro.core import formats as jformats
from repro.core.caa import CaaConfig as JCaaConfig
from repro_torch.certify import spec as tspec

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "v1_certificate_set.json")


def _v1_set_dict():
    with open(FIXTURE) as fh:
        return json.load(fh)["certificate_set"]


def _fmt(k, e, **kw):
    return jformats.from_bits(k, e, **kw).to_dict()


def _jax_v3_set(with_formats=True, with_layer_k=True):
    cfg = JCaaConfig(u_max=2.0 ** -9, round_abs=1.5e-3, emulate_k=12)
    certs = []
    for i, req in enumerate([11, 13]):
        lf = None
        if with_formats:
            lf = {"": _fmt(req, 5), "layer0": _fmt(req + 2, 6),
                  "layer*/attn": _fmt(req - 1, 5), "layer1/mlp": _fmt(9, 4)}
        certs.append(jspec.Certificate(
            model_id="qwen2-smoke", params_digest="ab" * 32,
            class_key=f"profile{i}", cfg=cfg, bounds_u_max=2.0 ** -9,
            final_abs_u=12.5 + i, final_rel_u=float("inf"),
            required_k=req, satisfied_by=["binary32", "float16"],
            trace_summary=[{"name": "head", "kind": "head", "shape": [4],
                            "out_mag": 1.0, "max_dbar": 3.0,
                            "max_ebar": None}],
            p_star=None,
            layer_k=({"layer0": req + 1, "layer1": req - 2}
                     if with_layer_k else None),
            layer_format=lf,
            meta={"map_provenance": {"layer_format": "synthesized"},
                  "margin": 0.25 * (i + 1)}))
    return jspec.CertificateSet(model_id="qwen2-smoke",
                                params_digest="ab" * 32, certificates=certs,
                                p_star=None,
                                meta={"serving": {"mean_bits": 11.5}})


def test_v1_fixture_round_trips_byte_identically():
    d = _v1_set_dict()
    want = jspec.CertificateSet.from_dict(d)
    got = tspec.CertificateSet.from_dict(d)
    assert got.to_json() == want.to_json()
    assert tspec.CertificateSet.from_json(got.to_json()).to_json() == \
        want.to_json()


def test_v1_fixture_serving_decisions_agree():
    d = _v1_set_dict()
    want = jspec.CertificateSet.from_dict(d)
    got = tspec.CertificateSet.from_dict(d)
    assert got.serving_k == want.serving_k == 12
    assert got.serving_layer_k is None and want.serving_layer_k is None
    assert got.serving_layer_format is None
    assert got.error_bars() == want.error_bars()
    assert got.summary() == want.summary()


@pytest.mark.parametrize("with_formats,with_layer_k",
                         [(True, True), (True, False), (False, True)])
def test_reference_written_sets_round_trip_byte_identically(with_formats,
                                                            with_layer_k):
    s = _jax_v3_set(with_formats, with_layer_k).to_json()
    got = tspec.CertificateSet.from_json(s)
    assert got.to_json() == s
    assert json.loads(s)["schema_version"] == tspec.SCHEMA_VERSION == 3


def test_v3_serving_maps_and_error_bars_agree():
    js = _jax_v3_set()
    ts = tspec.CertificateSet.from_json(js.to_json())
    assert ts.serving_k == js.serving_k
    assert ts.serving_layer_k == js.serving_layer_k
    assert ts.serving_layer_format == js.serving_layer_format
    assert ts.error_bars() == js.error_bars()
    assert ts.map_provenance() == js.map_provenance()
    assert ts.summary() == js.summary()
    assert ts.worst_abs_u == js.worst_abs_u
    assert ts.lookup("profile1").error_bars() == \
        js.lookup("profile1").error_bars()


def test_single_certificate_round_trip_and_config():
    jc = _jax_v3_set().certificates[0]
    tc = tspec.Certificate.from_json(jc.to_json())
    assert tc.to_json() == jc.to_json()
    assert tc.u == jc.u
    assert tc.format().to_dict() == jc.format().to_dict()
    assert tspec._cfg_to_dict(tc.cfg) == jspec._cfg_to_dict(jc.cfg)


def test_mixed_flags_or_missing_default_give_no_format_map():
    js = _jax_v3_set()
    d = js.to_dict()
    d["certificates"][1]["layer_format"]["layer0"]["saturating"] = True
    assert tspec.CertificateSet.from_dict(d).serving_layer_format is None
    assert jspec.CertificateSet.from_dict(d).serving_layer_format is None
    d = js.to_dict()
    del d["certificates"][0]["layer_format"][""]
    assert tspec.CertificateSet.from_dict(d).serving_layer_format is None


def test_newer_schema_is_refused():
    d = _v1_set_dict()
    d["schema_version"] = 99
    with pytest.raises(ValueError):
        tspec.CertificateSet.from_dict(d)
    c = dict(d["certificates"][0], schema_version=99)
    with pytest.raises(ValueError):
        tspec.Certificate.from_dict(c)
