"""The port's observability layer (``repro_torch.obs``) against the JAX
package's ``repro.obs`` on the same inputs: the analytic roofline terms,
format bits, scope classes and the fitted cost model equal the reference's
(the same float operations in the same order, so equality is exact);
histogram digests and registry snapshots are identical on the same
samples;
a trace the port writes passes both schema validators, and one the
reference writes passes the port's; the kernel profiler keeps the
reference's kernel names and row keys (``route`` in place of
``interpret``, no Pallas ``block``), and the serving profile its digest.
Everything runs on the CPU: the rows time plain versions, and only their
shapes and bookkeeping are checked here.
"""
import json
import warnings

import numpy as np
import pytest

from repro import obs as jobs
from repro.obs import costmodel as jcm
from repro.obs import profile as jprof
from repro_torch import configs as tconfigs
from repro_torch import obs as tobs
from repro_torch.obs import costmodel as tcm
from repro_torch.obs import profile as tprof

HW_PAIRS = [
    (jcm.TPU_POD_CHIP, tcm.TPU_POD_CHIP),
    (jcm.Hardware(**tcm.H100_SXM.to_dict()), tcm.H100_SXM),
]


def test_hardware_entries():
    assert tcm.TPU_POD_CHIP.to_dict() == jcm.TPU_POD_CHIP.to_dict()
    h = tcm.H100_SXM
    assert (h.peak_flops, h.hbm_bytes_per_s, h.link_bytes_per_s) == (
        67e12, 3.35e12, 450e9)
    assert h.ridge_intensity == pytest.approx(20.0, rel=1e-3)


@pytest.mark.parametrize("hw", HW_PAIRS, ids=["tpu", "h100"])
@pytest.mark.parametrize("bits", [32.0, 16.0, 9.0])
def test_analytic_terms_equal_reference(hw, bits):
    jhw, thw = hw
    for (M, K, N) in [(4, 3584, 18944), (512, 18944, 3584), (1, 7, 3)]:
        assert tprof.gemm_terms(M, K, N, bits, thw) == jprof.gemm_terms(
            M, K, N, bits, jhw)
    for shape in [(4, 145, 4, 7, 128), (2, 256, 2, 2, 64)]:
        assert (tprof.flash_decode_terms(*shape, bits, thw)
                == jprof.flash_decode_terms(*shape, bits, jhw))


def test_format_bits_and_scope_class_equal_reference():
    for k in (2, 8, 11, 24, 53):
        assert tcm.format_bits(k) == jcm.format_bits(k)
        for emax, emin in ((15, -14), (7, -6), (127, -126), (31, -30),
                           (3, -2), (1023, -1022)):
            assert tcm.format_bits(k, emax, emin) == jcm.format_bits(
                k, emax, emin)
    for scope in ("", "layer3/attn", "layer*/mlp", "layer0", "layer*",
                  "dense2", "head", "embed"):
        assert tcm.scope_class(scope) == jcm.scope_class(scope)


def _records(seed):
    rng = np.random.RandomState(seed)
    out = []
    for kernel in ("quant_matmul_format", "quant_matmul_dynamic_k",
                   "flash_decode", "matmul_baseline"):
        for i in range(1 + rng.randint(4)):
            out.append({"kernel": kernel,
                        "median_s": float(rng.uniform(1e-5, 1e-2)),
                        "flops": float(rng.uniform(1e6, 1e12)),
                        "bytes": float(rng.uniform(1e5, 1e9))})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_cost_model_equals_reference(seed):
    recs = _records(seed)
    for jhw, thw in HW_PAIRS:
        jm = jcm.fit_cost_model(recs, jhw)
        tm = tcm.fit_cost_model(recs, thw)
        assert tm.to_dict() == jm.to_dict()
        for scope in ("layer0/attn", "layer*/mlp", "head", ""):
            for fmt in ((12, None, None), (10, 15, -14)):
                assert tm.predict(scope, 1e9, *fmt, tokens=4) == jm.predict(
                    scope, 1e9, *fmt, tokens=4)
    again = tcm.CostModel.from_dict(json.loads(json.dumps(tm.to_dict())))
    assert again == tm


def test_fit_drops_plain_rows_as_the_reference_drops_interpret_rows():
    recs = _records(3)
    jrecs = [dict(r, interpret=(i % 2 == 0)) for i, r in enumerate(recs)]
    trecs = [dict(r, route="plain" if i % 2 == 0 else "cuda")
             for i, r in enumerate(recs)]
    jm = jcm.fit_cost_model(jrecs)
    tm = tcm.fit_cost_model(trecs, jcm.TPU_POD_CHIP)
    assert (tm.alpha, tm.beta) == (jm.alpha, jm.beta)
    assert tm.meta["plain_rows_dropped"] == jm.meta["interpret_rows_dropped"]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        only = tcm.fit_cost_model([dict(r, route="plain") for r in recs])
    assert only.meta["plain_only"] is True
    assert any(issubclass(w.category, RuntimeWarning) for w in caught)


def test_histogram_and_registry_equal_reference():
    rng = np.random.RandomState(4)
    samples = list(rng.lognormal(-5, 1.5, 257)) + [0.0, 1e-6, 250.0]
    jh, th = jobs.Histogram("lat"), tobs.Histogram("lat")
    jr, tr = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    for s in samples:
        jh.observe(s)
        th.observe(s)
        jr.observe("serve.decode_latency_s{lane=1}", s)
        tr.observe("serve.decode_latency_s{lane=1}", s)
    assert th.percentiles() == jh.percentiles()
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert th.quantile(q) == jh.quantile(q)
    assert th.to_dict() == jh.to_dict()
    for r in (jr, tr):
        r.counter("serve.tokens", 12)
        r.gauge("serve.batch_occupancy", 0.75)
    tsnap, jsnap = tr.to_dict(), jr.to_dict()
    assert tsnap.pop("t") > 0 and jsnap.pop("t") > 0
    assert tsnap == jsnap


def _write_port_trace(path):
    tobs.configure(path=str(path), program="port-test", argv=["-x"])
    try:
        with tobs.span("outer", a=1):
            with tobs.span("inner") as sp:
                sp.set(found=3)
            tobs.event("thing", n=2)
        tobs.counter("hits", 2)
        tobs.gauge("g", 1.5)
    finally:
        tobs.shutdown()


def test_port_trace_validates_under_both_schemas(tmp_path):
    path = tmp_path / "trace.jsonl"
    _write_port_trace(path)
    evs = tobs.load_events(str(path))
    assert tobs.validate_events(evs) == []
    assert jobs.validate_events(jobs.load_events(str(path))) == []
    spans = [e for e in evs if e["type"] == "span"]
    assert [(s["name"], s["depth"], s["parent"]) for s in spans] == [
        ("inner", 1, "outer"), ("outer", 0, None)]
    assert spans[0]["attrs"] == {"found": 3}
    assert {e["type"] for e in evs} == {"meta", "span", "event", "counters",
                                        "gauges"}
    assert tobs.SCHEMA == jobs.SCHEMA
    # and the reference's trace passes the port's validator
    jpath = tmp_path / "jtrace.jsonl"
    jobs.configure(path=str(jpath), program="ref")
    with jobs.span("s"):
        jobs.counter("c")
    jobs.shutdown()
    assert tobs.validate_events(tobs.load_events(str(jpath))) == []
    assert tobs.validate_events([{"type": "bogus"}]) != []


def test_measure_contract():
    calls = []
    t = tobs.measure(lambda x: calls.append(x), 1, reps=3, warmup=2)
    assert len(calls) == 5 and t["reps"] == 3 and len(t["samples"]) == 3
    assert t["min_s"] <= t["median_s"] <= t["max_s"]


def _keys_by_kernel(rows, drop=()):
    out = {}
    for r in rows:
        out.setdefault(r["kernel"], set()).update(set(r) - set(drop))
    return out


def test_profile_kernels_keeps_reference_names_and_keys():
    kw = dict(gemm_shapes=((16, 16, 16),), ks=(8,), formats=((4, 8, -6),),
              flash_shapes=((1, 16, 1, 2, 8),), reps=1, warmup=0)
    include = jprof.ALL_KERNELS + ("quant_matmul",)
    jrows = jprof.profile_kernels(include=include, **kw)
    tr = tobs.configure()
    try:
        trows = tprof.profile_kernels(include=include, device="cpu", **kw)
    finally:
        tobs.shutdown()
    assert tprof.ALL_KERNELS == jprof.ALL_KERNELS
    assert [r["kernel"] for r in trows] == [r["kernel"] for r in jrows]
    want = _keys_by_kernel(jrows, drop=("interpret", "block"))
    got = _keys_by_kernel(trows, drop=("route",))
    assert got == want
    assert {r["route"] for r in trows} == {"plain"}
    for jr, trow in zip(jrows, trows):
        # the hardware-free terms (the port's default peaks are the H100's)
        for key in ("flops", "bytes", "intensity", "shape"):
            assert trow[key] == jr[key], key
    spans = [e for e in tr.events if e["type"] == "span"]
    assert [s["attrs"]["kernel"] for s in spans] == [r["kernel"]
                                                      for r in trows]
    with pytest.raises(ValueError, match="block sweep"):
        tprof.profile_kernels(blocks=((16, 16, 16),), device="cpu", **kw)


def test_profile_serving_digest(tmp_path):
    reg = tobs.MetricsRegistry()
    tobs.configure(path=str(tmp_path / "serve.jsonl"))
    try:
        out = tobs.profile_serving(precision_k=12, decode_steps=5,
                                   registry=reg, device="cpu")
    finally:
        tobs.shutdown()
    evs = tobs.load_events(str(tmp_path / "serve.jsonl"))
    assert tobs.validate_events(evs) == []
    names = [e["name"] for e in evs if e["type"] == "span"]
    assert names.count("serve.prefill") == 1
    assert names.count("serve.decode") == 5
    assert (out["n_layers"], out["batch"], out["prefill_len"],
            out["precision_k"]) == (2, 2, 8, 12)
    pct = out["decode"]["percentiles"]
    assert pct["p50"] <= pct["p95"] <= pct["p99"]
    assert out["decode"]["count"] == 5
    assert reg.histograms["serve.decode_latency_s"].percentiles() == pct
    assert set(out) == {"arch", "size", "n_layers", "batch", "prefill_len",
                        "decode_steps", "precision_k", "device", "prefill",
                        "decode"}
    assert out["size"] == "smoke"


def test_profile_serving_size_picks_the_config():
    with pytest.raises(ValueError, match="size must be"):
        tobs.profile_serving(size="medium", device="cpu")
    depth = tconfigs.get("qwen2_7b").SMOKE.n_layers
    for cap, want in ((None, depth), (0, depth), (1, 1)):
        out = tobs.profile_serving(max_layers=cap, decode_steps=1,
                                   device="cpu")
        assert (out["size"], out["n_layers"]) == ("smoke", want)
