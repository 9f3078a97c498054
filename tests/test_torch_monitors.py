"""The port's certificate-violation monitor against the JAX package's.

``repro_torch.obs.monitors.ViolationMonitor`` is a copy of the reference's
host-side fold: fed the same sequence of numeric-health stats under the
same certificate set (v1, v2, and v3 with ``scope_ranges`` holding concrete
``layer<i>`` keys, sub-layer keys and an explicit ``layer*``), both give
the same summary and export the same metrics. Exact equality: the fold is
Python float arithmetic in both packages.

What the port adds is the device log: a monitored forward writes one row a
matmul and calls nothing on the host; ``flush()`` folds the rows in order,
exactly as one ``observe_scope`` call per product would.
"""
import _torch_test_setup  # noqa: F401  (before any reference compile)
import json
import math

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.certify import spec as jspec
from repro_torch import configs as tconfigs
from repro_torch import obs as tobs
from repro_torch.certify import spec as tspec
from repro_torch.core.quantize import numeric_health
from repro_torch.kernels import health
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT
from repro_torch.obs.monitors import HealthLog, ViolationMonitor

FMT = {"k": 12, "emax": 15, "emin": -14, "has_subnormals": True,
       "saturating": True, "name": "f"}
RANGES = {
    "embed": {"max_abs": 3.0},
    "layer0": {"max_abs": 9.0},
    "layer1": {"max_abs": 4.0},
    "layer*": {"max_abs": 5.0},          # explicit wildcard, merge-maxed
    "layer0/attn": {"max_abs": 2.0},
    "layer1/attn": {"max_abs": 2.5},
    "layer1/mlp": {"max_abs": 0.75},
    "head": {"max_abs": float("inf")},   # not finite: no envelope
    "": {"max_abs": 1.0},                # default scope: not addressable
}


def _cert(class_key, required_k, abs_u, layer_k=None, layer_format=None):
    return {"model_id": "qwen2-smoke", "params_digest": "ab" * 32,
            "class_key": class_key, "cfg": {}, "bounds_u_max": 2.0 ** -9,
            "final_abs_u": abs_u, "final_rel_u": 2 * abs_u,
            "required_k": required_k, "satisfied_by": [],
            "schema_version": 3, "layer_k": layer_k,
            "layer_format": layer_format}


SETS = {
    "v1": {"schema_version": 1, "certificates": [
        _cert("p0", 12, 40.0), _cert("p1", 11, 75.5)], "meta": {}},
    "v2": {"schema_version": 2, "certificates": [
        _cert("p0", 12, 40.0, {"layer0": 9, "layer1/mlp": 10}),
        _cert("p1", 11, 12.0, {"layer0": 10, "layer1": 8})], "meta": {}},
    "v3_ranges": {"schema_version": 3, "certificates": [
        _cert("p0", 12, 30.0, {"layer0": 9},
              {"": FMT, "layer0": dict(FMT, k=10)})],
        "meta": {"formats": {"applied": True, "scope_ranges": RANGES}}},
}


def _set_json(name):
    return json.dumps({"model_id": "qwen2-smoke", "params_digest": "ab" * 32,
                       **SETS[name]})


def _stats_sequence():
    """Observations under concrete, stacked and unmapped paths: inside and
    outside the envelopes, with overflow, underflow and non-finite
    events, an all-zero product and an error sample below and above δ̄."""
    rng = np.random.RandomState(7)
    paths = [["embed"], ["layer0"], ["layer*"], ["layer*", "attn"],
             ["layer1", "attn"], ["layer*", "mlp"], ["layer1", "mlp"],
             ["layer0", "mlp"], ["head"], ["elsewhere"], []]
    seq = []
    for i in range(60):
        path = paths[i % len(paths)]
        seq.append((path, {
            "max_abs": float(np.float32(rng.choice([0.0, 0.5, 1.9, 4.5,
                                                    7.0, 30.0]))
                             * np.float32(1 + rng.rand()))
            if i % 13 else 0.0,
            "min_nonzero": float(rng.rand()) if i % 13 else math.inf,
            "n_over": int(rng.rand() < 0.1),
            "n_under": int(rng.randint(0, 3)),
            "n_nonfinite": int(rng.rand() < 0.05)}))
    return seq


@pytest.mark.parametrize("name", sorted(SETS))
def test_monitor_summary_and_export_equal_the_reference(name):
    js = jspec.CertificateSet.from_json(_set_json(name))
    ts = tspec.CertificateSet.from_json(_set_json(name))
    jm = jobs.ViolationMonitor.from_certificate_set(js)
    tm = ViolationMonitor.from_certificate_set(ts)
    assert tm.envelopes == jm.envelopes
    assert (tm.dbar_u, tm.u, tm.slack) == (jm.dbar_u, jm.u, jm.slack)
    if name == "v3_ranges":
        assert tm.envelopes["layer*"] == {"max_abs": 9.0}
        assert tm.envelopes["layer*/attn"] == {"max_abs": 2.5}
        assert "" not in tm.envelopes and "head" not in tm.envelopes
    else:
        assert tm.envelopes == {}
    for i, (path, stats) in enumerate(_stats_sequence()):
        jm.observe_scope(path, stats)
        tm.observe_scope(path, stats)
        if i in (20, 45):
            err = 0.5 * tm.dbar_u if i == 20 else 3.0 * tm.dbar_u
            jm.observe_error(err)
            tm.observe_error(err)
    assert tm.summary() == jm.summary()
    assert tm.violations == jm.violations
    assert tm.error_margin_u() == jm.error_margin_u()
    if name == "v3_ranges":
        assert tm.counters["obs.enclosure_violations"] > 0
        assert any(m < 0 for m in tm.scope_margin.values())
    jr, tr = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    for _ in range(2):               # a second export adds nothing
        jm.export(jr)
        tm.export(tr)
    jd, td = jr.to_dict(), tr.to_dict()
    jd.pop("t"), td.pop("t")
    assert td == jd
    assert tr.render_prometheus() == jr.render_prometheus()


def _monitored_forward(mon):
    cfg = tconfigs.get("qwen2_7b").SMOKE
    params = TT.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    sc = tserve.ServeConfig(precision_layer_format={
        "": {"k": 12, "emax": 15, "emin": -14},
        "layer*/mlp": {"k": 10, "emax": 15, "emin": -14},
        "layer0/mlp": {"k": 16, "emax": 31, "emin": -30}})
    bk = tserve._backend(sc, mon)
    toks = torch.from_numpy(np.random.RandomState(1).randint(0, cfg.vocab,
                                                             (2, 8)))
    cache = TT.init_cache(cfg, 2, 12, device="cpu")
    with torch.no_grad():
        logits, _ = tserve.prefill_step(bk, params, cfg, cache, toks)
    return logits


def test_device_log_folds_as_per_observation_calls(monkeypatch):
    """One monitored forward: a row per matmul is pending and nothing was
    folded; ``flush()`` then folds exactly what one ``observe_scope`` call
    per product (under its ``layer*`` label, with the plain stats) gives,
    and leaves nothing pending."""
    ts = tspec.CertificateSet.from_json(_set_json("v3_ranges"))
    mon = ViolationMonitor.from_certificate_set(ts)
    twin = ViolationMonitor.from_certificate_set(ts)
    seen, calls = [], []
    record = mon.record

    def spy_record(scope, x, k, emax=127, emin=-126):
        seen.append((list(scope), x.clone(), (k, emax, emin)))
        return record(scope, x, k, emax, emin)

    observe = mon.observe_scope
    monkeypatch.setattr(mon, "record", spy_record)
    monkeypatch.setattr(mon, "observe_scope",
                        lambda s, st: (calls.append(s), observe(s, st)))
    _monitored_forward(mon)
    cfg = tconfigs.get("qwen2_7b").SMOKE
    assert mon.pending == len(seen) == 7 * cfg.n_layers
    assert calls == [] and mon.counters["obs.scope_observations"] == 0
    assert {tuple(s) for s, _, _ in seen} == {("layer*", "attn"),
                                              ("layer*", "mlp")}
    # layer0/mlp's format rounds its products, the label is the stack's
    assert (16, 31, -30) in {f for s, _, f in seen if s[-1] == "mlp"}
    assert mon.flush() == len(seen)
    assert mon.pending == 0 and calls == [s for s, _, _ in seen]
    for scope, x, fmt in seen:
        twin.observe_scope(scope, {key: v.item() for key, v in
                                   numeric_health(x, *fmt).items()})
    assert mon.summary() == twin.summary()
    assert mon.flush() == 0


def test_device_log_grows_and_reinitialises_rows():
    """A full log doubles without losing rows; a flushed row starts again
    from max_abs 0, min_nonzero +inf and zero counts."""
    log = HealthLog(capacity=2)
    xs = [torch.tensor([0.5, -3.0, 1e-30, float("nan")]),
          torch.zeros(5), torch.tensor([70000.0, -2.0 ** -20]),
          torch.tensor([1.0])]
    for i, x in enumerate(xs):
        log.record([f"s{i}"], x, 8, 15, -14)
    assert log.buf.shape[0] == 4 and log.pending == 4
    rows = log.drain()
    assert [label for label, _ in rows] == [["s0"], ["s1"], ["s2"], ["s3"]]
    for (_, got), x in zip(rows, xs):
        want = {key: v.item() for key, v in
                numeric_health(x, 8, 15, -14).items()}
        assert got == want
    assert rows[1][1]["min_nonzero"] == math.inf
    assert rows[1][1]["max_abs"] == 0.0
    assert rows[0][1]["n_nonfinite"] == 1 and rows[2][1]["n_over"] == 1
    assert torch.equal(log.buf, health.init_rows(4, "cpu"))
    log.record(["again"], torch.tensor([2.0]), 8, 15, -14)
    assert log.drain()[0][1]["max_abs"] == 2.0


@pytest.mark.parametrize("k,emax,emin", [(8, 15, -14), (24, 127, -126),
                                         (26, 127, -126), (12, 15, -150),
                                         (11, 5, -6)])
def test_threshold_bits_are_the_plain_versions(k, emax, emin):
    """The f32 thresholds the kernel takes from the host are the plain
    version's own: max_finite +inf for k ≥ 26 in f32, min_normal at or
    below the smallest f32 subnormal for emin < −149."""
    max_bits, min_bits = health.threshold_bits(k, emax, emin)
    as_f32 = lambda b: float(np.array([b], np.uint32).view(np.float32)[0])
    x = torch.tensor([as_f32(max_bits), as_f32(min_bits)])
    # exactly at either threshold counts as neither over nor under
    st = numeric_health(x, k, emax, emin)
    assert st["n_over"].item() == 0 and st["n_under"].item() == 0
    if k >= 26:
        assert as_f32(max_bits) == math.inf
    if emin < -149:
        assert as_f32(min_bits) <= 2.0 ** -149
    bumped = torch.nextafter(x, torch.full_like(x, math.inf))
    st = numeric_health(bumped, k, emax, emin)
    assert st["n_over"].item() == int(bool(torch.isfinite(bumped[0])))


def test_dispatch_refuses_what_the_log_cannot_hold():
    buf = health.init_rows(2, "cpu")
    with pytest.raises(ValueError, match="f32"):
        health.numeric_health_dispatch(torch.ones(3, dtype=torch.float64),
                                       8, 15, -14, buf, 0)
    with pytest.raises(IndexError):
        health.numeric_health_dispatch(torch.ones(3), 8, 15, -14, buf, 2)
    with pytest.raises(ValueError, match="CUDA"):
        health.numeric_health(torch.ones(3), 8, 15, -14, buf, 0)
