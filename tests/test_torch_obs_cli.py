"""The port's trace report, schema check, bench trajectory and monitored
serving CLI against the JAX package's, on the CPU.

* ``report``: the same JSONL trace renders to the same text through both
  packages' ``report`` (module and CLI); ``validate`` gives the same
  verdicts on good and bad traces.
* ``bench``: append, read, the in-session dedupe and ``perfgate`` agree
  with the reference's on temporary directories (timestamps aside); the
  port writes only its own ``BENCH_torch_*.json`` and no ``benchmarks/``
  snapshot.
* ``python -m repro_torch.launch.serve --monitor --metrics --prom
  --trace`` on the CPU writes a metrics snapshot whose keys are the
  reference CLI's for the same certificate set (the reference's compile
  gauges aside: they have no PyTorch counterpart), and a trace both
  packages' ``validate_events`` accept.
"""
import _torch_test_setup  # noqa: F401  (before any reference compile)
import json
import os

import pytest

from repro import obs as jobs
from repro.obs import __main__ as jcli
from repro.obs import bench as jbench
from repro.obs import report as jreport
from repro_torch import obs as tobs
from repro_torch.obs import __main__ as tcli
from repro_torch.obs import bench as tbench
from repro_torch.obs import report as treport

COMPILE_GAUGES = {"serve.prefill_compile_s", "serve.decode_compile_s"}


def _write_trace(path):
    tr = tobs.Tracer(path=str(path), program="repro_torch.test",
                     argv=["--x", "1"])
    with tr.span("certify_run", arch="digits"):
        for scope in ("dense1", "dense2", "dense1"):
            with tr.span("greedy_descent_step", scope=scope):
                with tr.span("probe", k=12):
                    pass
        tr.counter("store.hits_mem", 3)
        tr.gauge("serve.decode_tokens_per_s", 123.456)
        tr.event("note", text="hello")
    tr.close()
    return path


def test_report_renders_the_same_text(tmp_path, capsys):
    path = _write_trace(tmp_path / "t.jsonl")
    events = tobs.load_events(str(path))
    assert treport.render(events) == jreport.render(events)
    assert (treport.render(events, per_scope=False)
            == jreport.render(events, per_scope=False))
    assert treport.summarize(events) == jreport.summarize(events)
    outs = []
    for cli in (tcli, jcli):
        assert cli.main(["report", str(path)]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "greedy_descent_step" in outs[0]


def test_validate_gives_the_same_verdicts(tmp_path, capsys):
    good = _write_trace(tmp_path / "good.jsonl")
    lines = good.read_text().splitlines()
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    no_meta = tmp_path / "no_meta.jsonl"         # valid: meta is optional
    no_meta.write_text("\n".join(lines[1:]) + "\n")
    old_schema = tmp_path / "old_schema.jsonl"
    meta = dict(json.loads(lines[0]), schema=-1)
    old_schema.write_text("\n".join([json.dumps(meta)] + lines[1:]) + "\n")
    bad_span = tmp_path / "bad_span.jsonl"
    spans = [json.loads(ln) for ln in lines]
    for ev in spans:
        if ev.get("type") == "span":
            ev["dur_s"] = -1.0
    bad_span.write_text("\n".join(json.dumps(e) for e in spans) + "\n")
    garbage = tmp_path / "garbage.jsonl"
    garbage.write_text("{not json\n")
    verdicts = {}
    for path in (good, empty, no_meta, old_schema, bad_span, garbage):
        got = [cli.main(["validate", str(path)]) for cli in (tcli, jcli)]
        capsys.readouterr()
        assert got[0] == got[1], path.name
        verdicts[path.name] = got[0]
    assert verdicts == {"good.jsonl": 0, "empty.jsonl": 1,
                        "no_meta.jsonl": 0, "old_schema.jsonl": 1,
                        "bad_span.jsonl": 1, "garbage.jsonl": 1}


def _strip_t(entries):
    return [{k: v for k, v in e.items() if k != "t"} for e in entries]


def _kernel_entry(scale):
    return {"kind": "kernel_bench", "case": f"c{scale}", "rows": [
        {"kernel": "quant_matmul", "shape": "4x64x64", "k": 12,
         "median_s": 1e-5 * scale},
        {"kernel": "flash_decode", "shape": "B4S145", "median_s": 2e-5}]}


def test_bench_trajectory_and_perfgate_agree(tmp_path, monkeypatch, capsys):
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    monkeypatch.setenv("REPRO_BENCH_DIR", str(jdir))
    monkeypatch.setenv("REPRO_TORCH_BENCH_DIR", str(tdir))
    monkeypatch.setattr(jbench, "_session_keys", {})
    monkeypatch.setattr(tbench, "_session_keys", {})
    runs = [{"kind": "certify", "arch": "digits", "mixed": False,
             "analysis_seconds": 1.5},
            {"kind": "certify", "arch": "digits", "mixed": True,
             "analysis_seconds": 2.5},
            # same identity as the first: replaces it in this session
            {"kind": "certify", "arch": "digits", "mixed": False,
             "analysis_seconds": 1.25},
            {"note": "no identity fields: always appended"},
            {"note": "no identity fields: always appended"}]
    for e in runs:
        jbench.append_bench("runs", e)
        tbench.append_bench("runs", e)
    got = tbench.read_bench("runs")
    assert _strip_t(got) == _strip_t(jbench.read_bench("runs"))
    assert _strip_t(got) == [runs[2], runs[1], runs[3], runs[4]]
    # exact duplicates in a file are dropped on read
    dup = [{"t": 1.0, "kind": "x"}, {"t": 1.0, "kind": "x"},
           {"t": 2.0, "kind": "x"}]
    for d, mod in ((jdir, jbench), (tdir, tbench)):
        with open(mod.bench_path("dup"), "w") as fh:
            json.dump(dup, fh)
    assert tbench.read_bench("dup") == jbench.read_bench("dup") == [
        dup[0], dup[2]]
    os.remove(tbench.bench_path("dup"))
    for scale in (1.0, 2.0):
        jbench.append_bench("kernels", _kernel_entry(scale))
        tbench.append_bench("kernels", _kernel_entry(scale))
    findings = tbench.check_regressions("kernels", 0.25)
    assert findings == jbench.check_regressions("kernels", 0.25)
    assert [f["kernel"] for f in findings] == ["quant_matmul"]
    outs = []
    for cli in (tcli, jcli):
        assert cli.main(["perfgate"]) == 0
        assert cli.main(["perfgate", "--fail-on", "0.5"]) == 1
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "::error::perf: quant_matmul" in outs[0]
    assert tcli.main(["report", "--kernels"]) == 0
    assert "quant_matmul" in capsys.readouterr().out
    # the port's files are its own, and it keeps no benchmarks/ snapshot
    assert sorted(os.listdir(tdir)) == ["BENCH_torch_kernels.json",
                                        "BENCH_torch_runs.json"]
    assert "benchmarks" in os.listdir(jdir)
    monkeypatch.delenv("REPRO_TORCH_BENCH_DIR")
    root = tbench.repo_root()
    assert tbench.bench_path("runs") == os.path.join(
        root, "BENCH_torch_runs.json")
    assert os.path.isfile(os.path.join(root, "BENCH_runs.json"))


def _v3_set_json():
    fmt = {"k": 12, "emax": 15, "emin": -14, "has_subnormals": True,
           "saturating": True, "name": "f"}
    cert = {"model_id": "qwen2-smoke", "params_digest": "ab" * 32,
            "class_key": "p0", "cfg": {}, "bounds_u_max": 2.0 ** -11,
            "final_abs_u": 5.0e4, "final_rel_u": 1.0e5, "required_k": 12,
            "satisfied_by": [], "schema_version": 3, "layer_k": None,
            "layer_format": {"": fmt, "layer*/mlp": dict(fmt, k=10)}}
    ranges = {f"layer{i}/{s}": {"max_abs": 1e3} for i in range(2)
              for s in ("attn", "mlp")}
    return json.dumps({
        "schema_version": 3, "model_id": "qwen2-smoke",
        "params_digest": "ab" * 32, "certificates": [cert],
        "meta": {"formats": {"applied": True, "scope_ranges": ranges}}})


def _reference_snapshot(tmp_path, monkeypatch, set_json):
    """The reference serving CLI on the same set (its store lookup stubbed
    to return it, its host mesh with Auto axes, which its serving
    shardings need under this JAX)."""
    import jax

    import repro.certify as jcertify
    from repro.certify import spec as jspec
    from repro.launch import mesh as jmesh
    from repro.launch import serve as jserve

    monkeypatch.setattr(jcertify, "serving_certificate",
                        lambda *a, **k: jspec.CertificateSet.from_json(
                            set_json))
    monkeypatch.setattr(jmesh, "make_host_mesh", lambda: jax.make_mesh(
        (1, 1), ("data", "model"),
        axis_types=(jax.sharding.AxisType.Auto,) * 2))
    out = tmp_path / "jax"
    try:
        registry, monitor = jserve.main([
            "--batch", "2", "--prefill-len", "8", "--decode-steps", "2",
            "--certificates", "unused", "--monitor",
            "--metrics", str(out / "m.jsonl"), "--prom", str(out / "m.prom"),
            "--trace", str(out / "t.jsonl")])
    finally:
        jobs.shutdown()
    return json.loads((out / "m.jsonl").read_text().splitlines()[-1])


def _keys(snap):
    return {part: set(snap[part]) for part in
            ("meta", "counters", "gauges", "histograms")}


def test_serve_cli_monitor_metrics_prom_trace(tmp_path, monkeypatch):
    from repro_torch.launch import serve as tserve

    set_json = _v3_set_json()
    set_path = tmp_path / "set.json"
    set_path.write_text(set_json)
    out = tmp_path / "torch"
    try:
        res = tserve.main([
            "--device", "cpu", "--batch", "2", "--prefill-len", "8",
            "--decode-steps", "2", "--certificate-set", str(set_path),
            "--monitor", "--metrics", str(out / "m.jsonl"),
            "--prom", str(out / "m.prom"), "--trace", str(out / "t.jsonl")])
    finally:
        tobs.shutdown()
    snap = json.loads((out / "m.jsonl").read_text().splitlines()[-1])
    assert res.monitor is not None and res.registry is not None
    assert snap["counters"]["obs.scope_observations"] == 7 * 2 * 3
    assert snap["counters"]["obs.error_samples"] == 1
    assert res.monitor.violations == 0
    assert {"obs.bound_margin_log2{scope=layer*/attn}",
            "obs.bound_margin_log2{scope=layer*/mlp}"} <= set(snap["gauges"])
    prom = (out / "m.prom").read_text()
    assert "obs_scope_observations" in prom and 'scope="layer*/mlp"' in prom

    ref = _reference_snapshot(tmp_path, monkeypatch, set_json)
    want = _keys(ref)
    want["gauges"] -= COMPILE_GAUGES
    assert _keys(snap) == want
    # the two CLIs seed other weights, so only the shape-given counts agree
    for name in ("obs.scope_observations", "obs.error_samples",
                 "serve.requests", "serve.tokens"):
        assert snap["counters"][name] == ref["counters"][name]

    events = tobs.load_events(str(out / "t.jsonl"))
    assert tobs.validate_events(events) == []
    assert jobs.validate_events(events) == []
    names = {ev["name"] for ev in events if ev.get("type") == "span"}
    assert names == {"serve.prefill", "serve.decode"}
    assert "serve.decode" in treport.render(events)


def test_serve_cli_monitor_needs_a_certificate():
    from repro_torch.launch import serve as tserve

    with pytest.raises(SystemExit):
        tserve.main(["--device", "cpu", "--precision-k", "12", "--monitor"])
