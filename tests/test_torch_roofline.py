"""The port's roofline (``repro_torch.benchmarks.roofline``) and report
tables (``repro_torch.benchmarks.report_tables``) on the CPU.

* ``analytic_terms`` priced at the reference's ``TPU_POD_CHIP`` equals the
  reference's ``benchmarks.roofline.analytic_terms`` exactly, key for key,
  in every (arch × shape) cell that is not skipped and under each of the
  reference's policy switches.
* The reference's own roofline tests, on the port at the H100's peaks:
  analytic against counted params on the port's SMOKE init, positive
  terms in every cell, and the policies' monotonicity.
* ``load_cells`` on dry-run records names its peaks and the census's
  FLOPs and bytes for what they are; ``report_tables`` splices the two
  dry-run grids and the roofline table into a document between its
  markers, and a second run gives the same document.

The calibration against the dry run's FULL cells lives beside them in
``tests/test_torch_dryrun.py`` (``full_cells()``: the dry runs run once).
"""
import _torch_test_setup  # noqa: F401  (before any reference compile)
import json

import pytest
import torch

from benchmarks import roofline as JR
from repro import configs as jconfigs
from repro.launch.dryrun import effective_shape as j_effective_shape
from repro_torch import configs as tconfigs
from repro_torch.benchmarks import report_tables as RT
from repro_torch.benchmarks import roofline as R
from repro_torch.launch.dryrun import effective_shape
from repro_torch.models import transformer as TT
from repro_torch.obs.costmodel import H100_SXM, TPU_POD_CHIP

POLICIES = [{}, {"train_fsdp_gather": False},
            {"serve_params_data_sharded": False},
            {"param_bits": 8, "cache_bits": 8}, {"quant_moments": True},
            {"quant_moments": False}, {"grad_payload_bits": 8}]
CELLS = [(a, s) for a, s, skip in tconfigs.cells() if not skip]


@pytest.mark.parametrize("policy", POLICIES,
                         ids=[json.dumps(p, sort_keys=True) or "default"
                              for p in POLICIES])
def test_analytic_terms_equal_the_reference_under_its_chip(policy):
    assert len(CELLS) == 34             # 40 cells, 6 skipped
    for arch, shape in CELLS:
        tcfg, jcfg = tconfigs.get(arch).FULL, jconfigs.get(arch).FULL
        got = R.analytic_terms(tcfg, effective_shape(
            tcfg, tconfigs.SHAPES[shape]), policy, hw=TPU_POD_CHIP)
        want = JR.analytic_terms(jcfg, j_effective_shape(
            jcfg, jconfigs.SHAPES[shape]), policy)
        assert got == want, (arch, shape)


def test_analytic_params_match_counted():
    """Analytic parameter counts against the port's initialised SMOKE
    trees (the reference's test, its 25 %)."""
    for arch in ["qwen2_7b", "mixtral_8x22b", "minicpm3_4b", "rwkv6_1p6b"]:
        cfg = tconfigs.get(arch).SMOKE
        params = TT.init_params(cfg, generator=torch.Generator().manual_seed(
            0), device="cpu")
        counted = sum(t.numel() for t in _leaves(params))
        analytic = TT.analytic_params(cfg)
        assert abs(counted - analytic) / counted < 0.25, (arch, counted,
                                                          analytic)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_terms_positive_and_dominant_defined():
    for arch, shape in CELLS:
        cfg = tconfigs.get(arch).FULL
        a = R.analytic_terms(cfg, effective_shape(cfg,
                                                  tconfigs.SHAPES[shape]))
        assert a["compute_s"] > 0 and a["memory_s"] > 0
        assert a["collective_s"] > 0 and a["model_flops"] > 0


def test_policy_monotonicity():
    """fp8 storage must not raise the memory term; resident params must
    not raise the collective term (at the H100's peaks)."""
    cfg = tconfigs.get("qwen2_7b").FULL
    s = tconfigs.SHAPES["decode_32k"]
    base = R.analytic_terms(cfg, s)
    fp8 = R.analytic_terms(cfg, s, {"param_bits": 8, "cache_bits": 8})
    res = R.analytic_terms(cfg, s, {"serve_params_data_sharded": False})
    assert fp8["memory_s"] < base["memory_s"]
    assert res["collective_s"] < base["collective_s"]
    h100, tpu = (R.analytic_terms(cfg, s, hw=hw)
                 for hw in (H100_SXM, TPU_POD_CHIP))
    assert h100["memory_s"] < tpu["memory_s"]      # 3.35 TB/s vs 819 GB/s


def _record(arch, shape, mesh, status="ok", peak=1e9):
    rec = {"arch": arch, "shape": shape, "mesh": mesh, "status": status,
           "mesh_shape": [16, 16] if mesh == "single" else [2, 16, 16]}
    if status == "skipped":
        return dict(rec, reason="needs sub-quadratic attention")
    return dict(rec, memory={"peak_bytes": int(peak)},
                cost={"flops": 2.5e15, "flops_counted": "products only",
                      "bytes_accessed": 4e12,
                      "bytes_accessed_is": "unfused upper bound"},
                collectives={"total_bytes": 3e9, "count_by_kind": {},
                             "bytes_by_kind": {}})


def test_load_cells_and_report_tables(tmp_path):
    out = tmp_path / "records"
    out.mkdir()
    recs = [_record("qwen2_7b", "train_4k", "single", peak=1.5e11),
            _record("qwen2_7b", "decode_32k", "single"),
            _record("qwen2_7b", "long_500k", "single", status="skipped"),
            _record("qwen2_7b", "train_4k", "multi", peak=7e10)]
    for r in recs:
        (out / f"{r['arch']}_{r['shape']}_{r['mesh']}.json").write_text(
            json.dumps(r))
    cells = [c for c in R.load_cells(str(out)) if c["status"] == "ok"]
    assert [c["shape"] for c in cells] == ["decode_32k", "train_4k"]
    roof = cells[1]["roofline"]
    assert roof["peaks"]["name"] == H100_SXM.name
    assert roof["peaks"]["peak_flops"] == H100_SXM.peak_flops
    assert "CUDA cores" in roof["peaks"]["peak_flops_is"]
    assert roof["census_flops_counted"] == "products only"
    assert roof["census_bytes_are"] == "unfused upper bound"
    want = R.analytic_terms(tconfigs.get("qwen2_7b").FULL,
                            tconfigs.SHAPES["train_4k"])
    assert roof["compute_s"] == want["compute_s"]
    assert roof["census_flops_ratio"] == 2.5e15 * 256 / want["flops"]

    doc = tmp_path / "DOC.md"
    doc.write_text("# doc\n\n<!-- DRYRUN_TABLE -->\nold\n"
                   "<!-- /DRYRUN_TABLE -->\n\ntext\n\n<!-- ROOFLINE_TABLE -->"
                   "\n<!-- /ROOFLINE_TABLE -->\nend\n")
    argv = ["--doc", str(doc), "--out", str(out)]
    first = RT.main(argv)
    assert RT.main(argv) == first == doc.read_text()
    assert "old" not in first and first.endswith("end\n")
    assert "4 records: 3 ok, 1 skipped" in first
    assert "| qwen2_7b | 150.0 ✗ · 2,500 · 3 | not run | 1.0 · 2,500 · 3 | " \
        "skipped |" in first
    assert "| qwen2_7b | 70.0 · 2,500 · 3 | not run | not run | not run |" \
        in first
    assert "| mixtral_8x22b | not run | not run | not run | not run |" in first
    ratio = 2.5e15 * 256 / want["flops"]
    t = max(want["compute_s"], want["memory_s"], want["collective_s"])
    assert f"| qwen2_7b | {roof['dominant']} {t:.3g} s · " \
        f"{roof['mfu_bound']:.3f} · {ratio:.3g} |" in first
    assert "| mixtral_8x22b | — | — | — | — |" in first   # single-pod only
    assert "unfused upper bound" in first
