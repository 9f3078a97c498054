"""Regenerate ``PERF.md``'s dry-run grids and roofline table from the dry
run's records (``results/dryrun_torch/*.json``) — the counterpart of the
JAX package's ``benchmarks/report_tables.py``, which writes
``EXPERIMENTS.md``.

Each table is spliced between its markers (``<!-- DRYRUN_TABLE -->`` …
``<!-- /DRYRUN_TABLE -->``, ``<!-- ROOFLINE_TABLE -->`` …
``<!-- /ROOFLINE_TABLE -->``); a second run on the same records gives the
same document. The figures are the dry run's counts (shapes, fake
tensors), not measurements on a device.

Usage::

    python -m repro_torch.benchmarks.report_tables [--doc PERF.md]
        [--out results/dryrun_torch]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch import configs
from repro_torch.configs import SHAPES
from repro_torch.launch.dryrun import H100_BYTES

MESHES = (("single", "16 × 16"), ("multi", "2 × 16 × 16"))


def _records(out_dir: str) -> dict:
    recs = {}
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        recs[(rec["arch"], rec["shape"], rec["mesh"])] = rec
    return recs


def _cell(rec) -> str:
    if rec is None:
        return "not run"
    if rec["status"] == "skipped":
        return "skipped"
    if rec["status"] == "error":
        return "error"
    peak = rec["memory"]["peak_bytes"]
    mark = "" if peak <= H100_BYTES else " ✗"
    return (f"{peak / 1e9:,.1f}{mark} · {rec['cost']['flops'] / 1e12:,.4g} · "
            f"{rec['collectives']['total_bytes'] / 1e9:,.4g}")


def dryrun_table(out_dir: str = "results/dryrun_torch") -> str:
    """Two grids (16 × 16, 2 × 16 × 16): a cell's peak GB a rank (✗ over
    80 GB) · TFLOP of products a rank · collective GB a rank."""
    recs = _records(out_dir)
    n = {s: sum(r["status"] == s for r in recs.values())
         for s in ("ok", "skipped", "error")}
    out = [f"{len(recs)} records: {n['ok']} ok, {n['skipped']} skipped "
           f"(the reference's skip rule), {n['error']} errors. Cell: peak "
           "GB a rank (✗: over 80 GB) · TFLOP of products a rank · "
           "collective GB a rank (the dry run's counts)."]
    for mesh, title in MESHES:
        out += ["", f"| {title} | " + " | ".join(SHAPES) + " |",
                "| --- |" + " --- |" * len(SHAPES)]
        for arch in configs.ARCHS:
            out.append(f"| {arch} | " + " | ".join(
                _cell(recs.get((arch, s, mesh))) for s in SHAPES) + " |")
    errors = [r for r in recs.values() if r["status"] == "error"]
    for r in errors:
        out.append(f"- error {r['arch']} × {r['shape']} ({r['mesh']}): "
                   f"{r.get('error', '')[:140]}")
    return "\n".join(out)


def roofline_table(out_dir: str = "results/dryrun_torch") -> str:
    """The single-pod roofline (``roofline.load_cells``) as a grid: a
    cell's dominant term and its time (the analytic terms at the H100's
    peaks) · the MFU bound · the census's FLOPs × chips over the analytic
    FLOPs."""
    from repro_torch.benchmarks import roofline as R

    cells = R.load_cells(out_dir)
    ok = {(c["arch"], c["shape"]): c["roofline"] for c in cells
          if c.get("status") == "ok"}

    def cell(arch, shape):
        r = ok.get((arch, shape))
        if r is None:
            return "—"
        t = max(r["compute_s"], r["memory_s"], r["collective_s"])
        return (f"{r['dominant']} {t:.3g} s · {r['mfu_bound']:.3f} · "
                f"{r['census_flops_ratio']:.3g}")

    out = ["Cell: the dominant term and its seconds a step · MFU bound · "
           "census / analytic FLOPs (— : no ok record).", "",
           "| 16 × 16 | " + " | ".join(SHAPES) + " |",
           "| --- |" + " --- |" * len(SHAPES)]
    for arch in configs.ARCHS:
        out.append(f"| {arch} | " + " | ".join(cell(arch, s) for s in SHAPES)
                   + " |")
    if ok:
        r = next(iter(ok.values()))
        p = r["peaks"]
        out += ["", f"Peaks ({p['name']}): {p['peak_flops']:.3g} FLOP/s, "
                f"{p['peak_flops_is']}; {p['hbm_bytes_per_s']:.3g} B/s "
                f"{p['hbm_bytes_per_s_is']}; {p['link_bytes_per_s']:.3g} "
                f"B/s {p['link_bytes_per_s_is']}. Census FLOPs: "
                f"{r['census_flops_counted']}, the whole step a rank; its "
                f"bytes (not tabled): an {r['census_bytes_are']}."]
    return "\n".join(out)


def splice(doc: str, start_marker: str, end_marker: str, new: str) -> str:
    i = doc.index(start_marker) + len(start_marker)
    j = doc.index(end_marker)
    return doc[:i] + "\n\n" + new + "\n\n" + doc[j:]


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.report_tables",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--doc", default="PERF.md")
    ap.add_argument("--out", default="results/dryrun_torch",
                    help="the dry run's records")
    args = ap.parse_args(argv)
    with open(args.doc) as f:
        doc = f.read()
    doc = splice(doc, "<!-- DRYRUN_TABLE -->", "<!-- /DRYRUN_TABLE -->",
                 dryrun_table(args.out))
    doc = splice(doc, "<!-- ROOFLINE_TABLE -->", "<!-- /ROOFLINE_TABLE -->",
                 roofline_table(args.out))
    with open(args.doc, "w") as f:
        f.write(doc)
    print(f"{args.doc}: dry-run and roofline tables regenerated")
    return doc


if __name__ == "__main__":
    main()
