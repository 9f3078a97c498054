"""Benchmark driver: the paper's tables on the port.

The counterpart of the JAX package's ``benchmarks/run.py`` for its paper
drivers: runs :mod:`.table1`, :mod:`.analysis_speed` and
:mod:`.bound_tightness` on ``--device``, prints ``name,us_per_call,derived``
CSV at the end and appends the same rows as one entry to
``BENCH_torch_micro.json`` (``repro_torch.obs.bench``; the directory is
``$REPRO_TORCH_BENCH_DIR`` or the repository root). The reference's kernel
and serving benchmarks and its roofline are not part of this driver.

Run:  python -m repro_torch.benchmarks.run [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks import add_device_arg
from repro_torch.launch.serve import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.benchmarks.run")
    add_device_arg(ap)
    dev = resolve_device(ap.parse_args(argv).device)
    from repro_torch.benchmarks import analysis_speed, bound_tightness, table1
    from repro_torch.obs.bench import append_bench

    rows = []
    rows += table1.run(dev)
    rows += analysis_speed.run(dev)
    rows += bound_tightness.run(dev)

    print("\nname,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")

    # machine-readable trajectory: the same rows, appended as one entry to
    # BENCH_torch_micro.json so regressions are diffable across runs
    append_bench("micro", {
        "kind": "bench_suite", "device": str(dev),
        "rows": [{"name": n, "us_per_call": round(us, 1), "derived": d}
                 for n, us, d in rows],
    })
    return rows


if __name__ == "__main__":
    main()
