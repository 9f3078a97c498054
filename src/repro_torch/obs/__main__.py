"""CLI of the port's observability: render or validate JSONL traces; kernel
trajectory views (the PyTorch port's copy of ``python -m repro.obs``).

  python -m repro_torch.obs report trace.jsonl [--no-scopes]
  python -m repro_torch.obs report --kernels [--bench-dir DIR]
  python -m repro_torch.obs validate trace.jsonl
  python -m repro_torch.obs perfgate [--threshold 0.25] [--bench-dir DIR]

``report`` prints the per-stage/per-scope summary table (and/or, with
``--kernels``, the measured-kernel roofline table + serving percentile
digest from the port's ``BENCH_torch_kernels.json`` trajectory);
``validate`` checks the schema (exit 1 on an empty or invalid trace).
``perfgate`` is the SOFT perf gate: it compares the last two
kernel trajectory entries and prints a ``::warning::`` line per kernel
whose median regressed beyond the threshold — exit 0; timing on shared CI
runners is advisory, not a merge blocker. The opt-in ``--fail-on PCT``
adds a HARD rail on top: regressions beyond that (larger) fraction print
``::error::`` and exit 1.
"""
from __future__ import annotations

import argparse
import sys

from . import bench as B
from . import report as R
from . import trace as T


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m repro_torch.obs")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("report", help="render a trace into summary tables")
    pr.add_argument("trace", nargs="?", default=None,
                    help="JSONL trace file (optional with --kernels)")
    pr.add_argument("--no-scopes", action="store_true",
                    help="suppress per-scope sub-rows")
    pr.add_argument("--kernels", action="store_true",
                    help="render the measured kernel-bench trajectory "
                         "(BENCH_torch_kernels.json): median latency, "
                         "achieved "
                         "intensity vs analytic roofline, serving "
                         "p50/p95/p99")
    pr.add_argument("--bench-dir", default=None,
                    help="trajectory directory (default: repo root / "
                         "$REPRO_TORCH_BENCH_DIR)")

    pv = sub.add_parser("validate", help="schema-check a trace (CI gate)")
    pv.add_argument("trace", help="JSONL trace file")

    pg = sub.add_parser("perfgate",
                        help="warn (never fail) on kernel medians that "
                             "regressed vs the previous trajectory entry")
    pg.add_argument("--threshold", type=float, default=0.25,
                    help="relative regression to warn at (default 0.25)")
    pg.add_argument("--fail-on", type=float, default=None, metavar="PCT",
                    help="opt-in hard gate: exit 1 (with ::error:: "
                         "annotations) when any kernel median regressed "
                         "beyond this fraction (e.g. 1.0 = +100%%); "
                         "regressions between --threshold and --fail-on "
                         "still only warn")
    pg.add_argument("--bench-dir", default=None)
    pg.add_argument("--name", default="kernels",
                    help="trajectory name (BENCH_torch_<name>.json)")

    args = p.parse_args(argv)

    if args.cmd == "perfgate":
        try:
            findings = B.check_regressions(args.name, args.threshold,
                                           args.bench_dir)
        except (OSError, ValueError) as e:
            print(f"perfgate: cannot read trajectory ({e}) — skipping",
                  file=sys.stderr)
            return 0
        if not findings:
            n = len(B.read_bench(args.name, args.bench_dir))
            print(f"perfgate: ok — no kernel median regressed "
                  f">{args.threshold:.0%} ({n} trajectory entries)")
            return 0
        hard = []
        for f in findings:
            # ::warning::/::error:: render as GitHub Actions annotations;
            # plain text everywhere else
            over_rail = (args.fail_on is not None
                         and f["ratio"] > 1.0 + args.fail_on)
            if over_rail:
                hard.append(f)
            level = "error" if over_rail else "warning"
            print(f"::{level}::perf: {f['kernel']} {f.get('shape', '')} "
                  f"k={f.get('k')} median {f['prev_median_s'] * 1e6:.1f}us "
                  f"-> {f['last_median_s'] * 1e6:.1f}us "
                  f"({f['ratio'] - 1.0:+.0%})")
        if hard:
            print(f"perfgate: {len(hard)} kernel point(s) regressed "
                  f">{args.fail_on:.0%} (--fail-on hard gate) — failing")
            return 1
        print(f"perfgate: {len(findings)} kernel point(s) regressed "
              f">{args.threshold:.0%} (soft gate — not failing the build)")
        return 0

    if args.cmd == "report" and args.kernels and args.trace is None:
        try:
            entries = B.read_bench("kernels", args.bench_dir)
        except (OSError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        print(R.render_kernel_table(entries))
        return 0

    if args.trace is None:
        print("error: report needs a trace file (or --kernels)",
              file=sys.stderr)
        return 1
    try:
        events = T.load_events(args.trace)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    if args.cmd == "validate":
        errors = T.validate_events(events)
        if errors:
            for e in errors[:20]:
                print(f"invalid: {e}", file=sys.stderr)
            return 1
        n_spans = sum(1 for ev in events if ev.get("type") == "span")
        print(f"ok: {len(events)} events ({n_spans} spans) schema-valid")
        return 0

    try:
        print(R.render(events, per_scope=not args.no_scopes))
        if args.kernels:
            entries = B.read_bench("kernels", args.bench_dir)
            print()
            print(R.render_kernel_table(entries))
    except BrokenPipeError:  # report | head — downstream closed, not an error
        sys.stderr.close()
        return 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
