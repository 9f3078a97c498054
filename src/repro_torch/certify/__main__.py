"""CLI: produce (or fetch) a persisted certificate set (PyTorch).

The counterpart of the JAX package's ``python -m repro.certify``::

  # the paper's Digits classifier, all 10 classes batched, top-1 safe at p*:
  PYTHONPATH=src python -m repro_torch.certify --arch digits --p-star 0.6

  # the pendulum Lyapunov net, absolute-tolerance certificate:
  PYTHONPATH=src python -m repro_torch.certify --arch pendulum --abs-tol 1e-3

  # full custom-format synthesis (per-scope k AND exponent range, v3):
  PYTHONPATH=src python -m repro_torch.certify --arch digits --formats --mixed

  # an LM architecture (its SMOKE config), decode-argmax certificate;
  # "transformer" is an alias of qwen2_7b:
  PYTHONPATH=src python -m repro_torch.certify --arch qwen2_7b
  PYTHONPATH=src python -m repro_torch.certify --arch transformer --mixed \\
      --formats --profiles 4 --max-layers 2

  # store maintenance: evict entries unused for 30 days, keep at most 256:
  PYTHONPATH=src python -m repro_torch.certify gc --max-age-days 30 \\
      --max-entries 256

Runs on the card unless ``--device cpu`` is given; without a card and
without ``--device cpu`` it raises. A second identical invocation is
served from the content-addressed store. The params are made from seeds:
Digits is trained with PyTorch autograd from a ``torch.Generator`` (so its
params, and the digest in its store key, differ from the JAX CLI's), the
LM archs get the port's seeded ``init_params``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.backend import TorchOps
from .pipeline import certify, certify_lm
from .store import DEFAULT_ROOT, CertificateStore

log = obs.get_logger("certify")


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to certify on the CPU")
    return dev


def train_digits(params, imgs, labels, steps: int, lr: float = 0.2):
    """The reference CLI's training in PyTorch autograd: SGD, batches of
    64 drawn by ``RandomState(i)``, mean cross-entropy of the logits."""
    from repro_torch.models import paper_models as PM

    dev = params["w1"].device
    x_all = torch.from_numpy(imgs).to(dev)
    y_all = torch.from_numpy(labels).long().to(dev)
    bk = TorchOps()
    for i in range(steps):
        idx = torch.from_numpy(np.random.RandomState(i).choice(
            imgs.shape[0], 64)).to(dev)
        ps = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        lp = torch.log_softmax(PM.digits_logits(bk, ps, x_all[idx]), -1)
        loss = -lp.gather(-1, y_all[idx][:, None]).mean()
        grads = torch.autograd.grad(loss, list(ps.values()))
        params = {k: (v - lr * g).detach()
                  for (k, v), g in zip(ps.items(), grads)}
    return params


def _eager_format_opts(args):
    """format_opts of the Digits / Pendulum pipelines: only user-set affine
    knobs enter (the opts are part of the store key)."""
    opts = {}
    if args.affine_budget is not None:
        opts["affine_budget"] = args.affine_budget
    if args.affine_rank is not None:
        opts["affine_rank"] = args.affine_rank
    return opts or None


def _digits(args, store, dev):
    from repro_torch.data import synthetic_digits
    from repro_torch.models import paper_models as PM

    imgs, labels = synthetic_digits.make_dataset(args.samples, seed=0)
    params = PM.init_digits(torch.Generator(device=dev).manual_seed(0),
                            h1=args.h1, h2=args.h2, device=dev)
    params = train_digits(params, imgs, labels, args.train_steps)
    with torch.no_grad():
        pred = PM.digits_logits(TorchOps(), params,
                                torch.from_numpy(imgs).to(dev)).argmax(-1)
    acc = float((pred.cpu().numpy() == labels).mean())
    log.info("trained digits model", h1=args.h1, h2=args.h2,
             train_acc=round(acc, 3))
    los, his = [], []
    for c in range(10):
        m = imgs[labels == c].mean(0)
        los.append(np.clip(m - args.pad, 0.0, 1.0))
        his.append(np.clip(m + args.pad, 0.0, 1.0))
    d_in = imgs.shape[-1]
    # matmul FLOPs per scoped block: the weights of the mean-k savings
    flops = {"dense1": 2.0 * d_in * args.h1,
             "dense2": 2.0 * args.h1 * args.h2,
             "dense3": 2.0 * args.h2 * 10,
             "softmax": 4.0 * 10}
    cs = certify(
        PM.digits_forward, params, los, his, p_star=args.p_star,
        model_id=f"digits/h{args.h1}x{args.h2}",
        class_keys=[f"digit{c}(±{args.pad})" for c in range(10)],
        store=store, k_max=args.k_max,
        mixed=args.mixed, layer_flops=flops, formats=args.formats,
        format_opts=_eager_format_opts(args),
    )
    return cs, flops


def _pendulum(args, store, dev):
    from repro_torch.models import paper_models as PM

    params = PM.init_pendulum(torch.Generator(device=dev).manual_seed(2),
                              h=args.h1, device=dev)
    lo, hi = np.full(2, -6.0), np.full(2, 6.0)
    flops = {"dense1": 2.0 * 2 * args.h1,
             "dense2": 2.0 * args.h1 * args.h1,
             "dense3": 2.0 * args.h1 * 1}
    cs = certify(
        PM.pendulum_forward, params, [lo], [hi], abs_tol=args.abs_tol,
        model_id=f"pendulum/h{args.h1}",
        class_keys=["state[-6,6]^2"],
        store=store, k_max=args.k_max,
        mixed=args.mixed, layer_flops=flops, formats=args.formats,
        format_opts=_eager_format_opts(args),
    )
    return cs, flops


def _cost_report(out_path: str, cs, layer_flops, dev, tokens: int = 1):
    """The ``--cost-report`` what-if pass: fit a measured cost model from a
    quick kernel profile on ``dev``, re-score the certificate's serving map
    by predicted latency against the FLOP-weighted-bits objective, write
    both as JSON and print the per-scope comparison."""
    from repro_torch.obs import costmodel as CM
    from repro_torch.obs import profile as P

    with obs.span("cost_report_profile"):
        rows = P.profile_kernels(
            gemm_shapes=((128, 128, 128),), ks=(8,),
            formats=((8, 15, -14),),
            flash_shapes=((2, 256, 2, 2, 64),), reps=3, warmup=1,
            device=str(dev))
    model = CM.fit_cost_model(rows)
    with obs.span("cost_report_score"):
        rep = CM.certificate_cost_report(cs, layer_flops, model,
                                         tokens=tokens)
    payload = {"schema": 1, "cost_model": model.to_dict(), "report": rep}
    d = os.path.dirname(os.path.abspath(out_path))
    os.makedirs(d, exist_ok=True)
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1)
        f.write("\n")
    os.replace(tmp, out_path)
    print()
    print(CM.render_cost_report(rep))
    log.info("cost report written", path=out_path,
             scopes=len(rep["scopes"]),
             rank_agreement=round(rep["rank_agreement"], 3),
             disagreements=len(rep["disagreements"]))
    return rep


def _gc(argv):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.certify gc",
        description="evict old/excess certificate-store entries, or "
                    "inspect the store's cumulative stats")
    ap.add_argument("--store", default=DEFAULT_ROOT)
    ap.add_argument("--max-age-days", type=float, default=None,
                    help="evict entries unused for more than N days")
    ap.add_argument("--max-entries", type=int, default=None,
                    help="keep at most M entries (oldest-unused evicted)")
    ap.add_argument("--stats", action="store_true",
                    help="print cumulative store stats and the on-disk "
                         "entry breakdown; no eviction unless a policy flag "
                         "is also given")
    args = ap.parse_args(argv)
    if (args.max_age_days is None and args.max_entries is None
            and not args.stats):
        ap.error("pass --max-age-days and/or --max-entries (or --stats)")
    store = CertificateStore(args.store)
    n = 0
    if args.max_age_days is not None or args.max_entries is not None:
        n = store.gc(max_age_days=args.max_age_days,
                     max_entries=args.max_entries)
        log.info("gc done", evicted=n, remaining=len(store),
                 root=store.root)
    if args.stats:
        lifetime = store.persist_stats()
        scan = store.entry_summary()
        print(f"store: {store.root}")
        print(f"  entries: {scan['entries']}  "
              f"({scan['bytes']} bytes on disk)")
        for v, cnt in sorted(scan["by_schema"].items()):
            print(f"    schema {v}: {cnt}")
        print("  lifetime stats (all processes):")
        for k in sorted(lifetime):
            print(f"    {k:<16} {lifetime[k]}")
    else:
        store.persist_stats()
    return n


def _log_maps(cs):
    mx = cs.meta.get("mixed")
    if mx:
        if mx.get("applied"):
            log.info("mixed precision applied",
                     uniform_k=mx["uniform_k"],
                     mean_k_flop_weighted=round(
                         mx["mean_k_flop_weighted"], 2),
                     savings_k_flop_weighted=round(
                         mx["savings_k_flop_weighted"], 2),
                     probes=mx["probes"])
        else:
            log.info("mixed precision not applied", reason=mx.get("reason"))
    fm = cs.meta.get("formats")
    if fm:
        if fm.get("applied"):
            from repro_torch.core import formats as F

            log.info("custom formats applied",
                     baseline_bits=fm["baseline_bits"],
                     uniform_k=fm["uniform_k"],
                     mean_bits_flop_weighted=round(
                         fm["mean_bits_flop_weighted"], 2),
                     savings_bits_flop_weighted=round(
                         fm["savings_bits_flop_weighted"], 2),
                     probes=fm["probes"])
            for sc, f in sorted(fm["layer_format"].items()):
                r = fm["scope_ranges"].get(sc, {})
                ma = r.get("max_abs")
                bits = 1 + F.exponent_bits(f["emax"], f["emin"]) + f["k"] - 1
                log.info("format", scope=sc or "<default>", k=f["k"],
                         emin=f["emin"], emax=f["emax"], bits=bits,
                         range_sup=ma if ma is None else round(ma, 4))
            if fm.get("attached") is False:
                log.info("format map not attached",
                         reason=fm.get("attach_reason"))
        else:
            log.info("custom formats not applied", reason=fm.get("reason"))


def _append_run(args, cs, n_probes: int) -> None:
    """The reference's ``runs`` trajectory entry of a fresh certification,
    into the port's own ``BENCH_torch_runs.json``
    (:mod:`repro_torch.obs.bench`)."""
    fm = cs.meta.get("formats") or {}
    mx = cs.meta.get("mixed") or {}
    serving = cs.meta.get("serving") or {}
    obs.append_bench("runs", {
        "kind": "certify", "arch": args.arch,
        "mixed": bool(args.mixed), "formats": bool(args.formats),
        "analysis_seconds": cs.meta["analysis_seconds"],
        "probes": n_probes,
        "ladder_compiles": cs.meta.get("ladder_compiles"),
        "mantissa_mode": fm.get("mantissa_mode"),
        "mean_bits_flop_weighted": fm.get(
            "mean_bits_flop_weighted", mx.get("mean_bits_flop_weighted")),
        "baseline_bits": fm.get("baseline_bits"),
        "profiles": cs.meta.get("profiles") or None,
        "serving_mean_bits": serving.get("mean_bits_flop_weighted"),
        "raised_baseline_bits": serving.get("raised_baseline_mean_bits"),
        "profile_maps_differ": serving.get("profile_maps_differ"),
    })


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "gc":
        return _gc(argv[1:])
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.certify",
        description="batched certificate pipeline: analyse, persist, serve")
    ap.add_argument("--arch", default="digits",
                    help="digits | pendulum | qwen2_7b | transformer")
    ap.add_argument("--p-star", type=float, default=0.6)
    ap.add_argument("--abs-tol", type=float, default=1e-3,
                    help="absolute tolerance (pendulum mode)")
    ap.add_argument("--store", default=DEFAULT_ROOT)
    ap.add_argument("--device", default="cuda",
                    help="where the analysis runs (cuda | cpu)")
    ap.add_argument("--samples", type=int, default=400)
    ap.add_argument("--pad", type=float, default=0.02,
                    help="class envelope half-width around the class mean")
    ap.add_argument("--h1", type=int, default=64)
    ap.add_argument("--h2", type=int, default=32)
    ap.add_argument("--train-steps", type=int, default=200)
    ap.add_argument("--k-max", type=int, default=None,
                    help="search ceiling (default: 53; LM archs: 24, "
                         "or 53 with --mixed/--formats)")
    ap.add_argument("--seq", type=int, default=8, help="LM profile length")
    ap.add_argument("--batch", type=int, default=1,
                    help="LM profile batch (sequences certified jointly)")
    ap.add_argument("--max-layers", type=int, default=None,
                    help="cap the LM arch's layer count")
    ap.add_argument("--profiles", default=None, metavar="S1,S2,...",
                    help="extra sequence lengths whose range passes widen "
                         "the --formats overflow (emax) evidence")
    ap.add_argument("--mixed", action="store_true",
                    help="also certify a per-layer {scope: k} map "
                         "(sensitivity-driven greedy descent)")
    ap.add_argument("--formats", action="store_true",
                    help="also certify per-scope custom formats (k, emin, "
                         "emax): schema-v3 {scope: FpFormat} maps")
    ap.add_argument("--affine-budget", type=int, default=None, metavar="N",
                    help="noise-symbol budget of the affine range pass "
                         "(a non-default budget addresses another entry)")
    ap.add_argument("--affine-rank", default=None,
                    choices=["sensitivity", "magnitude"],
                    help="noise-symbol retention policy of the affine "
                         "condensation (a non-default rank addresses "
                         "another entry)")
    ap.add_argument("--trace", default=None, metavar="OUT.JSONL",
                    help="record a per-stage JSONL trace to this path")
    ap.add_argument("--cost-report", default=None, metavar="OUT.JSON",
                    help="fit a measured cost model (quick kernel profile), "
                         "re-score the certificate's serving map by "
                         "predicted latency against the FLOP-weighted-bits "
                         "objective, and write both as JSON")
    args = ap.parse_args(argv)
    if args.arch == "transformer":
        args.arch = "qwen2_7b"
    if args.arch == "digits" and not 0.5 < args.p_star <= 1.0:
        ap.error("--p-star must be in (0.5, 1] (guaranteed top-1 probability)")
    if args.arch == "pendulum" and args.abs_tol <= 0:
        ap.error("--abs-tol must be positive")
    dev = _device(args.device)

    if args.trace:
        obs.configure(path=args.trace, program="repro_torch.certify",
                      argv=argv)
    store = CertificateStore(args.store)
    t0 = time.perf_counter()
    with obs.span("certify_run", arch=args.arch, mixed=args.mixed,
                  formats=args.formats):
        if args.arch == "digits":
            args.k_max = args.k_max or 53
            cs, layer_flops = _digits(args, store, dev)
        elif args.arch == "pendulum":
            args.k_max = args.k_max or 53
            cs, layer_flops = _pendulum(args, store, dev)
        else:
            from repro_torch import configs
            from .lm import lm_layer_flops

            arch_cfg = configs.get(args.arch).SMOKE
            if args.max_layers is not None:
                arch_cfg = dataclasses.replace(
                    arch_cfg, n_layers=min(args.max_layers,
                                           arch_cfg.n_layers))
            layer_flops = lm_layer_flops(arch_cfg)
            profiles = tuple(int(s) for s in args.profiles.split(",")) \
                if args.profiles else ()
            format_opts = _eager_format_opts(args)
            cs = certify_lm(
                args.arch, arch_cfg, seq=args.seq, batch=args.batch,
                store=store,
                k_max=args.k_max or (53 if (args.mixed or args.formats)
                                     else 24),
                mixed=args.mixed, formats=args.formats, profiles=profiles,
                format_opts=format_opts, device=str(dev))
    dt = time.perf_counter() - t0

    print()
    print(cs.summary())
    print()
    if cs.meta.get("from_store"):
        log.info("served from store",
                 lookup_ms=round(cs.meta["lookup_seconds"] * 1e3, 1),
                 store=store.root)
    else:
        probes = cs.meta.get("probes", [])
        n_probes = probes if isinstance(probes, int) else len(probes)
        log.info("analysed (all classes batched per probe)",
                 seconds=round(cs.meta["analysis_seconds"], 2),
                 probes=n_probes)
        log.info("persisted — re-run to load from the store",
                 store=store.root)
        _append_run(args, cs, n_probes)
    _log_maps(cs)
    if args.cost_report:
        _cost_report(args.cost_report, cs, layer_flops, dev)
    log.info("done", total_seconds=round(dt, 2), **store.stats.to_dict())
    store.persist_stats()
    if args.trace:
        obs.shutdown()
        log.info("trace written", path=args.trace)
    return cs


if __name__ == "__main__":
    main()
