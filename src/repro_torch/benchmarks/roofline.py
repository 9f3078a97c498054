"""Roofline terms of every (arch × shape) cell on the single-pod mesh, read
beside the dry run's census — the counterpart of the JAX package's
``benchmarks/roofline.py``.

The three terms a device per step come from the reference's closed forms
(``analytic_terms``, formulas and ``DEFAULT_POLICY`` unchanged):

  compute    = (dense + attention FLOPs) / chips / peak
     train:   6·N_act·tokens (+ attention ×3 for the backward)
     prefill: 2·N_act·tokens (+ attention)
     decode:  2·N_act·B      (+ attention over the context)
  memory     = bytes a device / HBM: train streams the params 3× (forward,
               remat recompute, backward) at the model shard, the
               optimizer update on the chip's shard (16 B a param in f32,
               6 with 8-bit moments) and activations; serving reads the
               params once and writes (prefill) or reads (decode) the cache
  collective = link bytes a device / link: train gathers the params for
               the forward and again for the backward (a layer at a time,
               ``train_fsdp_gather``) and reduces the gradients; serving
               moves activations over "model" and gathers data-split
               params

The peaks are one card's, from :mod:`repro_torch.obs.costmodel` (the single
source): :data:`H100_SXM` by default — the f32 rate of the CUDA cores,
on which every product of the port runs, its bf16 and e4m3 instances
too; HBM3 bandwidth; NVLink per direction — and the reference's
``TPU_POD_CHIP`` for the parity tests. A record names its peaks.

The dry run's census (``launch/dryrun.py``) is read as the calibration:
where the reference reads XLA's per-iteration FLOPs of a scanned loop, the
port's census counts the whole step's products a rank (matmuls,
convolutions, attention; no elementwise work), and its bytes accessed are
each op's operands and results summed, an unfused upper bound. The census
runs the step the port runs: its model ranks repeat their data rows'
products (the compute half of the reference's mesh training is still to
port), and remat recomputes each layer's forward.

CLI (the single-pod records; the terms are the single-pod mesh's)::

    python -m repro_torch.benchmarks.roofline [--out results/dryrun_torch]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Any, Dict, List, Optional

from repro_torch import configs
from repro_torch.configs import SHAPES
from repro_torch.launch.dryrun import effective_shape
from repro_torch.models.transformer import analytic_params
from repro_torch.obs.costmodel import H100_SXM, Hardware

CHIPS = 256          # the single-pod mesh
D_AX, M_AX = 16, 16  # its ("data", "model") axes

#: what the H100 peaks price (the records say so)
PEAK_NOTES = {
    "peak_flops": "f32 on the CUDA cores: every product of the port runs "
                  "there, its bf16 and e4m3 instances too",
    "hbm_bytes_per_s": "HBM3",
    "link_bytes_per_s": "NVLink, per direction",
}

DEFAULT_POLICY = {
    # the baseline the port runs; the reference's keys and defaults
    "train_fsdp_gather": True,        # params data-axis split, a layer at a time
    "serve_params_data_sharded": True,  # greedy sharding also splits over data
    "param_bits": 16,                 # bf16 storage
    "cache_bits": 16,                 # bf16 KV cache
    "quant_moments": None,            # None → by size
    "grad_payload_bits": 16,          # int8 compression sets 8
}


def _attn_flops(cfg, B, S_q, S_kv, backward: bool):
    """One layer's QKᵀ and PV FLOPs (2 a MAC), causal ≈ ½ when S_q ==
    S_kv; a sliding window caps the context; RWKV's state updates."""
    if cfg.rwkv:
        C = cfg.d_model // cfg.n_heads
        f = 4.0 * B * S_q * cfg.n_heads * C * C
        return f * (3.0 if backward else 1.0)
    W = min(S_kv, cfg.window or S_kv)
    if cfg.local_global_period:
        W = (min(S_kv, cfg.local_global_period) + S_kv) / 2  # half local
    causal = 0.5 if S_q == S_kv else 1.0
    f = 4.0 * cfg.n_layers * B * S_q * W * causal * cfg.n_heads * cfg.head_dim
    return f * (3.0 if backward else 1.0) / cfg.n_layers


def _cache_bytes(cfg, B, S):
    if cfg.rwkv:
        C = cfg.d_model // cfg.n_heads
        return 2.0 * B * cfg.n_layers * cfg.n_heads * C * C
    if cfg.mla:
        return 2.0 * B * S * cfg.n_layers * (cfg.kv_rank + cfg.d_rope)
    per = 2 * cfg.n_kv_heads * cfg.head_dim
    return 2.0 * B * S * cfg.n_layers * per


def _is_big(cfg) -> bool:
    return analytic_params(cfg) > 2e10


def analytic_terms(cfg, shape, policy: Optional[Dict[str, Any]] = None,
                   hw: Hardware = H100_SXM) -> Dict[str, float]:
    """Per-device roofline terms of ``cfg`` at ``shape`` (module
    docstring), priced at ``hw``'s peaks."""
    pol = {**DEFAULT_POLICY, **(policy or {})}
    B, S = shape.batch, shape.seq
    N_act = analytic_params(cfg, active=True)
    N_tot = analytic_params(cfg, active=False)
    P_bytes = N_tot * pol["param_bits"] / 8.0
    L, d = cfg.n_layers, cfg.d_model
    toks = B * S

    if shape.kind == "train":
        dense = 6.0 * N_act * toks
        attn = L * _attn_flops(cfg, B, S, S, backward=True)
        flops_dev = (dense + attn) / CHIPS
        qm = pol["quant_moments"]
        qm = (_is_big(cfg) if qm is None else qm)
        opt_bytes = N_tot / CHIPS * (6.0 if qm else 16.0)
        w_stream = 3.0 * P_bytes / M_AX
        act = 24.0 * toks / CHIPS * d * L * 2.0 / 16.0
        mem_dev = w_stream + opt_bytes + act
        gb = pol["grad_payload_bits"] / 16.0
        coll_dev = (2.0 * P_bytes / M_AX if pol["train_fsdp_gather"] else 0.0)
        coll_dev += P_bytes / M_AX * gb
        coll_dev += L * 8.0 * (toks / D_AX) * d * 2.0 / M_AX
        model = dense
    elif shape.kind == "prefill":
        dense = 2.0 * N_act * toks
        attn = L * _attn_flops(cfg, B, S, S, backward=False)
        flops_dev = (dense + attn) / CHIPS
        cache_dev = _cache_bytes(cfg, B, S) * pol["cache_bits"] / 16.0 / CHIPS
        act = 8.0 * toks / CHIPS * d * L * 2.0 / 16.0
        mem_dev = P_bytes / M_AX + cache_dev + act
        coll_dev = L * 4.0 * (toks / D_AX) * d * 2.0 / M_AX
        if pol["serve_params_data_sharded"]:
            coll_dev += P_bytes / M_AX
        model = dense
    else:  # decode
        dense = 2.0 * N_act * B
        attn = L * _attn_flops(cfg, B, 1, S, backward=False)
        flops_dev = (dense + attn) / CHIPS
        cache_dev = _cache_bytes(cfg, B, S) * pol["cache_bits"] / 16.0 / CHIPS
        mem_dev = P_bytes / M_AX * 1.0 + cache_dev
        coll_dev = L * 4.0 * max(B / D_AX, 1.0) * d * 2.0 / M_AX
        if pol["serve_params_data_sharded"]:
            coll_dev += P_bytes / M_AX
        model = dense

    flops = flops_dev * CHIPS
    return {
        "flops": flops, "mem_bytes": mem_dev, "coll_bytes": coll_dev,
        "model_flops": model, "params": N_tot, "active_params": N_act,
        "compute_s": flops_dev / hw.peak_flops,
        "memory_s": mem_dev / hw.hbm_bytes_per_s,
        "collective_s": coll_dev / hw.link_bytes_per_s,
    }


def peaks(hw: Hardware = H100_SXM) -> Dict[str, Any]:
    """The peaks a record is priced at, each with what it is."""
    out = {"name": hw.name}
    for key, note in PEAK_NOTES.items():
        out[key] = getattr(hw, key)
        out[key + "_is"] = note if hw is H100_SXM else hw.name
    return out


def load_cells(out_dir: str = "results/dryrun_torch", mesh: str = "single",
               hw: Hardware = H100_SXM) -> List[Dict[str, Any]]:
    """The dry run's records of ``mesh`` under ``out_dir``; each ``ok`` one
    gains a ``roofline`` entry: the analytic terms, the dominant one, the
    usefulness (model FLOPs / analytic FLOPs) and the MFU bound, beside
    the census's products-only FLOPs a rank for the whole step, its unfused
    bytes bound and its collective bytes, with the peaks they are priced
    at."""
    cells = []
    for path in sorted(glob.glob(os.path.join(out_dir, f"*_{mesh}.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("status") != "ok":
            cells.append(rec)
            continue
        cfg = configs.get(rec["arch"]).FULL
        shape = effective_shape(cfg, SHAPES[rec["shape"]])
        a = analytic_terms(cfg, shape, hw=hw)
        terms = {k: a[k] for k in ("compute_s", "memory_s", "collective_s")}
        dom = max(terms, key=terms.get).replace("_s", "")
        chips = 1
        for n in rec.get("mesh_shape", [CHIPS]):
            chips *= n
        cost = rec["cost"]
        rec["roofline"] = {
            **{k: a[k] for k in ("compute_s", "memory_s", "collective_s",
                                 "model_flops", "flops")},
            "dominant": dom,
            "usefulness": a["model_flops"] / max(a["flops"], 1.0),
            "mfu_bound": (a["model_flops"] / CHIPS / hw.peak_flops)
            / max(max(terms.values()), 1e-30),
            "census_flops_per_step": cost["flops"],
            "census_flops_counted": cost.get("flops_counted",
                                             "products only"),
            "census_flops_ratio": cost["flops"] * chips
            / max(a["flops"], 1.0),
            "census_bytes_accessed": cost["bytes_accessed"],
            "census_bytes_are": cost.get("bytes_accessed_is",
                                         "unfused upper bound"),
            "census_coll_bytes_per_step": rec["collectives"]["total_bytes"],
            "census_compute_s": cost["flops"] / hw.peak_flops,
            "census_memory_s": cost["bytes_accessed"] / hw.hbm_bytes_per_s,
            "census_collective_s": rec["collectives"]["total_bytes"]
            / hw.link_bytes_per_s,
            "peaks": peaks(hw),
            "recommendation": _recommend(dom),
        }
        cells.append(rec)
    return cells


def _recommend(dom: str) -> str:
    if dom == "memory":
        return ("memory-bound: raise arithmetic intensity — a bigger batch "
                "a card, narrower caches and params (certified low "
                "precision)")
    if dom == "collective":
        return ("collective-bound: keep params resident over 'model', "
                "overlap the gathers with a layer's compute, int8 gradient "
                "payloads")
    return "compute-bound: the products' rate on the card decides"


def print_table(cells) -> list:
    ok = [c for c in cells if c.get("status") == "ok"]
    print("\n== roofline (single-pod 16×16; analytic terms at "
          f"{ok[0]['roofline']['peaks']['name'] if ok else '-'}) ==")
    print(f"{'arch':<18s}{'shape':<13s}{'compute':>11s}{'memory':>11s}"
          f"{'collect':>11s}{'dom':>12s}{'MFU≤':>7s}{'census/an':>10s}")
    rows = []
    for c in ok:
        r = c["roofline"]
        print(f"{c['arch']:<18s}{c['shape']:<13s}"
              f"{r['compute_s']:>11.3e}{r['memory_s']:>11.3e}"
              f"{r['collective_s']:>11.3e}{r['dominant']:>12s}"
              f"{r['mfu_bound']:>7.3f}{r['census_flops_ratio']:>10.3g}")
        rows.append((f"roofline_{c['arch']}_{c['shape']}",
                     max(r["compute_s"], r["memory_s"],
                         r["collective_s"]) * 1e6,
                     round(r["mfu_bound"], 4)))
    skipped = [c for c in cells if c.get("status") == "skipped"]
    if skipped:
        print(f"({len(skipped)} cells skipped by the reference's skip "
              "rule)")
    return rows


def interesting_cells(cells) -> Dict[str, Any]:
    ok = [c for c in cells if c.get("status") == "ok"]
    if not ok:
        return {}
    worst = min(ok, key=lambda c: c["roofline"]["mfu_bound"])
    coll = max(ok, key=lambda c: (c["roofline"]["collective_s"]
                                  / max(c["roofline"]["compute_s"],
                                        c["roofline"]["memory_s"], 1e-30)))
    serving = [c for c in ok if SHAPES[c["shape"]].kind != "train"]
    out = {"worst_mfu": worst, "most_collective": coll}
    if serving:
        out["paper_rep"] = max(serving,
                               key=lambda c: c["roofline"]["model_flops"])
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.roofline",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="results/dryrun_torch",
                    help="the dry run's records")
    args = ap.parse_args(argv)
    cells = load_cells(args.out)
    rows = print_table(cells)
    for why, c in interesting_cells(cells).items():
        print(f"  {why:16s}: {c['arch']} × {c['shape']} "
              f"(dom={c['roofline']['dominant']}, "
              f"MFU≤{c['roofline']['mfu_bound']:.3f})")
    return rows


if __name__ == "__main__":
    main()
