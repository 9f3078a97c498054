#!/usr/bin/env python3
"""Time and fingerprint the two certified GEMM kernels of one source tree.

    python3 tools/quant_gemm_compare.py --src SRC_DIR --tag NAME

``SRC_DIR`` is a ``src`` directory that holds a ``repro_torch`` package (this
repository's, or an older commit's unpacked with ``git archive``). The script
builds that tree's ``quant_matmul_format`` and ``quant_matmul`` kernels (nvcc
``-Xptxas -v``), then runs each at the seven Qwen2-7B projections, M = 4
(decode) and 512 (prefill), on seeded inputs: format k12 e[-14, 15] for
kernel 1, k = 12 for kernel 3. Per row it reports the kernel's time with
weights cold (rotated through copies that exceed the L2, as
``chip_smoke.py`` times them), one ``torch.matmul`` of the same shapes timed
the same way, the bound, and the sha256 of the kernel's output bits, so
that two trees' outputs can be compared bit for bit. To compare two trees
on one card, run them in turns on the same machine (old, new, new, old).

Prints one JSON object. Needs a CUDA device; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True,
                    help="a src directory holding repro_torch")
    ap.add_argument("--tag", required=True, help="name of this run")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("quant_gemm_compare: no CUDA device", file=sys.stderr)
        return 3
    import chip_smoke as cs
    import repro_torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import quant_matmul as qmm

    if not Path(repro_torch.__file__).resolve().is_relative_to(src):
        raise RuntimeError(f"repro_torch loaded from {repro_torch.__file__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    built = _build.build(("quant_matmul_format", "quant_matmul"),
                         ptxas_verbose=True)
    fmt = cs.FORMATS["k12_e15"]
    kernels = {
        "quant_matmul_format": lambda a, b: qmm.quant_matmul_format(a, b, fmt),
        "quant_matmul": lambda a, b: qmm.quant_matmul(a, b, k=cs.SERVE_K),
    }
    gen = torch.Generator(device="cuda").manual_seed(20)
    rows = []
    for proj, (K, N) in cs.GEMM_SHAPES.items():
        w = torch.randn(K, N, device="cuda", generator=gen) / math.sqrt(K)
        copies = cs.weight_copies(torch, w)
        for M in (4, 512):
            x = torch.randn(M, K, device="cuda", generator=gen)
            iters = 20 if M == 4 else 5
            row = {"proj": proj, "M": M, "K": K, "N": N}
            row["bound_ms"], row["bound_by"] = cs.bound_ms(
                4.0 * (M * K + K * N + M * N), 2.0 * M * N * K)
            row["library_ms"] = cs.time_cold_ms(
                torch, lambda wc: torch.matmul(x, wc), copies, iters)
            for name, fn in kernels.items():
                out = fn(x, w)
                torch.cuda.synchronize()
                row[name] = {
                    "ms": cs.time_cold_ms(torch, lambda wc: fn(x, wc),
                                          copies, iters),
                    "sha256": hashlib.sha256(
                        out.cpu().numpy().tobytes()).hexdigest()}
            rows.append(row)
            del x
        del w, copies
    layer = {}
    for M in (4, 512):
        sel = [r for r in rows if r["M"] == M]
        layer[M] = {"bound_ms": sum(r["bound_ms"] for r in sel),
                    "library_ms": sum(r["library_ms"] for r in sel),
                    **{name: sum(r[name]["ms"] for r in sel)
                       for name in kernels}}
    res = {"tag": args.tag, "src": str(src), "device":
           torch.cuda.get_device_name(0), "nvidia_smi": cs.nvidia_smi_line(),
           "timing": "CUDA events, weights rotated through copies that "
                     "exceed the 50 MB L2",
           "ptxas": {n: cs.ptxas_report(b["log"]) for n, b in built.items()},
           "per_layer": layer, "rows": rows}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
