#!/usr/bin/env python3
"""Time and fingerprint a pair of kernels of one source tree.

    python3 tools/quant_gemm_compare.py --src SRC_DIR --tag NAME \
        [--kernels quant|interval|flash] [--sass]
        [--sass-listing DIR]

``SRC_DIR`` is a ``src`` directory that holds a ``repro_torch`` package (this
repository's, or an older commit's unpacked with ``git archive``). The script
builds that tree's ``quant_matmul_format`` and ``quant_matmul`` kernels (nvcc
``-Xptxas -v``), then runs each at the seven Qwen2-7B projections, M = 4
(decode) and 512 (prefill), on seeded inputs: format k12 e[-14, 15] for
kernel 1, k = 12 for kernel 3. Per row it reports the kernel's time with
weights cold (rotated through copies that exceed the L2, as
``chip_smoke.py`` times them), one ``torch.matmul`` of the same shapes timed
the same way, the bound, and the sha256 of the kernel's output bits, so
that two trees' outputs can be compared bit for bit. ``--kernels interval``
does the same for the interval GEMMs ``caa_matmul`` (x, dbar = U[0, 4),
g = γ(K) at u = 2⁻²³) and ``interval_matmul`` ([x - dbar/100,
x + dbar/100]), with one stacked ``torch.bmm`` as the yardstick, as
``chip_smoke.py`` times rows 5 and 6, and adds the six Digits
analysis-path shapes (M = 10, 64; 784→700→256→10), timed from a profiler
trace as ``chip_smoke.py`` times them. ``--kernels flash`` times the
decode-attention kernels ``flash_decode_certified`` (format k12 e[-14, 15])
and ``flash_decode_attention`` in every case of ``chip_smoke.FLASH_CASES``
(B = 4, K = 4, G = 7, D = 128), each from a profiler trace of as many calls
as ``chip_smoke.flash_iters`` gives, with the cache rotated through
copies that exceed the L2, as ``chip_smoke.py`` times them, with each CUDA
kernel's share of the call (the chunk and the combine kernel) and SDPA as
the yardstick. To compare two trees on one card,
run them in turns on the same machine (old, new, new, old). ``--sass``
adds each kernel function's instruction mix (``cuobjdump -sass`` of the
built library: FFMA, SEL/FSEL, LDS, ... counted over the whole function,
whose unrolled full-tile k-loop dominates the count). ``--sass-listing
DIR`` writes each built library's whole ``cuobjdump -sass`` listing to
``DIR/<kernel>.sass``, the per-file hash of the anonymous namespace taken
out of the mangled names, so that two trees' machine code can be compared
with ``diff -r``.

Prints one JSON object. Needs a CUDA device; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True,
                    help="a src directory holding repro_torch")
    ap.add_argument("--tag", required=True, help="name of this run")
    ap.add_argument("--kernels", choices=("quant", "interval", "flash"),
                    default="quant", help="quant_matmul_format and "
                    "quant_matmul (default), caa_matmul and "
                    "interval_matmul, or flash_decode_certified and "
                    "flash_decode_attention")
    ap.add_argument("--sass", action="store_true",
                    help="add the kernels' SASS instruction mix")
    ap.add_argument("--sass-listing", metavar="DIR",
                    help="write each kernel's SASS listing into DIR")
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
    if args.kernels == "interval":
        rows, layer, built = interval_rows(torch, cs, _build)
    elif args.kernels == "flash":
        rows, built = flash_rows(torch, cs, _build)
        layer = None
    else:
        rows, layer, built = quant_rows(torch, cs, _build, qmm)
    res = {"tag": args.tag, "src": str(src), "kernels": args.kernels,
           "device": torch.cuda.get_device_name(0),
           "nvidia_smi": cs.nvidia_smi_line(),
           "timing": "weights (flash: caches) rotated through copies that "
                     "exceed the 50 MB L2; CUDA events (the Digits rows and "
                     "flash: a profiler trace)",
           "ptxas": {n: cs.ptxas_report(b["log"]) for n, b in built.items()},
           "per_layer": layer, "rows": rows}
    if args.sass:
        res["sass"] = {n: sass_mix(sass_text(_build, n)) for n in built}
    if args.sass_listing:
        out = Path(args.sass_listing)
        out.mkdir(parents=True, exist_ok=True)
        for n in built:
            (out / f"{n}.sass").write_text(sass_text(_build, n))
    print(json.dumps(res), flush=True)
    return 0


SASS_OPS = ("FFMA", "FSEL", "SEL", "LDS", "FSETP", "FADD", "FMNMX", "LOP3",
            "IMAD", "BAR", "LDGSTS")


def sass_text(_build, name):
    """``cuobjdump -sass`` of the built library of ``name``, with the
    anonymous namespace's per-file hash in mangled names replaced by
    ``_GLOBAL__N_``."""
    cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", str(_build.lib_path(name))],
                         check=True, capture_output=True, text=True).stdout
    return re.sub(r"\d+_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}",
                  "_GLOBAL__N_", out)


def sass_mix(text):
    """{kernel function: {opcode: count}} of a :func:`sass_text` listing
    (opcodes of SASS_OPS, modifiers dropped, and the total)."""
    mix, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = mix.setdefault(m.group(1), {op: 0 for op in SASS_OPS})
            cur["total"] = 0
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                     line)
        if cur is not None and m:
            cur["total"] += 1
            if m.group(1) in cur:
                cur[m.group(1)] += 1
    return mix


def sha256(outs) -> str:
    h = hashlib.sha256()
    for o in outs:
        h.update(o.cpu().numpy().tobytes())
    return h.hexdigest()


def per_layer(rows, names):
    layer = {}
    for M in (4, 512):
        sel = [r for r in rows if r["M"] == M]
        layer[M] = {"bound_ms": sum(r["bound_ms"] for r in sel),
                    "library_ms": sum(r["library_ms"] for r in sel),
                    **{name: sum(r[name]["ms"] for r in sel)
                       for name in names}}
    return layer


def quant_rows(torch, cs, _build, qmm):
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
                    "sha256": sha256([out])}
            rows.append(row)
            del x
        del w, copies
    return rows, per_layer(rows, kernels), built


DIGITS_SHAPES = [(M, K, N) for M in (10, 64)
                 for K, N in ((784, 700), (700, 256), (256, 10))]


def interval_rows(torch, cs, _build):
    from repro_torch.core import caa
    from repro_torch.kernels import caa_matmul as cm
    from repro_torch.kernels import interval_matmul as im

    built = _build.build(("caa_matmul", "interval_matmul"),
                         ptxas_verbose=True)
    gen = torch.Generator(device="cuda").manual_seed(21)
    # (row name, M, K, N): the projections by CUDA events, the Digits
    # shapes from a trace
    cases = [(proj, M, K, N) for proj, (K, N) in cs.GEMM_SHAPES.items()
             for M in (4, 512)]
    cases += [("digits", M, K, N) for M, K, N in DIGITS_SHAPES]
    rows = []
    for proj, M, K, N in cases:
        g = caa.CaaConfig(u_max=2.0 ** -23).gamma(K)
        w = torch.randn(K, N, device="cuda", generator=gen) / math.sqrt(K)
        copies = cs.weight_copies(torch, w)
        x = torch.randn(M, K, device="cuda", generator=gen)
        d = torch.rand(M, K, device="cuda", generator=gen) * 4.0
        lo, hi = x - 0.01 * d, x + 0.01 * d
        if proj == "digits":
            timer, iters = cs.trace_ms, 200
        else:
            timer, iters = cs.time_cold_ms, 20 if M == 4 else 3
        row = {"proj": proj, "M": M, "K": K, "N": N}
        # (kernel, the yardstick's two activation operands)
        kernels = {
            "caa_matmul": (lambda wc: cm.caa_matmul(x, d, wc, g=g), x,
                           d + g * x.abs()),
            "interval_matmul": (lambda wc: im.interval_matmul(lo, hi, wc),
                                lo, hi)}
        for name, (fn, a0, a1) in kernels.items():
            r = {"sha256": sha256(fn(w)),
                 "ms": timer(torch, fn, copies, iters)}
            A, B = cs.bmm_operands(torch, name, a0, a1, w)
            bcopies = cs.weight_copies(torch, B)
            del B
            r["library_ms"] = timer(torch, lambda b: torch.bmm(A, b),
                                    bcopies, iters)
            del A, bcopies
            r["bound_ms"], r["bound_by"] = cs.analysis_kernel_bound(
                M, K, N, name)
            row[name] = r
        rows.append(row)
        del x, d, lo, hi, w, copies
    layer = {M: {name: {key: sum(r[name][key] for r in rows if r["M"] == M)
                        for key in ("ms", "library_ms", "bound_ms")}
                 for name in ("caa_matmul", "interval_matmul")}
             for M in (4, 512)}
    return rows, layer, built



def trace_per_kernel(torch, fn, copies, iters):
    """{CUDA kernel: device ms a call} from a profiler trace of ``iters``
    calls of ``fn(c)``, ``c`` rotating through ``copies``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(copies[i % len(copies)])
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            m = re.search(r"(\w+_kernel)", e.name)
            name = m.group(1) if m else e.name
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    return {name: ms / iters for name, ms in out.items()}


def flash_rows(torch, cs, _build):
    from repro_torch.kernels import flash_decode as fd

    built = _build.build(("flash_decode_certified", "flash_decode"),
                         ptxas_verbose=True)
    fmt = cs.FORMATS["k12_e15"]
    kernels = {
        "flash_decode_certified":
            lambda q, k, v, n: fd.flash_decode_certified(q, k, v, n, fmt),
        "flash_decode_attention": fd.flash_decode_attention}
    B, H, G, D = cs.SERVE_BATCH, 4, 7, 128
    gen = torch.Generator(device="cuda").manual_seed(22)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for case, (S, lens) in cs.FLASH_CASES.items():
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = torch.randn(B, H, G, D, device="cuda", generator=gen)
        k = torch.randn(B, S, H, D, device="cuda", generator=gen)
        v = torch.randn(B, S, H, D, device="cuda", generator=gen)
        iters = cs.flash_iters(S)
        copies = cs.cache_copies(torch, k, v)
        row = {"case": case, "Smax": S, "lengths": lens}
        for name, fn in kernels.items():
            row[name] = {"sha256": sha256([fn(q, k, v, lengths)]),
                         "ms": cs.trace_ms(
                             torch, lambda c: fn(q, *c, lengths), copies,
                             iters),
                         "per_kernel_ms": trace_per_kernel(
                             torch, lambda c: fn(q, *c, lengths), copies,
                             iters)}
        if len(set(lens)) == 1:
            n = lens[0]
            tcopies = [tuple(t[:, :n].permute(0, 2, 1, 3).contiguous()
                             for t in c) for c in copies]
            del copies
            qs = q.reshape(B, H * G, 1, D)
            row["library_ms"] = cs.trace_ms(
                torch, lambda c: sdpa(qs, *c, enable_gqa=True), tcopies,
                iters)
            del tcopies
        n_pos = int(cs.attended(torch, lengths, S).sum())
        row["bound_ms"], row["bound_by"] = cs.bound_ms(
            4.0 * (2 * q.numel() + 2 * n_pos * H * D) + 4 * B,
            4.0 * G * D * H * n_pos)
        rows.append(row)
        del q, k, v
    return rows, built


if __name__ == "__main__":
    sys.exit(main())
