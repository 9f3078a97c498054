#!/usr/bin/env python3
"""Plant faults in the decode-attention combine and see which check fails.

    python3 tools/decode_fault_check.py [--work DIR]

Copies this repository's ``src`` into ``DIR`` (default
``build/fault_check``, git-ignored) once as it is and once for each fault
planted in the combine kernel of ``csrc/flash_decode.cuh``: a fold that
skips chunk 40, and a fold that swaps α and β in the group of 32 chunks
from chunk 33. Each copy runs in a process of its own, which builds
kernels 2 (format k12 e[-14, 15]) and 4 from it and runs them at B = 4,
K = 4, G = 7, D = 128 on seeded inputs, at lengths [2112, 2113, 4160,
4161] (Smax 4,224: the combine's group edges) and [32768, 0, 5000, 64]
(Smax 32,768). Per lane it reports whether the output meets
``chip_smoke.flash_tol`` against the plain version and
``chip_smoke.flash_f64_tol`` against ``flash_decode_split_ref`` in f64,
with the error and the limit of the latter.

Prints one JSON object; exits 1 unless the unchanged copy meets both
rules in every lane and every fault fails the f64 rule in some lane.
Needs a CUDA device; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BODY = Path("repro_torch") / "csrc" / "flash_decode.cuh"
# fault: (text in the combine kernel, what replaces it)
FAULTS = {
    "none": None,
    "skip_chunk_40": ("            if (j < cnt) {",
                      "            if (j < cnt && c0 + j != 40) {"),
    "swap_alpha_beta_from_chunk_33": (
        "const float alpha = expf(prev - mx), beta = expf(cur.m - mx);",
        "const float alpha = expf((c0 == 33 ? cur.m : prev) - mx), "
        "beta = expf((c0 == 33 ? prev : cur.m) - mx);"),
}
CASES = [(4224, [2112, 2113, 4160, 4161]), (32768, [32768, 0, 5000, 64])]


def read_rules() -> dict:
    """Both rules, lane by lane, on the repro_torch this process imports."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import flash_decode as fd

    gen = torch.Generator(device="cuda").manual_seed(5)
    B, H, G, D = 4, 4, 7, 128
    out = {"repro_torch": fd.__file__}
    for S, lens in CASES:
        q = torch.randn(B, H, G, D, device="cuda", generator=gen)
        k = torch.randn(B, S, H, D, device="cuda", generator=gen)
        v = torch.randn(B, S, H, D, device="cuda", generator=gen)
        n = torch.tensor(lens, dtype=torch.int32, device="cuda")
        for name, fmt in (("flash_decode_attention", None),
                          ("flash_decode_certified", (12, 15, -14))):
            if fmt is None:
                got = fd.flash_decode_attention(q, k, v, n)
                plain = fd.flash_decode_ref(q, k, v, n)
            else:
                got = fd.flash_decode_certified(q, k, v, n, fmt)
                plain = fd.flash_decode_quantized_ref(q, k, v, n, fmt)
            exact = fd.flash_decode_split_ref(q, k, v, n, fmt,
                                              dtype=torch.float64)
            ulps = fmt or (24, 127, -126)
            lanes = []
            for b in range(B):
                s = slice(b, b + 1)
                old_ok, _ = cs.compare(torch, got[s], plain[s], ulps,
                                       cs.flash_tol(torch, v[s], n[s], fmt))
                tol = cs.flash_f64_tol(torch, v[s], n[s], fmt)
                f64_ok, st = cs.compare(torch, got[s], exact[s], ulps, tol)
                lanes.append({"length": lens[b], "flash_tol_ok": old_ok,
                              "f64_ok": f64_ok,
                              "f64_max_abs_err": st["max_abs_err"],
                              "f64_max_tol": float(tol.max())})
            out[f"{name} Smax={S}"] = lanes
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", default=str(ROOT / "build" / "fault_check"),
                    help="where the copies of src go")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("decode_fault_check: no CUDA device", file=sys.stderr)
        return 3
    if args.child:
        print(json.dumps(read_rules()))
        return 0
    res, ok = {}, True
    for fault, edit in FAULTS.items():
        src = Path(args.work) / fault / "src"
        shutil.rmtree(src.parent, ignore_errors=True)
        shutil.copytree(ROOT / "src", src,
                        ignore=shutil.ignore_patterns("__pycache__"))
        if edit is not None:
            body = (src / BODY).read_text()
            if body.count(edit[0]) != 1:
                raise RuntimeError(f"{fault}: the text to replace is not "
                                   f"in {BODY} exactly once")
            (src / BODY).write_text(body.replace(edit[0], edit[1]))
        env = dict(os.environ, PYTHONPATH=f"{src}{os.pathsep}{ROOT}")
        run = subprocess.run([sys.executable, __file__, "--child"], env=env,
                             capture_output=True, text=True, check=True)
        res[fault] = json.loads(run.stdout)
        lanes = [x for key, rows in res[fault].items()
                 if key != "repro_torch" for x in rows]
        if edit is None:
            ok &= all(x["flash_tol_ok"] and x["f64_ok"] for x in lanes)
        else:
            ok &= not all(x["f64_ok"] for x in lanes)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": cs.nvidia_smi_line(), **res}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
