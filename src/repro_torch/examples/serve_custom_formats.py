"""End-to-end custom-format serving: certify (k, emin, emax) per scope,
then serve digits through the certified formats — with receipts.

The full schema-v3 vertical in one script, on the port:

  1. train the paper's Digits classifier (tiny, seeded);
  2. certify per-scope FULL formats — mixed mantissa map + IA-range-proven
     exponent ranges with underflow folded into the bounds
     (``python -m repro_torch.certify --formats`` under the hood),
     persisted to a store when one is given;
  3. serve a batch through ``FormatQuantJOps`` (every matmul rounded into
     its scope's certified format: the ``quant_matmul_format`` kernel on
     the card) with (δ̄, ε̄, format) error bars;
  4. on the card, hold one layer's GEMM through the kernel bit for bit
     against its sequential-order emulation (one exact fmaf chain an
     output, as the kernel sums), and against ``quant_matmul_format_ref``
     (``torch.matmul`` in another order) within the GEMM contract: one ulp
     at k plus 2·√K·2⁻²⁴·(|x̂|@|ŵ|). On the CPU serving runs the plain
     version, and there is no kernel to hold.

The counterpart of the JAX package's ``examples/serve_custom_formats.py``
(whose step 4 runs the Pallas kernel in interpret mode).

Run:  python -m repro_torch.examples.serve_custom_formats [--device cpu]
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from repro_torch import certify as C
from repro_torch.benchmarks import add_device_arg, steady
from repro_torch.certify.__main__ import train_digits
from repro_torch.core import formats as F
from repro_torch.core.quantize import quantize_to_format
from repro_torch.data import synthetic_digits
from repro_torch.launch.serve import FormatQuantJOps, resolve_device
from repro_torch.models import paper_models as PM


def kernel_check(x, w, fmt, has_subnormals, saturating):
    """Kernel 1 on ``x @ w`` in ``fmt`` against its sequential-order
    emulation (bit for bit) and against ``quant_matmul_format_ref`` (the
    GEMM contract); raises on a mismatch. Returns the largest difference
    from the plain version as a fraction of the contract's tolerance."""
    from repro_torch.kernels.quant_matmul import (quant_matmul_format,
                                                  quant_matmul_format_ref)
    from repro_torch.kernels.row_order import f32_matmul_seq_ref

    triple = (fmt.k, fmt.emax, fmt.emin)
    flags = dict(has_subnormals=has_subnormals, saturating=saturating)

    def q(v):
        return quantize_to_format(v, *triple, has_subnormals, saturating)

    ker = quant_matmul_format(x, w, triple, **flags)
    emul = q(f32_matmul_seq_ref(q(x), q(w)))
    if not torch.equal(ker.view(torch.int32), emul.view(torch.int32)):
        raise AssertionError("kernel/sequential emulation drift!")
    ref = quant_matmul_format_ref(x, w, triple, **flags)
    mag = q(x).abs().double() @ q(w).abs().double()
    big = torch.maximum(ker.abs(), ref.abs()).double()
    e = torch.clamp(torch.floor(torch.log2(big.clamp_min(1e-300))),
                    min=fmt.emin)
    ulp = torch.exp2(e - (fmt.k - 1))
    diff = (ker.double() - ref.double()).abs()
    tol = ulp + 2 * math.sqrt(x.shape[1]) * 2.0 ** -24 * mag
    if not bool((diff <= tol).all()):
        raise AssertionError("kernel/plain version outside the GEMM rule")
    return float((diff / tol).max())


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.serve_custom_formats")
    ap.add_argument("--samples", type=int, default=300)
    ap.add_argument("--h1", type=int, default=32)
    ap.add_argument("--h2", type=int, default=16)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--store", default=None,
                    help="certificate store dir (default: no persistence)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    imgs, labels = synthetic_digits.make_dataset(args.samples, seed=0)
    params = PM.init_digits(torch.Generator().manual_seed(0), h1=args.h1,
                            h2=args.h2, device=dev)
    params = train_digits(params, imgs, labels, steps=120)
    los, his = [], []
    for c in range(10):
        m = imgs[labels == c].mean(0)
        los.append(np.clip(m - 0.02, 0.0, 1.0))
        his.append(np.clip(m + 0.02, 0.0, 1.0))

    store = None if args.store is None else C.CertificateStore(args.store)
    t0 = time.perf_counter()
    cs = C.certify(PM.digits_forward, params, los, his, p_star=0.6,
                   model_id=f"digits/h{args.h1}x{args.h2}", store=store,
                   k_max=24, mixed=True, formats=True)
    print(f"certified in {time.perf_counter() - t0:.1f}s"
          + (" (store hit)" if cs.meta.get("from_store") else ""))
    print(cs.summary())

    sm = cs.serving_layer_format
    if sm is None:
        raise SystemExit("no jointly-certified format map — widen k_max")
    fm = cs.meta.get("formats", {})
    if fm.get("applied"):
        print(f"\nbits/value: baseline {fm['baseline_bits']} → "
              f"{fm['mean_bits_flop_weighted']:.2f} FLOP-weighted "
              f"(saves {fm['savings_bits_flop_weighted']:.2f})")

    # -- serve through the certified formats -------------------------------
    bk = FormatQuantJOps(sm)
    x = torch.from_numpy(imgs[:args.batch].astype(np.float32)).to(dev)
    with torch.no_grad():
        probs, t_serve = steady(lambda: PM.digits_forward(bk, params, x),
                                dev)
    pred = probs.argmax(-1).cpu().numpy()
    acc = float((pred == labels[:args.batch]).mean())
    print(f"\nserved {args.batch} requests through certified formats in "
          f"{t_serve*1e3:.2f} ms (acc {acc:.3f})")
    bars = cs.error_bars()
    print(f"response error bars: dbar={bars['dbar_u']:.4g}u "
          f"ebar={bars['ebar_u']:.4g}u k={bars['k']}")

    # -- the format GEMM kernel, bitwise -----------------------------------
    fmt = F.from_dict(sm["dense1"])
    rule = None
    if dev.type == "cuda":
        xs = x[: min(8, args.batch)].contiguous()
        rule = kernel_check(xs, params["w1"].contiguous(), fmt,
                            bk.has_subnormals, bk.saturating)
        print(f"quant_matmul_format kernel == sequential emulation "
              f"(bitwise), and within the GEMM rule of the plain version "
              f"(largest |Δ| / tolerance {rule:.3g}), for dense1's "
              f"{fmt.describe()}")
    else:
        print(f"served by the plain version on the CPU (no kernel to hold) "
              f"for dense1's {fmt.describe()}")
    return {"certset": cs, "layer_format": sm, "accuracy": acc,
            "serve_seconds": t_serve, "error_bars": bars,
            "kernel_vs_plain_rule": rule, "device": str(dev)}


if __name__ == "__main__":
    main()
