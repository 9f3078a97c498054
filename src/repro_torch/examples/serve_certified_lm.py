"""Serve an LM architecture under a layer-stacked mixed-precision
certificate, on the port.

The pipeline end-to-end, on a reduced registered arch:

  1. **Certify** — ``repro_torch.certify.certify_lm(mixed=True)`` runs the
     layer-stacked CAA analysis (the stack as one ``layer*`` scope whose
     per-layer round-scale lanes are read at the layer index): it searches
     the uniform k, ranks layer sensitivities and descends a rigorous
     ``{layer{i}|head: k}`` map, eagerly re-confirmed on the per-layer
     reference before it persists (schema v3, content-addressed store).
  2. **Serve** — ``launch/serve.py`` picks the map up: matmuls inside each
     mapped scope run at that scope's k (the ``quant_matmul`` kernel on
     the card), and every response carries the certified (δ̄, ε̄, k) error
     bars.
  3. **Differential** — the mixed serving path is checked bit for bit
     against the same map applied layer by layer through the k-bit GEMM's
     plain version: ``quant_matmul_ref`` on the CPU, and on the card the
     plain version in the kernel's own order (one exact fmaf chain an
     output, ``row_order.f32_matmul_seq_ref`` between the two roundings),
     since ``torch.matmul`` there sums in another order.

The counterpart of the JAX package's ``examples/serve_certified_lm.py``,
whose differential holds its scanned serving body against an eager
per-layer unroll; the port's layer loop is unrolled in both, so what it
holds is the kernel against the plain version. One card (``--device``)
takes the place of the host mesh.

Run:  python -m repro_torch.examples.serve_certified_lm
      python -m repro_torch.examples.serve_certified_lm --formats \\
          --decode-steps 8

The first run pays the analysis; re-runs load the certificate from the
store (watch the fetch time collapse).
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.benchmarks import add_device_arg
from repro_torch.core.quantize import _quantize_normal
from repro_torch.kernels.quant_matmul import quant_matmul_ref
from repro_torch.kernels.row_order import f32_matmul_seq_ref
from repro_torch.launch.serve import (MixedQuantJOps, ServeConfig, _backend,
                                      apply_certificates, configure_precision,
                                      decode_step, make_responses,
                                      prefill_step, resolve_device)
from repro_torch.models import transformer as T


def plain_k_matmul(x, w, k):
    """The k-bit GEMM's plain version on ``x`` [M, K] @ ``w`` [K, N]:
    ``quant_matmul_ref`` on the CPU; on the card the same roundings around
    the kernel's own order of the sum."""
    if x.device.type == "cpu":
        return quant_matmul_ref(x, w, k)
    q = lambda t: _quantize_normal(t.to(torch.float32), k)
    return q(f32_matmul_seq_ref(q(x), q(w)))


class LayerByLayerMixedQuantJOps(MixedQuantJOps):
    """The per-layer reference: each matmul at its scope's k through
    :func:`plain_k_matmul`."""

    def matmul(self, a, b):
        k = self.k_for(self.scope_path)
        lead, K = a.shape[:-1], a.shape[-1]
        out = plain_k_matmul(a.reshape(-1, K), b, k)
        return out.reshape(*lead, b.shape[-1]).to(self.compute_dtype)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.serve_certified_lm")
    ap.add_argument("--arch", default="qwen2_7b")
    ap.add_argument("--max-layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prefill-len", type=int, default=8)
    ap.add_argument("--decode-steps", type=int, default=4)
    ap.add_argument("--formats", action="store_true",
                    help="also synthesize per-scope custom (k, emin, emax) "
                         "formats")
    ap.add_argument("--certificates", default=None, metavar="STORE_DIR",
                    help="certificate store (default: a temp dir)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    configure_precision()

    smoke = configs.get(args.arch).SMOKE
    cfg = dataclasses.replace(
        smoke, n_layers=min(args.max_layers, smoke.n_layers))
    store_dir = args.certificates or tempfile.mkdtemp(prefix="lmcerts_")
    sc = ServeConfig(arch=args.arch, batch=args.batch,
                     max_seq=args.prefill_len + args.decode_steps + 1,
                     prefill_len=args.prefill_len,
                     certificates=store_dir, device=str(dev))
    params = T.init_params(cfg, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)

    t0 = time.perf_counter()
    sc, certset = apply_certificates(
        sc, cfg, params, mixed=True, formats=args.formats, k_max=53,
        seq=args.prefill_len, batch=1)
    t_cert = time.perf_counter() - t0
    src = ("store hit — no re-analysis" if certset.meta.get("from_store")
           else "cold layer-stacked analysis — persisted for next time")
    print(f"certificate fetch: {t_cert:.2f}s ({src})")
    print(f"  uniform k={sc.precision_k}, mixed map={sc.precision_layer_k}")
    mx = certset.meta.get("mixed")
    if mx and mx.get("applied"):
        print(f"  FLOP-weighted mean k={mx['mean_k_flop_weighted']:.2f} "
              f"→ {mx['mean_bits_flop_weighted']:.2f} bits/value "
              f"(binary32 ships 32)")

    bk = _backend(sc)
    cache = T.init_cache(cfg, sc.batch, sc.max_seq, device=dev)
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(
        rng.randint(0, cfg.vocab, (sc.batch, sc.prefill_len))).to(dev)
    with torch.no_grad():
        logits, cache = prefill_step(bk, params, cfg, cache, tokens)
        tok = torch.argmax(logits[:, -1, :], dim=-1)
        toks = [tok]
        for i in range(args.decode_steps):
            tok, _, cache = decode_step(bk, params, cfg, cache, tok[:, None],
                                        sc.prefill_len + i)
            toks.append(tok)
    out = torch.stack(toks, dim=1)
    responses = make_responses(out, certset)
    print(f"served {sc.batch} seqs × {args.decode_steps} tokens; "
          f"response[0]: {responses[0]['tokens'][:6]}…")
    print(f"  error bars: dbar={responses[0]['certificate']['dbar_u']:.4g}u "
          f"at k={responses[0]['certificate']['k']}")

    # bit-for-bit differential: the mixed serving path vs the same map
    # applied layer by layer through the plain version
    differential = None
    if sc.precision_layer_k:
        lk, dk = sc.precision_layer_k, sc.precision_k
        with torch.no_grad():
            a = T.forward(MixedQuantJOps(lk, dk), params, cfg, tokens)[0]
            b = T.forward(LayerByLayerMixedQuantJOps(lk, dk), params, cfg,
                          tokens)[0]
        differential = torch.equal(a.view(torch.int32), b.view(torch.int32))
        if not differential:
            raise AssertionError("serving vs layer-by-layer mismatch!")
        print("differential: mixed serving == per-layer plain reference, "
              "bit for bit")
    return {"certset": certset, "precision_k": sc.precision_k,
            "layer_k": sc.precision_layer_k,
            "layer_format": sc.precision_layer_format,
            "tokens": out.cpu(), "responses": responses,
            "differential_bitwise": differential, "device": str(dev)}


if __name__ == "__main__":
    main()
