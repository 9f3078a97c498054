"""End-to-end serving driver: batched requests against an LM with the
paper's certified low-precision arithmetic, on the port.

Serves a reduced qwen2-family model (the arch's SMOKE config): prefills a
batch of prompts, decodes tokens with a KV cache, and (with
--precision-k) runs every GEMM in the certified k-bit emulation — the
``quant_matmul`` kernel on the card — with decode attention through
``flash_decode_attention``: the pipeline a low-precision inference chip
would execute, with error bars supplied by the CAA analysis.

With --certificates the precision is not hand-set: the certificate store
supplies (or creates, on first use) the persisted certificate for this
exact (arch, params), precision_k comes from it, and every response
carries the certified (δ̄, ε̄, k) error bars. Run it twice to see the
certified-vs-uncached difference: the first run pays the analysis, the
second is served from the store.

The counterpart of the JAX package's ``examples/serve_certified.py``; one
card (``--device``) takes the place of its host mesh, and the params are
the port's seeded ``init_params``.

Run:  python -m repro_torch.examples.serve_certified --precision-k 12
      python -m repro_torch.examples.serve_certified --certificates certs/
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.benchmarks import add_device_arg, sync
from repro_torch.launch.serve import (ServeConfig, _backend,
                                      apply_certificates, configure_precision,
                                      decode_step, make_responses,
                                      prefill_step, resolve_device)
from repro_torch.models import transformer as T


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.serve_certified")
    ap.add_argument("--arch", default="qwen2_7b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prefill-len", type=int, default=64)
    ap.add_argument("--decode-steps", type=int, default=32)
    ap.add_argument("--precision-k", type=int, default=None,
                    help="run GEMMs in certified k-bit emulation")
    ap.add_argument("--certificates", default=None, metavar="STORE_DIR",
                    help="pick precision_k from the certificate store "
                         "(certifying on first use) and attach error bars")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    configure_precision()

    cfg = configs.get(args.arch).SMOKE
    sc = ServeConfig(arch=args.arch, batch=args.batch,
                     max_seq=args.prefill_len + args.decode_steps + 1,
                     prefill_len=args.prefill_len,
                     precision_k=args.precision_k,
                     certificates=args.certificates, device=str(dev))
    rng = np.random.RandomState(0)
    params = T.init_params(cfg, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)

    certset = None
    if sc.certificates is not None:
        t0 = time.perf_counter()
        sc, certset = apply_certificates(sc, cfg, params)
        t_cert = time.perf_counter() - t0
        src = ("store hit — no re-analysis"
               if certset.meta.get("from_store")
               else f"cold analysis ({certset.meta['analysis_seconds']:.2f}s)"
               " — persisted for next time")
        print(f"certificate fetch: {t_cert:.2f}s ({src})")
        print(f"  k={sc.precision_k}, error bars {certset.error_bars()}")

    bk = _backend(sc)
    cache = T.init_cache(cfg, sc.batch, sc.max_seq, device=dev)
    prompt = torch.from_numpy(
        rng.randint(0, cfg.vocab, (sc.batch, sc.prefill_len))).to(dev)
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, cache = prefill_step(bk, params, cfg, cache, prompt)
        tok = torch.argmax(logits[:, -1, :], dim=-1)
        sync(dev)
        t_prefill = time.perf_counter() - t0

        toks = [tok]
        t0 = time.perf_counter()
        for i in range(args.decode_steps):
            tok, _, cache = decode_step(bk, params, cfg, cache, tok[:, None],
                                        sc.prefill_len + i)
            toks.append(tok)
        sync(dev)
        t_decode = time.perf_counter() - t0

    out = torch.stack(toks, dim=1)
    responses = make_responses(out, certset)
    if sc.precision_k:
        mode = (f"certified k={sc.precision_k}"
                + (" (from certificate store)" if certset is not None else ""))
    else:
        mode = "full precision"
    print(f"served {args.batch} requests ({mode})")
    print(f"  prefill {sc.prefill_len} toks: {t_prefill:.2f}s  |  "
          f"decode {args.decode_steps} toks: {t_decode:.2f}s "
          f"({args.batch*args.decode_steps/t_decode:.1f} tok/s)")
    print(f"  sample continuation: {out[0][:12].tolist()}")
    if certset is not None:
        print(f"  response[0] error bars: {responses[0]['certificate']}")
    return {"tokens": out.cpu(), "responses": responses, "mode": mode,
            "precision_k": sc.precision_k, "prefill_s": t_prefill,
            "decode_s": t_decode, "device": str(dev)}


if __name__ == "__main__":
    main()
