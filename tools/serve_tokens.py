#!/usr/bin/env python3
"""Serve the format-map (or a uniform-k) path of one source tree; print it.

    python3 tools/serve_tokens.py --src SRC_DIR

``SRC_DIR`` is a ``src`` directory that holds a ``repro_torch`` package (this
repository's, or an older commit's unpacked with ``git archive``). The
script runs ``launch/serve.py`` as ``chip_smoke.py``'s ``serve`` phase runs
it (full-width Qwen2-7B from seed 0, the phase's format map, batch 4, 128
prompt tokens, 16 decode steps, on the card) and prints one JSON object:
the sha256 of the logits as ``chip_smoke.py`` takes it, every lane's
tokens, and every lane's top-1 logit gap (largest minus second largest
logit) at each token, so that two trees' tokens can be compared and a token
that differs be weighed by how near its choice was to a tie, with the run's
decode ms a step (host clock; with a tree that records them, every step's
ms too). ``--arch A`` serves another arch at full width and depth under
the format map ``chip_smoke.py`` serves it with (a ``layer*`` key added
for the recurrent and the last three families), ``--decode-steps N`` that
many steps. ``--precision-k K`` serves the uniform-k
path (``serve_k``'s: kernel 3 and the k backends' decode attention) in
place of the format map. ``--batching`` then serves the ``batching``
phase's 8 requests through the continuous-batching engine on the same
weights under the same precision (4 lanes, 256 positions, pages of 16, 24
pages) and adds its decode ms a step and every request's tokens. Run two
trees in turns within one chip call to compare their times. Needs a CUDA
device; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True,
                    help="a src directory holding repro_torch")
    ap.add_argument("--batching", action="store_true",
                    help="also serve the batching phase's requests")
    ap.add_argument("--precision-k", type=int, default=None,
                    help="serve a uniform k in place of the format map")
    ap.add_argument("--arch", default="qwen2_7b")
    ap.add_argument("--decode-steps", type=int, default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("serve_tokens: no CUDA device", file=sys.stderr)
        return 3
    import chip_smoke as cs
    import repro_torch
    from repro_torch.launch import serve

    fmt = (cs.MLA_FORMAT if args.arch in cs.MLA_ENCDEC_ARCHS + cs.SSM_ARCHS
           else cs.SERVE_FORMAT)
    precision = (["--precision-k", str(args.precision_k)]
                 if args.precision_k is not None else
                 ["--layer-format", json.dumps(fmt)])
    steps = (["--decode-steps", str(args.decode_steps)]
             if args.decode_steps is not None else [])
    res = serve.main(cs.serve_argv("--arch", args.arch, *precision, *steps))
    digest, gaps = hashlib.sha256(), []
    for lg in [res.prefill_logits] + res.decode_logits:
        digest.update(lg.detach().float().cpu().numpy().tobytes())
        top2 = torch.topk(lg.reshape(lg.shape[0], -1).double(), 2).values
        gaps.append((top2[:, 0] - top2[:, 1]).tolist())
    out = {
        "src": repro_torch.__file__, "device": torch.cuda.get_device_name(0),
        "nvidia_smi": cs.nvidia_smi_line(), "logits_sha256": digest.hexdigest(),
        "decode_ms_per_step": res.timing["decode_ms_per_step"],
        "prefill_s": res.timing["prefill_s"],
        "decode_step_ms": res.timing.get("decode_step_ms"),
        "tokens": res.tokens.tolist(),
        "top1_gap": [list(lane) for lane in zip(*gaps)]}
    if args.batching:
        from repro_torch.launch import batching

        sc = serve.ServeConfig(arch=args.arch,
                               batch=cs.BATCH_ENGINE["n_lanes"],
                               max_seq=cs.BATCH_ENGINE["max_seq"],
                               **({"precision_k": args.precision_k}
                                  if args.precision_k is not None else
                                  {"precision_layer_format": fmt}))
        reqs, _ = cs.batching_requests(torch, batching, res.cfg.vocab)
        engine = batching.ContinuousBatchingEngine(
            res.cfg, sc, res.params, device="cuda", **cs.BATCH_ENGINE)
        responses = engine.run(reqs)
        out["batching"] = {
            "decode_ms_per_step": 1e3 * engine.decode_s / engine.steps,
            "steps": engine.steps,
            "tokens": {r["id"]: r["tokens"] for r in responses}}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
