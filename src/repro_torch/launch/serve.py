"""Certified serving (PyTorch): prefill + decode at a certified precision.

The counterpart of the JAX package's ``repro.launch.serve`` for its
certified paths. Three backends round every ``bk.matmul``, one per kind of
certificate, in the reference's precedence (:func:`_backend`):

* :class:`FormatQuantJOps` — a schema-v3 per-scope format map (k, emax,
  emin): matmuls through the ``quant_matmul_format`` CUDA kernel and every
  single-token decode attention through ``flash_decode_certified``;
* :class:`MixedQuantJOps` — a v2 per-layer map {scope: k} with a default k;
* :class:`QuantJOps` — a v1 uniform k.

The last two round operands and result to k mantissa bits through the
``quant_matmul`` CUDA kernel and decode through the unrounded attention of
:class:`repro_torch.core.backend.TorchOps`: on the card the fixed-order
``flash_decode_attention`` kernel (the reference composes einsums and a
softmax, which the card's library products run in an order that depends on
the batch), on the CPU the composed path. Prefill attention and the LM head
stay unrounded true-f32 products in every backend.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; without a card and without an explicit ``cpu`` they
raise. There is no silent CPU path.

With ``--certificates STORE_DIR`` the precision comes from the certificate
store (:func:`apply_certificates`): the set certified for this arch and
these exact params, found under the reference's content address. A miss
certifies on first use (:func:`repro_torch.certify.pipeline.
serving_certificate`) and persists the set.

CLI::

    python -m repro_torch.launch.serve --size full --batch 4 \\
        --prefill-len 128 --decode-steps 16 --precision-k 12
    (or --layer-format '{"": {...}}', --certificate-set SET.json, or
    --certificates STORE_DIR [--certify-formats])
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import configs, obs
from repro_torch.certify.pipeline import serving_certificate
from repro_torch.certify.spec import CertificateSet
from repro_torch.core.backend import TorchOps
from repro_torch.core.scopes import resolve_scope_value
from repro_torch.kernels.flash_decode import certified_decode_attention
from repro_torch.kernels.quant_matmul import (quant_matmul_dynamic_k,
                                              quant_matmul_format_dispatch)
from repro_torch.models import transformer as T


def configure_precision() -> None:
    """True f32 for every unrounded product on the card: no TF32 in
    cuBLAS or cuDNN, "highest" float32 matmul precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device: str) -> torch.device:
    """The serving device; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--device cpu) to serve on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    arch: str = "qwen2_7b"
    batch: int = 4
    max_seq: int = 256
    prefill_len: int = 128
    compute_dtype: str = "float32"
    # Uniform certified mantissa precision k (v1); None serves plain.
    precision_k: Optional[int] = None
    # Per-layer map {scope: k} (v2): matmuls inside a mapped scope run at
    # its k, everything else at precision_k (which it therefore needs).
    precision_layer_k: Optional[Dict[str, int]] = None
    # Per-scope FULL-format map {scope: FpFormat descriptor} (schema v3);
    # the "" entry is the default for unmapped scopes. Takes precedence
    # over precision_layer_k and precision_k.
    precision_layer_format: Optional[Dict[str, Dict]] = None
    # A certificate store directory: the precision comes from the set
    # stored for (arch, exact params) (:func:`apply_certificates`).
    certificates: Optional[str] = None
    device: str = "cuda"

    def __post_init__(self):
        if self.compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype {self.compute_dtype!r}: the port serves f32 "
                "only")


class QuantJOps(TorchOps):
    """TorchOps whose matmuls run in the certified k-bit emulation:
    operands and result RNE-rounded to ``k`` mantissa bits (full f32
    exponent range), f32 accumulation — through the ``quant_matmul`` CUDA
    kernel on the card."""

    def __init__(self, k: int, compute_dtype=torch.float32):
        super().__init__(compute_dtype)
        self.k = int(k)

    def matmul(self, a, b):
        return quant_matmul_dynamic_k(a, b, self.k).to(self.compute_dtype)


class MixedQuantJOps(TorchOps):
    """TorchOps whose matmuls run at a per-scope certified precision.

    ``layer_k`` maps scope names (``layer3``, ``layer*/attn``,
    ``layer0/mlp``, ...) to mantissa precisions; matmuls outside every
    mapped scope run at ``default_k`` — the semantics a v2 certificate
    proved. The layer loop is unrolled, so each matmul's scope path resolves
    a Python int k (as the reference's unrolled baseline does), cached per
    path."""

    def __init__(self, layer_k: Dict[str, int], default_k: int,
                 compute_dtype=torch.float32):
        super().__init__(compute_dtype)
        self.layer_k = {str(s): int(v) for s, v in (layer_k or {}).items()}
        self.default_k = int(default_k)
        self._resolved: Dict[tuple, int] = {}

    def k_for(self, path) -> int:
        """The k a scope path resolves to."""
        key = tuple(path)
        got = self._resolved.get(key)
        if got is None:
            got = self._resolved[key] = int(resolve_scope_value(
                list(path), self.layer_k, self.default_k))
        return got

    def matmul(self, a, b):
        out = quant_matmul_dynamic_k(a, b, self.k_for(self.scope_path))
        return out.to(self.compute_dtype)


class _FmtTriple:
    """Opaque (k, emax, emin) holder for scope maps — NOT a sequence, so
    :func:`resolve_scope_value` never indexes it as an ``[L]`` per-layer
    array when a ``layer*`` wildcard key matches."""

    __slots__ = ("triple",)

    def __init__(self, triple):
        self.triple = triple


class FormatQuantJOps(TorchOps):
    """TorchOps whose matmuls (and single-token decode attention) run in
    per-scope certified CUSTOM FORMATS.

    ``layer_format`` maps scope names to FpFormat descriptor dicts; the
    ``""`` entry covers matmuls outside every mapped scope. Each matmul's operands and result are rounded into the format the
    current scope path resolves to (``layer3/attn`` against ``layer*/attn``,
    ``layer0/mlp``, ...), exactly as the reference's unrolled baseline
    resolves it. The subnormal/saturation flags must be uniform over the
    map."""

    def __init__(self, layer_format: Dict[str, Dict],
                 compute_dtype=torch.float32):
        super().__init__(compute_dtype)
        self.layer_format = {str(s): dict(f)
                             for s, f in layer_format.items()}
        default = self.layer_format.get("")
        if default is None:
            raise ValueError("layer_format needs a '' default entry for "
                             "unmapped scopes")
        fmts = list(self.layer_format.values())
        flags = {(f.get("has_subnormals", True), f.get("saturating", True))
                 for f in fmts}
        if len(flags) != 1:
            raise ValueError(f"layer_format mixes subnormal/saturation "
                             f"flags {sorted(flags)} — not representable by "
                             "one serving map")
        self.has_subnormals, self.saturating = next(iter(flags))
        if any(f.get("max_finite_override") is not None for f in fmts):
            raise NotImplementedError(
                "encoding-clipped formats (max_finite_override) are not "
                "servable through the (k, emax, emin) triple path")
        self.default_triple = self._triple(default)
        self._triples = {s: _FmtTriple(self._triple(f))
                         for s, f in self.layer_format.items() if s}
        self._resolved: Dict[tuple, tuple] = {}

    @staticmethod
    def _triple(f: Dict) -> tuple:
        return (int(f["k"]), int(f["emax"]), int(f["emin"]))

    def format_for(self, path) -> tuple:
        """The (k, emax, emin) a scope path resolves to."""
        key = tuple(path)
        got = self._resolved.get(key)
        if got is None:
            got = self._resolved[key] = resolve_scope_value(
                list(path), self._triples,
                _FmtTriple(self.default_triple)).triple
        return got

    def matmul(self, a, b):
        out = quant_matmul_format_dispatch(
            a, b, self.format_for(self.scope_path),
            has_subnormals=self.has_subnormals, saturating=self.saturating)
        return out.to(self.compute_dtype)

    def decode_attention(self, q, k, v, lengths):
        out = certified_decode_attention(
            q, k, v, lengths, self.format_for(self.scope_path),
            has_subnormals=self.has_subnormals, saturating=self.saturating)
        return out.to(self.compute_dtype)


def _backend(sc: ServeConfig, monitor=None):
    """The serving backend, in the reference's precedence: the format map,
    then the per-layer k map (which needs ``precision_k`` as its default),
    then the uniform k, then plain TorchOps. A violation ``monitor`` is not
    ported yet and raises."""
    if monitor is not None:
        raise NotImplementedError(
            "violation monitors are not ported to repro_torch yet")
    if sc.precision_layer_format:
        return FormatQuantJOps(sc.precision_layer_format)
    if sc.precision_layer_k:
        if sc.precision_k is None:
            raise ValueError("precision_layer_k needs precision_k as the "
                             "default for unmapped scopes")
        return MixedQuantJOps(sc.precision_layer_k, sc.precision_k)
    if sc.precision_k is not None:
        return QuantJOps(sc.precision_k)
    return TorchOps(torch.float32)


def apply_certificate_set(sc: ServeConfig,
                          certset: CertificateSet) -> ServeConfig:
    """The ServeConfig that serves ``certset``, resolved as the reference's
    ``apply_certificates`` resolves a stored set: ``precision_k`` from
    ``serving_k``, the per-layer map from ``serving_layer_k`` and the format
    map from ``serving_layer_format`` (each None when the set has none). A
    set with no uniform k but a complete format map (its "" entry) degrades
    to format-only serving; with neither it raises."""
    k = certset.serving_k
    lf = certset.serving_layer_format
    if k is None:
        if lf is not None and lf.get(""):
            obs.event("serve.format_only_degrade", arch=sc.arch,
                      scopes=len(lf))
            return dataclasses.replace(sc, precision_k=None,
                                       precision_layer_k=None,
                                       precision_layer_format=lf)
        raise RuntimeError(
            f"certificate set for {certset.model_id} holds no certifiable "
            "precision — serve at full precision")
    return dataclasses.replace(sc, precision_k=k,
                               precision_layer_k=certset.serving_layer_k,
                               precision_layer_format=lf)


def apply_certificates(sc: ServeConfig, arch_cfg, params, **certify_kw):
    """Resolve ``sc.certificates`` (a store directory) into the precision
    it certifies for this exact (arch, params): the stored set is read with
    :func:`repro_torch.certify.pipeline.serving_certificate` (``certify_kw``
    — ``k_max``, ``mixed``, ``formats``, ... — address the request as the
    reference's ``certify_lm`` does) and resolved by
    :func:`apply_certificate_set`, format-only degrade included. Returns
    (updated ServeConfig, CertificateSet). A miss certifies and persists."""
    cs = serving_certificate(sc.arch, arch_cfg, params, sc.certificates,
                             **certify_kw)
    return apply_certificate_set(sc, cs), cs


def certify_kwargs(ap: argparse.ArgumentParser, args) -> Dict[str, Any]:
    """The store request the CLI flags ``--certify-mixed``,
    ``--certify-formats`` and ``--certify-k-max`` address, as the
    reference's serving CLIs map them (k_max 53 for the stacked
    pipeline); they need ``--certificates``."""
    if ((args.certify_mixed or args.certify_formats
         or args.certify_k_max is not None) and args.certificates is None):
        ap.error("--certify-* require --certificates STORE_DIR")
    if args.certify_mixed or args.certify_formats:
        return {"mixed": args.certify_mixed, "formats": args.certify_formats,
                "k_max": args.certify_k_max or 53}
    if args.certify_k_max is not None:
        return {"k_max": args.certify_k_max}
    return {}


def add_certificate_flags(ap: argparse.ArgumentParser) -> None:
    """``--certificates STORE_DIR`` and the flags that pick its entry."""
    ap.add_argument("--certificates", default=None, metavar="STORE_DIR",
                    help="serve the certificate set stored for this arch "
                         "and these exact params (a miss certifies them "
                         "and stores the set)")
    ap.add_argument("--certify-mixed", action="store_true",
                    help="with --certificates: the per-layer k entry (the "
                         "certify CLI's --mixed)")
    ap.add_argument("--certify-formats", action="store_true",
                    help="with --certificates: the per-scope format entry "
                         "(the certify CLI's --formats)")
    ap.add_argument("--certify-k-max", type=int, default=None,
                    help="with --certificates: the search ceiling the "
                         "entry was certified with (default 24; 53 with "
                         "--certify-mixed/--certify-formats)")


def prefill_step(bk, params, cfg, cache, tokens):
    """Prefill ``tokens`` [B, S] into an empty cache. Returns (last-position
    logits [B, 1, V], cache)."""
    logits, cache = T.forward(bk, params, cfg, tokens, cache=cache,
                              q_offset=0)
    return logits[:, -1:, :], cache


def decode_step(bk, params, cfg, cache, tokens, pos: int):
    """One token per sequence at absolute position ``pos``. Returns
    (next tokens [B], logits [B, V], cache)."""
    logits, cache = T.forward(bk, params, cfg, tokens, cache=cache,
                              q_offset=pos)
    last = logits[:, -1, :]
    return torch.argmax(last, dim=-1), last, cache


def make_responses(toks, certset: Optional[CertificateSet] = None):
    """Per-sequence response dicts; with a certificate set, each carries
    the certified (δ̄, ε̄, k) error bars it was served under."""
    bars = None if certset is None else certset.error_bars()
    responses = []
    for row in toks.tolist():
        r: Dict[str, Any] = {"tokens": row}
        if bars is not None:
            r["certificate"] = dict(bars, params_digest=certset.params_digest)
        responses.append(r)
    return responses


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor          # [B, 1 + decode_steps] generated ids
    prompt: torch.Tensor          # [B, prefill_len]
    prefill_logits: torch.Tensor  # [B, 1, V]
    decode_logits: List[torch.Tensor]
    responses: List[Dict]
    timing: Dict[str, float]
    params: Dict[str, Any]
    cfg: Any
    config: ServeConfig


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen2_7b")
    ap.add_argument("--size", choices=("smoke", "full"), default="smoke",
                    help="the arch's SMOKE or FULL (published) config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prefill-len", type=int, default=32)
    ap.add_argument("--decode-steps", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the weights' generator and the prompts")
    ap.add_argument("--precision-k", type=int, default=None,
                    help="serve every matmul at this certified mantissa "
                         "precision k (uniform, v1 semantics)")
    ap.add_argument("--layer-format", default=None, metavar="JSON",
                    help="a precision_layer_format map {scope: {k, emax, "
                         "emin, ...}} with a '' default entry")
    ap.add_argument("--certificate-set", default=None, metavar="FILE",
                    help="a CertificateSet JSON (schema v1/v2/v3); "
                         "serves its format map, else its per-layer k map, "
                         "else its uniform k")
    add_certificate_flags(ap)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.certificate_set and (args.layer_format
                                 or args.precision_k is not None):
        ap.error("--certificate-set sets the precision itself: give it "
                 "without --layer-format and --precision-k")
    if args.certificates and (args.certificate_set or args.layer_format
                              or args.precision_k is not None):
        ap.error("--certificates sets the precision itself: give it "
                 "without --certificate-set, --layer-format and "
                 "--precision-k")
    certify_kw = certify_kwargs(ap, args)

    dev = resolve_device(args.device)
    configure_precision()
    mod = configs.get(args.arch)
    cfg = mod.FULL if args.size == "full" else mod.SMOKE

    sc = ServeConfig(arch=args.arch, batch=args.batch,
                     max_seq=args.prefill_len + args.decode_steps + 1,
                     prefill_len=args.prefill_len,
                     precision_k=args.precision_k,
                     precision_layer_format=(json.loads(args.layer_format)
                                             if args.layer_format else None),
                     certificates=args.certificates, device=str(dev))
    certset = None
    if args.certificate_set:
        with open(args.certificate_set) as fh:
            certset = CertificateSet.from_json(fh.read())
        sc = apply_certificate_set(sc, certset)

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = T.init_params(cfg, generator=gen, device=dev)
    cache = T.init_cache(cfg, sc.batch, sc.max_seq, device=dev)
    rng = np.random.RandomState(args.seed)
    prompt = torch.from_numpy(
        rng.randint(0, cfg.vocab, (sc.batch, sc.prefill_len))).to(dev)
    _sync(dev)
    t_init = time.perf_counter() - t0
    if sc.certificates is not None:
        sc, certset = apply_certificates(sc, cfg, params, **certify_kw)
    bk = _backend(sc)

    with torch.no_grad():
        t0 = time.perf_counter()
        logits, cache = prefill_step(bk, params, cfg, cache, prompt)
        tok = torch.argmax(logits[:, -1, :], dim=-1)
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        out_toks, decode_logits, step_s = [tok], [], []
        for i in range(args.decode_steps):
            td = time.perf_counter()
            tok, last, cache = decode_step(bk, params, cfg, cache,
                                           tok[:, None],
                                           sc.prefill_len + i)
            _sync(dev)
            step_s.append(time.perf_counter() - td)
            out_toks.append(tok)
            decode_logits.append(last)
    toks = torch.stack(out_toks, dim=1)
    t_decode = sum(step_s)
    timing = {
        "init_s": t_init,
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_ms_per_step": 1e3 * t_decode / max(args.decode_steps, 1),
        "decode_tokens_per_s": (sc.batch * args.decode_steps / t_decode
                                if t_decode > 0 else float("nan")),
        "prefill_tokens_per_s": sc.batch * sc.prefill_len / t_prefill,
    }
    return ServeResult(tokens=toks, prompt=prompt, prefill_logits=logits,
                       decode_logits=decode_logits,
                       responses=make_responses(toks, certset),
                       timing=timing, params=params, cfg=cfg, config=sc)


if __name__ == "__main__":
    res = main()
    print(json.dumps({"tokens": res.tokens.tolist(), **res.timing}))
