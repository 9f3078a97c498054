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
the batch), on the CPU the composed path. A model with a softcap or a
sliding window (Gemma-2, Mixtral) decodes through that unrounded kernel on
every backend, the format one included: the reference composes its decode
attention, unrounded, everywhere. Prefill attention and the LM head stay
unrounded true-f32 products in every backend.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; without a card and without an explicit ``cpu`` they
raise. There is no silent CPU path.

With ``--certificates STORE_DIR`` the precision comes from the certificate
store (:func:`apply_certificates`): the set certified for this arch and
these exact params, found under the reference's content address. A miss
certifies on first use (:func:`repro_torch.certify.pipeline.
serving_certificate`) and persists the set.

With ``--monitor`` a :class:`repro_torch.obs.ViolationMonitor` built from
the set observes every matmul product of the certified backends (one row
of a device log each, read back once a step) and one sampled
full-precision prefill; ``--metrics`` / ``--prom`` write the registry
(latency histograms, tokens/s, the monitor's counters and margins) and
``--trace`` a JSONL trace for ``python -m repro_torch.obs report``.

Every arch of :mod:`repro_torch.configs` serves through the same path
(``--arch qwen2_7b|command_r_35b|gemma2_27b|mixtral_8x22b|
llama4_maverick|rwkv6_1p6b|hymba_1p5b|minicpm3_4b|whisper_medium|
paligemma_3b``); ``--max-layers`` cuts the depth of a full-width config to
fit the card. A modality stub's inputs are drawn from ``--seed`` after the
prompt, as the reference's CLI draws them: PaliGemma's patches are
prepended at prefill (its decode positions follow them), and Whisper's
frames are encoded once at prefill, the encoder states reused by every
decode step.

Dtypes (``ServeConfig.compute_dtype`` / ``cache_dtype`` / ``param_dtype``,
the reference's fields; CLI ``--compute-dtype float32|bfloat16``,
``--cache-dtype float32|bfloat16|fp8``, ``--param-dtype same|fp8``): every
backend runs in the compute dtype; params are stored in it ("same") or in
e4m3 ("fp8"), the dry run's reading; the cache is allocated in the cache
dtype, written by rounding into it and read by upcasting to the compute
dtype. The certified backends keep the reference's order: operands to f32,
rounded into the format or k, f32 sums, the result rounded, then cast to
the compute dtype (two roundings in bf16 for k > 8). Under bf16 a
violation monitor observes each product in bf16, after that cast.

CLI::

    python -m repro_torch.launch.serve --size full --batch 4 \\
        --prefill-len 128 --decode-steps 16 --precision-k 12
    (or --layer-format '{"": {...}}', --certificate-set SET.json, or
    --certificates STORE_DIR [--certify-formats]; plus --monitor,
    --metrics OUT.jsonl, --prom OUT.prom, --trace OUT.jsonl; plus
    --compute-dtype bfloat16 --cache-dtype fp8 --param-dtype fp8)
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
from repro_torch.core import dtypes
from repro_torch.core.backend import MeshOps, MeshTorchOps, TorchOps
from repro_torch.core.scopes import resolve_scope_value
from repro_torch.kernels.flash_decode import certified_decode_attention
from repro_torch.kernels.quant_matmul import (quant_matmul_dynamic_k,
                                              quant_matmul_format_dispatch)
from repro_torch.launch import mesh as meshlib
from repro_torch.models import transformer as T
from repro_torch.obs.monitors import ViolationMonitor, stacked_label
from repro_torch.parallel import sharding

log = obs.get_logger("serve")


def _emit_health(bk, out, k, emax=127, emin=-126):
    """Log the numeric health of a matmul product ``out`` against (k, emax,
    emin) to the backend's attached :class:`ViolationMonitor`, if any: one
    row of the monitor's device log (the ``numeric_health`` kernel on the
    card), no host sync; the serving loop folds the step's rows with
    ``monitor.flush()``. The product is only read, on the same stream, so
    the served values stay what they are without a monitor; with no monitor
    (the default) nothing runs at all.

    The label is the scope path with its ``layer<i>`` segment replaced by
    ``layer*``: the reference serves every layer through one scanned body
    under the stacked scope and observes there, so labels and envelope
    look-ups follow it. The format or k the product was rounded to still
    comes from the concrete path."""
    if bk.monitor is not None:
        bk.monitor.record(stacked_label(bk.scope_path), out, k, emax, emin)


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
    # the dtypes of activations and products, of the KV cache (or recurrent
    # state) and of stored params ("same": the compute dtype; "fp8": e4m3),
    # the reference's fields and defaults; names outside DTYPES raise
    compute_dtype: str = "float32"
    cache_dtype: str = "float32"
    param_dtype: str = "same"
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
    # Keep params resident on the "model" axis, replicated over "data" (no
    # per-step gathers over the data axis): ``shard_params(model_only=)``.
    # None → auto by param count (resident up to 70e9, the reference's
    # policy); False reproduces the greedy-FSDP baseline.
    params_resident: Optional[bool] = None

    def __post_init__(self):
        # stricter than the reference, which reads an unknown name as f32
        dtypes.compute_dtype(self.compute_dtype)
        dtypes.cache_dtype(self.cache_dtype)
        dtypes.param_dtype(self.param_dtype, self.compute_dtype)

    @property
    def dtypes(self):
        """(compute, cache, param) torch dtypes."""
        return (dtypes.compute_dtype(self.compute_dtype),
                dtypes.cache_dtype(self.cache_dtype),
                dtypes.param_dtype(self.param_dtype, self.compute_dtype))


class QuantJOps(TorchOps):
    """TorchOps whose matmuls run in the certified k-bit emulation:
    operands and result RNE-rounded to ``k`` mantissa bits (full f32
    exponent range), f32 accumulation — through the ``quant_matmul`` CUDA
    kernel on the card.

    ``monitor`` (a :class:`ViolationMonitor`, default None) observes every
    matmul product before its final rounding, as the reference does: the
    f32 accumulator, which kernel 3's raw instance writes and the device
    rounding then rounds in place (no second GEMM; the served bits are
    those of the unmonitored path). With no monitor the kernel runs as
    ever."""

    monitor = None

    def __init__(self, k: int, compute_dtype=torch.float32):
        super().__init__(compute_dtype)
        self.k = int(k)

    def matmul(self, a, b):
        if self.monitor is None:
            out = quant_matmul_dynamic_k(a, b, self.k)
        else:
            out = quant_matmul_dynamic_k(
                a, b, self.k,
                observe=lambda acc: _emit_health(self, acc, self.k))
        return out.to(self.compute_dtype)


class MixedQuantJOps(TorchOps):
    """TorchOps whose matmuls run at a per-scope certified precision.

    ``layer_k`` maps scope names (``layer3``, ``layer*/attn``,
    ``layer0/mlp``, ...) to mantissa precisions; matmuls outside every
    mapped scope run at ``default_k`` — the semantics a v2 certificate
    proved. The layer loop is unrolled, so each matmul's scope path resolves
    a Python int k (as the reference's unrolled baseline does), cached per
    path. ``monitor`` observes every (rounded) matmul product, as in the
    reference."""

    monitor = None

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
        k = self.k_for(self.scope_path)
        out = quant_matmul_dynamic_k(a, b, k)
        _emit_health(self, out, k)
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
    map. ``monitor`` observes every (rounded) matmul product against its
    scope's format, as in the reference; decode attention is not
    observed."""

    monitor = None

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
        fmt = self.format_for(self.scope_path)
        out = quant_matmul_format_dispatch(
            a, b, fmt, has_subnormals=self.has_subnormals,
            saturating=self.saturating)
        _emit_health(self, out, *fmt)
        return out.to(self.compute_dtype)

    def decode_attention(self, q, k, v, lengths):
        out = certified_decode_attention(
            q, k, v, lengths, self.format_for(self.scope_path),
            has_subnormals=self.has_subnormals, saturating=self.saturating)
        return out.to(self.compute_dtype)


class MeshQuantJOps(MeshOps, QuantJOps):
    """QuantJOps on a device mesh (:class:`MeshOps`)."""


class MeshMixedQuantJOps(MeshOps, MixedQuantJOps):
    """MixedQuantJOps on a device mesh (:class:`MeshOps`)."""


class MeshFormatQuantJOps(MeshOps, FormatQuantJOps):
    """FormatQuantJOps on a device mesh (:class:`MeshOps`)."""


_ON_MESH = {TorchOps: MeshTorchOps, QuantJOps: MeshQuantJOps,
            MixedQuantJOps: MeshMixedQuantJOps,
            FormatQuantJOps: MeshFormatQuantJOps}


def _backend(sc: ServeConfig, monitor=None, mesh=None):
    """The serving backend, in the reference's precedence: the format map,
    then the per-layer k map (which needs ``precision_k`` as its default),
    then the uniform k, then plain TorchOps; its mesh variant on ``mesh``
    (a DeviceMesh) when given (:class:`repro_torch.core.backend.MeshOps`).
    A violation ``monitor`` is attached to the certified backends; the
    plain one refuses it. Every backend, the plain one included, runs in
    ``sc.compute_dtype`` (the reference's ``dt``)."""
    dt = dtypes.compute_dtype(sc.compute_dtype)
    if sc.precision_layer_format:
        cls, args = FormatQuantJOps, (sc.precision_layer_format, dt)
    elif sc.precision_layer_k:
        if sc.precision_k is None:
            raise ValueError("precision_layer_k needs precision_k as the "
                             "default for unmapped scopes")
        cls, args = MixedQuantJOps, (sc.precision_layer_k, sc.precision_k,
                                     dt)
    elif sc.precision_k is not None:
        cls, args = QuantJOps, (sc.precision_k, dt)
    else:
        if monitor is not None:
            raise ValueError("violation monitoring needs a certified "
                             "quantised backend (precision_k / layer map / "
                             "format map)")
        cls, args = TorchOps, (dt,)
    bk = cls(*args) if mesh is None else _ON_MESH[cls](*args, mesh=mesh)
    if cls is not TorchOps:
        bk.monitor = monitor
    return bk


def resident_params(sc: ServeConfig, cfg) -> bool:
    """``sc.params_resident``, or by param count where it is None: resident
    up to 70e9 params (the reference's auto policy)."""
    if sc.params_resident is not None:
        return bool(sc.params_resident)
    return T.analytic_params(cfg) <= 70e9


def serving_cache_specs(cache, mesh, cfg) -> Dict[str, tuple]:
    """The cache's placement on a serving mesh, from ``shard_cache``'s: a
    rank's buffers hold its rows of the batch, so every per-lane buffer
    ([L, B, ...]: keys and values, a recurrent state and its token-shift
    rows) takes the batch's split (``batch_spec``: over "pod" and
    "data", as the rank's rows), and a GQA cache its KV-head split (over
    "model"). A sequence split, and a split of a recurrent state's heads,
    is not taken: the attention and the scan would then reduce across
    ranks; those dims stay whole. The reference's ``shard_cache`` also
    leaves RWKV's token-shift rows whole and splits the batch over "data"
    only."""
    specs = sharding.shard_cache(cache, mesh, cfg)
    out = {}
    for key, t in cache.items():
        spec = [None] * t.dim()
        if t.dim() >= 3:
            spec[1] = sharding.batch_spec(mesh, t.shape[1], 1)[0]
        if key in ("k", "v") and t.dim() == 5:
            spec[3] = specs[key][3]
        out[key] = tuple(spec)
    return out


def gather_rows(bk, t, entry):
    """Gather a batch-split tensor's rows over the axes of the batch spec
    entry ``entry`` (None: whole already), in the spec's order."""
    axes = () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))
    for ax in reversed(axes):
        t = bk.gather(t, 0, ax)
    return t


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


def prefix_len(cfg) -> int:
    """Positions a vision prefix takes before the prompt (its patches sit
    in the cache after the prefill); 0 for other archs."""
    return cfg.frontend_seq if cfg.frontend == "vision" else 0


def encode_step(bk, params, cfg, frontend):
    """An encoder-decoder model's encoder states [B, Se, d] of the audio
    frames ``frontend``, computed once for a prefill and every decode step
    after it (as the reference's ``_fwd_kwargs`` intends); None for other
    archs."""
    if not cfg.enc_dec:
        return None
    return bk.value_of(T.encode(bk, params, cfg, frontend))


def prefill_step(bk, params, cfg, cache, tokens, frontend=None,
                 enc_out=None):
    """Prefill ``tokens`` [B, S] into an empty cache — after a vision
    prefix ``frontend`` (its patches, projected and prepended), or
    attending to the encoder states ``enc_out`` (:func:`encode_step`).
    Returns (last-position logits [B, 1, V], cache)."""
    kw = {"enc_out": enc_out} if cfg.enc_dec else {}
    if cfg.frontend == "vision" and frontend is not None:
        kw["frontend_embeds"] = frontend
    logits, cache = T.forward(bk, params, cfg, tokens, cache=cache,
                              q_offset=0, **kw)
    return logits[:, -1:, :], cache


def decode_step(bk, params, cfg, cache, tokens, pos: int, enc_out=None):
    """One token per sequence at absolute position ``pos`` (a vision
    prefix's positions included); an encoder-decoder model attends to the
    prefill's ``enc_out``. Returns (next tokens [B], logits [B, V],
    cache)."""
    kw = {"enc_out": enc_out} if cfg.enc_dec else {}
    logits, cache = T.forward(bk, params, cfg, tokens, cache=cache,
                              q_offset=pos, **kw)
    last = logits[:, -1, :]
    return torch.argmax(last, dim=-1), last, cache


def build_serve_steps(arch_cfg, sc: ServeConfig, mesh, monitor=None):
    """The prefill and decode steps on ``mesh`` (a DeviceMesh), the
    counterpart of the reference's ``build_serve_steps``: returns
    (prefill, decode, placements).

    * ``prefill(params, cache, batch)`` → (logits [B, 1, V], cache), and
      an encoder-decoder model's encoder states [B, Se, d] after them;
    * ``decode(params, cache, batch)`` → (next tokens [B], logits [B, V],
      cache);

    over :func:`prefill_step` / :func:`decode_step` on the backend of
    ``sc`` (:func:`_backend`, its mesh variant). ``params`` are placed
    by ``placements["params"]`` (``shard_params(model_only=
    resident_params(sc, cfg))``) and ``cache`` is this rank's block of
    the cache placed by ``placements["cache"]``
    (:func:`serving_cache_specs`, which keeps the sequence dim and a
    recurrent state's heads whole where the reference's ``shard_cache``
    splits them). ``batch`` holds the whole batch, the same on every
    rank: ``tokens`` [B, S], at decode ``pos`` (an int), a modality's
    ``frontend`` at prefill and an encoder-decoder's ``enc_out`` at
    decode; each rank runs its rows (``batch_spec``) and the results are
    gathered whole. ``placements["backend"]`` is the backend the steps
    run on."""
    bk = _backend(sc, monitor=monitor, mesh=mesh)
    resident = resident_params(sc, arch_cfg)
    specs = {"params": sharding.shard_params(
                 T.param_shapes(arch_cfg), mesh, model_only=resident),
             "cache": serving_cache_specs(
                 {k: torch.empty(shape, device="meta") for k, shape in
                  T.cache_shapes(arch_cfg, sc.batch, sc.max_seq).items()},
                 mesh, arch_cfg),
             "backend": bk}

    rows = sharding.batch_spec(mesh, sc.batch, 1)[0]    # the batch's split
    mine = lambda t: (None if t is None else
                      sharding.local_block(t, (rows,), mesh))

    def prefill(params, cache, batch):
        frontend = mine(batch.get("frontend"))
        enc_out = encode_step(bk, params, arch_cfg, frontend)
        logits, cache = prefill_step(bk, params, arch_cfg, cache,
                                     mine(batch["tokens"]), frontend,
                                     enc_out)
        logits = gather_rows(bk, logits, rows)
        if arch_cfg.enc_dec:
            return logits, cache, gather_rows(bk, enc_out, rows)
        return logits, cache

    def decode(params, cache, batch):
        _, last, cache = decode_step(bk, params, arch_cfg, cache,
                                     mine(batch["tokens"]), batch["pos"],
                                     mine(batch.get("enc_out")))
        last = gather_rows(bk, last, rows)
        return torch.argmax(last, dim=-1), last, cache

    return prefill, decode, specs


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
    registry: Optional[obs.MetricsRegistry] = None
    monitor: Optional[ViolationMonitor] = None
    frontend: Optional[torch.Tensor] = None   # the stub's frames / patches
    backend: Any = None           # the backend the run served through
    placed: Optional[Dict[str, Any]] = None   # params as placed on its mesh


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sample_error(monitor, certset, params, cfg, prompt, logits, max_seq):
    """The reference's one sampled empirical-error check: a full-precision
    ``TorchOps`` prefill of the same prompts, max |Δlogits| of the last
    position in units of the certified u, folded by
    :meth:`ViolationMonitor.observe_error` (nothing when the set has no
    u)."""
    u = certset.error_bars().get("u")
    if not u:
        return
    cache = T.init_cache(cfg, prompt.shape[0], max_seq, device=prompt.device)
    ref, _ = T.forward(TorchOps(torch.float32), params, cfg, prompt,
                       cache=cache, q_offset=0)
    err = (ref[:, -1:, :].double() - logits.double()).abs().max()
    monitor.observe_error(float(err) / u)


def _log_served(registry, monitor, certset, responses, args, sc, toks,
                wall, t_prefill, t_decode):
    """The reference's closing log lines and latency-percentile gauges."""
    log.info("served", seqs=sc.batch, decode_steps=args.decode_steps,
             total_s=round(wall, 2), prefill_s=round(t_prefill, 3),
             decode_s_per_tok=round(t_decode / max(args.decode_steps, 1), 4),
             sample=toks[0][:10].tolist())
    dh = registry.histograms.get("serve.decode_latency_s")
    if dh is not None and dh.count:
        pct = dh.percentiles()
        log.info("decode latency percentiles",
                 p50_ms=round(pct["p50"] * 1e3, 3),
                 p95_ms=round(pct["p95"] * 1e3, 3),
                 p99_ms=round(pct["p99"] * 1e3, 3), steps=dh.count)
        for q, v in pct.items():
            registry.gauge(f"serve.decode_latency_{q}_s", v)
    if certset is not None:
        log.info("response metadata",
                 certificate=responses[0]["certificate"])
    if monitor is not None:
        monitor.export(registry)
        ms = monitor.summary()
        log.info("monitor", violations=ms["violations"],
                 observations=ms["counters"]["obs.scope_observations"],
                 worst_err_u=ms["worst_err_u"], dbar_u=ms["dbar_u"],
                 scope_margin_log2={k: round(v, 2) for k, v in
                                    ms["scope_margin_log2"].items()})


def main(argv=None, mesh=None) -> ServeResult:
    """The serving CLI. ``mesh``: the ("data", "model") DeviceMesh to serve
    on; None builds the host mesh (1 × 1, this process's device). The
    steps and placements are :func:`build_serve_steps`': params placed by
    ``shard_params(model_only=params_resident)`` and the cache by
    ``shard_cache`` (:func:`serving_cache_specs`); each rank runs its
    block of the batch, and the results are gathered whole."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen2_7b")
    ap.add_argument("--size", choices=("smoke", "full"), default="smoke",
                    help="the arch's SMOKE or FULL (published) config")
    ap.add_argument("--max-layers", type=int, default=None,
                    help="cap the config's layer count (depth cut for "
                         "memory; widths stay the config's)")
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
    ap.add_argument("--metrics", default=None, metavar="OUT.JSONL",
                    help="append a serving-metrics snapshot (latency "
                         "histograms, tokens/s, occupancy, violation "
                         "counters) as one JSONL object")
    ap.add_argument("--prom", default=None, metavar="OUT.PROM",
                    help="also write the metrics as a Prometheus text "
                         "exposition file (no server)")
    ap.add_argument("--monitor", action="store_true",
                    help="attach certificate-violation monitors: every "
                         "matmul's numeric health checked against the "
                         "certified enclosures (one device log, read back "
                         "once a step), plus one sampled empirical-error "
                         "check against δ̄ (needs --certificates or "
                         "--certificate-set)")
    ap.add_argument("--trace", default=None, metavar="OUT.JSONL",
                    help="record a JSONL trace of the serving run "
                         "(prefill / decode spans, log events); render "
                         "with `python -m repro_torch.obs report`. The "
                         "reference's compile-time and jaxpr-size gauges "
                         "have no PyTorch counterpart and are not "
                         "recorded")
    ap.add_argument("--compute-dtype", choices=sorted(dtypes.COMPUTE_DTYPES),
                    default="float32",
                    help="activations and products (ServeConfig."
                         "compute_dtype)")
    ap.add_argument("--cache-dtype", choices=sorted(dtypes.CACHE_DTYPES),
                    default="float32",
                    help="the KV cache or recurrent state (fp8: e4m3)")
    ap.add_argument("--param-dtype", choices=dtypes.PARAM_DTYPES,
                    default="same",
                    help="stored params: the compute dtype, or e4m3 (fp8)")
    ap.add_argument("--params-resident", choices=("auto", "on", "off"),
                    default="auto",
                    help="params on the mesh's model axis only (on), or "
                         "also split over data (off); auto by param count")
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
    if args.monitor and not (args.certificates or args.certificate_set):
        ap.error("--monitor needs --certificates or --certificate-set "
                 "(violations are relative to a certificate's bounds)")
    certify_kw = certify_kwargs(ap, args)

    dev = resolve_device(args.device)
    if args.trace:
        obs.configure(path=args.trace, program="repro_torch.launch.serve",
                      argv=argv)
    configure_precision()
    mod = configs.get(args.arch)
    cfg = mod.FULL if args.size == "full" else mod.SMOKE
    if args.max_layers is not None:
        cfg = dataclasses.replace(
            cfg, n_layers=min(args.max_layers, cfg.n_layers))

    prefix = prefix_len(cfg)
    sc = ServeConfig(arch=args.arch, batch=args.batch,
                     max_seq=args.prefill_len + args.decode_steps + 1
                     + prefix,
                     prefill_len=args.prefill_len,
                     precision_k=args.precision_k,
                     precision_layer_format=(json.loads(args.layer_format)
                                             if args.layer_format else None),
                     certificates=args.certificates, device=str(dev),
                     compute_dtype=args.compute_dtype,
                     cache_dtype=args.cache_dtype,
                     param_dtype=args.param_dtype,
                     params_resident={"auto": None, "on": True,
                                      "off": False}[args.params_resident])
    compute_dt, cache_dt, param_dt = sc.dtypes
    certset = None
    if args.certificate_set:
        with open(args.certificate_set) as fh:
            certset = CertificateSet.from_json(fh.read())
        sc = apply_certificate_set(sc, certset)

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = T.init_params(cfg, generator=gen, device=dev, dtype=param_dt)
    cache = T.init_cache(cfg, sc.batch, sc.max_seq, device=dev,
                         dtype=cache_dt)
    rng = np.random.RandomState(args.seed)
    prompt = torch.from_numpy(
        rng.randint(0, cfg.vocab, (sc.batch, sc.prefill_len))).to(dev)
    # the stub's inputs, drawn after the prompt as the reference draws them
    frontend = T.frontend_inputs(cfg, sc.batch, rng, dev, dtype=compute_dt)
    _sync(dev)
    t_init = time.perf_counter() - t0
    if sc.certificates is not None:
        sc, certset = apply_certificates(sc, cfg, params, **certify_kw)
    if certset is not None:
        log.info("certificate resolved", k=sc.precision_k,
                 source=("store" if certset.meta.get("from_store")
                         else "file" if args.certificate_set
                         else "fresh analysis (now persisted)"),
                 mixed_scopes=(None if sc.precision_layer_k is None
                               else len(sc.precision_layer_k)),
                 format_scopes=(None if sc.precision_layer_format is None
                                else len(sc.precision_layer_format)),
                 error_bars=certset.error_bars())
    monitor = None
    if args.monitor:
        monitor = ViolationMonitor.from_certificate_set(certset)
        log.info("violation monitor attached",
                 envelopes=len(monitor.envelopes), dbar_u=monitor.dbar_u)
    registry = obs.MetricsRegistry()
    registry.meta.update(arch=args.arch, batch=sc.batch,
                         precision_k=sc.precision_k)
    if mesh is None:
        mesh = meshlib.make_host_mesh(str(dev))
    sc = dataclasses.replace(sc, params_resident=resident_params(sc, cfg))
    prefill, decode, specs = build_serve_steps(cfg, sc, mesh, monitor)
    bk = specs["backend"]
    placed = sharding.place(params, specs["params"], mesh)
    cache = sharding.local(sharding.place(cache, specs["cache"], mesh))

    with torch.no_grad():
        t0 = time.perf_counter()
        with obs.span("serve.prefill", arch=args.arch, batch=sc.batch,
                      prefill_len=sc.prefill_len):
            out = prefill(placed, cache, {"tokens": prompt,
                                          "frontend": frontend})
            logits, cache = out[:2]
            enc_out = out[2] if cfg.enc_dec else None
            tok = torch.argmax(logits[:, -1, :], dim=-1)
            if monitor is not None:
                monitor.flush()
            _sync(dev)
        t_prefill = time.perf_counter() - t0
        registry.observe("serve.prefill_latency_s", t_prefill)
        out_toks, decode_logits, step_s = [tok], [], []
        for i in range(args.decode_steps):
            td = time.perf_counter()
            with obs.span("serve.decode", step=i):
                tok, last, cache = decode(placed, cache, {
                    "tokens": tok[:, None], "enc_out": enc_out,
                    "pos": prefix + sc.prefill_len + i})
                if monitor is not None:
                    monitor.flush()
                _sync(dev)
            step_s.append(time.perf_counter() - td)
            registry.observe("serve.decode_latency_s", step_s[-1])
            out_toks.append(tok)
            decode_logits.append(last)
        wall = time.perf_counter() - t0
        if monitor is not None and not cfg.frontend and not cfg.enc_dec:
            sample_error(monitor, certset, params, cfg, prompt, logits,
                         sc.max_seq)
    toks = torch.stack(out_toks, dim=1)
    t_decode = sum(step_s)
    timing = {
        "init_s": t_init,
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_ms_per_step": 1e3 * t_decode / max(args.decode_steps, 1),
        "decode_step_ms": [1e3 * s for s in step_s],
        "decode_tokens_per_s": (sc.batch * args.decode_steps / t_decode
                                if t_decode > 0 else float("nan")),
        "prefill_tokens_per_s": sc.batch * sc.prefill_len / t_prefill,
    }
    registry.counter("serve.requests", sc.batch)
    registry.counter("serve.tokens", int(toks.numel()))
    registry.gauge("serve.batch_occupancy", 1.0)     # every lane is live
    if t_decode > 0:
        registry.gauge("serve.decode_tokens_per_s",
                       timing["decode_tokens_per_s"])
    registry.gauge("serve.prefill_tokens_per_s",
                   timing["prefill_tokens_per_s"])
    responses = make_responses(toks, certset)
    _log_served(registry, monitor, certset, responses, args, sc, toks,
                wall, t_prefill, t_decode)
    if args.metrics:
        registry.write_jsonl(args.metrics)
        log.info("metrics written", path=args.metrics)
    if args.prom:
        registry.write_prometheus(args.prom)
        log.info("prometheus exposition written", path=args.prom)
    if args.trace:
        obs.shutdown()
        log.info("trace written", path=args.trace,
                 hint="render with: python -m repro_torch.obs report "
                      + args.trace)
    return ServeResult(tokens=toks, prompt=prompt, prefill_logits=logits,
                       decode_logits=decode_logits, responses=responses,
                       timing=timing, params=params, cfg=cfg, config=sc,
                       registry=registry, monitor=monitor,
                       frontend=frontend, backend=bk, placed=placed)


if __name__ == "__main__":
    res = main()
    print(json.dumps({"tokens": res.tokens.tolist(), **res.timing}))
