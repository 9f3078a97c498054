"""Layer-stacked mixed-precision / custom-format certificates for LM archs.

The counterpart of the JAX package's ``repro.certify.lm``. The classifier
pipelines certify per-scope {scope: k} and {scope: FpFormat} maps by
gating CAA knobs on scope strings; an LM's layer stack runs as ONE stacked
scope (:class:`repro_torch.core.backend.StackedCaaOps`, whose per-layer
knobs are ``[L]`` lanes — the reference's ``lax.scan`` body, run here as a
Python loop). This module is the layer-stacked version of the pipeline:

* **probes** go through one :class:`repro_torch.certify.formats.
  FormatProbeLadder` in ``stacked`` mode — the uniform search, the
  sensitivity ranking, the greedy mixed-k descent (through
  :meth:`~repro_torch.certify.formats.ladder.FormatProbeLadder.mixed_view`)
  and the exponent descent; each probe is one eager analysis;
* **decisions** use the decode-argmax margin: the exact logits enclosure of
  the certification profile pins the next-token argmax as long as
  2·δ̄·u stays below the top-1 gap;
* **confirmations** stay on the eager per-layer reference (unrolled
  ``layer{i}`` scopes): persisted bounds always come from an eager pass
  that re-proves feasibility — and, for formats, overflow-freedom — at
  the final map; ladder bounds only steer the search.

Scope keys are the concrete ``layer{i}`` lanes plus the ``head`` block;
``embed`` and other unmapped scopes serve at the uniform certified k. The
certificates are ordinary schema-v3 certificates, so
``launch/serve.py --certificates`` and ``launch/batching.py
--certificates`` serve them. Every cache of this module keeps host numbers
(bounds, margins, range statistics), never device tensors: at Qwen2-7B's
width one analysis pass already fills most of the card.
"""
from __future__ import annotations

import dataclasses
import re
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import analyze, caa
from repro_torch.core import formats as F
from repro_torch.core import interval as iv
from repro_torch.core.backend import CaaOps
from repro_torch.core.scopes import scope_prefixes
from . import formats as FS
from . import mixed as MX
from .pipeline import (STACKED_CRITERION, _lm_setup, _satisfied_by,
                       params_device, serving_request)
from .spec import Certificate, CertificateSet, trace_summary
from .store import CertificateStore, params_digest
from .tokens import profile_tokens

_LAYER_KEY = re.compile(r"^layer\d+$")


class StageClock:
    """Seconds and peak device memory per named stage of a certification:
    ``with clock("name"): ...`` adds the block's seconds to
    ``seconds[name]``; on a CUDA device every stage boundary reads the
    allocator's peak into each open stage and resets it, so a stage's
    ``peak_gb`` is its own, nested stages included."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds: Dict[str, float] = {}
        self.peak_gb: Dict[str, float] = {}
        self._open: List[str] = []

    def _boundary(self):
        if self.device.type != "cuda":
            return
        peak = torch.cuda.max_memory_allocated(self.device) / 1e9
        for name in self._open:
            self.peak_gb[name] = max(self.peak_gb.get(name, 0.0), peak)
        torch.cuda.reset_peak_memory_stats(self.device)

    def add(self, name: str, seconds: float):
        self.seconds[name] = self.seconds.get(name, 0.0) + seconds

    def __call__(self, name: str):
        clock = self

        class _Block:
            def __enter__(self):
                clock._boundary()
                clock._open.append(name)
                self.t = time.perf_counter()

            def __exit__(self, *exc):
                clock.add(name, time.perf_counter() - self.t)
                clock._boundary()
                clock._open.remove(name)

        return _Block()


def _frontend_kwargs(arch_cfg, batch: int, seed: int) -> Dict:
    """Extra forward inputs of a modality frontend: none of the ported
    archs has one, and the rest raise through ``check_supported``."""
    from repro_torch.models import transformer as T

    del batch, seed
    T.check_supported(arch_cfg)
    return {}


def _lm_forward_adapter(arch_cfg, tokens, fw_kwargs):
    """Close the arch/profile over a classifier-shaped ``forward(bk, params,
    x)``: returns the final-position logits as a CaaTensor [B, 1, V] (the
    dummy ``x`` only fixes the per-sequence "class" axis for the ladders).
    Works for every CAA backend — eager unrolled or stacked."""
    from repro_torch.models import transformer as T

    def forward(bk, params, x):
        del x
        logits, _ = T.forward(bk, params, arch_cfg, tokens, **fw_kwargs)
        return caa.slice_(logits, (slice(None), slice(-1, None)))

    return forward


def lm_layer_flops(arch_cfg) -> Dict[str, float]:
    """Per-scope matmul FLOPs per token — the weights of the mean-k /
    mean-bits savings reports (relative weights only; the token count
    cancels). Derived from the same closed forms as
    :func:`repro_torch.models.transformer.analytic_params`: 2 FLOPs per
    stored matmul parameter per token."""
    from repro_torch.models import transformer as T

    total = T.analytic_params(arch_cfg, active=True)
    emb = arch_cfg.vocab * arch_cfg.d_model
    head = 2.0 * arch_cfg.d_model * arch_cfg.vocab
    n_emb = emb * (1 if arch_cfg.tie_embeddings else 2)
    per_layer = 2.0 * max(total - n_emb, 1) / max(arch_cfg.n_layers, 1)
    out = {f"layer{i}": per_layer for i in range(arch_cfg.n_layers)}
    out["head"] = head
    return out


def _gap_feasibility(gaps: np.ndarray):
    """Per-sequence argmax feasibility: the exact logits enclosure (which no
    probe changes — only δ̄ depends on the knobs) pins the top-1 decision
    iff inflating every logit by δ̄·u keeps the predicted logit's lower end
    above every rival's upper end: 2·δ̄·u < gap."""

    def feasible(abs_u, rel_u, k: int) -> np.ndarray:
        del rel_u                      # logits cross 0: ε̄ is typically +inf
        u = 2.0 ** (1 - int(k))
        with np.errstate(invalid="ignore"):
            return np.asarray(abs_u, np.float64) * u * 2.0 < gaps

    return feasible


@dataclasses.dataclass
class _EagerRef:
    """One eager per-layer reference pass (the confirmation oracle)."""

    abs_u: np.ndarray          # [B] max δ̄ of final-position logits
    rel_u: np.ndarray
    gaps: np.ndarray           # [B] exact-enclosure top-1 margins
    preds: np.ndarray          # [B] predicted next tokens
    trace: list
    scopes: List[str]


def _eager_pass(forward, params, x, ops) -> _EagerRef:
    out = forward(ops, params, x)
    B = out.shape[0]
    abs_u, rel_u = FS.ladder.class_bounds(out)
    lo = out.exact.lo.reshape(B, -1).cpu().numpy()
    hi = out.exact.hi.reshape(B, -1).cpu().numpy()
    preds = out.val.reshape(B, -1).argmax(-1).cpu().numpy()
    del out
    gaps = np.array([
        lo[b, preds[b]] - np.max(np.delete(hi[b], preds[b]))
        for b in range(lo.shape[0])
    ])
    return _EagerRef(
        abs_u=abs_u, rel_u=rel_u,
        gaps=gaps, preds=preds, trace=list(ops.trace),
        scopes=list(ops.seen_scopes))


def certify_lm_stacked(
    arch_name: str,
    arch_cfg=None,
    params=None,
    *,
    seq: int = 8,
    batch: int = 1,
    seed: int = 1,
    k_min: int = 4,
    k_max: int = 53,
    mixed: bool = True,
    formats: bool = False,
    profiles: Sequence[int] = (),
    store: Optional[CertificateStore] = None,
    layer_flops: Optional[Dict[str, float]] = None,
    format_opts: Optional[Dict] = None,
    device: str = "cuda",
) -> CertificateSet:
    """Mixed-precision / custom-format serving certificate for an LM arch.

    Certifies, for the (batch × seq) certification profile, the smallest
    uniform mantissa k whose rigorous parametric bounds pin the next-token
    argmax — then refines it into a per-layer ``{layer{i}|head: k}`` map
    (``mixed``) and per-scope full ``FpFormat``s (``formats``), all probed
    through one stacked probe ladder and eagerly re-confirmed on the
    per-layer reference before anything persists. ``profiles`` lists extra
    sequence lengths whose range passes widen the overflow (emax) evidence
    via :func:`repro_torch.core.analyze.merge_range_maps`. The analysis
    runs where ``params`` live (``device`` places the seeded params made
    when none are given). ``meta["stage_seconds"]`` holds the seconds of
    each stage and, on the card, ``meta["stage_peak_gb"]`` its peak device
    memory (:class:`StageClock`).
    """
    t0 = time.perf_counter()
    arch_cfg, params = _lm_setup(arch_name, arch_cfg, params, device)
    dev = params_device(params)
    digest = params_digest(params)
    fw_kwargs = _frontend_kwargs(arch_cfg, batch, seed)
    key, request = serving_request(
        arch_name, arch_cfg, digest, seq=seq, batch=batch, seed=seed,
        k_min=k_min, k_max=k_max, mixed=mixed, formats=formats,
        profiles=profiles, format_opts=format_opts)
    class_key = request["class_key"]
    base_cfg = caa.DEFAULT_CONFIG
    target = {"criterion": STACKED_CRITERION,
              "profiles": sorted({int(p) for p in profiles})}
    if store is not None:
        with obs.span("store_lookup"):
            hit = store.get(key, expect_params_digest=digest)
        if hit is not None:
            obs.event("certify.store_hit", key=key[:12])
            return dataclasses.replace(hit, meta=dict(
                hit.meta, from_store=True,
                lookup_seconds=time.perf_counter() - t0))

    tokens = profile_tokens(seed, batch, seq, arch_cfg.vocab, dev)
    forward = _lm_forward_adapter(arch_cfg, tokens, fw_kwargs)
    x = caa.make(torch.zeros((batch, 1), dtype=torch.float64, device=dev))
    _stage = StageClock(dev)
    # -- eager reference: margins + scope discovery (one unrolled pass) -----
    eager_cache: Dict[Tuple, _EagerRef] = {}

    def eager_uniform(k: int) -> _EagerRef:
        if ("u", k) not in eager_cache:
            ops = CaaOps(analyze.batch_config(
                dataclasses.replace(base_cfg, u_max=2.0 ** (1 - k)), batch))
            with obs.span("eager_reference", k=int(k)):
                eager_cache[("u", k)] = _eager_pass(forward, params, x, ops)
        return eager_cache[("u", k)]

    with _stage("eager_reference"):
        ref = eager_uniform(k_max)
    gaps = ref.gaps
    feasible = _gap_feasibility(gaps)
    scope_keys = [s for s in scope_prefixes(ref.scopes, 1)
                  if _LAYER_KEY.match(s) or s == "head"]

    def finish(cs: CertificateSet) -> CertificateSet:
        cs.meta["analysis_seconds"] = time.perf_counter() - t0
        cs.meta["stage_seconds"] = dict(_stage.seconds)
        if _stage.peak_gb:
            cs.meta["stage_peak_gb"] = dict(_stage.peak_gb)
        if store is not None:
            with obs.span("store_put"):
                store.put(key, cs, request={"model_id": f"lm/{arch_name}",
                                            "class_key": class_key})
        return cs

    def certificate(required, rep: _EagerRef, layer_k=None,
                    layer_format=None, extra_meta=None,
                    class_key_=None) -> Certificate:
        probe_k = required if required is not None else k_max
        return Certificate(
            model_id=f"lm/{arch_name}",
            params_digest=digest,
            class_key=class_key if class_key_ is None else class_key_,
            cfg=dataclasses.replace(base_cfg, u_max=2.0 ** (1 - probe_k)),
            bounds_u_max=2.0 ** (1 - probe_k),
            final_abs_u=float(np.max(rep.abs_u)),
            final_rel_u=float(np.max(rep.rel_u)),
            required_k=None if required is None else int(required),
            satisfied_by=_satisfied_by(required),
            trace_summary=trace_summary(
                [r for r in rep.trace if r.kind != "router"]),
            p_star=None,
            layer_k=(None if layer_k is None
                     else {str(s): int(v) for s, v in layer_k.items()}),
            layer_format=layer_format,
            meta=dict({
                "criterion": target["criterion"],
                "min_gap": float(np.min(rep.gaps)),
                "sample_next_tokens": [int(t) for t in rep.preds[:4]],
            }, **(extra_meta or {})),
        )

    meta = {"from_store": False, "arch": arch_name, "batched": True,
            "scan_native": True, "scope_keys": list(scope_keys),
            "profiles": target["profiles"]}

    if (gaps <= 0).any() or not scope_keys:
        meta["reason"] = ("no positive argmax margin on the certification "
                          "profile" if (gaps <= 0).any()
                          else "model exposes no certifiable scopes")
        return finish(CertificateSet(
            model_id=f"lm/{arch_name}", params_digest=digest,
            certificates=[certificate(None, ref)], p_star=None, meta=meta))

    # -- one stacked ladder serves every search below -----------------------
    ladder = FS.FormatProbeLadder(forward, params, x, scope_keys,
                                  cfg=base_cfg, stacked=True)
    mview = ladder.mixed_view()

    def ladder_ok(k: int) -> bool:
        abs_u, rel_u, k_ref = mview({s: k for s in scope_keys}, k)
        return bool(np.all(feasible(abs_u, rel_u, k_ref)))

    # uniform binary search (ladder), then eager-confirm the endpoint —
    # mirroring batch.required_k_batched's confirm-or-bump fixpoint
    with _stage("uniform_search"):
        ok_at_max = ladder_ok(k_max)
    if not ok_at_max:
        meta["reason"] = f"not certifiable at k_max={k_max}"
        meta["probes"] = ladder.probes
        meta["ladder_compiles"] = ladder.compiles
        return finish(CertificateSet(
            model_id=f"lm/{arch_name}", params_digest=digest,
            certificates=[certificate(None, ref)], p_star=None, meta=meta))
    def _confirmed(k: int) -> bool:
        with _stage("eager_confirmation"):
            return bool(np.all(feasible(eager_uniform(k).abs_u, None, k)))

    with obs.span("uniform_search", k_min=k_min, k_max=k_max) as _sp, \
            _stage("uniform_search"):
        lo, hi = k_min, k_max
        while lo < hi:
            mid = (lo + hi) // 2
            if ladder_ok(mid):
                hi = mid
            else:
                lo = mid + 1
        uniform_k = hi
        _sp.set(uniform_k=int(uniform_k))
    while not _confirmed(uniform_k):
        if uniform_k >= k_max:
            meta["reason"] = "eager confirmation failed at k_max"
            meta["probes"] = ladder.probes
            meta["ladder_compiles"] = ladder.compiles
            return finish(CertificateSet(
                model_id=f"lm/{arch_name}", params_digest=digest,
                certificates=[certificate(None, ref)], p_star=None,
                meta=meta))
        uniform_k += 1
    with _stage("eager_confirmation"):
        urep = eager_uniform(uniform_k)
    flops = layer_flops if layer_flops is not None else lm_layer_flops(arch_cfg)
    flops = {s: flops.get(s, 1.0) for s in scope_keys}

    # extra input profiles: forward adapters shared by the format range
    # evidence AND the per-profile argmax certificates below
    extra_profiles = sorted({int(p) for p in target["profiles"]
                             if int(p) != seq})
    prof_fwds = {
        p_seq: _lm_forward_adapter(
            arch_cfg,
            profile_tokens(seed, batch, p_seq, arch_cfg.vocab, dev),
            fw_kwargs)
        for p_seq in extra_profiles
    }

    # -- greedy per-layer mixed descent (stacked probes, eager confirm) -----
    # formats imply the mixed descent: the synthesis's mixed-mantissa
    # attempt needs a layer_k map to fix per-scope ks
    run_mixed = mixed or formats
    layer_k = None
    if run_mixed:
        with obs.span("mixed_descent") as _sp:
            plan = MX.greedy_mixed_assignment(
                forward, params, x, feasible, uniform_k,
                scope_keys=scope_keys, cfg=base_cfg, k_min=k_min,
                ladder=mview, stage=_stage)
            _sp.set(feasible=plan.feasible)
        layer_k = dict(plan.layer_k)
        confirms = 0
        while True:
            k_ref = min(list(layer_k.values()) + [uniform_k])
            u_ref = 2.0 ** (1 - k_ref)
            ops = MX.MixedCaaOps(
                analyze.batch_config(
                    dataclasses.replace(base_cfg, u_max=u_ref), batch),
                {s: 2.0 ** (1 - k) / u_ref for s, k in layer_k.items()},
                default_scale=2.0 ** (1 - uniform_k) / u_ref)
            with obs.span("mixed_confirm", k_ref=int(k_ref)), \
                    _stage("mixed_confirm"):
                rep = _eager_pass(forward, params, x, ops)
            confirms += 1
            if bool(np.all(feasible(rep.abs_u, None, k_ref))):
                break
            raised = False
            for s in sorted(layer_k):
                if layer_k[s] < uniform_k:
                    layer_k[s] += 1
                    raised = True
            if not raised:
                break
        mixed_rep, mixed_k_ref = rep, k_ref
        mean_k = MX.flop_weighted_mean_k(layer_k, flops)
        meta["mixed"] = {
            "applied": True,
            "layer_k": {s: int(v) for s, v in layer_k.items()},
            "uniform_k": int(uniform_k),
            "mean_k_flop_weighted": mean_k,
            "savings_k_flop_weighted": uniform_k - mean_k,
            # serving cost of the mixed map: k-bit mantissa in a binary32
            # carrier → 1 sign + 8 exponent + (k−1) stored mantissa bits
            "mean_bits_flop_weighted": mean_k + 8.0,
            "savings_bits_vs_binary32": 32.0 - (mean_k + 8.0),
            "sensitivity_abs_u": {s: float(v)
                                  for s, v in plan.sensitivity.items()},
            "probes": ladder.probes,
            "eager_confirms": confirms,
            "ladder_compiles": ladder.compiles,
        }

    # -- full-format synthesis (shared ladder; profile-widened ranges) ------
    layer_format = None
    fplan = None
    if formats:
        opts = dict(format_opts or {})
        # affine/zonotope range evidence: min-combined with the IA ranges
        # per profile, it keeps the emax floors finite where the IA pass
        # saturates at the mixed map's coarse u_ref — without it the
        # mixed-mantissa attempt below dies on base_overflow for every
        # attention arch (the silent uniform-k fallback this knob fixes)
        affine = bool(opts.pop("affine", True))
        affine_budget = int(opts.pop("affine_budget",
                                     iv.AFF_DEFAULT_BUDGET))
        affine_rank = str(opts.pop("affine_rank", iv.AFF_DEFAULT_RANK))
        obs.gauge("affine.budget", affine_budget)
        affine_stacked = bool(opts.pop("affine_stacked", False))
        affine_sublanes = tuple(opts.pop("affine_sublanes",
                                         ("attn", "mlp")))

        tighten_ranges_fn = None
        aff_cache: Dict[Tuple, Dict] = {}

        def affine_map(fwd, lf, df):
            with _stage("range_passes"):
                return analyze.analyze_ranges_affine(
                    fwd, params, x, lf, df, keys=scope_keys,
                    stacked=affine_stacked, sublanes=affine_sublanes,
                    budget=affine_budget, condense_rank=affine_rank)

        if affine:
            def tighten_ranges_fn(lf, df):
                ck = (tuple(sorted((s, f.name) for s, f in lf.items())),
                      df.name)
                if ck not in aff_cache:
                    with obs.span("affine_ranges", scopes=len(lf),
                                  budget=affine_budget, rank=affine_rank):
                        aff_cache[ck] = affine_map(forward, lf, df)
                return aff_cache[ck]

        extra_ranges_fn = None
        if extra_profiles:
            def extra_ranges_fn(lf, df):
                maps = []
                for p_seq in extra_profiles:
                    pf = prof_fwds[p_seq]
                    with _stage("range_passes"):
                        _, _, _, ranges = FS.eager_format_report(
                            pf, params, x, lf, df, scope_keys, cfg=base_cfg)
                    if affine:
                        # tighten per profile BEFORE the cross-profile
                        # max — the other order is unsound
                        ranges = analyze.tighten_range_maps(
                            ranges, affine_map(pf, lf, df))
                    maps.append(ranges)
                return analyze.merge_range_maps(maps, scope_keys)

        # Exponent-lattice mantissas: "auto" tries the mixed map's per-scope
        # ks first (the affine evidence keeps its overflow floors finite);
        # only if the joint feasibility still fails does it fall back to
        # the uniform mantissa so the exponent descent can proceed alone.
        layer_k_mode = opts.pop("layer_k_mode", "auto")
        attempts = []
        if layer_k_mode in ("auto", "mixed") and layer_k:
            attempts.append(("mixed", dict(layer_k)))
        if layer_k_mode in ("auto", "uniform") or not attempts:
            attempts.append(("uniform", None))
        for mode, lk in attempts:
            with obs.span("format_synthesis", mantissa_mode=mode) as _sp, \
                    _stage("format_synthesis"):
                fplan = FS.synthesize_formats(
                    forward, params, x, feasible, uniform_k, layer_k=lk,
                    scope_keys=scope_keys, cfg=base_cfg, ladder=ladder,
                    extra_ranges_fn=extra_ranges_fn,
                    tighten_ranges_fn=tighten_ranges_fn, **opts)
                _sp.set(feasible=fplan.feasible)
            if fplan.feasible:
                break
            saturated = [s for s, r in fplan.scope_ranges.items()
                         if not np.isfinite(r.max_abs)]
            obs.event(
                "formats.mantissa_fallback", mode=mode,
                affine=bool(affine), saturated_scopes=len(saturated),
                reason=("range enclosures saturated — overflow floors "
                        "unprovable at this mantissa map" if saturated
                        else "joint feasibility failed at this mantissa "
                             "map"))
        if fplan.feasible:
            mean_bits = fplan.mean_bits(flops)
            mixed_bits = (meta["mixed"]["mean_bits_flop_weighted"]
                          if layer_k is not None else
                          float(F.from_bits(uniform_k, 8).total_bits))
            # attach the format map only when it is the cheaper serving
            # option — serving prefers layer_format over layer_k, so
            # attaching a costlier map would regress real-silicon bits
            attach = mean_bits <= mixed_bits
            if attach:
                layer_format = fplan.formats_dict()
            meta["formats"] = {
                "applied": True,
                "attached": bool(attach),
                "mantissa_mode": mode,
                "layer_format": fplan.formats_dict(),
                "uniform_k": int(uniform_k),
                "baseline_bits": fplan.baseline_bits,
                "mean_bits_flop_weighted": mean_bits,
                "savings_bits_flop_weighted": fplan.savings_bits(flops),
                # the serving-cost headline: the cheapest certified map vs
                # shipping uniform binary32 values
                "savings_bits_vs_binary32":
                    32.0 - min(mean_bits, mixed_bits),
                "scope_ranges": {s: r.to_dict()
                                 for s, r in fplan.scope_ranges.items()},
                "emax_floor_bits": dict(fplan.emax_floor),
                "probes": fplan.probes,
                "ladder_compiles": ladder.compiles,
            }
            if not attach:
                meta["formats"]["attach_reason"] = (
                    "mixed {scope: k} map serves cheaper "
                    f"({mixed_bits:.2f}b < {mean_bits:.2f}b/value) — format "
                    "map certified but not attached")
        else:
            meta["formats"] = {
                "applied": False,
                "reason": "no jointly-feasible format map confirmed",
                "history": fplan.history,
            }

    meta["probes"] = ladder.probes
    meta["ladder_compiles"] = ladder.compiles
    # The persisted (final_abs_u, bounds_u_max) pair comes from the UNIFORM
    # eager confirmation — bounds_u_max is documented as "the u at which
    # final_abs_u was computed", and error_bars() serves dbar_u·u, so the
    # units must match required_k (exactly as the classifier pipeline
    # persists the uniform probe's bounds next to its layer_k map). The
    # mixed confirmation's own bounds ride in meta, in THEIR unit.
    extra_meta = {}
    if layer_k is not None:
        extra_meta["mixed_confirm"] = {
            "abs_u_ref": float(np.max(mixed_rep.abs_u)),
            "rel_u_ref": float(np.max(mixed_rep.rel_u)),
            "k_ref": int(mixed_k_ref),
        }
    primary_prov = {}
    if layer_k is not None:
        primary_prov["layer_k"] = "synthesized"
    if layer_format is not None:
        primary_prov["layer_format"] = "synthesized"
    if primary_prov:
        extra_meta["map_provenance"] = primary_prov
    cert = certificate(
        uniform_k, urep, layer_k=layer_k, layer_format=layer_format,
        extra_meta=extra_meta)

    # -- full multi-profile argmax certificates -----------------------------
    # Each extra profile gets its own eagerly-confirmed certificate at the
    # certified uniform k (its own class_key, its own margins) — only
    # profiles whose argmax actually pins are appended; failures are
    # recorded in meta and never poison the primary certificate. A profile
    # first re-confirms the attached layer_k / layer_format maps under ITS
    # OWN margins; a profile that REJECTS a map no longer just raises it
    # until feasible — it re-runs the greedy mixed descent / the exponent
    # synthesis from its own margins and its own tightened range evidence
    # through its own stacked ladder (built lazily, only for a profile
    # that rejects), then eagerly re-confirms the result.
    # serving_layer_k / serving_layer_format merge per-scope COARSEST
    # demand across the set, so per-profile maps stay jointly sound; the
    # legacy raise-until-feasible map is still computed as the baseline and
    # the fallback whenever re-synthesis fails to beat it scope-wise, which
    # keeps the merged serving cost ≤ the legacy merge by construction.
    profile_certs: List[Certificate] = []
    ok_profiles: List[int] = []
    p_old_maps: Dict[int, Optional[Dict[str, int]]] = {}
    p_format_whole: Dict[int, bool] = {}
    prof_ladders: Dict[int, FS.FormatProbeLadder] = {}
    t_profiles = time.perf_counter()
    if extra_profiles:
        from .formats.ladder import eager_format_report

        meta["profile_certificates"] = {}
        for p_seq in extra_profiles:
            pf = prof_fwds[p_seq]
            ops = CaaOps(analyze.batch_config(
                dataclasses.replace(base_cfg, u_max=2.0 ** (1 - uniform_k)),
                batch))
            with obs.span("profile_confirm", seq=int(p_seq),
                          k=int(uniform_k)):
                prep = _eager_pass(pf, params, x, ops)
            p_feasible = _gap_feasibility(prep.gaps)
            p_ok = bool((prep.gaps > 0).all()) and bool(np.all(
                p_feasible(prep.abs_u, None, uniform_k)))
            p_meta = {
                "certified": bool(p_ok),
                "min_gap": float(np.min(prep.gaps)),
                "abs_u": float(np.max(prep.abs_u)),
            }
            prov: Dict[str, str] = {}

            def p_ladder(pf=pf, p_seq=p_seq):
                if p_seq not in prof_ladders:
                    prof_ladders[p_seq] = FS.FormatProbeLadder(
                        pf, params, x, scope_keys, cfg=base_cfg,
                        stacked=True, tag=f"format[seq{p_seq}]")
                return prof_ladders[p_seq]

            def eager_mixed(trial, pf=pf, p_seq=p_seq):
                k_ref = min(list(trial.values()) + [uniform_k])
                u_ref = 2.0 ** (1 - k_ref)
                ops_m = MX.MixedCaaOps(
                    analyze.batch_config(
                        dataclasses.replace(base_cfg, u_max=u_ref), batch),
                    {s: 2.0 ** (1 - k) / u_ref for s, k in trial.items()},
                    default_scale=2.0 ** (1 - uniform_k) / u_ref)
                with obs.span("profile_confirm_mixed", seq=int(p_seq),
                              k_ref=int(k_ref)):
                    prep_m = _eager_pass(pf, params, x, ops_m)
                return bool(np.all(_gap_feasibility(prep_m.gaps)(
                    prep_m.abs_u, None, k_ref)))

            def confirm_raise(start, eager_mixed=eager_mixed):
                # the legacy fixpoint: lift every below-uniform scope one
                # step until this profile's eager confirm passes (the
                # all-uniform endpoint reduces to the uniform pass that
                # already certified above)
                trial = dict(start)
                while True:
                    if eager_mixed(trial):
                        return trial
                    raised = False
                    for s in sorted(trial):
                        if trial[s] < uniform_k:
                            trial[s] += 1
                            raised = True
                    if not raised:
                        return None

            p_layer_k = None
            if p_ok and layer_k is not None:
                raised_map = confirm_raise(layer_k)
                p_old_maps[p_seq] = raised_map
                if raised_map == layer_k:
                    p_layer_k = dict(layer_k)
                    prov["layer_k"] = "primary-confirmed"
                else:
                    # rejected: greedy descent from THIS profile's margins
                    with obs.span("profile_mixed_descent",
                                  seq=int(p_seq)) as _sp:
                        pplan = MX.greedy_mixed_assignment(
                            pf, params, x, p_feasible, uniform_k,
                            scope_keys=scope_keys, cfg=base_cfg,
                            k_min=k_min, ladder=p_ladder().mixed_view())
                        _sp.set(feasible=pplan.feasible)
                    cand = confirm_raise(pplan.layer_k)
                    if (cand is not None and raised_map is not None
                            and any(cand[s] > raised_map[s]
                                    for s in raised_map)):
                        # scope-wise cap so the coarsest-demand merge can
                        # never exceed the legacy merge; capping lowers ks
                        # (grows error), so the cap must re-confirm
                        cand = confirm_raise(
                            {s: min(cand[s], raised_map[s]) for s in cand})
                    if cand is not None and (
                            raised_map is None
                            or all(cand[s] <= raised_map[s]
                                   for s in raised_map)):
                        p_layer_k = cand
                        prov["layer_k"] = "resynthesized"
                    elif raised_map is not None:
                        p_layer_k = raised_map
                        prov["layer_k"] = "raised"
                    if raised_map is not None:
                        p_meta["mixed_raised_mean_k"] = \
                            MX.flop_weighted_mean_k(raised_map, flops)
                        p_meta["mixed_resynth_differs"] = bool(
                            p_layer_k is not None
                            and p_layer_k != raised_map)
                p_meta["mixed_certified"] = p_layer_k is not None
                if p_layer_k is not None:
                    p_meta["mixed_mean_k"] = MX.flop_weighted_mean_k(
                        p_layer_k, flops)
                    p_meta["mixed_raised_scopes"] = sum(
                        1 for s in layer_k if p_layer_k[s] > layer_k[s])
            p_layer_format = None
            if p_ok and layer_format is not None:
                lf = {s: F.from_dict(d) for s, d in layer_format.items()
                      if s}
                df = F.from_dict(layer_format[""])
                with obs.span("profile_confirm_format", seq=int(p_seq)):
                    f_abs, _f_rel, fk_ref, _r = eager_format_report(
                        pf, params, x, lf, df, scope_keys, cfg=base_cfg)
                whole = bool(np.all(p_feasible(f_abs, None, fk_ref)))
                p_format_whole[p_seq] = whole
                if whole:
                    p_layer_format = dict(layer_format)
                    prov["layer_format"] = "primary-confirmed"
                else:
                    # rejected: exponent synthesis from THIS profile's own
                    # tightened range evidence. Per-profile soundness is
                    # enough — serving merges coarsest demand, and the
                    # primary certificate already carries the
                    # profile-widened overflow evidence.
                    p_tighten = None
                    if affine:
                        p_aff_cache: Dict[Tuple, Dict] = {}

                        def p_tighten(lf_, df_, pf=pf,
                                      p_aff_cache=p_aff_cache):
                            ck = (tuple(sorted((s, f.name)
                                               for s, f in lf_.items())),
                                  df_.name)
                            if ck not in p_aff_cache:
                                with obs.span("affine_ranges",
                                              scopes=len(lf_),
                                              budget=affine_budget,
                                              rank=affine_rank):
                                    p_aff_cache[ck] = affine_map(
                                        pf, lf_, df_)
                            return p_aff_cache[ck]

                    p_attempts = []
                    if p_layer_k:
                        p_attempts.append(("mixed", dict(p_layer_k)))
                    p_attempts.append(("uniform", None))
                    pfp = None
                    for p_mode, p_lk in p_attempts:
                        with obs.span("profile_format_synthesis",
                                      seq=int(p_seq),
                                      mantissa_mode=p_mode) as _sp:
                            pfp = FS.synthesize_formats(
                                pf, params, x, p_feasible, uniform_k,
                                layer_k=p_lk, scope_keys=scope_keys,
                                cfg=base_cfg, ladder=p_ladder(),
                                tighten_ranges_fn=p_tighten, **opts)
                            _sp.set(feasible=pfp.feasible)
                        if pfp.feasible:
                            break
                    if pfp.feasible:
                        p_layer_format = pfp.formats_dict()
                        prov["layer_format"] = "resynthesized"
                        p_meta["format_mean_bits"] = pfp.mean_bits(flops)
                    else:
                        prov["layer_format"] = "uncertified"
                p_meta["format_certified"] = p_layer_format is not None
            p_meta["map_provenance"] = dict(prov)
            meta["profile_certificates"][str(p_seq)] = p_meta
            if p_ok:
                ok_profiles.append(p_seq)
                profile_certs.append(certificate(
                    uniform_k, prep, layer_k=p_layer_k,
                    layer_format=p_layer_format,
                    extra_meta={"map_provenance": dict(prov),
                                "profile_seq": int(p_seq)},
                    class_key_=(f"lm/{arch_cfg.name}/tokens"
                                f"[{batch}x{p_seq}]seed{seed}")))
            else:
                obs.event("certify.profile_uncertified", seq=int(p_seq),
                          k=int(uniform_k))
        meta["profile_ladders"] = {
            str(p): {"probes": lad.probes, "compiles": lad.compiles}
            for p, lad in prof_ladders.items()}
        _stage.add("profiles", time.perf_counter() - t_profiles)

    cs = CertificateSet(
        model_id=f"lm/{arch_name}", params_digest=digest,
        certificates=[cert] + profile_certs, p_star=None, meta=meta)

    # -- serving summary: merged cost vs the legacy raise-until-feasible ----
    def _k_bits(m):
        # k-bit mantissa in a binary32 carrier (sign + 8 exponent bits)
        return MX.flop_weighted_mean_k(m, flops) + 8.0

    def _f_bits(fm):
        tot = sum(flops.values()) or 1.0
        return sum(
            flops[s] * F.from_dict(fm.get(s, fm[""])).total_bits
            for s in scope_keys) / tot

    def _serving_bits(cs_):
        sf_ = cs_.serving_layer_format
        if sf_ is not None:
            return _f_bits(sf_), "formats"
        sk_ = cs_.serving_layer_k
        if sk_ is not None:
            return _k_bits(sk_), "mixed"
        return float(uniform_k + 8.0), "uniform"

    baseline_bits, baseline_src = float(uniform_k + 8.0), "uniform"
    if layer_format is not None and all(
            p_format_whole.get(p, False) for p in ok_profiles):
        # every class wholesale-confirmed the primary format map — the
        # legacy merge equals today's
        sf = cs.serving_layer_format
        if sf is not None:
            baseline_bits, baseline_src = _f_bits(sf), "formats"
    elif layer_k is not None:
        old_maps = [layer_k] + [p_old_maps.get(p) for p in ok_profiles]
        if all(m is not None for m in old_maps):
            merged_old = {s: max(m[s] for m in old_maps)
                          for s in scope_keys}
            baseline_bits, baseline_src = _k_bits(merged_old), "mixed"

    if cs.serving_layer_format is not None:
        serving_bits, _src = _serving_bits(cs)
        if serving_bits > baseline_bits:
            # a resynthesized format map made the merged format map pricier
            # than the legacy serving — drop the PROFILE format maps so the
            # set demotes to the mixed merge, which the scope-wise cap
            # above keeps ≤ the legacy merge
            obs.event("certify.profile_format_maps_dropped",
                      merged_bits=float(serving_bits),
                      baseline_bits=float(baseline_bits))
            profile_certs = [
                dataclasses.replace(
                    c, layer_format=None,
                    meta=dict(c.meta, map_provenance=dict(
                        c.meta.get("map_provenance", {}),
                        layer_format="dropped-pricier-than-mixed")))
                for c in profile_certs]
            cs = CertificateSet(
                model_id=f"lm/{arch_name}", params_digest=digest,
                certificates=[cert] + profile_certs, p_star=None,
                meta=meta)

    serving_bits, serving_src = _serving_bits(cs)
    differ = any(
        v == "resynthesized"
        for p in cs.map_provenance().values() for v in p.values())
    meta["serving"] = {
        "mean_bits_flop_weighted": float(serving_bits),
        "map_source": serving_src,
        "raised_baseline_mean_bits": float(baseline_bits),
        "raised_baseline_source": baseline_src,
        "profile_maps_differ": bool(differ),
        "provenance": cs.map_provenance(),
    }
    return finish(cs)

