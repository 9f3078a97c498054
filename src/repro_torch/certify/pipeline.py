"""certify(): analyse → decide → persist, behind the content-addressed store.

The counterpart of the JAX package's ``repro.certify.pipeline``. Two
certification shapes cover the workloads:

* :func:`certify` — the paper's classifier workflow, batched: per-class
  interval input envelopes, one joint CAA pass per probed precision, a
  vectorised binary search for each class's smallest safe k against the
  p* margins (or an absolute tolerance), optional per-layer k maps
  (``mixed``) and per-scope formats (``formats``), and one stored
  CertificateSet;
* :func:`certify_lm` — the LM serving certificate: the smallest k whose
  k-bit emulated CAA enclosure still pins the model's next-token argmax on
  the certification profile (``mixed`` / ``formats`` go through the
  layer-stacked pipeline of :mod:`repro_torch.certify.lm`).

Both consult the store first under the reference's content address (the
same key for the same request and the same numbers), so an entry either
package certified is a hit for the other. The analysis runs on the device
the params live on; the certification profile's tokens are the
reference's for the same seed (:mod:`repro_torch.certify.tokens`).
:func:`serving_certificate` — what serving calls — certifies on a miss and
persists the result.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import caa, formats as F, precision
from repro_torch.core.backend import CaaOps
from repro_torch.core.caa import CaaConfig
from repro_torch.core.scopes import scope_prefixes
from . import batch as B
from . import formats as FS
from . import mixed as MX
from .spec import Certificate, CertificateSet, trace_summary
from .store import CertificateStore, _leaves, params_digest, request_key
from .tokens import profile_tokens


def range_digest(los: Sequence, his: Sequence) -> str:
    """Content key of the per-class input annotation."""
    h = hashlib.sha256()
    for lo, hi in zip(los, his):
        a = np.ascontiguousarray(np.asarray(lo, np.float64))
        b = np.ascontiguousarray(np.asarray(hi, np.float64))
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
        h.update(b.tobytes())
    return h.hexdigest()[:32]


def params_device(params) -> torch.device:
    """The device of the first tensor leaf: where the analysis runs."""
    for leaf in _leaves(params):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def _as_store_hit(hit: CertificateSet, t0: float) -> CertificateSet:
    """A store hit, marked as such WITHOUT mutating the LRU-cached object."""
    return dataclasses.replace(hit, meta=dict(
        hit.meta, from_store=True,
        lookup_seconds=time.perf_counter() - t0))


def _satisfied_by(k: Optional[int]) -> List[str]:
    if k is None:
        return []
    return sorted(f.name for f in F.REGISTRY.values() if f.k >= k)


def certify(
    forward,
    params,
    class_los: Sequence,
    class_his: Sequence,
    p_star: Optional[float] = None,
    *,
    abs_tol: Optional[float] = None,
    model_id: str,
    class_keys: Optional[Sequence[str]] = None,
    cfg: CaaConfig = caa.DEFAULT_CONFIG,
    store: Optional[CertificateStore] = None,
    k_min: int = 2,
    k_max: int = 53,
    weights_exact: bool = True,
    use_ladder: bool = True,
    mixed: bool = False,
    mixed_scopes: Optional[Sequence[str]] = None,
    layer_flops: Optional[Dict[str, float]] = None,
    formats: bool = False,
    format_opts: Optional[Dict] = None,
) -> CertificateSet:
    """The batched certificate pipeline (the reference's arguments).

    ``class_los[c]/class_his[c]`` annotate the input for class c (paper
    §V). The decision target is ``p_star`` (``forward`` returns softmax
    probabilities; bounds must fit the top-1 margins) or ``abs_tol``
    (absolute output error ≤ abs_tol). ``use_ladder`` routes the required-k
    search through :class:`repro_torch.certify.batch.ProbeLadder`, whose
    final ks are eagerly confirmed; ``mixed`` adds the greedy per-layer
    descent (:mod:`repro_torch.certify.mixed`), ``formats`` the full-format
    synthesis (:mod:`repro_torch.certify.formats`; ``format_opts`` reach
    :func:`synthesize_formats`). The analysis runs on the params' device;
    the meta records ``from_store`` and the end-to-end seconds."""
    if (p_star is None) == (abs_tol is None):
        raise ValueError("pass exactly one of p_star / abs_tol")
    t0 = time.perf_counter()
    digest = params_digest(params)
    rkey = range_digest(class_los, class_his)
    n = len(class_los)
    class_keys = list(class_keys or (f"class{c}" for c in range(n)))
    if len(class_keys) != n or len(class_his) != n:
        raise ValueError(
            f"{n} class ranges but {len(class_his)} highs / "
            f"{len(class_keys)} class_keys")
    # everything that changes the proven facts OR their labelling is part
    # of the address
    target = {"p_star": p_star, "abs_tol": abs_tol,
              "k_min": k_min, "k_max": k_max,
              "weights_exact": weights_exact,
              "class_keys": class_keys}
    if mixed:
        target["mixed"] = {"scopes": (list(mixed_scopes)
                                      if mixed_scopes is not None else None)}
    if formats:
        target["formats"] = {"opts": dict(format_opts or {}),
                             "scopes": (list(mixed_scopes)
                                        if mixed_scopes is not None
                                        else None)}
    key = request_key(model_id, digest, rkey, cfg, target=target)
    if store is not None:
        with obs.span("store_lookup"):
            hit = store.get(key, expect_params_digest=digest)
        if hit is not None:
            obs.event("certify.store_hit", key=key[:12])
            return _as_store_hit(hit, t0)

    x = B.stack_class_ranges(class_los, class_his,
                             device=params_device(params))
    feasible = (B.margin_feasibility(p_star) if p_star is not None
                else B.tolerance_feasibility(abs_tol))
    ladder = (B.ProbeLadder(forward, params, x, cfg=cfg,
                            weights_exact=weights_exact)
              if use_ladder else None)
    with obs.span("required_k_search", classes=n) as _sp:
        ks, reports = B.required_k_batched(
            forward, params, x, feasible,
            cfg=cfg, k_min=k_min, k_max=k_max, weights_exact=weights_exact,
            ladder=ladder,
        )
        _sp.set(ks=[None if np.isnan(v) else int(v) for v in ks],
                compiles=None if ladder is None else ladder.compiles)

    plan = None
    fplan = None
    certifiable_all = not np.isnan(ks).any()
    if (mixed or formats) and certifiable_all and mixed_scopes is None:
        # the eager reports already walked the model: their seen-scope
        # paths give the layer granularity
        mixed_scopes = scope_prefixes(next(iter(reports.values())).scopes)
    if mixed and certifiable_all:
        with obs.span("mixed_descent") as _sp:
            plan = MX.greedy_mixed_assignment(
                forward, params, x, feasible, int(np.max(ks)),
                scope_keys=mixed_scopes, cfg=cfg, k_min=k_min,
                weights_exact=weights_exact,
            )
            _sp.set(feasible=plan.feasible, probes=plan.probes,
                    compiles=plan.compiles)
    if formats and certifiable_all:
        with obs.span("format_synthesis") as _sp:
            fplan = FS.synthesize_formats(
                forward, params, x, feasible, int(np.max(ks)),
                layer_k=(dict(plan.layer_k)
                         if plan is not None and plan.feasible else None),
                scope_keys=mixed_scopes, cfg=cfg, weights_exact=weights_exact,
                **(format_opts or {}),
            )
            _sp.set(feasible=fplan.feasible, probes=fplan.probes,
                    compiles=fplan.compiles)
    layer_format = (fplan.formats_dict()
                    if fplan is not None and fplan.feasible else None)
    certs = []
    for c in range(n):
        k = None if np.isnan(ks[c]) else int(ks[c])
        # bounds of the probe at this class's certified precision (for an
        # uncertifiable class: the deepest probe, as a diagnostic)
        probe_k = k if k is not None else k_max
        rep = reports[probe_k]
        abs_c, rel_c = rep.per_class(c)
        certs.append(Certificate(
            model_id=model_id,
            params_digest=digest,
            class_key=class_keys[c],
            cfg=dataclasses.replace(cfg, u_max=2.0 ** (1 - probe_k)),
            bounds_u_max=2.0 ** (1 - probe_k),
            final_abs_u=abs_c,
            final_rel_u=rel_c,
            required_k=k,
            satisfied_by=_satisfied_by(k),
            trace_summary=trace_summary(rep.layers),
            p_star=p_star,
            layer_k=None if plan is None else dict(plan.layer_k),
            layer_format=layer_format,
            meta={"range_digest": rkey, "abs_tol": abs_tol},
        ))
    dt = time.perf_counter() - t0
    meta = {
        "from_store": False,
        "analysis_seconds": dt,
        "probes": (sorted(set(ladder.ks_probed) | set(reports))
                   if ladder is not None else sorted(reports)),
        "n_classes": n,
        "batched": True,
        "abs_tol": abs_tol,
    }
    if ladder is not None:
        meta["ladder_compiles"] = ladder.compiles
    if mixed:
        if plan is None:
            meta["mixed"] = {"applied": False,
                             "reason": "some class is uncertifiable"}
        else:
            meta["mixed"] = {
                "applied": True,
                "layer_k": dict(plan.layer_k),
                "uniform_k": plan.uniform_k,
                "mean_k_flop_weighted": plan.mean_k(layer_flops),
                "savings_k_flop_weighted": plan.savings(layer_flops),
                "sensitivity_abs_u": {s: float(v)
                                      for s, v in plan.sensitivity.items()},
                "probes": plan.probes,
                "ladder_compiles": plan.compiles,
            }
    if formats:
        if fplan is None:
            meta["formats"] = {"applied": False,
                               "reason": "some class is uncertifiable"}
        elif not fplan.feasible:
            meta["formats"] = {
                "applied": False,
                "reason": "no jointly-feasible format map confirmed",
                "history": fplan.history,
            }
        else:
            meta["formats"] = {
                "applied": True,
                "layer_format": layer_format,
                "uniform_k": fplan.uniform_k,
                "abs_u_ref": [float(v) for v in fplan.abs_u],
                "rel_u_ref": [float(v) for v in fplan.rel_u],
                "k_ref": int(fplan.k_ref),
                "baseline_bits": fplan.baseline_bits,
                "mean_bits_flop_weighted": fplan.mean_bits(layer_flops),
                "savings_bits_flop_weighted":
                    fplan.savings_bits(layer_flops),
                "scope_ranges": {s: r.to_dict()
                                 for s, r in fplan.scope_ranges.items()},
                "emax_floor_bits": dict(fplan.emax_floor),
                "history": fplan.history,
                "probes": fplan.probes,
                "ladder_compiles": fplan.compiles,
            }
    cs = CertificateSet(
        model_id=model_id,
        params_digest=digest,
        certificates=certs,
        p_star=p_star,
        meta=meta,
    )
    if store is not None:
        with obs.span("store_put"):
            store.put(key, cs, request={
                "model_id": model_id, "range_digest": rkey,
                "p_star": p_star})
    return cs


# ---------------------------------------------------------------------------
# LM serving certificates
# ---------------------------------------------------------------------------

def _lm_probe(arch_cfg, params, tokens, k: int):
    """One emulated-k CAA pass over the arch: per-sequence argmax safety of
    the final-position logits and the certified actual error of the
    emulated run, as host numbers (no device tensor is kept)."""
    from repro_torch.models import transformer as T

    ccfg = CaaConfig(u_max=2.0 ** (1 - k), emulate_k=k)
    bk = CaaOps(ccfg)
    logits, _ = T.forward(bk, params, arch_cfg, tokens)
    last = caa.slice_(logits, (slice(None), slice(-1, None)))
    del logits
    lo = last.exact.lo.cpu().numpy()[:, 0]
    hi = last.exact.hi.cpu().numpy()[:, 0]
    preds = torch.argmax(last.val, dim=-1).cpu().numpy()[:, 0]
    safe = np.array([
        precision.classification_safe(lo[i], hi[i], int(preds[i]))
        for i in range(lo.shape[0])
    ])
    a_abs, a_rel = caa.actual_error_in_u(last, ccfg.u_max)
    return {
        "safe": bool(safe.all()),
        "abs_u": float(torch.max(a_abs)),
        # +inf propagates (the paper's "no bound of this kind")
        "rel_u": float(torch.max(a_rel)),
        "trace": bk.trace,
        "preds": preds,
    }


def _lm_setup(arch_name: str, arch_cfg, params, device):
    """(arch_cfg, params) of a certification: the arch's SMOKE config and
    the port's own seeded params (``torch.Generator`` seed 0 on
    ``device``) where the caller gives none."""
    from repro_torch import configs
    from repro_torch.models import transformer as T

    if arch_cfg is None:
        arch_cfg = configs.get(arch_name).SMOKE
    T.check_supported(arch_cfg)
    if params is None:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to certify on the CPU")
        params = T.init_params(
            arch_cfg, generator=torch.Generator(device=dev).manual_seed(0),
            device=dev)
    return arch_cfg, params


#: the decision the layer-stacked LM pipeline certifies (part of its key)
STACKED_CRITERION = "decode argmax pinned (parametric margins)"


def serving_request(arch_name: str, arch_cfg, digest: str, *, seq: int = 8,
                    batch: int = 1, seed: int = 1, k_min: int = 4,
                    k_max: int = 24, mixed: bool = False,
                    formats: bool = False, profiles: Sequence[int] = (),
                    format_opts: Optional[Dict] = None,
                    ) -> Tuple[str, Dict[str, Any]]:
    """(store key, request record) of the LM certification for the params
    whose :func:`params_digest` is ``digest``: the reference's key for the
    same request. Keyword arguments and defaults are :func:`certify_lm`'s;
    ``mixed`` / ``formats`` select the stacked pipeline's key."""
    class_key = f"lm/{arch_cfg.name}/tokens[{batch}x{seq}]seed{seed}"
    if mixed or formats:
        cfg = dataclasses.replace(caa.DEFAULT_CONFIG,
                                  u_max=2.0 ** (1 - k_max))
        target: Dict[str, Any] = {
            "criterion": STACKED_CRITERION,
            "k_min": k_min, "k_max": k_max,
            "mixed": bool(mixed), "formats": bool(formats),
            "profiles": sorted({int(p) for p in profiles}),
        }
        if formats:
            target["format_opts"] = dict(format_opts or {})
    else:
        cfg = CaaConfig(u_max=2.0 ** (1 - k_max), emulate_k=k_max)
        target = {"argmax_safe": True, "k_min": k_min, "k_max": k_max}
    model_id = f"lm/{arch_name}"
    key = request_key(model_id, digest, class_key, cfg, target=target)
    return key, {"model_id": model_id, "class_key": class_key}


def certify_lm(
    arch_name: str,
    arch_cfg=None,
    params=None,
    *,
    seq: int = 8,
    batch: int = 1,
    seed: int = 1,
    k_min: int = 4,
    k_max: int = 24,
    store: Optional[CertificateStore] = None,
    mixed: bool = False,
    formats: bool = False,
    profiles: Sequence[int] = (),
    layer_flops: Optional[Dict[str, float]] = None,
    format_opts: Optional[Dict] = None,
    device: str = "cuda",
) -> CertificateSet:
    """Certified serving precision for an architecture.

    Binary-searches the smallest k (u = 2^(1-k)) at which the k-bit
    emulated model's next-token argmax is rigorously pinned by the CAA
    enclosure on the certification profile (``batch`` × ``seq`` tokens
    drawn from ``seed`` as the reference draws them). ``mixed`` /
    ``formats`` switch to :func:`repro_torch.certify.lm.certify_lm_stacked`
    (per-layer k maps and per-scope formats; ``profiles`` widen its range
    evidence). The analysis runs where ``params`` live; ``device`` only
    places the seeded params made when none are given (the card unless
    ``"cpu"`` is asked for)."""
    if mixed or formats:
        from .lm import certify_lm_stacked

        return certify_lm_stacked(
            arch_name, arch_cfg, params, seq=seq, batch=batch, seed=seed,
            k_min=k_min, k_max=k_max, mixed=mixed, formats=formats,
            profiles=profiles, store=store, layer_flops=layer_flops,
            format_opts=format_opts, device=device)

    t0 = time.perf_counter()
    arch_cfg, params = _lm_setup(arch_name, arch_cfg, params, device)
    digest = params_digest(params)
    key, request = serving_request(arch_name, arch_cfg, digest, seq=seq,
                                   batch=batch, seed=seed, k_min=k_min,
                                   k_max=k_max)
    class_key = request["class_key"]
    if store is not None:
        with obs.span("store_lookup"):
            hit = store.get(key, expect_params_digest=digest)
        if hit is not None:
            obs.event("certify.store_hit", key=key[:12])
            return _as_store_hit(hit, t0)
    tokens = profile_tokens(seed, batch, seq, arch_cfg.vocab,
                            params_device(params))

    probes: Dict[int, dict] = {}

    def probe(k: int) -> dict:
        if k not in probes:
            with obs.span("lm_probe", k=k):
                probes[k] = _lm_probe(arch_cfg, params, tokens, k)
        return probes[k]

    with obs.span("uniform_search", k_min=k_min, k_max=k_max) as _sp:
        if not probe(k_max)["safe"]:
            required = None
        else:
            lo, hi = k_min, k_max      # invariant: hi safe
            while lo < hi:
                mid = (lo + hi) // 2
                if probe(mid)["safe"]:
                    hi = mid
                else:
                    lo = mid + 1
            required = hi
        _sp.set(required_k=required, probes=len(probes))
    rep = probes[required if required is not None else k_max]
    kcfg = CaaConfig(
        u_max=2.0 ** (1 - (required if required is not None else k_max)),
        emulate_k=required if required is not None else k_max,
    )
    cert = Certificate(
        model_id=f"lm/{arch_name}",
        params_digest=digest,
        class_key=class_key,
        cfg=kcfg,
        bounds_u_max=kcfg.u_max,
        final_abs_u=rep["abs_u"],
        final_rel_u=rep["rel_u"],
        required_k=required,
        satisfied_by=_satisfied_by(required),
        trace_summary=trace_summary(rep["trace"]),
        p_star=None,
        meta={"criterion": "decode argmax rigorously pinned",
              "sample_next_tokens": [int(t) for t in rep["preds"][:4]]},
    )
    dt = time.perf_counter() - t0
    cs = CertificateSet(
        model_id=f"lm/{arch_name}",
        params_digest=digest,
        certificates=[cert],
        p_star=None,
        meta={"from_store": False, "analysis_seconds": dt,
              "probes": sorted(probes), "arch": arch_name},
    )
    if store is not None:
        with obs.span("store_put"):
            store.put(key, cs, request=request)
    return cs


def serving_certificate(arch_name: str, arch_cfg, params, store_dir: str,
                        **kw) -> CertificateSet:
    """What the serving path calls: store-first LM certification. A hit is
    marked ``from_store``; a miss certifies (``kw`` are
    :func:`certify_lm`'s) and persists the set under the same key."""
    return certify_lm(arch_name, arch_cfg, params,
                      store=CertificateStore(store_dir), **kw)
