"""The serving side of the certificate pipeline: :func:`serving_certificate`.

The counterpart of the JAX package's ``repro.certify.pipeline.
serving_certificate`` for a language model: it computes the store key
exactly as the reference's ``certify_lm`` (uniform k) and
``certify_lm_stacked`` (``mixed`` / ``formats``) do — the class key of the
certification profile, the decision target and the analysis config at
u_max = 2^(1 - k_max) — and reads the store. An entry the JAX package
certified for the same numbers is served from here.

The analysis that certifies an LM is not ported yet: on a miss this module
raises, where the reference certifies on first use. Nothing certifies
silently.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Sequence, Tuple

from .spec import CaaConfig, CertificateSet
from .store import CertificateStore, params_digest, request_key


def serving_request(arch_name: str, arch_cfg, digest: str, *, seq: int = 8,
                    batch: int = 1, seed: int = 1, k_min: int = 4,
                    k_max: int = 24, mixed: bool = False,
                    formats: bool = False, profiles: Sequence[int] = (),
                    format_opts: Optional[Dict] = None,
                    ) -> Tuple[str, Dict[str, Any]]:
    """(store key, request record) of the reference's LM certification for
    the params whose :func:`params_digest` is ``digest``. Keyword arguments
    and defaults are ``certify_lm``'s; ``mixed`` / ``formats`` select the
    stacked pipeline's key, as the reference's ``certify_lm`` does."""
    class_key = f"lm/{arch_cfg.name}/tokens[{batch}x{seq}]seed{seed}"
    if mixed or formats:
        cfg = CaaConfig(u_max=2.0 ** (1 - k_max))
        target: Dict[str, Any] = {
            "criterion": "decode argmax pinned (parametric margins)",
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


def serving_certificate(arch_name: str, arch_cfg, params, store_dir: str,
                        **kw) -> CertificateSet:
    """What the serving path calls: the stored certificate set for (arch,
    exact params, request ``kw``), marked ``from_store``. A miss raises:
    certifying on first use waits for the certification pipeline."""
    t0 = time.perf_counter()
    digest = params_digest(params)
    key, _ = serving_request(arch_name, arch_cfg, digest, **kw)
    store = CertificateStore(store_dir)
    hit = store.get(key, expect_params_digest=digest)
    if hit is None:
        raise LookupError(
            f"no certificate for lm/{arch_name} (params {digest[:12]}…, key "
            f"{key[:12]}…) in {store_dir}: certifying on first use waits for "
            "the port of the certification pipeline (ROADMAP §1 item 7); "
            "certify with the JAX package into this store, or serve a "
            "certificate set with --certificate-set")
    return dataclasses.replace(hit, meta=dict(
        hit.meta, from_store=True, lookup_seconds=time.perf_counter() - t0))
