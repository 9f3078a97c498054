"""Certificate schema, read side: the precision facts the analyser proves.

The PyTorch port's copy of the JAX package's ``repro.certify.spec``: the
same dataclasses and the same JSON, so a certificate set the JAX package
wrote loads here and writes back byte for byte. :class:`CaaConfig` is the
analysis's own (:mod:`repro_torch.core.caa`), field for field the
reference's.

A :class:`Certificate` is one (model, params, input-range/class) precision
fact — everything Table I of the paper reports for one class run, plus the
identifiers that make it safe to reuse: the params digest pins the exact
weights the bounds were proven for, the class key pins the input annotation,
and the :class:`CaaConfig` pins the analysis semantics
(accumulation order, trajectory mode, u_max). A :class:`CertificateSet`
bundles all classes of one model into the unit the store persists and the
serving path loads.

JSON round-trip notes: bounds are routinely ``+inf`` ("no bound of this
kind", the paper's convention) — Python's json emits/parses the literal
``Infinity`` for these, which we rely on; everything else is plain JSON.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

from repro_torch.core import formats
from repro_torch.core.caa import CaaConfig

# v1 (PR 1): uniform per-class required_k only.
# v2 (PR 2): adds the per-layer mixed-precision map ``layer_k`` (+ mixed meta).
# v3: adds ``layer_format`` — full per-scope FpFormat descriptors
#     (k, emax, emin, subnormal/saturation flags) certified by the format
#     synthesizer (repro.certify.formats): mantissa AND exponent range.
# Readers accept all three; writers emit v3 (and the store's content key
# carries the writer schema, so newer entries never shadow older addresses).
SCHEMA_VERSION = 3
_READABLE_SCHEMAS = (1, 2, 3)


def _cfg_to_dict(cfg: CaaConfig) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def _cfg_from_dict(d: Dict[str, Any]) -> CaaConfig:
    known = {f.name for f in dataclasses.fields(CaaConfig)}
    return CaaConfig(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass(frozen=True)
class Certificate:
    """One rigorous precision fact: bounds + the decision they license.

    Attributes:
      model_id: stable name of the analysed network (e.g. "digits/h64x32").
      params_digest: sha256 over the exact parameter tensors (see
        the JAX package's ``repro.certify.store.params_digest``) — any
        retrain/finetune changes it and invalidates the certificate.
      class_key: identifies the input annotation this was proven for
        (classifier class envelope, LM input profile, ...).
      cfg: the per-class-equivalent CaaConfig of the analysis.
      bounds_u_max: the u at which ``final_abs_u``/``final_rel_u`` were
        computed (bounds are sound for any format with u ≤ bounds_u_max).
      final_abs_u / final_rel_u: output δ̄ / ε̄ in units of u (+inf = no
        bound of that kind at this u_max).
      required_k: smallest mantissa precision k (implicit bit included)
        at which the certified property holds; None if uncertifiable.
      layer_k: per-layer mixed-precision map {layer_scope: k} (v2) — a
        rigorous refinement of required_k: serving each mapped scope's
        matmuls at its own k (everything else at required_k) still satisfies
        the certified property. None = uniform-only certificate (v1).
      layer_format: per-scope FULL format map {layer_scope: FpFormat
        descriptor dict} (v3): each scope's matmuls served in its own
        (k, emax, emin) custom format — overflow-freedom proven by IA range
        analysis at the chosen emax, underflow absorption folded into the
        bounds as the λ·2^{emin-(k-1)} absolute term. The ``""`` key is the
        default format for scopes outside the map. None = range-unbounded
        certificate (v1/v2).
      satisfied_by: standard formats with k ≥ required_k.
      trace_summary: the dominant per-layer records of the analysis pass
        (name, kind, out_mag, max_dbar, max_ebar) — the debugging view.
      meta: free-form extras (margins used, analysis seconds, ...).
    """

    model_id: str
    params_digest: str
    class_key: str
    cfg: CaaConfig
    bounds_u_max: float
    final_abs_u: float
    final_rel_u: float
    required_k: Optional[int]
    satisfied_by: List[str]
    trace_summary: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    p_star: Optional[float] = None
    layer_k: Optional[Dict[str, int]] = None
    layer_format: Optional[Dict[str, Dict[str, Any]]] = None
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def u(self) -> Optional[float]:
        """The unit of the certified format, u = 2^{1-k}."""
        return None if self.required_k is None else 2.0 ** (1 - self.required_k)

    def format(self) -> Optional[formats.FpFormat]:
        return None if self.required_k is None else formats.custom(self.required_k)

    def error_bars(self) -> Dict[str, float]:
        """The (δ̄, ε̄, k) triple served alongside responses."""
        bars = {
            "dbar_u": self.final_abs_u,
            "ebar_u": self.final_rel_u,
            "k": self.required_k,
            "u": self.u,
        }
        if self.layer_k is not None:
            bars["layer_k"] = dict(self.layer_k)
        if self.layer_format is not None:
            bars["layer_format"] = {s: dict(f)
                                    for s, f in self.layer_format.items()}
        return bars

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["cfg"] = _cfg_to_dict(self.cfg)
        d["schema_version"] = SCHEMA_VERSION
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Certificate":
        d = dict(d)
        version = d.pop("schema_version", 1)
        if version not in _READABLE_SCHEMAS:
            raise ValueError(
                f"certificate schema v{version} is newer than this reader "
                f"(understands {_READABLE_SCHEMAS})")
        d["cfg"] = _cfg_from_dict(d["cfg"])
        if d.get("layer_k") is not None:
            d["layer_k"] = {str(s): int(k) for s, k in d["layer_k"].items()}
        if d.get("layer_format") is not None:
            # round-trip through FpFormat so descriptors are validated and
            # normalised (unknown keys dropped, defaults filled)
            d["layer_format"] = {
                str(s): formats.from_dict(f).to_dict()
                for s, f in d["layer_format"].items()}
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=None, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Certificate":
        return cls.from_dict(json.loads(s))


@dataclasses.dataclass
class CertificateSet:
    """All certificates of one (model, params, analysis request).

    ``serving_k`` is what the serving path consumes: the smallest precision
    that simultaneously satisfies every class certificate (max over the
    per-class required_k).
    """

    model_id: str
    params_digest: str
    certificates: List[Certificate]
    p_star: Optional[float] = None
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def serving_k(self) -> Optional[int]:
        ks = [c.required_k for c in self.certificates]
        if not ks or any(k is None for k in ks):
            return None
        return max(ks)

    @property
    def serving_layer_k(self) -> Optional[Dict[str, int]]:
        """The per-layer map the serving path may apply: for every scope any
        class certified, the pointwise max over classes of that class's
        demand there — its mapped k, or its uniform required_k for a scope
        absent from its own map (that class never certified lowering that
        scope, so only its uniform k is proven for it). The coarsest-demand
        merge is therefore sound for all classes simultaneously. None unless
        EVERY certificate is certifiable and carries a map (a class without
        one needs uniform serving_k everywhere, so no mixed map is jointly
        certified)."""
        if not self.certificates:
            return None
        for c in self.certificates:
            if c.layer_k is None or c.required_k is None:
                return None
        scopes = {s for c in self.certificates for s in c.layer_k}
        return {
            s: max(int(c.layer_k.get(s, c.required_k))
                   for c in self.certificates)
            for s in sorted(scopes)
        }

    @property
    def serving_layer_format(self) -> Optional[Dict[str, Dict[str, Any]]]:
        """The per-scope FULL-format map the serving path may apply: for
        each scope, the coarsest-demand merge over classes — k and emax
        pointwise max, emin pointwise min (every direction only shrinks
        rounding/underflow error and widens the overflow-free range, so the
        merged format is sound for every class simultaneously; a scope
        absent from a class's own map falls back to that class's ``""``
        default entry). None unless EVERY certificate carries a format map
        with consistent subnormal/saturation flags."""
        if not self.certificates:
            return None
        for c in self.certificates:
            if c.layer_format is None or "" not in c.layer_format:
                return None
        flags = {(f["has_subnormals"], f["saturating"])
                 for c in self.certificates
                 for f in c.layer_format.values()}
        if len(flags) != 1:
            return None
        subn, sat = next(iter(flags))
        scopes = {s for c in self.certificates for s in c.layer_format}
        out = {}
        for s in sorted(scopes):
            fs = [formats.from_dict(c.layer_format.get(s,
                                                       c.layer_format[""]))
                  for c in self.certificates]
            k = max(f.k for f in fs)
            emax = max(f.emax for f in fs)
            emin = min(f.emin for f in fs)
            merged = formats.FpFormat(
                f"custom_k{k}_e{emax}_{emin}", k=k, emax=emax, emin=emin,
                has_subnormals=bool(subn), saturating=bool(sat))
            # encoding-clipped entries (e4m3-style max_finite_override) cap
            # the provable range below the formula: the coarsest demand is
            # the LARGEST per-class max_finite (serving wider range is
            # sound), carried as an override when the formula overshoots it
            widest = max(f.max_finite for f in fs)
            if widest != merged.max_finite:
                merged = dataclasses.replace(merged,
                                             max_finite_override=widest)
            out[s] = merged.to_dict()
        return out

    def map_provenance(self) -> Dict[str, Dict[str, str]]:
        """Per-class provenance of the served maps: for each certificate
        that records one, ``{class_key: {"layer_k"|"layer_format":
        "synthesized"|"primary-confirmed"|"resynthesized"|"raised"|...}}``.
        "resynthesized" means the class rejected the primary profile's map
        and got its own greedy descent from its own margins; "raised" means
        the legacy raise-until-feasible fallback. Free-form meta, so v3
        certificates round-trip it with no schema change."""
        out: Dict[str, Dict[str, str]] = {}
        for c in self.certificates:
            prov = c.meta.get("map_provenance")
            if prov:
                out[c.class_key] = {str(k): str(v) for k, v in prov.items()}
        return out

    @property
    def worst_abs_u(self) -> float:
        return max((c.final_abs_u for c in self.certificates), default=float("inf"))

    @property
    def worst_rel_u(self) -> float:
        return max((c.final_rel_u for c in self.certificates), default=float("inf"))

    def lookup(self, class_key: str) -> Optional[Certificate]:
        for c in self.certificates:
            if c.class_key == class_key:
                return c
        return None

    def error_bars(self) -> Dict[str, Any]:
        """Set-level (δ̄, ε̄, k): worst bounds, the k that serves all classes
        (plus the merged per-layer map when every class certified one)."""
        k = self.serving_k
        bars = {
            "dbar_u": self.worst_abs_u,
            "ebar_u": self.worst_rel_u,
            "k": k,
            "u": None if k is None else 2.0 ** (1 - k),
        }
        lk = self.serving_layer_k
        if lk is not None:
            bars["layer_k"] = lk
        lf = self.serving_layer_format
        if lf is not None:
            bars["layer_format"] = lf
        return bars

    def summary(self) -> str:
        lines = [
            f"certificate set: {self.model_id} "
            f"(params {self.params_digest[:12]}…, {len(self.certificates)} classes)"
        ]
        for c in self.certificates:
            k = "—" if c.required_k is None else str(c.required_k)
            sat = ", ".join(c.satisfied_by[:3]) or "none"
            lines.append(
                f"  {c.class_key:24s} δ̄={c.final_abs_u:12.5g}u "
                f"ε̄={c.final_rel_u:12.5g}u  k={k:>3s}  [{sat}]"
            )
        k = self.serving_k
        lines.append(
            f"  serving precision: k={k} (u=2^{1 - k})" if k is not None
            else "  serving precision: uncertified"
        )
        lk = self.serving_layer_k
        if lk is not None:
            per = ", ".join(f"{s}:k={v}" for s, v in lk.items())
            lines.append(f"  mixed-precision map: {per}")
        lf = self.serving_layer_format
        if lf is not None:
            per = ", ".join(
                f"{s or '<default>'}:(k={f['k']},e[{f['emin']},{f['emax']}],"
                f"{1 + formats.exponent_bits(f['emax'], f['emin']) + f['k'] - 1}b)"
                for s, f in lf.items())
            lines.append(f"  certified formats: {per}")
        prov = self.map_provenance()
        if prov:
            per = "; ".join(
                f"{ck}: " + ",".join(f"{k}={v}" for k, v in sorted(p.items()))
                for ck, p in sorted(prov.items()))
            lines.append(f"  map provenance: {per}")
        return "\n".join(lines)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema_version": SCHEMA_VERSION,
            "model_id": self.model_id,
            "params_digest": self.params_digest,
            "p_star": self.p_star,
            "meta": self.meta,
            "certificates": [c.to_dict() for c in self.certificates],
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CertificateSet":
        version = d.get("schema_version", 1)
        if version not in _READABLE_SCHEMAS:
            raise ValueError(
                f"certificate-set schema v{version} is newer than this "
                f"reader (understands {_READABLE_SCHEMAS})")
        return cls(
            model_id=d["model_id"],
            params_digest=d["params_digest"],
            p_star=d.get("p_star"),
            meta=dict(d.get("meta", {})),
            certificates=[Certificate.from_dict(c) for c in d["certificates"]],
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "CertificateSet":
        return cls.from_dict(json.loads(s))



def trace_summary(records, top_n: int = 8) -> List[Dict[str, Any]]:
    """The dominant layers of a trace, JSON-ready (inf kept, nan dropped)."""
    import math

    def _key(r):
        v = r.max_dbar
        return -1.0 if math.isnan(v) else (math.inf if math.isinf(v) else v)

    ranked = sorted(records, key=_key, reverse=True)[:top_n]
    out = []
    for r in ranked:
        out.append({
            "name": r.name,
            "kind": r.kind,
            "shape": list(r.shape),
            "out_mag": None if math.isnan(r.out_mag) else r.out_mag,
            "max_dbar": None if math.isnan(r.max_dbar) else r.max_dbar,
            "max_ebar": None if math.isnan(r.max_ebar) else r.max_ebar,
        })
    return out
