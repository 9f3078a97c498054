"""Scope-path matching & per-scope value resolution (string and stacked).

A plain-Python copy of the JAX package's ``repro.core.scopes``: the port
resolves certificate maps exactly as the reference does.

Every backend tracks the model's scope path ("layer3/attn", ...); certified
per-scope maps — ``{scope: k}``, ``{scope: FpFormat}``, ``{scope:
round_scale}`` — are resolved against that path both by the analysis
backends (scope-gated CAA knobs) and by the serving backends (per-scope
quantisation). This module is the single home of that resolution so the
analysis and serving sides can never drift apart.

Two kinds of keys resolve:

  * **string keys** — ``"block1"``/``"block1/inner"``: matched as a
    contiguous run of '/'-separated path segments (``"block1"`` never
    matches inside ``"block10"``), most specific (longest) key wins;
  * **stacked keys** — the wildcard segment :data:`STACK_SCOPE`
    (``"layer*"``), which matches any concrete ``layer<i>`` path segment.
    When its mapped value is an ``[L]``-shaped array/sequence, resolution
    *indexes it by the matched layer number*: ``{"layer*": ks}`` resolves
    ``layer3/attn`` to ``ks[3]``. This is the map form the scan-native
    analysis (the JAX package's ``StackedCaaOps``) and the scanned
    serving backends exchange: one ``[L]`` lane vector instead of L string
    entries.

A concrete key (``"layer3"``) always beats the wildcard at equal depth.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Sequence

# The wildcard segment a scan-stacked layer_loop pushes: one traced body
# analyses all L layers, so the scope path cannot name a concrete layer.
STACK_SCOPE = "layer*"

_LAYER_RE = re.compile(r"^layer(\d+)$")


def _segment_matches(want: str, have: str) -> bool:
    """Does key segment ``want`` match path segment ``have``?"""
    if want == have:
        return True
    return want == STACK_SCOPE and _LAYER_RE.match(have) is not None


def scope_active(active: str, scope: Sequence[str]) -> bool:
    """True iff ``active``'s '/'-separated segments appear as a contiguous
    run of the current scope path's segments. Substring matching is wrong
    here: layer 'block1' must not activate inside 'block10'. The
    :data:`STACK_SCOPE` wildcard segment matches any ``layer<i>``."""
    parts = [seg for s in scope for seg in s.split("/")]
    want = active.split("/")
    return any(
        all(_segment_matches(w, parts[i + j]) for j, w in enumerate(want))
        for i in range(len(parts) - len(want) + 1)
    )


def _layer_index_of(active: str, scope: Sequence[str]):
    """Layer number bound by ``active``'s wildcard segment against ``scope``
    (None when the key has no wildcard or binds no concrete layer)."""
    parts = [seg for s in scope for seg in s.split("/")]
    want = active.split("/")
    for i in range(len(parts) - len(want) + 1):
        if all(_segment_matches(w, parts[i + j]) for j, w in enumerate(want)):
            for j, w in enumerate(want):
                if w == STACK_SCOPE:
                    m = _LAYER_RE.match(parts[i + j])
                    if m:
                        return int(m.group(1))
            return None
    return None


def _maybe_index(value, idx):
    """Index an [L]-shaped mapped value by the bound layer number; scalars
    and values bound by a non-wildcard key pass through unchanged."""
    if idx is None:
        return value
    if isinstance(value, (list, tuple)):
        return value[idx]
    if hasattr(value, "ndim") and getattr(value, "ndim", 0) >= 1:
        return value[idx]
    return value


def resolve_scope_value(path: Sequence[str], mapping: Dict[str, Any],
                        default):
    """Value of the most specific map key matching ``path``.

    Specificity is (segment count, number of exact segments): a concrete
    ``"layer3"`` beats the ``"layer*"`` wildcard at equal depth; ties keep
    the later key (dict order), matching the historical behaviour.
    ``default`` covers ops outside every mapped scope. A wildcard key whose
    value is an ``[L]`` array/sequence is indexed by the matched layer
    number (``layer3/attn`` through ``{"layer*": ks}`` → ``ks[3]``).
    Shared by the mixed/format analyses (scope → round_scale/round_abs) and
    the serving backends (scope → quantisation k / format triple).
    """
    best, best_spec = default, (0, -1)
    for key, v in mapping.items():
        segs = key.split("/")
        spec = (len(segs), sum(s != STACK_SCOPE for s in segs))
        if spec >= best_spec and path and scope_active(key, path):
            best = _maybe_index(v, _layer_index_of(key, path))
            best_spec = spec
    return best


def scope_prefixes(paths: Sequence[str], depth: int = 1) -> List[str]:
    """Unique ``depth``-segment prefixes of scope paths, first-seen order."""
    out: List[str] = []
    seen = set()
    for path in paths:
        prefix = "/".join(path.split("/")[:depth])
        if prefix not in seen:
            seen.add(prefix)
            out.append(prefix)
    return out


def expand_stacked(scopes: Sequence[str], n_layers: int) -> List[str]:
    """Replace the :data:`STACK_SCOPE` wildcard with concrete per-layer
    names: ``["embed", "layer*", "head"]`` → ``["embed", "layer0", ...,
    "layer{L-1}", "head"]`` — the key set a stacked analysis certifies at
    (certificates store concrete names; the wildcard is an analysis-side
    encoding)."""
    out: List[str] = []
    for s in scopes:
        if s == STACK_SCOPE or s.startswith(STACK_SCOPE + "/"):
            suffix = s[len(STACK_SCOPE):]
            for i in range(n_layers):
                name = f"layer{i}{suffix}"
                if name not in out:
                    out.append(name)
        elif s not in out:
            out.append(s)
    return out
