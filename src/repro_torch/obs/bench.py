"""Machine-readable benchmark trajectory of the port: append-only
``BENCH_torch_*.json`` (the PyTorch port's counterpart of the JAX
package's ``repro.obs.bench``).

Each ``BENCH_torch_<name>.json`` at the repository root is one JSON
*array* of run entries. :func:`append_bench` does an atomic
read-modify-replace, so a crashed run never leaves a truncated file, and
stamps every entry with a wall-clock time plus whatever the caller
measured::

    append_bench("runs", {"kind": "certify", "arch": "digits", ...})

``$REPRO_TORCH_BENCH_DIR`` (or an explicit ``directory``) overrides the
root; the tests point it at a temporary directory.

The port's files are its own: it never reads or writes the JAX package's
``BENCH_*.json``, and it keeps no snapshot under ``benchmarks/`` — the
reference mirrors every write there for its CI readers and seeds its root
file from that mirror, and the port leaves both out.

Repeated runs in one process with the same identity fields
(``kind``/``arch`` and the flag-like values) replace their previous entry
instead of appending a duplicate, as in the reference.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

_BENCH_DIR_ENV = "REPRO_TORCH_BENCH_DIR"
_PREFIX = "BENCH_torch_"

#: entry fields that identify "the same benchmark point" for in-session
#: dedupe: same values → the new entry replaces the old one
_IDENTITY_FIELDS = ("kind", "arch", "mixed", "formats", "profiles",
                    "mantissa_mode", "kernel", "case", "flags")

#: (name, dir, identity) → index appended this session
_session_keys: Dict[Tuple[str, str, str], int] = {}


def repo_root() -> str:
    # src/repro_torch/obs/bench.py → the repository root is three
    # directories up from obs/
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


def bench_dir(explicit: Optional[str] = None) -> str:
    """The repository root (or ``$REPRO_TORCH_BENCH_DIR`` / ``explicit``)."""
    if explicit:
        return explicit
    env = os.environ.get(_BENCH_DIR_ENV)
    if env:
        return env
    return repo_root()


def bench_path(name: str, directory: Optional[str] = None) -> str:
    return os.path.join(bench_dir(directory), f"{_PREFIX}{name}.json")


def _read_array(path: str) -> List[Dict[str, Any]]:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, list):
        raise ValueError(f"{path}: expected a JSON array of run entries")
    return data


def _dedupe(entries: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Drop exact-duplicate entries, keeping first-occurrence order."""
    seen = set()
    out = []
    for e in entries:
        key = json.dumps(e, sort_keys=True, default=str)
        if key not in seen:
            seen.add(key)
            out.append(e)
    return out


def read_bench(name: str, directory: Optional[str] = None
               ) -> List[Dict[str, Any]]:
    """The trajectory for ``name`` (empty before its first entry)."""
    return _dedupe(_read_array(bench_path(name, directory)))


def _identity(entry: Dict[str, Any]) -> Optional[str]:
    picked = {f: entry[f] for f in _IDENTITY_FIELDS if f in entry}
    if not picked:
        return None
    return json.dumps(picked, sort_keys=True, default=str)


def _write_atomic(path: str, entries: List[Dict[str, Any]]):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(entries, f, indent=1)
        f.write("\n")
    os.replace(tmp, path)


def append_bench(name: str, entry: Dict[str, Any],
                 directory: Optional[str] = None) -> str:
    """Append one run entry (timestamped) to BENCH_torch_<name>.json,
    atomically; a same-session entry with identical identity fields
    replaces the one it supersedes. Returns the file's path."""
    path = bench_path(name, directory)
    entries = read_bench(name, directory)
    stamped = {"t": time.time(), **entry}

    ident = _identity(stamped)
    skey = (name, bench_dir(directory), ident or "")
    replaced = False
    if ident is not None and skey in _session_keys:
        idx = _session_keys[skey]
        if 0 <= idx < len(entries) and _identity(entries[idx]) == ident:
            entries[idx] = stamped
            replaced = True
    if not replaced:
        entries.append(stamped)
    if ident is not None:
        _session_keys[skey] = (idx if replaced else len(entries) - 1)
    _write_atomic(path, entries)
    return path


def check_regressions(name: str = "kernels", threshold: float = 0.25,
                      directory: Optional[str] = None
                      ) -> List[Dict[str, Any]]:
    """Soft perf gate: the LAST trajectory entry's kernel medians against
    the previous entry's, flagging rows whose ``median_s`` grew by more
    than ``threshold`` (0.25 = +25 %). Rows are identified by ``kernel``
    and their optional shape/k/emax/emin/block fields. Empty when there
    are fewer than two entries."""
    entries = read_bench(name, directory)
    if len(entries) < 2:
        return []
    prev, last = entries[-2], entries[-1]

    def _rowkey(r: Dict[str, Any]) -> str:
        return json.dumps({f: r[f] for f in
                           ("kernel", "shape", "k", "emax", "emin", "block")
                           if f in r}, sort_keys=True, default=str)

    prev_rows = {_rowkey(r): r for r in prev.get("rows", [])
                 if r.get("median_s")}
    findings = []
    for r in last.get("rows", []):
        p = prev_rows.get(_rowkey(r))
        if not p or not r.get("median_s"):
            continue
        ratio = r["median_s"] / p["median_s"]
        if ratio > 1.0 + threshold:
            findings.append({
                "kernel": r.get("kernel"), "shape": r.get("shape"),
                "k": r.get("k"), "block": r.get("block"),
                "prev_median_s": p["median_s"],
                "last_median_s": r["median_s"],
                "ratio": ratio,
            })
    return findings
