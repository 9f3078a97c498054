"""Content-addressed certificate store, read side and ``put`` (PyTorch).

The counterpart of the JAX package's ``repro.certify.store``. The store
key is the sha256 of the canonical certification request — model id,
params digest, class/range key, CaaConfig, decision target — so a retrain
(new params digest) or a changed analysis (new CaaConfig) is a different
address, and stale entries can never be hit. A small in-memory LRU sits on
top, so the serving hot path touches disk only on first use.

Both packages compute the same digest for the same numbers and the same
key for the same request: an entry the JAX package wrote is found here
under the same address, and an entry :meth:`CertificateStore.put` writes
is found there. :func:`params_digest` rebuilds the string of a JAX pytree's
structure for nested dicts (sorted keys, ``*`` leaves, the
``PyTreeDef(...)`` wrapper) and hashes dtype, shape and bytes leaf by leaf;
a tensor on the card streams to the host in chunks, so a 30 GB model is
never copied whole.

Layout: ``<root>/<key>.json``, one CertificateSet per file, with the key
and the request stored alongside. Eviction (``gc``), the persistent stats
sidecar, ``entry_summary`` and ``invalidate_params`` come with the
certification pipeline.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import os
import tempfile
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch import obs
from .spec import SCHEMA_VERSION, CaaConfig, CertificateSet, _cfg_to_dict

# the names numpy (and JAX, for bfloat16) give the dtypes a digest records
_DTYPE_NAMES = {
    torch.float64: "float64", torch.float32: "float32",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
    torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool",
}
_CHUNK_BYTES = 64 << 20


def _treedef_str(tree) -> str:
    """``str(treedef)`` of the JAX pytree ``tree`` would be, inside the
    ``PyTreeDef(...)`` wrapper: dicts with their keys sorted and repr'd,
    lists, tuples, None as an empty node, and ``*`` for every leaf."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef_str(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_treedef_str(v) for v in tree)
        if isinstance(tree, list):
            return f"[{inner}]"
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    return "None" if tree is None else "*"


def _leaves(tree) -> Iterator[Any]:
    """The leaves in the order JAX flattens them (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


class _HostReader:
    """Streams a tensor's bytes to the host in chunks of ``_CHUNK_BYTES``
    through two pinned buffers: the copy of chunk j+1 (on a side stream)
    runs while chunk j is hashed."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self.bufs = [torch.empty(_CHUNK_BYTES, dtype=torch.uint8,
                                 pin_memory=True) for _ in range(2)]
        self.done = [torch.cuda.Event(), torch.cuda.Event()]

    def feed(self, h, u8: torch.Tensor):
        self.stream.wait_stream(torch.cuda.current_stream(u8.device))
        prev = None
        for j, lo in enumerate(range(0, u8.numel(), _CHUNK_BYTES)):
            n = min(_CHUNK_BYTES, u8.numel() - lo)
            slot = j % 2
            with torch.cuda.stream(self.stream):
                self.bufs[slot][:n].copy_(u8[lo:lo + n], non_blocking=True)
                self.done[slot].record(self.stream)
            if prev is not None:
                self._hash(h, *prev)
            prev = (slot, n)
        if prev is not None:
            self._hash(h, *prev)

    def _hash(self, h, slot: int, n: int):
        self.done[slot].synchronize()
        h.update(self.bufs[slot][:n].numpy())


def params_digest(params) -> str:
    """sha256 over the exact parameter tree: its structure, then each
    leaf's dtype, shape and bytes — the reference's digest of the same
    numbers. Leaves are tensors (on any device), numpy arrays, or Python
    scalars and strings (hashed by ``repr``)."""
    h = hashlib.sha256()
    h.update(f"PyTreeDef({_treedef_str(params)})".encode())
    readers: Dict[torch.device, _HostReader] = {}
    for leaf in _leaves(params):
        if isinstance(leaf, (int, float, str, bool)):
            h.update(repr(leaf).encode())
            continue
        if isinstance(leaf, (np.ndarray, np.generic)):
            leaf = torch.from_numpy(np.array(leaf, copy=True))
        if leaf.dtype not in _DTYPE_NAMES:
            raise TypeError(f"params_digest: unsupported dtype {leaf.dtype}")
        h.update(_DTYPE_NAMES[leaf.dtype].encode())
        h.update(str(tuple(leaf.shape)).encode())
        u8 = leaf.detach().reshape(-1).view(torch.uint8)
        if u8.device.type == "cpu":
            h.update(u8.numpy())
        else:
            if u8.device not in readers:
                readers[u8.device] = _HostReader(u8.device)
            readers[u8.device].feed(h, u8)
    return h.hexdigest()


def request_key(model_id: str, params_digest_: str, range_key: str,
                cfg: CaaConfig, target: Any = None) -> str:
    """The content address of one certification request. The writer's
    schema version is part of the address, so a newer pipeline never
    collides with an older entry."""
    canon = json.dumps({
        "schema": SCHEMA_VERSION,
        "model_id": model_id,
        "params_digest": params_digest_,
        "range_key": range_key,
        "cfg": _cfg_to_dict(cfg),
        "target": target,
    }, sort_keys=True)
    return hashlib.sha256(canon.encode()).hexdigest()


@dataclasses.dataclass
class StoreStats:
    hits_mem: int = 0
    hits_disk: int = 0
    misses: int = 0
    puts: int = 0
    rejected_stale: int = 0
    corrupt: int = 0
    read_v1: int = 0   # legacy uniform-k entries served
    evicted: int = 0   # entries removed by gc (with the pipeline)

    def to_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


class CertificateStore:
    """On-disk certificate sets behind an in-memory LRU.

    get/put are by request key; ``get`` also re-checks the stored params
    digest against the caller's expectation, so a hand-copied file never
    serves bounds for other weights. ``root`` is the store directory
    (created if missing)."""

    def __init__(self, root: str, lru_size: int = 64):
        self.root = root
        self.lru_size = int(lru_size)
        self._lru: "collections.OrderedDict[str, CertificateSet]" = (
            collections.OrderedDict())
        self.stats = StoreStats()
        os.makedirs(self.root, exist_ok=True)

    def path_for(self, key: str) -> str:
        return os.path.join(self.root, f"{key}.json")

    def _bump(self, name: str, inc: int = 1):
        """One stats increment, mirrored to the tracer's counters."""
        setattr(self.stats, name, getattr(self.stats, name) + inc)
        obs.counter(f"store.{name}", inc)

    def get(self, key: str, expect_params_digest: Optional[str] = None
            ) -> Optional[CertificateSet]:
        """The set stored under ``key``, or None: missing, unreadable
        (counted ``corrupt``) or proven for other weights (counted
        ``rejected_stale``)."""
        cs = self._lru.get(key)
        if cs is not None:
            self._lru.move_to_end(key)
            self._bump("hits_mem")
            self._touch(self.path_for(key))
        else:
            path = self.path_for(key)
            if not os.path.exists(path):
                self._bump("misses")
                return None
            try:
                with open(path) as f:
                    payload = json.load(f)
                raw = payload["certificate_set"]
                cs = CertificateSet.from_dict(raw)
                if raw.get("schema_version", 1) == 1:
                    self._bump("read_v1")
            except (json.JSONDecodeError, KeyError, TypeError, ValueError,
                    OSError):
                # a corrupted, truncated or unreadably new entry is a miss
                self._bump("corrupt")
                return None
            self._bump("hits_disk")
            self._touch(path)
            self._remember(key, cs)
        if (expect_params_digest is not None
                and cs.params_digest != expect_params_digest):
            self._bump("rejected_stale")
            return None
        return cs

    def put(self, key: str, cs: CertificateSet,
            request: Optional[Dict[str, Any]] = None) -> str:
        """Crash- and concurrency-safe write: each writer serialises into
        its own temporary file, fsyncs it, then publishes it with one
        atomic ``os.replace``; a reader sees the old entry or the new one,
        never a mix. Returns the entry's path."""
        path = self.path_for(key)
        payload = {"key": key, "request": request or {},
                   "certificate_set": cs.to_dict()}
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        finally:
            try:
                os.unlink(tmp)          # no-op after a successful replace
            except FileNotFoundError:
                pass
        self._remember(key, cs)
        self._bump("puts")
        return path

    def _remember(self, key: str, cs: CertificateSet):
        self._lru[key] = cs
        self._lru.move_to_end(key)
        while len(self._lru) > self.lru_size:
            self._lru.popitem(last=False)

    def keys(self) -> Iterator[str]:
        for name in sorted(os.listdir(self.root)):
            # "_"-prefixed files are store metadata, not entries
            if name.endswith(".json") and not name.startswith("_"):
                yield name[:-len(".json")]

    @staticmethod
    def _touch(path: str):
        """Refresh the entry's recency marker (mtime): serving an entry
        counts as use for the eviction policy."""
        try:
            os.utime(path)
        except OSError:
            pass                     # raced with an evictor: harmless

    def __len__(self) -> int:
        return sum(1 for _ in self.keys())
