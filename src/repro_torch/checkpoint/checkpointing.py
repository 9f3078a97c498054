"""Checkpointing (PyTorch): atomic step manifests, asynchronous snapshots,
restore — the counterpart of the JAX package's
``repro.checkpoint.checkpointing``, in its on-disk layout.

Layout: ``<dir>/step_<N>/{arrays.npz, manifest.json}``, with the
reference's array keys: each leaf's path joined by "/", a dict entry by its
key, a ``NamedTuple`` field as ``.name`` (``OptState``'s ``.m``, the EF
state's ``.residual``), a list entry by its index; ``None`` has no leaf. So
a state the reference saved restores into the port's train state, and the
reverse.

* ``save`` copies every tensor to the host before it returns (the caller
  may then update its tensors in place), into host buffers the
  checkpointer keeps from one save to the next (pinned for a card's
  tensors: the copy then runs at the link's rate, and a later save
  faults no new pages in); the write goes to ``step_<N>.tmp``, the
  manifest is fsynced, then ``os.replace`` publishes the directory — a
  crash mid-write never corrupts the latest complete checkpoint. With
  ``blocking=False`` a writer thread does the writing while training goes
  on; ``wait`` joins it (and raises what the write raised). The archive
  is written by ``np.savez``, as the reference writes it.
* ``keep`` bounds the checkpoints kept: the oldest are removed after each
  write. A save refuses to start when the directory's file system has less
  room than the snapshot (``shutil.disk_usage``).
* ``stats`` holds one entry a save: its step, bytes, host-copy seconds and
  (once written) write seconds.
* ``restore`` loads into the structure of a template and places each
  tensor on ``device`` (or on its template leaf's device). Each array is
  read straight from the file at its member's offset, one at a time
  (``np.savez`` stores its members uncompressed, in C order); bound for a
  card, it streams through a pinned slice into the device tensor.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import struct
import threading
import time
import zipfile
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch


def _items(tree, path=()) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) pairs of ``tree``, keyed as the reference keys them."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], path + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _items(getattr(tree, name), path + ("." + name,))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _items(t, path + (str(i),))
    else:
        yield "/".join(path), tree


_SLICE = 64 << 20       # bytes a staged read moves


class _StoredNpz:
    """The arrays of an ``np.savez`` archive by name, each read when asked,
    straight from the file at its member's data."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        self._stage: Optional[torch.Tensor] = None    # pinned, for a card
        try:
            with zipfile.ZipFile(self._f) as zf:
                self._infos = {i.filename: i for i in zf.infolist()}
        except (OSError, zipfile.BadZipFile):
            self._f.close()
            raise

    def _seek_data(self, key: str):
        """Position the file at ``key``'s array data; returns the array's
        (shape, dtype). A member ``np.savez`` would not write (compressed,
        or in Fortran order) is refused."""
        info = self._infos[key + ".npy"]
        if info.compress_type != zipfile.ZIP_STORED:
            raise ValueError(f"{key}: a compressed member; checkpoints are "
                             "written by np.savez, uncompressed")
        f = self._f
        f.seek(info.header_offset + 26)          # the local header's lengths
        n_name, n_extra = struct.unpack("<HH", f.read(4))
        f.seek(info.header_offset + 30 + n_name + n_extra)
        version = np.lib.format.read_magic(f)
        read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                else np.lib.format.read_array_header_2_0)
        shape, fortran, dtype = read(f)
        if fortran:
            raise ValueError(f"{key}: a Fortran-order member")
        return shape, dtype

    def __getitem__(self, key: str) -> np.ndarray:
        shape, dtype = self._seek_data(key)
        return np.fromfile(self._f, dtype=dtype,
                           count=math.prod(shape)).reshape(shape)

    def tensor(self, key: str, device) -> torch.Tensor:
        """The array as a tensor on ``device``. For a card it streams
        through one pinned host slice reused for every array: no host copy
        of the whole array is made."""
        if torch.device(device).type != "cuda":
            return torch.from_numpy(self[key]).to(device)
        shape, dtype = self._seek_data(key)
        out = torch.empty(shape, device=device,
                          dtype=torch.from_numpy(np.empty(0, dtype)).dtype)
        dst = out.view(-1).view(torch.uint8)
        if self._stage is None:
            self._stage = torch.empty(_SLICE, dtype=torch.uint8,
                                      pin_memory=True)
        view = memoryview(self._stage.numpy())
        for off in range(0, dst.numel(), _SLICE):
            n = min(_SLICE, dst.numel() - off)
            if self._f.readinto(view[:n]) != n:
                raise OSError(f"{key}: the archive ends inside its data")
            dst[off:off + n].copy_(self._stage[:n])
        return out

    def close(self):
        self._f.close()
        self._stage = None


def _unflatten_into(template, flat, device, path=()):
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, device, path + (str(k),))
                for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(
            _unflatten_into(getattr(template, n), flat, device,
                            path + ("." + n,)) for n in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten_into(t, flat, device,
                                              path + (str(i),))
                              for i, t in enumerate(template))
    dev = device if device is not None else (
        template.device if isinstance(template, torch.Tensor) else "cpu")
    return flat.tensor("/".join(path), dev)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.stats: List[dict] = []
        self._error: Optional[Exception] = None
        self._bufs: Dict[str, torch.Tensor] = {}    # host copies, reused
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state: Any, blocking: bool = True,
             metadata: Optional[dict] = None):
        """Snapshot ``state`` (nested dicts / NamedTuples of tensors). The
        host copy is made before this returns; the write is asynchronous
        unless ``blocking``."""
        self.wait()
        leaves = dict(_items(state))
        n_bytes = sum(v.numel() * v.element_size()
                      if isinstance(v, torch.Tensor) else np.asarray(v).nbytes
                      for v in leaves.values())
        free = shutil.disk_usage(self.dir).free
        if free < n_bytes:
            raise OSError(f"checkpoint of step {step} needs {n_bytes:,} "
                          f"bytes; {self.dir} has {free:,} free")
        t0 = time.perf_counter()
        flat = {k: self._host(k, v) for k, v in leaves.items()}
        if any(isinstance(v, torch.Tensor) and v.is_cuda
               for v in leaves.values()):
            torch.cuda.synchronize()
        del leaves
        entry = {"step": step, "bytes": n_bytes,
                 "host_copy_s": time.perf_counter() - t0}
        self.stats.append(entry)
        if blocking:
            self._write(step, flat, metadata or {}, entry)
        else:
            self._thread = threading.Thread(
                target=self._write_logged,
                args=(step, flat, metadata or {}, entry))
            self._thread.start()

    def _host(self, key: str, leaf) -> np.ndarray:
        """A host copy of ``leaf`` that later in-place writes cannot reach,
        in the buffer kept for ``key`` (the previous save's write is over:
        ``save`` waits for it first)."""
        if not isinstance(leaf, torch.Tensor):
            return np.array(leaf, copy=True)
        buf = self._bufs.get(key)
        if buf is None or buf.shape != leaf.shape or buf.dtype != leaf.dtype:
            self._bufs.pop(key, None)
            buf = self._bufs[key] = torch.empty(
                leaf.shape, dtype=leaf.dtype, pin_memory=leaf.is_cuda)
        buf.copy_(leaf.detach(), non_blocking=leaf.is_cuda)
        return buf.numpy()

    def wait(self):
        """Join the writer thread; a write that failed raises here."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write_logged(self, *args):
        try:
            self._write(*args)
        except Exception as e:          # re-raised by wait()
            self._error = e

    def _write(self, step: int, flat: Dict[str, np.ndarray], metadata: dict,
               entry: dict):
        t0 = time.perf_counter()
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {
            "step": step,
            "time": time.time(),
            "n_arrays": len(flat),
            "bytes": int(sum(a.nbytes for a in flat.values())),
            **metadata,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        old = final + ".old"
        if os.path.isdir(final):        # the same step saved again
            os.replace(final, old)
        os.replace(tmp, final)  # atomic publish
        shutil.rmtree(old, ignore_errors=True)
        self._gc()
        entry["write_s"] = time.perf_counter() - t0

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and name[5:].isdigit():
                if os.path.exists(os.path.join(self.dir, name,
                                               "manifest.json")):
                    out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None,
                device=None) -> tuple:
        """Load the checkpoint of ``step`` (the latest if None) into the
        structure of ``template``; returns (state, manifest)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        npz = _StoredNpz(os.path.join(path, "arrays.npz"))
        try:        # one array read at a time, placed, dropped on the host
            return _unflatten_into(template, npz, device), manifest
        finally:
            npz.close()
