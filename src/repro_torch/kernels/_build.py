"""Build the CUDA sources of ``repro_torch/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into a shared library under ``build/repro_torch/``
at the repository root, at first use; the file name carries a digest of
the sources and flags, so an edit rebuilds and an unchanged tree reuses the
library. No ``--use_fast_math``: it would flush subnormals and approximate
``/`` and ``expf``, and the certified rounding depends on both.

Pointers and the CUDA stream go to the C functions as ``c_void_p``; each C
function returns ``cudaGetLastError()`` after its launch, which
:func:`check` turns into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("quant_matmul_format", "flash_decode_certified", "quant_matmul",
           "flash_decode", "caa_matmul", "interval_matmul", "row_mean",
           "f32_matmul", "numeric_health")
# the instances for bf16 / e4m3 operands (ServeConfig's compute, cache and
# param dtypes): libraries of their own, so that the f32 kernels' build does
# not wait on them
NARROW_SOURCES = ("quant_matmul_format_narrow", "quant_matmul_narrow",
                  "f32_matmul_narrow", "flash_decode_certified_narrow",
                  "flash_decode_bf16", "latent_decode_bf16")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin``, then ``PATH``, then the toolkit's
    default install location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built from source with the CUDA toolkit")


def lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES, *,
          ptxas_verbose: bool = False) -> Dict[str, Dict]:
    """Compile every source of ``names`` that has no current library, all
    ``nvcc`` processes started together. Returns {name: {"seconds",
    "cached", "log"}}; raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    out: Dict[str, Dict] = {}
    for name in names:
        path = lib_path(name)
        if path.exists() and not ptxas_verbose:
            out[name] = {"seconds": 0.0, "cached": True, "log": ""}
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        if ptxas_verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    # one thread a process drains its output (ptxas -v can fill a pipe) and
    # takes the time it ended: each source's own seconds
    logs, ended = {}, {}

    def wait(name, proc):
        logs[name], _ = proc.communicate()
        ended[name] = time.perf_counter() - t0

    waiters = [threading.Thread(target=wait, args=(name, proc))
               for name, (proc, _, _) in procs.items()]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    for name, (proc, tmp, path) in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{logs[name]}")
        os.replace(tmp, path)
        out[name] = {"seconds": ended[name], "cached": False,
                     "log": logs[name]}
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = lib_path(name)
            if not path.exists():
                build([name])
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_ptr(device) -> int:
    """The current PyTorch CUDA stream of ``device`` as a pointer value."""
    return torch.cuda.current_stream(device).cuda_stream
