"""Data pipeline (PyTorch): deterministic synthetic token streams,
host-sharded — the counterpart of the JAX package's ``repro.data.pipeline``.

Each host generates only its slice of the global batch (``host_slice``),
and determinism comes from a counter-based stateless generator keyed on
(seed, step, host), so a restart or an elastic re-shard reproduces the
same stream: the property the checkpoint/restart path relies on.

The stream is the reference's bit for bit. The reference draws with
``jax.random`` under x64: a threefry2x32 key ``PRNGKey(seed)``, folded
with the step and the host id, and 64 random bits per value (the
partitionable counter layout: value i hashes the counter pair (i >> 32,
i & 0xffffffff)), made an f64 uniform on [1e-6, 1) from their top 52 bits.
This module keeps its own threefry2x32 and ``fold_in`` in numpy uint32
arithmetic and the same f64 uniforms, then takes the same Zipf-like ranks
floor(vocab · u^1.1) in f64 on the CPU. The tokens are placed on the
requested device afterwards. XLA's CPU build fuses the uniform's scale
and shift into one fused multiply-add; the port computes that fma exactly
(:func:`fma_f64`), so its uniforms are the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
ALPHA = 1.1                 # the Zipf-like marginal's exponent
U_MIN = 1e-6                # the uniform's lower end


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0


def host_slice(cfg: DataConfig) -> Tuple[int, int]:
    per = cfg.global_batch // cfg.n_hosts
    return cfg.host_id * per, per


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The threefry2x32 hash (20 rounds) of the counter pairs (x0, x1)
    under ``key`` [2] uint32; returns the two uint32 output words."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x = [np.asarray(x0, np.uint32) + ks[0],
             np.asarray(x1, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: the 64-bit seed as (high, low) words."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in``: the hash of the counter pair (0, data)."""
    a, b = threefry2x32(key, np.zeros(1, np.uint32),
                        np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([a[0], b[0]], np.uint32)


def _two_prod(a: np.ndarray, b: np.ndarray):
    """a·b = p + e exactly (Dekker's product with Veltkamp's split)."""
    p = a * b

    def split(x):
        c = 134217729.0 * x                     # 2^27 + 1
        hi = c - (c - x)
        return hi, x - hi

    ah, al = split(a)
    bh, bl = split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def fma_f64(a: np.ndarray, b: float, c: float) -> np.ndarray:
    """a·b + c with one rounding (the product and the sum's errors
    carried by error-free transformations, added back last)."""
    p, e = _two_prod(a, np.full_like(a, b))
    s = p + c
    bb = s - p
    t = (p - (s - bb)) + (c - bb)
    return s + (t + e)


def uniform_f64(key: np.ndarray, n: int, minval: float = U_MIN,
                maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, (n,), float64, minval, maxval)``: 64 bits
    per value, the top 52 as the mantissa of a number in [1, 2)."""
    i = np.arange(n, dtype=np.uint64)
    hi, lo = threefry2x32(key, (i >> np.uint64(32)).astype(np.uint32),
                          (i & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    bits = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    mant = (bits >> np.uint64(12)) | np.float64(1.0).view(np.uint64)
    floats = mant.view(np.float64) - 1.0
    return np.maximum(minval, fma_f64(floats, maxval - minval, minval))


def batch_at(cfg: DataConfig, step: int, device="cpu") -> dict:
    """The (host-local slice of the) batch for a given step — stateless:
    ``tokens`` and ``targets`` [per, seq] int32 on ``device``."""
    _, per = host_slice(cfg)
    key = fold_in(fold_in(prng_key(cfg.seed), step), cfg.host_id)
    u = torch.from_numpy(uniform_f64(key, per * (cfg.seq + 1)))
    ranks = torch.floor(cfg.vocab * u ** ALPHA).to(torch.int32)
    toks = ranks.clamp(0, cfg.vocab - 1).reshape(per, cfg.seq + 1)
    toks = toks.to(device)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def stream(cfg: DataConfig, start_step: int = 0,
           device="cpu") -> Iterator[dict]:
    step = start_step
    while True:
        yield batch_at(cfg, step, device)
        step += 1
