"""The certification profile's tokens, as the reference draws them.

The reference certifies a language model on ``jax.random.randint(
jax.random.PRNGKey(seed), (batch, seq), 0, vocab)`` (64-bit integers: the
JAX package enables x64). The profile is part of what a certificate
proves, and its seed is part of the store key, so the port must draw the
same tokens for the same seed: :func:`profile_tokens` replays that draw in
numpy — the Threefry-2x32 hash (Salmon et al., SC 2011; 20 rounds), JAX's
key construction from an integer seed, its counter-based ``split`` and
64-bit ``random_bits``, and ``randint``'s reduction of two 64-bit draws
modulo the span.
"""
from __future__ import annotations

import numpy as np
import torch

_U32 = np.uint32
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(key, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 with 20 rounds of the 2-word counters (x0, x1) under
    the key (k0, k1); uint32 arrays in, a pair of uint32 arrays out."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x = [np.asarray(x0, _U32) + ks[0], np.asarray(x1, _U32) + ks[1]]
        for i in range(5):
            for r in _ROT[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def prng_key(seed: int):
    """``PRNGKey(seed)``: the seed's high and low 32-bit words."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return (_U32(seed >> 32), _U32(seed & 0xFFFFFFFF))


def _counters(n: int):
    c = np.arange(n, dtype=np.uint64)
    return (c >> np.uint64(32)).astype(_U32), (c & np.uint64(0xFFFFFFFF)
                                               ).astype(_U32)


def split(key):
    """``jax.random.split(key)`` into two keys (the counter-based split)."""
    b0, b1 = threefry2x32(key, *_counters(2))
    return (b0[0], b1[0]), (b0[1], b1[1])


def random_bits64(key, shape) -> np.ndarray:
    """64 random bits per element: the hash of the element's flat index."""
    n = int(np.prod(shape)) if len(shape) else 1
    b0, b1 = threefry2x32(key, *_counters(n))
    bits = (b0.astype(np.uint64) << np.uint64(32)) | b1.astype(np.uint64)
    return bits.reshape(shape)


def randint(key, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval)`` in int64: two
    64-bit draws folded modulo the span (hi·(2^64 mod span) + lo)."""
    k1, k2 = split(key)
    hi, lo = random_bits64(k1, shape), random_bits64(k2, shape)
    span = np.uint64(max(int(maxval) - int(minval), 1))
    mult = np.uint64(2 ** 32) % span
    mult = (mult * mult) % span
    with np.errstate(over="ignore"):
        off = ((hi % span) * mult + lo % span) % span
    return (int(minval) + off.astype(np.int64)).astype(np.int64)


def profile_tokens(seed: int, batch: int, seq: int, vocab: int,
                   device="cpu") -> torch.Tensor:
    """The [batch, seq] int64 token profile the reference certifies an LM
    on for ``seed``, as a tensor on ``device``."""
    toks = randint(prng_key(seed), (int(batch), int(seq)), 0, int(vocab))
    return torch.from_numpy(toks).to(device)
