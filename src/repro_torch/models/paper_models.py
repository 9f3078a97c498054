"""The paper's own three experiment models (Section V / Table I), PyTorch.

The counterpart of the JAX package's ``repro.models.paper_models``:

  Digits    — MNIST-style classifier: three Dense, two ReLU, one Softmax
              (≈0.73M parameters at the default widths 784→700→256→10).
  ConvNet   — a small convolutional classifier standing in for the paper's
              MobileNet study (Conv → ReLU → Pool → Dense → Softmax); conv is
              patch extraction + matmul, so the trajectory dot-product rule
              applies verbatim.
  Pendulum  — the Lyapunov-function approximator: two Dense layers with
              two tanh activations, 2-D input on [-6, 6]².

All are backend-generic: under ``TorchOps`` they infer, under ``CaaOps``
they give Table-I-style rigorous error bounds. Parameters are dicts of f32
tensors; the inits draw them on the CPU from a ``torch.Generator`` and move
them to ``device``.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models import layers as L


def _zeros(n: int, device):
    return torch.zeros((n,), dtype=torch.float32, device=device)


def _input(bk, x):
    return x if hasattr(x, "val") else bk.input(x)


# --------------------------------------------------------------------------
# Digits
# --------------------------------------------------------------------------

def init_digits(generator: torch.Generator, d_in: int = 784, h1: int = 700,
                h2: int = 256, n_classes: int = 10, device=None) -> Dict:
    """≈0.73M params at defaults (784·700 + 700·256 + 256·10 + biases)."""
    g = dict(generator=generator, device=device)
    return {
        "w1": L.dense_init(d_in, h1, **g), "b1": _zeros(h1, device),
        "w2": L.dense_init(h1, h2, **g), "b2": _zeros(h2, device),
        "w3": L.dense_init(h2, n_classes, **g),
        "b3": _zeros(n_classes, device),
    }


def digits_forward(bk, params, x):
    """x: [..., 784] in [0,1] → softmax probabilities. Each block runs in a
    named scope ("dense1" … "softmax"), the unit of sensitivity attribution
    and per-layer certificates; record() calls stay outside the scopes."""
    with bk.scope("dense1"):
        h = bk.add(bk.matmul(_input(bk, x), bk.param(params["w1"])),
                   bk.param(params["b1"]))
        h = bk.relu(h)
    h = bk.record("dense1", h)
    with bk.scope("dense2"):
        h = bk.add(bk.matmul(h, bk.param(params["w2"])),
                   bk.param(params["b2"]))
        h = bk.relu(h)
    h = bk.record("dense2", h)
    with bk.scope("dense3"):
        o = bk.add(bk.matmul(h, bk.param(params["w3"])),
                   bk.param(params["b3"]))
    o = bk.record("dense3", o)
    with bk.scope("softmax"):
        p = bk.softmax(o, dim=-1)
    return bk.record("softmax", p)


def digits_logits(bk, params, x):
    with bk.scope("dense1"):
        h = bk.add(bk.matmul(_input(bk, x), bk.param(params["w1"])),
                   bk.param(params["b1"]))
        h = bk.relu(h)
    with bk.scope("dense2"):
        h = bk.add(bk.matmul(h, bk.param(params["w2"])),
                   bk.param(params["b2"]))
        h = bk.relu(h)
    with bk.scope("dense3"):
        return bk.add(bk.matmul(h, bk.param(params["w3"])),
                      bk.param(params["b3"]))


# --------------------------------------------------------------------------
# ConvNet (the MobileNet-class stand-in)
# --------------------------------------------------------------------------

def init_convnet(generator: torch.Generator, img: int = 28, c_in: int = 1,
                 c1: int = 16, c2: int = 32, n_classes: int = 10,
                 ksz: int = 3, device=None) -> Dict:
    side = img // 4  # two stride-2 pools
    n1, n2 = ksz * ksz * c_in, ksz * ksz * c1
    return {
        "k1": L.dense_init(n1, c1, n1 ** -0.5, generator=generator,
                           device=device),
        "bk1": _zeros(c1, device),
        "k2": L.dense_init(n2, c2, n2 ** -0.5, generator=generator,
                           device=device),
        "bk2": _zeros(c2, device),
        "wd": L.dense_init(side * side * c2, n_classes, generator=generator,
                           device=device),
        "bd": _zeros(n_classes, device),
        "meta": {"img": img, "c_in": c_in, "ksz": ksz},
    }


def _extract_patches(bk, x, img: int, c: int, ksz: int):
    """[B, img, img, c] → [B, img, img, ksz·ksz·c] (SAME padding), as an
    exact gather so conv == patches @ kernel-matrix."""
    pad = ksz // 2
    dev = x.device
    idx = torch.arange(img, device=dev)
    off = idx[:, None] + torch.arange(-pad, pad + 1, device=dev)[None, :]
    rows = torch.clamp(off, 0, img - 1)
    valid_r = (off >= 0) & (off <= img - 1)
    patches = []
    for dr in range(ksz):
        xr = bk.take(x, rows[:, dr], dim=1)
        mr = valid_r[:, dr]
        for dc in range(ksz):
            xc = bk.take(xr, rows[:, dc], dim=2)
            mc = valid_r[:, dc]
            m = (mr[:, None] & mc[None, :])[None, :, :, None]
            zero = bk.const(0.0, like=x)
            xc = bk.where(m, xc, bk.broadcast_to(zero, bk.shape_of(xc)))
            patches.append(xc)
    return bk.concat(patches, dim=-1)


def convnet_forward(bk, params, x):
    """x: [B, img, img, c_in] in [0,1] → probabilities [B, 10]."""
    meta = params["meta"]
    img, c_in, ksz = meta["img"], meta["c_in"], meta["ksz"]
    x = _input(bk, x)

    p = _extract_patches(bk, x, img, c_in, ksz)
    h = bk.add(bk.matmul(p, bk.param(params["k1"])), bk.param(params["bk1"]))
    h = bk.relu(bk.record("conv1", h))
    h = _maxpool2(bk, h)

    c1 = bk.shape_of(h)[-1]
    p2 = _extract_patches(bk, h, img // 2, c1, ksz)
    h = bk.add(bk.matmul(p2, bk.param(params["k2"])), bk.param(params["bk2"]))
    h = bk.relu(bk.record("conv2", h))
    h = _maxpool2(bk, h)

    B = bk.shape_of(h)[0]
    side = img // 4
    c2 = bk.shape_of(h)[-1]
    h = bk.reshape(h, (B, side * side * c2))
    o = bk.add(bk.matmul(h, bk.param(params["wd"])), bk.param(params["bd"]))
    return bk.record("softmax", bk.softmax(o, dim=-1))


def _maxpool2(bk, x):
    """2×2 max pool, stride 2 — pure selection, error-free in CAA."""
    B, H, W, C = bk.shape_of(x)
    a = bk.slice(x, (slice(None), slice(0, H, 2), slice(0, W, 2)))
    b = bk.slice(x, (slice(None), slice(1, H, 2), slice(0, W, 2)))
    c = bk.slice(x, (slice(None), slice(0, H, 2), slice(1, W, 2)))
    d = bk.slice(x, (slice(None), slice(1, H, 2), slice(1, W, 2)))
    return bk.maximum(bk.maximum(a, b), bk.maximum(c, d))


# --------------------------------------------------------------------------
# Pendulum (Lyapunov)
# --------------------------------------------------------------------------

def init_pendulum(generator: torch.Generator, h: int = 64,
                  device=None) -> Dict:
    g = dict(generator=generator, device=device)
    return {
        "w1": L.dense_init(2, h, **g), "b1": _zeros(h, device),
        "w2": L.dense_init(h, h, **g), "b2": _zeros(h, device),
        "w3": L.dense_init(h, 1, **g), "b3": _zeros(1, device),
    }


def pendulum_forward(bk, params, x):
    """x: [..., 2] on [-6, 6]² → scalar Lyapunov value. The output range
    contains 0, so (as the paper reports) no relative bound exists — only
    the absolute one."""
    with bk.scope("dense1"):
        h = bk.add(bk.matmul(_input(bk, x), bk.param(params["w1"])),
                   bk.param(params["b1"]))
    h = bk.record("dense1", h)
    with bk.scope("dense1"):
        h = bk.tanh(h)
    with bk.scope("dense2"):
        h = bk.add(bk.matmul(h, bk.param(params["w2"])),
                   bk.param(params["b2"]))
    h = bk.record("dense2", h)
    with bk.scope("dense2"):
        h = bk.tanh(h)
    with bk.scope("dense3"):
        return bk.add(bk.matmul(h, bk.param(params["w3"])),
                      bk.param(params["b3"]))
