"""Procedural digit dataset (MNIST stand-in, fully offline).

A copy of the JAX package's ``repro.data.synthetic_digits`` (numpy only; it
returns numpy arrays, and callers move them to their device): the same
seed gives the same images and labels as the reference.

Renders 28×28 glyphs for digits 0-9 from stroke templates with random
affine jitter + noise — enough signal to train the paper's Digits model to
high accuracy so its Table-I analysis runs against a *real* trained
classifier with meaningful top-1 margins p*.
"""
from __future__ import annotations

import numpy as np

_SEGS = {
    # 7-segment-ish stroke templates on a 28x28 canvas: (x0,y0,x1,y1) lines
    0: [(7, 4, 20, 4), (7, 23, 20, 23), (6, 5, 6, 22), (21, 5, 21, 22)],
    1: [(14, 4, 14, 23), (10, 7, 14, 4)],
    2: [(7, 4, 20, 4), (21, 5, 21, 13), (7, 14, 20, 14), (6, 15, 6, 22), (7, 23, 20, 23)],
    3: [(7, 4, 20, 4), (21, 5, 21, 13), (10, 14, 20, 14), (21, 15, 21, 22), (7, 23, 20, 23)],
    4: [(6, 4, 6, 13), (7, 14, 20, 14), (21, 4, 21, 23)],
    5: [(7, 4, 21, 4), (6, 5, 6, 13), (7, 14, 20, 14), (21, 15, 21, 22), (6, 23, 20, 23)],
    6: [(7, 4, 20, 4), (6, 5, 6, 22), (7, 14, 20, 14), (21, 15, 21, 22), (7, 23, 20, 23)],
    7: [(6, 4, 21, 4), (21, 5, 21, 23)],
    8: [(7, 4, 20, 4), (6, 5, 6, 22), (21, 5, 21, 22), (7, 14, 20, 14), (7, 23, 20, 23)],
    9: [(7, 4, 20, 4), (6, 5, 6, 13), (21, 5, 21, 22), (7, 14, 20, 14), (7, 23, 20, 23)],
}


def _draw(digit: int, rng: np.random.RandomState) -> np.ndarray:
    img = np.zeros((28, 28), np.float32)
    dx, dy = rng.randint(-2, 3), rng.randint(-2, 3)
    sx, sy = 1.0 + 0.12 * rng.randn(), 1.0 + 0.12 * rng.randn()
    for (x0, y0, x1, y1) in _SEGS[digit]:
        n = 40
        xs = np.linspace(x0, x1, n) * sx + dx
        ys = np.linspace(y0, y1, n) * sy + dy
        for x, y in zip(xs, ys):
            xi, yi = int(round(x)), int(round(y))
            for ox in (-1, 0, 1):
                for oy in (-1, 0, 1):
                    xj, yj = xi + ox, yi + oy
                    if 0 <= xj < 28 and 0 <= yj < 28:
                        w = 1.0 if (ox == 0 and oy == 0) else 0.45
                        img[yj, xj] = max(img[yj, xj], w)
    img += 0.08 * rng.rand(28, 28).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def make_dataset(n: int, seed: int = 0):
    """Returns (images [n,784] in [0,1], labels [n])."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=n)
    imgs = np.stack([_draw(int(d), rng).reshape(-1) for d in labels])
    return imgs.astype(np.float32), labels.astype(np.int32)
