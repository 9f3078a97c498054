"""Architecture registry of the PyTorch port: only what it supports.

Each module exposes FULL (the published configuration) and SMOKE (a reduced
same-family configuration for CPU tests), copied from the JAX package's
``repro.configs``.
"""
from __future__ import annotations

import importlib

ARCHS = ["qwen2_7b"]

_ALIASES = {"qwen2-7b": "qwen2_7b"}


def get(name: str):
    name = _ALIASES.get(name, name)
    if name not in ARCHS:
        raise KeyError(f"arch {name!r} is not ported to repro_torch; "
                       f"ported: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{name}")
