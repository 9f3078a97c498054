"""Architecture registry of the PyTorch port: the reference's ten archs.

Each module exposes FULL (the published configuration) and SMOKE (a reduced
same-family configuration for CPU tests), copied from the JAX package's
``repro.configs``.
"""
from __future__ import annotations

import importlib

ARCHS = ["qwen2_7b", "command_r_35b", "gemma2_27b", "mixtral_8x22b",
         "llama4_maverick", "rwkv6_1p6b", "hymba_1p5b", "minicpm3_4b",
         "whisper_medium", "paligemma_3b"]

_ALIASES = {"qwen2-7b": "qwen2_7b", "command-r-35b": "command_r_35b",
            "gemma2-27b": "gemma2_27b", "mixtral-8x22b": "mixtral_8x22b",
            "llama4-maverick-400b-a17b": "llama4_maverick",
            "rwkv6-1.6b": "rwkv6_1p6b", "hymba-1.5b": "hymba_1p5b",
            "minicpm3-4b": "minicpm3_4b", "whisper-medium": "whisper_medium",
            "paligemma-3b": "paligemma_3b"}


def get(name: str):
    name = _ALIASES.get(name, name)
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{name}")
