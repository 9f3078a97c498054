"""Architecture registry of the PyTorch port: the reference's ten archs.

Each module exposes FULL (the published configuration) and SMOKE (a reduced
same-family configuration for CPU tests), copied from the JAX package's
``repro.configs``; ``SHAPES`` are the assigned input-shape families, and
``cells`` / ``skip_reason`` the (arch × shape) cells the dry run
(:mod:`repro_torch.launch.dryrun`) covers, as the reference lists them.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

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


def cells():
    """All 40 (arch × shape) cells as (arch, shape name, skip reason or
    None)."""
    return [(a, s.name, skip_reason(get(a).FULL, s))
            for a in ARCHS for s in SHAPES.values()]


def skip_reason(cfg, shape: ShapeSpec) -> Optional[str]:
    """The assignment's documented skips: a 500k decode of a pure
    full-attention arch (it needs sub-quadratic attention). Recurrent,
    hybrid and sliding-window / local-global archs run it; an
    encoder-decoder's prefill and decode cells run at the decoder's
    architectural maximum (:func:`repro_torch.launch.dryrun.
    effective_shape`)."""
    if shape.name == "long_500k":
        if cfg.rwkv or cfg.hybrid:
            return None
        if cfg.window or cfg.local_global_period:
            return None
        return ("pure full-attention arch: 500k decode needs sub-quadratic "
                "attention — skipped per assignment")
    return None
