"""Serving's storage and compute dtypes: the names a ``ServeConfig`` takes
and the conversions into them.

The reference's ``repro.launch.serve.DTYPES`` maps ``"float32"``,
``"bfloat16"`` and ``"fp8"`` (``jnp.float8_e4m3fn``); here the same names
map to ``torch.float32``, ``torch.bfloat16`` and ``torch.float8_e4m3fn``.

Rounding into e4m3 follows the reference, not PyTorch: ``jnp.astype``
rounds to nearest even over e4m3fn's finite values and gives NaN for a
magnitude that rounds past 448 (above the tie at 464, and ±inf), where
``Tensor.to(torch.float8_e4m3fn)`` saturates to ±448. :func:`to_e4m3` is
the reference's conversion; every cast into e4m3 of the port (params, a
cache write, a recurrent state) goes through :func:`cast`. bf16 is RNE in
both frameworks.
"""
from __future__ import annotations

import torch

FP8 = torch.float8_e4m3fn
NARROW = (torch.bfloat16, FP8)

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CACHE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "fp8": FP8}
PARAM_DTYPES = ("same", "fp8")

#: the largest magnitude that rounds to e4m3fn's largest finite value, 448
#: (the tie between 448 and 480 goes to 448, the even mantissa)
E4M3_TIE = 464.0


def to_e4m3(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded into e4m3fn as ``jnp.astype(jnp.float8_e4m3fn)`` rounds
    it: RNE, subnormals kept, NaN where |t| > 464 or t is ±inf or NaN."""
    t = t.to(torch.float32)
    return torch.where(t.abs() > E4M3_TIE, torch.nan, t).to(FP8)


def cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in ``dtype``: the reference's e4m3 rounding for e4m3
    (:func:`to_e4m3`), ``Tensor.to`` (RNE) otherwise."""
    if dtype == FP8 and t.dtype != FP8:
        return to_e4m3(t)
    return t.to(dtype)


def copy_into(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``dst.copy_(src)`` with the cast of :func:`cast` (a cache or state
    buffer in a narrower dtype than the values written)."""
    return dst.copy_(cast(src, dst.dtype))


def compute_dtype(name: str) -> torch.dtype:
    """The torch dtype of a ``compute_dtype`` name; others raise."""
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {name!r}: one of "
                         f"{sorted(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[name]


def cache_dtype(name: str) -> torch.dtype:
    """The torch dtype of a ``cache_dtype`` name; others raise."""
    if name not in CACHE_DTYPES:
        raise ValueError(f"cache_dtype {name!r}: one of "
                         f"{sorted(CACHE_DTYPES)}")
    return CACHE_DTYPES[name]


def param_dtype(name: str, compute: str) -> torch.dtype:
    """The dtype params are stored in: the compute dtype for ``"same"``,
    e4m3 for ``"fp8"`` (the reference's dry-run reading); others raise."""
    if name not in PARAM_DTYPES:
        raise ValueError(f"param_dtype {name!r}: one of {list(PARAM_DTYPES)}")
    return FP8 if name == "fp8" else compute_dtype(compute)
