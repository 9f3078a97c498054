"""Public wrappers over the CAA analysis kernels, as the JAX package's
``repro.kernels.ops`` has them: batch-dim flattening, f32 casts, and the
rigorous γ-slop widening that turns the raw interval GEMM into a sound
enclosure.

Tensors on the CPU take each kernel's plain version; tensors on the card
launch the hand-written CUDA kernel (or raise — there is no fallback). The
kernels mask ragged tiles themselves, so nothing is padded.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.caa_matmul import caa_matmul, caa_matmul_plain
from repro_torch.kernels.interval_matmul import (interval_matmul,
                                                 interval_matmul_plain)


def gamma_in_u(n: int, u: float) -> float:
    """γ_n in units of u (the reference's ``kernels.ref.gamma_in_u``)."""
    m = 0.5 * n * u
    return (0.5 * n) / (1.0 - m) if m < 1 else float("inf")


def _flat(t: torch.Tensor) -> torch.Tensor:
    """[..., K] f32 → [T, K], contiguous."""
    return t.to(torch.float32).reshape(-1, t.shape[-1]).contiguous()


def _on_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def interval_matmul_rigorous(lo, hi, w):
    """Rigorous interval GEMM: [..., K] interval × [K, N] → (lo', hi',
    mag') with the f32 accumulation error of any order folded in: the raw
    bounds widened by γ_{2K+2}·2⁻²³·mag' (in f32, as the reference)."""
    lead, K = lo.shape[:-1], lo.shape[-1]
    lo2, hi2, w2 = _flat(lo), _flat(hi), w.to(torch.float32).contiguous()
    fn = interval_matmul_plain if _on_cpu(lo2, hi2, w2) else interval_matmul
    out_lo, out_hi, out_mag = fn(lo2, hi2, w2)
    g = gamma_in_u(2 * K + 2, 2.0 ** -23) * 2.0 ** -23
    out_lo = out_lo - g * out_mag
    out_hi = out_hi + g * out_mag
    N = w2.shape[1]
    return (out_lo.reshape(*lead, N), out_hi.reshape(*lead, N),
            out_mag.reshape(*lead, N))


def caa_matmul_fused(x, dbar, w, *, g: float):
    """Fused value + error GEMM: (val, dbar') for [..., K] @ [K, N]."""
    lead = x.shape[:-1]
    x2, d2, w2 = _flat(x), _flat(dbar), w.to(torch.float32).contiguous()
    fn = caa_matmul_plain if _on_cpu(x2, d2, w2) else caa_matmul
    val, err = fn(x2, d2, w2, g=g)
    N = w2.shape[1]
    return val.reshape(*lead, N), err.reshape(*lead, N)
