"""Emulation of low-precision FP formats on f32/f64 carriers (PyTorch).

The PyTorch counterpart of the JAX package's ``repro.core.quantize``: the
same bit-level algorithms, so every function here returns the same bits as
its JAX twin for f32 and f64 carriers (the CPU tests hold them bitwise).

PyTorch's unsigned 32/64-bit integers are incomplete, so the round-to-
nearest-even trick runs on ``int32``/``int64`` views of the carrier. The
addition wraps around exactly as the unsigned one does (two's complement),
and ``>>`` is arithmetic on signed types, so every shifted value is masked
before use. Powers of two are built from exponent bits (:func:`pow2`),
never from ``exp2``/``ldexp``.

The CUDA kernels of :mod:`repro_torch.kernels` apply the same rounding in
``csrc/quantize_format.cuh``; this module is its plain version.
"""
from __future__ import annotations

from typing import Dict, Union

import torch

from repro_torch.core.formats import get as get_format

IntLike = Union[int, torch.Tensor]

_CARRIERS = {
    # dtype: (signed view, stored mantissa bits, exponent bias, min exponent)
    torch.float32: (torch.int32, 23, 127, -149),
    torch.float64: (torch.int64, 52, 1023, -1074),
}


def _carrier(dt):
    try:
        return _CARRIERS[dt]
    except KeyError:
        raise TypeError(f"carrier must be f32/f64, got {dt}") from None


def _round_bits(bits: torch.Tensor, s: int) -> torch.Tensor:
    """RNE-truncate the lowest ``s`` (1 ≤ s) bits of a signed view:
    ``(b + (2^{s-1} - 1) + ((b >> s) & 1)) & ~(2^s - 1)``. A mantissa
    overflow carries into the exponent through the integer addition."""
    half = (1 << (s - 1)) - 1
    lsb = (bits >> s) & 1
    return (bits + half + lsb) & ~((1 << s) - 1)


def _quantize_normal(x: torch.Tensor, k: int) -> torch.Tensor:
    """Round the mantissa of x to k bits (RNE), full carrier exponent range.

    Works for f32 (k ≤ 24) and f64 (k ≤ 53) carriers. NaN/Inf pass through
    (a NaN payload may carry into Inf under the integer trick)."""
    int_t, total_mant, _, _ = _carrier(x.dtype)
    s = total_mant - (int(k) - 1)
    if s <= 0:
        return x
    out = _round_bits(x.view(int_t), s).view(x.dtype)
    return torch.where(torch.isnan(x) | torch.isinf(x), x, out)


def quantize_to_k(x: torch.Tensor, k: IntLike) -> torch.Tensor:
    """Mantissa-only RNE rounding to ``k`` bits; the twin of the JAX
    ``quantize_to_k``. PyTorch runs eagerly, so ``k`` is a Python int (a
    0-d tensor is read once); ``k ≥ carrier precision`` is the identity."""
    int_t, total_mant, _, _ = _carrier(x.dtype)
    s = total_mant - (int(k) - 1)
    if s <= 0:
        return x
    eff = min(max(s, 1), total_mant)
    out = _round_bits(x.view(int_t), eff).view(x.dtype)
    return torch.where(torch.isnan(x) | torch.isinf(x), x, out)


def pow2(e: IntLike, dtype: torch.dtype = torch.float32,
         device=None) -> torch.Tensor:
    """Exact 2^e for integer ``e`` (int or int tensor), carrier subnormals
    included, built from exponent bits. Returns a tensor of ``dtype``."""
    int_t, mant, bias, min_e = _carrier(dtype)
    e = torch.as_tensor(e, dtype=torch.int64, device=device)
    bits_n = (e + bias).clamp(0, 2 * bias) << mant
    bits_s = torch.ones_like(e) << (e - min_e).clamp(0, mant)
    bits = torch.where(e >= 1 - bias, bits_n, bits_s)
    return bits.to(int_t).view(dtype)


def quantize_to_format(x: torch.Tensor, k: IntLike, emax: IntLike,
                       emin: IntLike, has_subnormals: bool = True,
                       saturating: bool = True,
                       max_finite=None) -> torch.Tensor:
    """Full custom-format rounding, bitwise the JAX ``quantize_to_format``:
    RNE mantissa rounding to ``k`` bits, overflow beyond ``max_finite``
    (default ``(2 - 2^{1-k})·2^emax``) saturates to ±max_finite (±inf with
    ``saturating=False``); magnitudes below ``2^emin`` are rounded on the
    subnormal grid of spacing ``2^{emin-(k-1)}`` from the ORIGINAL value
    (one rounding), or flushed to 0 / ±2^emin without subnormals. NaN/Inf
    pass through.

    The rounding of ``x / step`` goes through ``torch.round`` (half to
    even). PyTorch does not flush carrier subnormals, so they are rounded
    like any other value."""
    dt = x.dtype
    _carrier(dt)
    k, emax, emin = int(k), int(emax), int(emin)
    dev = x.device
    y = quantize_to_k(x, k)
    if max_finite is None:
        max_fin = (2.0 - pow2(1 - k, dt, dev)) * pow2(emax, dt, dev)
    else:
        max_fin = torch.tensor(max_finite, dtype=dt, device=dev)
    min_norm = pow2(emin, dt, dev)

    # gate on x, not y: mantissa rounding may overflow the CARRIER (finite
    # x near carrier max → y = ±inf), and saturation must still clamp that
    over = (y.abs() > max_fin) & torch.isfinite(x)
    if saturating:
        inf_like = torch.sign(y) * max_fin
    else:
        inf_like = torch.sign(y) * torch.tensor(float("inf"), dtype=dt,
                                                device=dev)
    y = torch.where(over, inf_like, y)

    tiny = (y.abs() < min_norm) & (y != 0)
    if has_subnormals:
        step = pow2(emin - (k - 1), dt, dev)
        snapped = torch.round(x / step) * step
        y = torch.where(tiny, snapped, y)
    else:
        half_norm = min_norm / 2
        y = torch.where(tiny & (y.abs() < half_norm), torch.zeros_like(y), y)
        y = torch.where(tiny & (y.abs() >= half_norm),
                        torch.sign(y) * min_norm, y)
    return torch.where(torch.isnan(x) | torch.isinf(x), x, y)


def numeric_health(x: torch.Tensor, k: IntLike, emax: IntLike,
                   emin: IntLike) -> Dict[str, torch.Tensor]:
    """Per-tensor numeric-health stats against a (k, emax, emin) format:
    largest finite magnitude, smallest nonzero magnitude (+inf if none),
    counts beyond max_finite, below 2^emin (nonzero) and non-finite. All
    values are 0-d tensors on ``x``'s device (no host sync)."""
    if x.dtype not in _CARRIERS:
        x = x.to(torch.float32)
    dt, dev = x.dtype, x.device
    k = int(k)
    max_fin = (2.0 - pow2(1 - k, dt, dev)) * pow2(int(emax), dt, dev)
    min_norm = pow2(int(emin), dt, dev)
    a = x.abs()
    finite = torch.isfinite(x)
    nonzero = finite & (a > 0)
    inf = torch.tensor(float("inf"), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    return {
        "max_abs": torch.where(finite, a, zero).max(),
        "min_nonzero": torch.where(nonzero, a, inf).min(),
        "n_over": ((a > max_fin) & finite).sum(),
        "n_under": (nonzero & (a < min_norm)).sum(),
        "n_nonfinite": (~finite).sum(),
    }


def quantize(x: torch.Tensor, fmt) -> torch.Tensor:
    """Round every element of ``x`` into the format ``fmt`` (an
    :class:`~repro_torch.core.formats.FpFormat`, a registry name or a
    precision k for ``custom(k)``), value kept in the f32/f64 carrier; the
    twin of the JAX ``quantize`` (its static-format path). Other dtypes are
    cast to f32 first."""
    fmt = get_format(fmt)
    if x.dtype not in _CARRIERS:
        x = x.to(torch.float32)
    return quantize_to_format(x, fmt.k, fmt.emax, fmt.emin,
                              fmt.has_subnormals, fmt.saturating,
                              max_finite=fmt.max_finite)


def quantized_op(op, fmt):
    """Wrap an op so its *result* is rounded into ``fmt``: 'every FP
    operation rounds once' (the paper's eq. (5)) at the format's
    precision, for operands already representable in it."""
    def wrapped(*args):
        return quantize(op(*args), fmt)

    return wrapped


def seq_dot(x: torch.Tensor, w: torch.Tensor, fmt) -> torch.Tensor:
    """Sequential-order ``x[..., n] @ w[n, m]`` with one rounding per
    operation in ``fmt``: acc = fl(acc + fl(x_i·w_i)), the scalar loop the
    paper analyses (the reference's ``lax.scan`` is a Python loop here;
    every step is elementwise, so the bits are the reference's)."""
    xq = quantize(x, fmt)
    wq = quantize(w, fmt)
    acc = torch.zeros(x.shape[:-1] + (w.shape[-1],), dtype=xq.dtype,
                      device=x.device)
    for i in range(x.shape[-1]):
        prod = quantize(xq[..., i, None] * wq[i], fmt)
        acc = quantize(acc + prod, fmt)
    return acc


def pairwise_dot(x: torch.Tensor, w: torch.Tensor, fmt) -> torch.Tensor:
    """Pairwise (tree) order ``x[..., n] @ w[n, m]`` with one rounding per
    operation in ``fmt``: the XLA/TPU reduction tree, odd counts carrying
    their last term."""
    prods = quantize(quantize(x, fmt)[..., :, None] * quantize(w, fmt), fmt)
    vals = torch.movedim(prods, -2, 0)
    while vals.shape[0] > 1:
        if vals.shape[0] % 2:
            carry, vals = vals[-1:], vals[:-1]
        else:
            carry = None
        vals = quantize(vals[0::2] + vals[1::2], fmt)
        if carry is not None:
            vals = torch.cat([vals, carry], dim=0)
    return vals[0]


def kahan_dot(x: torch.Tensor, w: torch.Tensor, fmt) -> torch.Tensor:
    """Kahan-compensated ``x[..., n] @ w[n, m]`` with one rounding per
    operation in ``fmt`` — the oracle of the 'kahan' accumulation order."""
    xq = quantize(x, fmt)
    wq = quantize(w, fmt)
    acc = torch.zeros(x.shape[:-1] + (w.shape[-1],), dtype=xq.dtype,
                      device=x.device)
    comp = torch.zeros_like(acc)
    for i in range(x.shape[-1]):
        prod = quantize(xq[..., i, None] * wq[i], fmt)
        y = quantize(prod - comp, fmt)
        t = quantize(acc + y, fmt)
        comp = quantize(quantize(t - acc, fmt) - y, fmt)
        acc = t
    return acc


def measured_error_in_u(exact: torch.Tensor, approx: torch.Tensor, fmt):
    """(absolute, relative) error of ``approx`` against ``exact`` in units
    of the format's u, in f64."""
    u = get_format(fmt).u
    exact, approx = exact.to(torch.float64), approx.to(torch.float64)
    abs_err = (approx - exact).abs() / u
    denom = exact.abs()
    inf = torch.full_like(abs_err, float("inf"))
    rel_err = torch.where(denom > 0, abs_err / denom,
                          torch.where(abs_err > 0, inf, 0.0))
    return abs_err, rel_err
