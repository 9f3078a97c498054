// Rounding into a custom (k, emax, emin) floating-point format on an f32
// carrier: the device twin of repro_torch.core.quantize.quantize_to_format
// (itself bitwise the JAX package's repro.core.quantize.quantize_to_format).
//
// Bit-level, like the reference: RNE mantissa rounding by the integer trick
// on the f32 bits, powers of two built from exponent bits, rintf (round half
// to even) on the subnormal grid, IEEE division. Build without
// --use_fast_math: it would flush subnormals and approximate the division.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

struct QFmt {
    int k;               // precision, implicit bit included
    int emax;            // largest normal exponent
    int emin;            // smallest normal exponent
    int has_subnormals;  // gradual underflow on the 2^(emin-(k-1)) grid
    int saturating;      // overflow clamps to +-max_finite (else +-inf)
};

// Exact 2^e on f32, carrier subnormals included (pow2 of the reference).
__device__ __forceinline__ float repro_pow2f(int e) {
    if (e >= -126) {
        return __int_as_float(min(e + 127, 254) << 23);
    }
    return __int_as_float(1 << min(max(e + 149, 0), 23));
}

// RNE rounding of the stored mantissa to k bits; NaN/Inf pass through.
__device__ __forceinline__ float repro_quantize_to_k(float x, int k) {
    const int s = 24 - k;                  // dropped bits: 23 - (k - 1)
    if (s <= 0 || !isfinite(x)) return x;
    const int eff = min(s, 23);
    const uint32_t b = __float_as_uint(x);
    const uint32_t half = (1u << (eff - 1)) - 1u;
    const uint32_t lsb = (b >> eff) & 1u;
    return __uint_as_float((b + half + lsb) & ~((1u << eff) - 1u));
}

__device__ __forceinline__ float repro_quantize_to_format(float x,
                                                          const QFmt f) {
    if (!isfinite(x)) return x;
    float y = repro_quantize_to_k(x, f.k);
    const float max_fin = (2.0f - repro_pow2f(1 - f.k)) * repro_pow2f(f.emax);
    const float min_norm = repro_pow2f(f.emin);
    // gated on finite x: rounding may overflow the carrier itself (y = inf)
    if (fabsf(y) > max_fin) {
        y = copysignf(f.saturating ? max_fin : INFINITY, y);
    }
    if (fabsf(y) < min_norm && y != 0.0f) {
        if (f.has_subnormals) {
            // one rounding from the ORIGINAL value onto the subnormal grid
            const float step = repro_pow2f(f.emin - (f.k - 1));
            y = rintf(__fdiv_rn(x, step)) * step;
        } else {
            y = fabsf(y) < min_norm * 0.5f ? 0.0f : copysignf(min_norm, y);
        }
    }
    return y;
}
