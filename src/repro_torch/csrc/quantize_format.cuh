// Rounding into a custom (k, emax, emin) floating-point format on an f32
// carrier: the device twin of repro_torch.core.quantize.quantize_to_format
// (itself bitwise the JAX package's repro.core.quantize.quantize_to_format).
//
// Bit-level, like the reference: RNE mantissa rounding by the integer trick
// on the f32 bits, powers of two built from exponent bits, rintf (round half
// to even) on the subnormal grid, IEEE division. Build without
// --use_fast_math: it would flush subnormals and approximate the division.
//
// The kernels (the GEMM body quant_gemm.cuh, flash_decode_certified.cu)
// round through repro_quantize_to_format_t: the format's constants (largest
// finite value, smallest normal, subnormal step, the mantissa trick's shift
// and masks) are built once on the host by repro_format_consts and carried
// by value, every case is computed and selected without a branch, and the
// division onto the subnormal grid is an exact multiplication by powers of
// two.
#pragma once

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

struct QFmt {
    int k;               // precision, implicit bit included
    int emax;            // largest normal exponent
    int emin;            // smallest normal exponent
    int has_subnormals;  // gradual underflow on the 2^(emin-(k-1)) grid
    int saturating;      // overflow clamps to +-max_finite (else +-inf)
};

// ------------------------------------------- constants built once a launch

// The mantissa trick's constants for k bits: s = 24 - k dropped bits;
// k >= 24 rounds nothing (half = lsb = 0, mask = ~0).
struct QKConsts {
    uint32_t eff;   // min(s, 23)
    uint32_t half;  // 2^(eff-1) - 1
    uint32_t lsb;   // 1, or 0 where nothing is rounded
    uint32_t mask;  // ~(2^eff - 1)
};

// A format's constants, derived from QFmt as the plain version derives
// them.
struct QFmtConsts {
    QKConsts kc;
    float max_fin;        // (2 - 2^(1-k)) * 2^emax
    float min_norm;       // 2^emin
    float half_min_norm;  // min_norm * 0.5
    float step;           // 2^(emin - (k-1)), the subnormal spacing
    float sub_s1, sub_s2; // (x * sub_s1) * sub_s2 is x / step, bit for bit
    float ovf;            // saturating ? max_fin : inf
    int has_subnormals;
};

inline float repro_f32_from_bits(uint32_t u) {
    float f;
    memcpy(&f, &u, sizeof f);
    return f;
}

// Exact 2^e on f32 (pow2 of the reference), on the host: e is clamped
// to [-149, 127].
inline float repro_pow2f_host(int e) {
    if (e >= -126) {
        const int b = e + 127 < 254 ? e + 127 : 254;
        return repro_f32_from_bits(static_cast<uint32_t>(b) << 23);
    }
    int sh = e + 149;
    sh = sh < 0 ? 0 : (sh > 23 ? 23 : sh);
    return repro_f32_from_bits(1u << sh);
}

inline QKConsts repro_k_consts(int k) {
    const int s = 24 - k;
    if (s <= 0) return QKConsts{0u, 0u, 0u, ~0u};
    const uint32_t eff = static_cast<uint32_t>(s < 23 ? s : 23);
    return QKConsts{eff, (1u << (eff - 1)) - 1u, 1u, ~((1u << eff) - 1u)};
}

inline QFmtConsts repro_format_consts(const QFmt f) {
    QFmtConsts c;
    c.kc = repro_k_consts(f.k);
    c.max_fin = (2.0f - repro_pow2f_host(1 - f.k)) * repro_pow2f_host(f.emax);
    c.min_norm = repro_pow2f_host(f.emin);
    c.half_min_norm = c.min_norm * 0.5f;
    c.step = repro_pow2f_host(f.emin - (f.k - 1));
    // step is 2^e_s, e_s the clamped exponent; x / step and x * 2^-e_s are
    // the same real number, so they round to the same float. 2^-e_s is an
    // f32 for -e_s <= 127; beyond, x * 2^127 is exact (an upscale that
    // overflows only where x / step does too) and the second factor rounds.
    int e_s = f.emin - (f.k - 1);
    e_s = e_s < -149 ? -149 : (e_s > 127 ? 127 : e_s);
    c.sub_s1 = repro_pow2f_host(-e_s <= 127 ? -e_s : 127);
    c.sub_s2 = repro_pow2f_host(-e_s <= 127 ? 0 : -e_s - 127);
    c.ovf = f.saturating ? c.max_fin : repro_f32_from_bits(0x7f800000u);
    c.has_subnormals = f.has_subnormals;
    return c;
}

// RNE rounding of the stored mantissa to the constants' k bits. On NaN and
// +-Inf the result is meaningless: callers select x for those.
__device__ __forceinline__ float repro_round_mantissa(float x,
                                                      const QKConsts c) {
    const uint32_t b = __float_as_uint(x);
    const uint32_t lsb = (b >> c.eff) & c.lsb;
    return __uint_as_float((b + c.half + lsb) & c.mask);
}

// RNE rounding of the stored mantissa to k bits; NaN/Inf pass through.
// The rounding is computed for every x and then selected (not predicated),
// so a tile of values rounds without divergent work.
__device__ __forceinline__ float repro_quantize_to_k_c(float x,
                                                       const QKConsts c) {
    const float r = repro_round_mantissa(x, c);
    return isfinite(x) ? r : x;
}

// Keeps the mantissa trick's constants in registers: the compiler may
// otherwise reload them from the constant bank for every element it rounds
// (an integer shift takes its amount from a register). The float
// constants of a format stay where they are: a floating-point instruction
// reads the constant bank at no cost.
__device__ __forceinline__ void repro_pin(QKConsts& c) {
    asm volatile("" : "+r"(c.eff), "+r"(c.half), "+r"(c.lsb), "+r"(c.mask));
}

// rintf (round half to even) without the conversion pipe, which runs at an
// eighth of the f32 rate: for |v| < 2^23, |v| + 2^23 lies where the f32
// spacing is 1, so the addition rounds |v| to an integer, half to even,
// and the subtraction is exact; copysignf restores the sign (and -0).
// From 2^23 on every f32 is an integer already.
__device__ __forceinline__ float repro_rint(float v) {
    const float r = (fabsf(v) + 8388608.0f) - 8388608.0f;
    return fabsf(v) < 8388608.0f ? copysignf(r, v) : v;
}

// Rounding into the format, without a branch: every case is computed and
// the right one selected (the GEMM body rounds whole tiles; a branch taken
// by one lane in a few hundred would hold up its warp). HS: the format has
// subnormals (c.has_subnormals, fixed for a launch).
template <bool HS>
__device__ __forceinline__ float repro_quantize_to_format_t(
    float x, const QFmtConsts& c) {
    const float r = repro_round_mantissa(x, c.kc);
    // overflow (a finite x may round past the carrier itself: r = inf)
    float y = fabsf(r) > c.max_fin ? copysignf(c.ovf, r) : r;
    // underflow: one rounding from the ORIGINAL value onto the subnormal
    // grid, or a flush to 0 / +-min_norm
    const float a = fabsf(y);
    const float sub =
        HS ? repro_rint((x * c.sub_s1) * c.sub_s2) * c.step
           : (a < c.half_min_norm ? 0.0f : copysignf(c.min_norm, y));
    y = a < c.min_norm && y != 0.0f ? sub : y;
    return isfinite(x) ? y : x;
}
