// interval_matmul: the interval GEMM of rigorous inference. For interval
// activations [lo, hi] and a constant W, the sign-split enclosure of x @ W
// and the magnitude majorant:
//   lo'  = Σ_k (w ≥ 0 ? lo : hi)·w      hi' = Σ_k (w ≥ 0 ? hi : lo)·w
//   mag' = Σ_k max(|lo|, |hi|)·|w|
//
// Replaces the Pallas TPU kernel _interval_matmul_kernel of
// src/repro/kernels/interval_matmul.py (wrapper interval_matmul, reached
// through ops.interval_matmul_rigorous). The TPU kernel ran three products
// per tile against W⁺ = max(W, 0) and W⁻ = min(W, 0); here the sign split
// is taken per term on the one staged W tile, as two fmas per bound
// predicated on w ≥ 0, of which one runs. Accumulation is f32 round
// to nearest, as in the reference: K products and K sums per bound, which
// the wrapper's γ_{2K+2}·2⁻²³·mag' widening covers for any order. Directed
// rounding (__fmaf_rd / __fmaf_ru) would let that widening go, but would
// change the result the reference gives, so it is not used.
//
// What bounds it on an H100: reading W once at M = 4 (bytes, 3.35 TB/s), 3
// FMAs per term at M = 512 (6·M·K·N operations at 67 TFLOP/s). The body,
// its arithmetic contract and its design are in interval_gemm.cuh, shared
// with caa_matmul.cu.
#include "interval_gemm.cuh"

// lo, hi [M, K], w [K, N], out_lo, out_hi, out_mag [M, N]: f32, row-major,
// contiguous, on the device. Returns cudaGetLastError() after the launch.
extern "C" int repro_interval_matmul_f32(const void* lo, const void* hi,
                                         const void* w, void* out_lo,
                                         void* out_hi, void* out_mag, int M,
                                         int N, int K, void* stream) {
    return static_cast<int>(interval_gemm(lo, hi, w, out_lo, out_hi,
                                          out_mag, M, N, K, IntervalTerm{},
                                          stream));
}
