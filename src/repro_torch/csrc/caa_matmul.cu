// caa_matmul: the fused value + absolute-error-bound GEMM of the CAA
// analysis, val = x @ W and err = (dbar + g·|x|) @ |W| (units of u), in one
// pass over shared tiles.
//
// Replaces the Pallas TPU kernel _caa_matmul_kernel of
// src/repro/kernels/caa_matmul.py (wrapper caa_matmul, reached through
// ops.caa_matmul_fused). With exact weights this is the dbar term of the
// reference's caa.contract rule. The TPU kernel baked g into each compile
// and accumulated err round-to-nearest; here g is a runtime float (one build
// serves every K and every layer; the wrapper rounds the analysis's f64 g
// up to f32), and err is an upper bound by construction: t = g·|x| + dbar
// is staged with __fmaf_ru and every term added with __fmaf_ru(t, |w|, acc),
// so err ≥ the exact (dbar + g·|x|)@|W| of the f32 operands, at the cost of
// ordinary FMAs. val accumulates with fmaf, rounding to nearest.
//
// What bounds it on an H100: reading W once at M = 4 (bytes, 3.35 TB/s), 2
// FMAs per term at M = 512 (4·M·K·N operations at 67 TFLOP/s). The body,
// its arithmetic contract (one fixed order per output element, row-invariant
// bits, ragged tiles masked) and its design are in interval_gemm.cuh, shared
// with interval_matmul.cu.
#include "interval_gemm.cuh"

// x, dbar [M, K], w [K, N], val, err [M, N]: f32, row-major, contiguous,
// on the device. Returns cudaGetLastError() after the launch.
extern "C" int repro_caa_matmul_f32(const void* x, const void* dbar,
                                    const void* w, void* val, void* err,
                                    int M, int N, int K, float g,
                                    void* stream) {
    return static_cast<int>(interval_gemm(x, dbar, w, val, err, nullptr, M,
                                          N, K, CaaTerm{g}, stream));
}
