// quant_matmul's narrow instances: out = q_k(q_k(x) @ q_k(w)), q_k the RNE
// rounding of the mantissa to k bits, for x in f32 or bf16 and w in f32,
// bf16 or e4m3 (not both f32), written in x's dtype, or in f32 and
// unrounded for the raw instance (the violation monitor's accumulator, as
// in quant_matmul.cu): kernel 3 under ServeConfig's compute_dtype
// "bfloat16" and param_dtype "fp8".
//
// Replaces the Pallas TPU kernel _quant_matmul_kernel of
// src/repro/kernels/quant_matmul.py (wrapper quant_matmul) on bf16 and
// e4m3 operands. The body is quant_gemm.cuh's, the one of quant_matmul.cu,
// with its loads typed: bit for bit the f32 instance on the upcast
// operands, then RNE into x's dtype.
// A library of its own, built at first use: its instances (five operand
// pairs of the templated body) would slow the f32 instances' build.
#include "quant_gemm.cuh"
#include "quantize_format.cuh"

namespace {

struct MantissaRound {
    QKConsts c;
    __device__ __forceinline__ float operator()(float v) const {
        return repro_quantize_to_k_c(v, c);
    }
    __device__ __forceinline__ void pin() { repro_pin(c); }
};

}  // namespace

// x [M, K] of operand type code tx (0 f32, 1 bf16), w [K, N] of code tw
// (0 f32, 1 bf16, 2 e4m3), not both f32; out [M, N] of x's type, or f32
// where raw; row-major, contiguous, on the device; k >= 1. Returns
// cudaGetLastError() after the launch.
extern "C" int repro_quant_matmul_narrow(const void* x, const void* w,
                                         void* out, int M, int N, int K,
                                         int k, int raw, int tx, int tw,
                                         void* stream) {
    const MantissaRound q{repro_k_consts(k)};
    return static_cast<int>(
        raw ? quant_gemm_narrow<true>(x, w, out, M, N, K, tx, tw, q, stream)
            : quant_gemm_narrow<false>(x, w, out, M, N, K, tx, tw, q,
                                       stream));
}
