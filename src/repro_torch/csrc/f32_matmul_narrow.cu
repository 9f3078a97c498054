// f32_matmul's narrow instances: out = x @ w with one fixed fmaf order per
// output element, for x in f32 or bf16 and w in f32, bf16 or e4m3 (not
// both f32), written in x's dtype: serving's LM head and the plain
// backend's products under ServeConfig's compute_dtype "bfloat16" and
// param_dtype "fp8".
//
// A port-only kernel, as f32_matmul.cu (XLA computed these products in the
// reference). The body is quant_gemm.cuh's with a functor that rounds
// nothing and its loads typed: bit for bit the f32 instance on the upcast
// operands, then RNE into x's dtype (the reference's
// preferred_element_type=f32 product and .astype).
// A library of its own, built at first use: its instances (five operand
// pairs of the templated body) would slow the f32 instances' build.
#include "quant_gemm.cuh"

namespace {

struct PassThrough {
    __device__ __forceinline__ float operator()(float v) const { return v; }
    __device__ __forceinline__ void pin() {}
};

}  // namespace

// x [M, K] of operand type code tx (0 f32, 1 bf16), w [K, N] of code tw
// (0 f32, 1 bf16, 2 e4m3), not both f32; out [M, N] of x's type; row-major,
// contiguous, on the device. Returns cudaGetLastError() after the launch.
extern "C" int repro_f32_matmul_narrow(const void* x, const void* w,
                                       void* out, int M, int N, int K, int tx,
                                       int tw, void* stream) {
    return static_cast<int>(quant_gemm_narrow(x, w, out, M, N, K, tx, tw,
                                              PassThrough{}, stream));
}
