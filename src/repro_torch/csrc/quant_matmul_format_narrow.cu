// quant_matmul_format's narrow instances: out = q(q(x) @ q(w)) in a custom
// (k, emax, emin) format for x in f32 or bf16 and w in f32, bf16 or e4m3
// (not both f32), written in x's dtype: kernel 1 under ServeConfig's
// compute_dtype "bfloat16" and param_dtype "fp8".
//
// Replaces the Pallas TPU kernel _quant_matmul_format_kernel of
// src/repro/kernels/quant_matmul.py (wrapper quant_matmul_format) on bf16
// and e4m3 operands, which it reads with x.astype(f32) inside. The body is
// quant_gemm.cuh's, the one of quant_matmul_format.cu, with its loads
// typed: bit for bit the f32 instance on the upcast operands, then RNE into
// x's dtype.
// A library of its own, built at first use: its instances (five operand
// pairs of the templated body) would slow the f32 instances' build.
#include "quant_gemm.cuh"
#include "quantize_format.cuh"

namespace {

// HS: the format has subnormals; one instantiation each, as in
// quant_matmul_format.cu.
template <bool HS>
struct FormatRound {
    QFmtConsts c;
    __device__ __forceinline__ float operator()(float v) const {
        return repro_quantize_to_format_t<HS>(v, c);
    }
    __device__ __forceinline__ void pin() { repro_pin(c.kc); }
};

}  // namespace

// x [M, K] of operand type code tx (0 f32, 1 bf16), w [K, N] of code tw
// (0 f32, 1 bf16, 2 e4m3), not both f32; out [M, N] of x's type; row-major,
// contiguous, on the device. Returns cudaGetLastError() after the launch.
extern "C" int repro_quant_matmul_format_narrow(
    const void* x, const void* w, void* out, int M, int N, int K, int k,
    int emax, int emin, int has_subnormals, int saturating, int tx, int tw,
    void* stream) {
    const QFmtConsts c = repro_format_consts(
        QFmt{k, emax, emin, has_subnormals != 0, saturating});
    const cudaError_t rc =
        c.has_subnormals
            ? quant_gemm_narrow(x, w, out, M, N, K, tx, tw,
                                FormatRound<true>{c}, stream)
            : quant_gemm_narrow(x, w, out, M, N, K, tx, tw,
                                FormatRound<false>{c}, stream);
    return static_cast<int>(rc);
}
