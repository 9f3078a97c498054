// quant_matmul: out = q_k(q_k(x) @ q_k(w)), q_k = round-to-nearest-even of
// the f32 mantissa to k bits (implicit bit included) over the full f32
// exponent range, f32 accumulation on the CUDA cores. The serving GEMM of a
// uniform (certificate v1) or per-layer (v2) precision k.
//
// Replaces the Pallas TPU kernel _quant_matmul_kernel of
// src/repro/kernels/quant_matmul.py (wrapper quant_matmul), which baked k
// into each compile; here k is a runtime int, so one build serves every k
// and every lane of a per-layer map. Rounding is the bit trick of
// _rne_to_k_bits: s = 24 - k dropped bits, k >= 24 the identity, NaN and
// +-Inf passed through unchanged, and a finite value that rounds past the
// f32 maximum carries into Inf (repro_quantize_to_k_c in quantize_format.cuh).
//
// What bounds it on an H100: reading w once at decode (bytes, 3.35 TB/s),
// 2·M·N·K f32 operations at prefill (67 TFLOP/s on the CUDA cores). The
// GEMM body, its arithmetic contract (one fixed fmaf order per output
// element, row-invariant bits, no tensor cores: TF32's 11 bits are fewer
// than the k = 12 served) and its two configurations are in quant_gemm.cuh,
// shared with quant_matmul_format.cu. The functor carries the trick's shift
// and masks, built once per launch on the host.
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

// x [M, K], w [K, N], out [M, N]: f32, row-major, contiguous, on the device;
// k >= 1. Returns cudaGetLastError() after the launch.
extern "C" int repro_quant_matmul_f32(const void* x, const void* w, void* out,
                                      int M, int N, int K, int k,
                                      void* stream) {
    return static_cast<int>(
        quant_gemm(x, w, out, M, N, K, MantissaRound{repro_k_consts(k)},
                   stream));
}

// The same GEMM with its output unrounded: out = q_k(x) @ q_k(w), the f32
// accumulator in the same order as repro_quant_matmul_f32's (RawOut in
// quant_gemm.cuh). A violation monitor reads it, as the reference observes
// its product before the final rounding, and repro_quantize_k_inplace_f32
// then rounds it to the bits repro_quant_matmul_f32 writes.
extern "C" int repro_quant_matmul_raw_f32(const void* x, const void* w,
                                          void* out, int M, int N, int K,
                                          int k, void* stream) {
    return static_cast<int>(quant_gemm(
        x, w, out, M, N, K, RawOut<MantissaRound>{{repro_k_consts(k)}},
        stream));
}

// x[i] = q_k(x[i]) for n contiguous f32 values on the device, by the GEMM
// epilogue's own functor. Returns cudaGetLastError() after the launch.
extern "C" int repro_quantize_k_inplace_f32(void* x, long long n, int k,
                                            void* stream) {
    return static_cast<int>(repro_round_elementwise(
        x, x, n, MantissaRound{repro_k_consts(k)}, stream));
}
