// quant_matmul_format: out = q(q(x) @ q(w)), q = rounding into a custom
// (k, emax, emin) format, f32 accumulation on the CUDA cores.
//
// Replaces the Pallas TPU kernel _quant_matmul_format_kernel of
// src/repro/kernels/quant_matmul.py (wrapper quant_matmul_format). The
// format triple and flags are ordinary runtime arguments, so one build
// serves every certified format (the TPU kernel got them by scalar
// prefetch).
//
// What bounds it on an H100: reading w once at decode (bytes, 3.35 TB/s),
// 2·M·N·K f32 operations at prefill (67 TFLOP/s on the CUDA cores). The
// GEMM body, its arithmetic contract (one fixed fmaf order per output
// element, row-invariant bits, no tensor cores) and its two configurations
// are in quant_gemm.cuh, shared with quant_matmul.cu. The rounding is the
// body's per-element ALU work (at decode ~20 operations per weight against
// 4 FMAs), so the functor carries the format's constants, built once per
// launch on the host; the rounding is branch-free (quantize_format.cuh),
// and whether the format has subnormals is a template parameter, one GEMM
// instantiation each, so only one underflow case is computed.
#include "quant_gemm.cuh"
#include "quantize_format.cuh"

namespace {

// HS: the format has subnormals; one GEMM instantiation for each.
template <bool HS>
struct FormatRound {
    QFmtConsts c;
    __device__ __forceinline__ float operator()(float v) const {
        return repro_quantize_to_format_t<HS>(v, c);
    }
    __device__ __forceinline__ void pin() { repro_pin(c.kc); }
};

QFmtConsts format_consts(int k, int emax, int emin, int has_subnormals,
                         int saturating) {
    return repro_format_consts(
        QFmt{k, emax, emin, has_subnormals != 0, saturating});
}

template <bool HS>
__global__ void quantize_format_kernel(const float* __restrict__ x,
                                       float* __restrict__ y, long long n,
                                       FormatRound<HS> q) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         i < n; i += (long long)gridDim.x * blockDim.x) {
        y[i] = q(x[i]);
    }
}

}  // namespace

// x [M, K], w [K, N], out [M, N]: f32, row-major, contiguous, on the device.
// Returns cudaGetLastError() after the launch.
extern "C" int repro_quant_matmul_format_f32(
    const void* x, const void* w, void* out, int M, int N, int K, int k,
    int emax, int emin, int has_subnormals, int saturating, void* stream) {
    const QFmtConsts c =
        format_consts(k, emax, emin, has_subnormals, saturating);
    const cudaError_t rc =
        c.has_subnormals
            ? quant_gemm(x, w, out, M, N, K, FormatRound<true>{c}, stream)
            : quant_gemm(x, w, out, M, N, K, FormatRound<false>{c}, stream);
    return static_cast<int>(rc);
}

// Elementwise y = q(x) by the GEMM's own functor: checks the device rounding
// bit for bit against the plain version. Not on the serving path.
extern "C" int repro_quantize_format_f32(const void* x, void* y, long long n,
                                         int k, int emax, int emin,
                                         int has_subnormals, int saturating,
                                         void* stream) {
    const QFmtConsts c =
        format_consts(k, emax, emin, has_subnormals, saturating);
    const long long blocks = n > 0 ? (n + 255) / 256 : 1;
    const int grid = (int)(blocks < 4096 ? blocks : 4096);
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* xp = static_cast<const float*>(x);
    auto* yp = static_cast<float*>(y);
    if (c.has_subnormals) {
        quantize_format_kernel<<<grid, 256, 0, s>>>(xp, yp, n,
                                                    FormatRound<true>{c});
    } else {
        quantize_format_kernel<<<grid, 256, 0, s>>>(xp, yp, n,
                                                    FormatRound<false>{c});
    }
    return static_cast<int>(cudaGetLastError());
}
