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
// element, row-invariant bits) and its design are in quant_gemm.cuh,
// shared with quant_matmul.cu.
#include "quant_gemm.cuh"
#include "quantize_format.cuh"

namespace {

struct FormatRound {
    QFmt f;
    __device__ __forceinline__ float operator()(float v) const {
        return repro_quantize_to_format(v, f);
    }
};

__global__ void quantize_format_kernel(const float* __restrict__ x,
                                       float* __restrict__ y, long long n,
                                       QFmt f) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         i < n; i += (long long)gridDim.x * blockDim.x) {
        y[i] = repro_quantize_to_format(x[i], f);
    }
}

}  // namespace

// x [M, K], w [K, N], out [M, N]: f32, row-major, contiguous, on the device.
// Returns cudaGetLastError() after the launch.
extern "C" int repro_quant_matmul_format_f32(
    const void* x, const void* w, void* out, int M, int N, int K, int k,
    int emax, int emin, int has_subnormals, int saturating, void* stream) {
    const FormatRound q{QFmt{k, emax, emin, has_subnormals, saturating}};
    return static_cast<int>(quant_gemm(x, w, out, M, N, K, q, stream));
}

// Elementwise y = q(x): checks the device rounding bit for bit against the
// plain version. Not on the serving path.
extern "C" int repro_quantize_format_f32(const void* x, void* y, long long n,
                                         int k, int emax, int emin,
                                         int has_subnormals, int saturating,
                                         void* stream) {
    const QFmt f{k, emax, emin, has_subnormals, saturating};
    const long long blocks = n > 0 ? (n + 255) / 256 : 1;
    quantize_format_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<float*>(y), n, f);
    return static_cast<int>(cudaGetLastError());
}
