// f32_matmul: out = x @ w in f32 with one fixed fmaf order per output
// element, whatever the row count: the LM head of the serving path
// (layers.logits_head, "bsd,vd->bsv" through TorchOps.einsum on the card).
//
// A port-only kernel: no TPU kernel of the JAX package has this job (XLA
// computed the head there). It exists for the serving contract that a lane's
// bits do not depend on its batch: PyTorch's library GEMM picks its kernel
// by M, so a lane's logits at M = 4 and at M = 1 differed in their last bits
// at Qwen2-7B's width.
//
// It is the certified GEMM body of quant_gemm.cuh (kernels 1 and 3)
// instantiated with a rounding functor that rounds nothing: every output
// sums k = 0..K-1 with fmaf from +0, one rounding per step, no split-K, the
// same order in the decode GEMV (M <= 8) and the prefill SGEMM (M > 8), so a
// row's bits depend on K alone. The body reads w as [K, N]; the head's table
// is [V, D], so the caller hands it a transposed contiguous copy
// (row_order.transposed): the body, and with it kernels 1 and 3, stays
// exactly as it was. row_order.f32_matmul_seq_ref is this order in plain
// PyTorch (fmaf emulated exactly).
//
// What bounds it on an H100: reading w once at decode (V·D·4 bytes: 2.18
// GB at Qwen2-7B's width, 3.35 TB/s); 2·M·N·K f32 operations at prefill
// (67 TFLOP/s on the CUDA cores).
#include "quant_gemm.cuh"

namespace {

struct PassThrough {
    __device__ __forceinline__ float operator()(float v) const { return v; }
    __device__ __forceinline__ void pin() {}
};

}  // namespace

// x [M, K], w [K, N], out [M, N]: f32, row-major, contiguous, on the device.
// Returns cudaGetLastError() after the launch.
extern "C" int repro_f32_matmul(const void* x, const void* w, void* out,
                                int M, int N, int K, void* stream) {
    return static_cast<int>(
        quant_gemm(x, w, out, M, N, K, PassThrough{}, stream));
}
