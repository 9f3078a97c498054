// row_mean: out[r] = (sum over i of x[r, i]) / n for f32 x [R, n], in one
// summation order that depends on n alone. The mean of the rmsnorm on the
// serving path (mean(x², -1) of the port's layers.rmsnorm: the square is its
// own elementwise op, as in the reference, so this kernel sums what it is
// given).
//
// A port-only kernel: no TPU kernel of the JAX package has this job (XLA
// computed the mean there). It exists for the serving contract that a lane's
// bits do not depend on its batch: PyTorch's CUDA reduction picks its
// schedule by the row count, so the same row summed in a batch of 4 and
// alone came out in different bits at Qwen2-7B's width.
//
// The order, for blockDim = 256 (fixed, whatever R or n): thread t adds
// x[t], x[t+256], x[t+512], ... to an f32 accumulator that starts at +0, one
// rounding per addition (__fadd_rn: never contracted into an FMA); each warp
// then folds its 32 lanes by an xor butterfly over offsets 16, 8, 4, 2, 1
// (both lanes of a pair compute the same sum, addition commutes); thread 0
// adds the 8 warp sums in warp order, w0 + w1 + ... + w7, and divides by n
// (__fdiv_rn). A row's order depends on n only: not on R, on the row's place
// or on padding. row_order.row_mean_ref is this order in plain PyTorch.
//
// What bounds it on an H100: reading x once (bytes, 3.35 TB/s); at the
// shapes serving gives it (R = 4..512 rows of 3,584) it is a launch.
//
// The bf16 instance (compute_dtype "bfloat16") reads bf16 x, converts each
// element to f32 straight after its load (exact) and runs the same order,
// then writes the f32 mean rounded to bf16 (RNE): jnp.mean's f32
// accumulation of a bf16 array, bit for bit the f32 instance on the upcast
// x followed by the cast.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float rm_f32(float v) { return v; }
__device__ __forceinline__ float rm_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
__device__ __forceinline__ void rm_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void rm_store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
row_mean_kernel(const T* __restrict__ x, T* __restrict__ out, int n) {
    const T* row = x + (size_t)blockIdx.x * n;
    const int t = threadIdx.x;
    float acc = 0.0f;
    for (int i = t; i < n; i += kThreads) {
        acc = __fadd_rn(acc, rm_f32(row[i]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    }
    __shared__ float warp_sum[kThreads / 32];
    if (t % 32 == 0) warp_sum[t / 32] = acc;
    __syncthreads();
    if (t == 0) {
        float s = warp_sum[0];
#pragma unroll
        for (int w = 1; w < kThreads / 32; ++w) s = __fadd_rn(s, warp_sum[w]);
        rm_store(out + blockIdx.x, __fdiv_rn(s, static_cast<float>(n)));
    }
}

}  // namespace

// x [R, n], out [R]: f32, contiguous, on the device; n >= 1. Returns
// cudaGetLastError() after the launch.
extern "C" int repro_row_mean_f32(const void* x, void* out, int rows, int n,
                                  void* stream) {
    if (rows <= 0) return 0;
    row_mean_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<float*>(out), n);
    return static_cast<int>(cudaGetLastError());
}

// x [R, n], out [R]: bf16, contiguous, on the device; n >= 1. Returns
// cudaGetLastError() after the launch.
extern "C" int repro_row_mean_bf16(const void* x, void* out, int rows, int n,
                                   void* stream) {
    if (rows <= 0) return 0;
    row_mean_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
        n);
    return static_cast<int>(cudaGetLastError());
}
