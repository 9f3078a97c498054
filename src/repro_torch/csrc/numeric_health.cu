// numeric_health: the five numeric-health stats of an f32 tensor against a
// (k, emax, emin) format, written into one row of a violation monitor's
// device log (obs/monitors.py). The stats are those of the plain version,
// core/quantize.py::numeric_health:
//
//   max_abs      largest finite |x| (0 when there is none)
//   min_nonzero  smallest finite nonzero |x| (+inf when there is none)
//   n_over       finite elements with |x| > max_finite
//   n_under      finite nonzero elements with |x| < min_normal
//   n_nonfinite  NaN and ±inf elements
//
// max_finite = (2 - 2^(1-k)) * 2^emax and min_normal = 2^emin are computed
// by the host in f32 exactly as the plain version computes them (for k >= 26
// the first rounds to +inf in f32, and then nothing counts as over), and
// arrive here as their f32 bit patterns.
//
// A port-only kernel: the JAX package computes these stats with XLA and
// hands them to the host through one callback per matmul. Here every
// observed matmul launches this kernel once on the current stream, and the
// host reads the whole log back once per serving step.
//
// The row (four 64-bit words, 32 bytes):
//   word 0..2   n_over, n_under, n_nonfinite (int64)
//   word 3      max_abs (f32, low half), min_nonzero (f32, high half)
// The caller initialises it (max_abs 0, min_nonzero +inf, counts 0) once per
// step, not once per launch.
//
// Combination across blocks gives the same bits on every run: each block
// reduces its elements (warp shuffles, then the 8 warp results in order),
// then thread 0 folds the block's result into the row with atomicMax /
// atomicMin on the bit patterns of the non-negative magnitudes (whose
// unsigned order is their order as floats) and 64-bit integer atomicAdd for
// the counts. No float is added anywhere, so the order of the atomics does
// not matter. Comparisons are plain IEEE f32 comparisons; the build has no
// --use_fast_math, so subnormal inputs are not flushed.
//
// What bounds it on an H100: reading x once (bytes, 3.35 TB/s); at decode
// (4 rows of 512..18,944) it is a launch.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned int kInfBits = 0x7f800000u;

struct Health {
    unsigned int max_bits;
    unsigned int min_bits;
    unsigned long long over, under, nonfinite;
};

__device__ __forceinline__ void take(float v, float max_fin, float min_norm,
                                     Health& h) {
    const float a = fabsf(v);
    if (!isfinite(v)) {
        ++h.nonfinite;
        return;
    }
    const unsigned int bits = __float_as_uint(a);
    h.max_bits = max(h.max_bits, bits);
    if (a > max_fin) ++h.over;
    if (a > 0.0f) {
        h.min_bits = min(h.min_bits, bits);
        if (a < min_norm) ++h.under;
    }
}

__device__ __forceinline__ void fold(Health& h, const Health& o) {
    h.max_bits = max(h.max_bits, o.max_bits);
    h.min_bits = min(h.min_bits, o.min_bits);
    h.over += o.over;
    h.under += o.under;
    h.nonfinite += o.nonfinite;
}

__device__ __forceinline__ Health shfl(const Health& h, int off) {
    Health o;
    o.max_bits = __shfl_xor_sync(0xffffffffu, h.max_bits, off);
    o.min_bits = __shfl_xor_sync(0xffffffffu, h.min_bits, off);
    o.over = __shfl_xor_sync(0xffffffffu, h.over, off);
    o.under = __shfl_xor_sync(0xffffffffu, h.under, off);
    o.nonfinite = __shfl_xor_sync(0xffffffffu, h.nonfinite, off);
    return o;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
numeric_health_kernel(const float* __restrict__ x, long long n,
                      float max_fin, float min_norm,
                      unsigned long long* __restrict__ row) {
    Health h{0u, kInfBits, 0ull, 0ull, 0ull};
    const long long stride = (long long)gridDim.x * kThreads;
    const long long t0 = (long long)blockIdx.x * kThreads + threadIdx.x;
    long long tail = 0;
    if (kVec) {
        const long long n4 = n / 4;
        const float4* x4 = reinterpret_cast<const float4*>(x);
        for (long long i = t0; i < n4; i += stride) {
            const float4 v = x4[i];
            take(v.x, max_fin, min_norm, h);
            take(v.y, max_fin, min_norm, h);
            take(v.z, max_fin, min_norm, h);
            take(v.w, max_fin, min_norm, h);
        }
        tail = n4 * 4;
    }
    for (long long i = tail + t0; i < n; i += stride) {
        take(x[i], max_fin, min_norm, h);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) fold(h, shfl(h, off));
    __shared__ Health warp_h[kWarps];
    const int t = threadIdx.x;
    if (t % 32 == 0) warp_h[t / 32] = h;
    __syncthreads();
    if (t != 0) return;
    Health b = warp_h[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) fold(b, warp_h[w]);
    unsigned int* halves = reinterpret_cast<unsigned int*>(row + 3);
    if (b.max_bits != 0u) atomicMax(halves, b.max_bits);
    if (b.min_bits != kInfBits) atomicMin(halves + 1, b.min_bits);
    if (b.over) atomicAdd(row + 0, b.over);
    if (b.under) atomicAdd(row + 1, b.under);
    if (b.nonfinite) atomicAdd(row + 2, b.nonfinite);
}

int sm_count() {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms > 0 ? sms : 1;
}

}  // namespace

// x: n f32 values, contiguous, on the device; row: 32 bytes of the log,
// initialised by the caller. max_fin_bits / min_norm_bits: the f32 bit
// patterns of max_finite and min_normal. Returns cudaGetLastError() after
// the launch.
extern "C" int repro_numeric_health_f32(const void* x, long long n,
                                        unsigned int max_fin_bits,
                                        unsigned int min_norm_bits,
                                        void* row, void* stream) {
    if (n <= 0) return 0;
    static const int sms = sm_count();
    float max_fin, min_norm;
    memcpy(&max_fin, &max_fin_bits, sizeof(float));
    memcpy(&min_norm, &min_norm_bits, sizeof(float));
    const bool vec = (reinterpret_cast<uintptr_t>(x) % 16) == 0;
    // 16 elements a thread before the grid is capped at 8 blocks an SM
    const long long per_block = (long long)kThreads * 16;
    long long blocks = (n + per_block - 1) / per_block;
    if (blocks > 8LL * sms) blocks = 8LL * sms;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* xf = static_cast<const float*>(x);
    unsigned long long* r = static_cast<unsigned long long*>(row);
    if (vec) {
        numeric_health_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
            xf, n, max_fin, min_norm, r);
    } else {
        numeric_health_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
            xf, n, max_fin, min_norm, r);
    }
    return static_cast<int>(cudaGetLastError());
}
