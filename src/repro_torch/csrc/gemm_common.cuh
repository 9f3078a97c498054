// What the two f32 CUDA-core GEMM bodies (quant_gemm.cuh, kernels 1 and 3;
// interval_gemm.cuh, kernels 5 and 6) share: the cp.async copies and the
// ring's commit / wait, packs of W floats in shared memory, the copy of one
// K-tile of w, and the launch helpers. The decode-attention body
// (flash_decode.cuh, kernels 2 and 4) takes the copies and allow_smem.
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
    const unsigned d =
        static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
    const unsigned d =
        static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    // the clobber keeps the compiler from moving a shared-memory access of
    // this thread across the wait (each thread reads its own copies after it)
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A W-float async copy (W = 4: 16 bytes, W = 1: 4), zero-filled if !ok.
template <int W>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool ok) {
    if constexpr (W == 4) {
        cp_async16(dst, src, ok);
    } else {
        cp_async4(dst, src, ok);
    }
}

// W consecutive floats of shared memory, in registers.
template <int W>
struct Pack {
    float v[W];
};

template <int W>
__device__ __forceinline__ Pack<W> lds_pack(const float* p) {
    Pack<W> r;
    if constexpr (W == 4) {
        const float4 t = *reinterpret_cast<const float4*>(p);
        r.v[0] = t.x; r.v[1] = t.y; r.v[2] = t.z; r.v[3] = t.w;
    } else {
        r.v[0] = *p;
    }
    return r;
}

template <int W>
__device__ __forceinline__ void sts_pack(float* p, const Pack<W>& r) {
    if constexpr (W == 4) {
        *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2],
                                                    r.v[3]);
    } else {
        *p = r.v[0];
    }
}

// Copies of one K-tile of w (BK x BN at rows k0.., columns n0..) into the
// slot ws [BK][BN] by NT copying threads: item j of thread pt is element
// e = W*(pt + j*NT), 16 bytes (W = 4) or 4 (W = 1); past an edge,
// zero-filled.
template <int W, int BK, int BN, int NT>
__device__ __forceinline__ void copy_w(float* ws, const float* w, int pt,
                                       int k0, int n0, int N, int K) {
    static_assert(BK * BN % (W * NT) == 0, "whole shares");
#pragma unroll
    for (int j = 0; j < BK * BN / (W * NT); ++j) {
        const int e = W * (pt + j * NT);
        const int gk = k0 + e / BN, gn = n0 + e % BN;
        const bool ok = gk < K && gn < N;
        cp_async<W>(ws + e, ok ? w + (size_t)gk * N + gn : w, ok);
    }
}

// Raise a kernel's dynamic shared memory limit once, where it needs more
// than the default 48 KB.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

inline int sm_count() {
    static const int n = [] {
        int dev = 0, v = 132;
        if (cudaGetDevice(&dev) == cudaSuccess) {
            cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
        }
        return v;
    }();
    return n;
}

}  // namespace
