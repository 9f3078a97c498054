// What the two f32 CUDA-core GEMM bodies (quant_gemm.cuh, kernels 1 and 3;
// interval_gemm.cuh, kernels 5 and 6) share: the cp.async copies and the
// ring's commit / wait, packs of W elements in shared memory read as f32,
// the copy of one K-tile of w, the operand types' conversions, and the
// launch helpers. The decode-attention body (flash_decode.cuh, kernels 2
// and 4) takes the copies, the conversions and allow_smem.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace {

// The operand types' codes of the narrow instances' C interfaces: f32,
// bf16, e4m3 (__nv_fp8_e4m3, the reference's jnp.float8_e4m3fn).
enum OperandType : int { kF32 = 0, kBF16 = 1, kE4M3 = 2 };

// An operand element in f32 (exact: bf16 and e4m3 are subsets of f32).
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 v) {
    return static_cast<float>(v);
}

// An f32 result stored in the output's type: as it is, or by RNE.
__device__ __forceinline__ void store_rn(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_rn(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
    const unsigned d =
        static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
    const unsigned d =
        static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 8 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
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

// An async copy of W elements of T (16, 8 or 4 bytes: f32 W = 4 or 1,
// bf16 8, 4 or 2, e4m3 8 or 4), zero-filled if !ok. Fewer than 4 bytes (one
// bf16 or e4m3 element, at a row that is not aligned) is a plain load and
// store: the same thread reads it back after its wait, as it reads its
// async copies.
template <int W, class T>
__device__ __forceinline__ void cp_async(T* dst, const T* src, bool ok) {
    constexpr int B = W * (int)sizeof(T);
    if constexpr (B == 16) {
        cp_async16(dst, src, ok);
    } else if constexpr (B == 8) {
        cp_async8(dst, src, ok);
    } else if constexpr (B == 4) {
        cp_async4(dst, src, ok);
    } else {
        static_assert(W == 1, "one element of fewer than 4 bytes");
        using U = typename std::conditional<B == 2, uint16_t, uint8_t>::type;
        *reinterpret_cast<U*>(dst) =
            ok ? *reinterpret_cast<const U*>(src) : U(0);
    }
}

// W consecutive elements of shared memory, in registers, in f32.
template <int W>
struct Pack {
    float v[W];
};

// The W elements of T at p (aligned to their W * sizeof(T) bytes where
// that is 4, 8 or 16), read in one load and converted to f32.
template <int W, class T = float>
__device__ __forceinline__ Pack<W> lds_pack(const T* p) {
    Pack<W> r;
    if constexpr (std::is_same<T, float>::value && W == 4) {
        const float4 t = *reinterpret_cast<const float4*>(p);
        r.v[0] = t.x; r.v[1] = t.y; r.v[2] = t.z; r.v[3] = t.w;
    } else if constexpr (std::is_same<T, float>::value) {
        static_assert(W == 1, "f32 packs of 4 or 1");
        r.v[0] = *p;
    } else {
        constexpr int B = W * (int)sizeof(T);
        using V = typename std::conditional<
            B == 16, uint4,
            typename std::conditional<
                B == 8, uint2,
                typename std::conditional<
                    B == 4, uint32_t,
                    typename std::conditional<B == 2, uint16_t,
                                              uint8_t>::type>::type>::type>::
            type;
        static_assert(sizeof(V) == B, "a pack is one load");
        const V u = *reinterpret_cast<const V*>(p);
        const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int i = 0; i < W; ++i) r.v[i] = to_f32(e[i]);
    }
    return r;
}

// A pack stored as f32 (16-byte stores where W % 4 == 0).
template <int W>
__device__ __forceinline__ void sts_pack(float* p, const Pack<W>& r) {
    if constexpr (W % 4 == 0) {
#pragma unroll
        for (int i = 0; i < W; i += 4) {
            *reinterpret_cast<float4*>(p + i) =
                make_float4(r.v[i], r.v[i + 1], r.v[i + 2], r.v[i + 3]);
        }
    } else {
#pragma unroll
        for (int i = 0; i < W; ++i) p[i] = r.v[i];
    }
}

// Copies of one K-tile of w (BK x BN at rows k0.., columns n0..) into the
// slot ws [BK][BN] by NT copying threads: item j of thread pt is element
// e = W*(pt + j*NT), W elements of T a copy (cp_async); past an edge,
// zero-filled.
template <int W, int BK, int BN, int NT, class T>
__device__ __forceinline__ void copy_w(T* ws, const T* w, int pt, int k0,
                                       int n0, int N, int K) {
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
