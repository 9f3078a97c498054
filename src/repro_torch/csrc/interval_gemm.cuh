// The f32 CUDA-core GEMM body of caa_matmul.cu and interval_matmul.cu:
// two activation operands a0, a1 [M, K] against one weight matrix w [K, N],
// several accumulators per output element, one per-term update functor.
//
//   CaaTerm       (a0, a1) = (x, dbar):  val += x·w,  err += t·|w| rounded
//                 up, t = g·|x| + dbar rounded up when the tile is staged
//   IntervalTerm  (a0, a1) = (lo, hi):   lo' += (w≥0 ? lo : hi)·w,
//                 hi' += (w≥0 ? hi : lo)·w,  mag' += max(|lo|,|hi|)·|w|
//
// Arithmetic contract (kept from quant_gemm.cuh, the body of kernels 1 and
// 3). f32 on the CUDA cores, no TF32. Every output element sums k = 0..K-1
// in that one order, one fmaf (or directed __fmaf_ru) per term and
// accumulator, whatever M, N or the tile it lies in: no split-K, and a
// ragged K-tile adds only its real terms. A row therefore gives the same
// bits in any batch; the tile shape is chosen by M only and both shapes do
// identical arithmetic per element. Each w tile is staged into shared memory
// once and read by every accumulator; the sign split and |w| are selects in
// registers, never three separate GEMMs.
//
// What bounds it on an H100. At M = 4 the work is reading w once: bytes,
// 3.35 TB/s (one Qwen2-7B layer's seven projections, Σ K·N = 233.1 M: about
// 0.279 ms). At M = 512 it is 2 FMAs per term for CaaTerm (4·M·ΣKN
// operations, about 7.12 ms at 67 TFLOP/s) and 3 for IntervalTerm (about
// 10.69 ms). This first design is simple: an output tile per block, K-tiles
// staged through shared memory by plain loads, a register micro-tile per
// thread. No TMA, cp.async pipelining or wgmma yet (the directed-rounding
// accumulator has no tensor-core form), and at M = 4 it launches few blocks
// for narrow N — the work of a later PR.
#pragma once

#include <cuda_runtime.h>

namespace {

struct CaaTerm {
    static constexpr int NACC = 2;
    float g;  // ≥ the analysis's γ(K): the wrapper rounds it up to f32

    __device__ __forceinline__ void stage(float x, float d, float& s0,
                                          float& s1) const {
        s0 = x;
        s1 = __fmaf_ru(g, fabsf(x), d);     // t ≥ g·|x| + dbar exactly
    }
    __device__ __forceinline__ void update(float x, float t, float w,
                                           float (&acc)[NACC]) const {
        acc[0] = fmaf(x, w, acc[0]);                  // round to nearest
        acc[1] = __fmaf_ru(t, fabsf(w), acc[1]);      // an upper bound
    }
};

struct IntervalTerm {
    static constexpr int NACC = 3;

    __device__ __forceinline__ void stage(float lo, float hi, float& s0,
                                          float& s1) const {
        s0 = lo;
        s1 = hi;
    }
    __device__ __forceinline__ void update(float lo, float hi, float w,
                                           float (&acc)[NACC]) const {
        const bool pos = w >= 0.0f;
        acc[0] = fmaf(pos ? lo : hi, w, acc[0]);
        acc[1] = fmaf(pos ? hi : lo, w, acc[1]);
        acc[2] = fmaf(fmaxf(fabsf(lo), fabsf(hi)), fabsf(w), acc[2]);
    }
};

template <class Op, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
interval_gemm_kernel(const float* __restrict__ a0,
                     const float* __restrict__ a1,
                     const float* __restrict__ w, float* __restrict__ o0,
                     float* __restrict__ o1, float* __restrict__ o2, int M,
                     int N, int K, Op op) {
    constexpr int NACC = Op::NACC;
    constexpr int TX = BN / TN;
    constexpr int TY = BM / TM;
    constexpr int NT = TX * TY;
    __shared__ float As0[BK][BM + 1];   // [k][m], padded against conflicts
    __shared__ float As1[BK][BM + 1];
    __shared__ float Bs[BK][BN];        // [k][n]

    const int tid = threadIdx.x;
    const int tx = tid % TX, ty = tid / TX;
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

    float acc[TM][TN][NACC];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
#pragma unroll
            for (int c = 0; c < NACC; ++c) acc[i][j][c] = 0.0f;

    for (int k0 = 0; k0 < K; k0 += BK) {
        const int kc = min(BK, K - k0);
        for (int i = tid; i < BM * BK; i += NT) {
            const int mm = i / BK, kk = i % BK, gm = m0 + mm;
            float v0 = 0.0f, v1 = 0.0f;
            if (gm < M && kk < kc) {
                const size_t off = (size_t)gm * K + k0 + kk;
                v0 = a0[off];
                v1 = a1[off];
            }
            op.stage(v0, v1, As0[kk][mm], As1[kk][mm]);
        }
        for (int i = tid; i < BK * BN; i += NT) {
            const int kk = i / BN, nn = i % BN, gn = n0 + nn;
            Bs[kk][nn] = (kk < kc && gn < N)
                             ? w[(size_t)(k0 + kk) * N + gn] : 0.0f;
        }
        __syncthreads();
        // only the kc real terms: a zero-padded term could turn an
        // accumulated -0 into +0 and change the bits
        for (int kk = 0; kk < kc; ++kk) {
            float x0[TM], x1[TM], b[TN];
#pragma unroll
            for (int i = 0; i < TM; ++i) {
                x0[i] = As0[kk][ty + i * TY];
                x1[i] = As1[kk][ty + i * TY];
            }
#pragma unroll
            for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + j * TX];
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j)
                    op.update(x0[i], x1[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }

    float* outs[3] = {o0, o1, o2};
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int gm = m0 + ty + i * TY;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int gn = n0 + tx + j * TX;
            if (gm < M && gn < N) {
#pragma unroll
                for (int c = 0; c < NACC; ++c)
                    outs[c][(size_t)gm * N + gn] = acc[i][j][c];
            }
        }
    }
}

template <class Op, int BM, int BN, int BK, int TM, int TN>
void interval_gemm_tiles(const float* a0, const float* a1, const float* w,
                         float* o0, float* o1, float* o2, int M, int N,
                         int K, Op op, cudaStream_t stream) {
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    const dim3 block((BM / TM) * (BN / TN));
    interval_gemm_kernel<Op, BM, BN, BK, TM, TN>
        <<<grid, block, 0, stream>>>(a0, a1, w, o0, o1, o2, M, N, K, op);
}

// a0, a1 [M, K], w [K, N], outputs [M, N] (Op::NACC of them; o2 unused for
// two): f32, row-major, contiguous, on the device. Launches on ``stream``;
// returns cudaGetLastError().
template <class Op>
cudaError_t interval_gemm(const void* a0, const void* a1, const void* w,
                          void* o0, void* o1, void* o2, int M, int N, int K,
                          Op op, void* stream) {
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* p0 = static_cast<const float*>(a0);
    const auto* p1 = static_cast<const float*>(a1);
    const auto* wp = static_cast<const float*>(w);
    auto* q0 = static_cast<float*>(o0);
    auto* q1 = static_cast<float*>(o1);
    auto* q2 = static_cast<float*>(o2);
    if (M <= 8) {
        interval_gemm_tiles<Op, 8, 32, 32, 1, 1>(p0, p1, wp, q0, q1, q2, M,
                                                 N, K, op, s);
    } else {
        interval_gemm_tiles<Op, 64, 64, 16, 4, 4>(p0, p1, wp, q0, q1, q2, M,
                                                  N, K, op, s);
    }
    return cudaGetLastError();
}

}  // namespace
