// The f32 CUDA-core GEMM body of quant_matmul_format.cu and quant_matmul.cu:
// out = q(q(x) @ q(w)) for a rounding functor q (a custom format, or a
// mantissa-only k), f32 accumulation on the CUDA cores.
//
// Arithmetic contract. The certificates assume f32 accumulation, so the
// product runs on the CUDA cores in f32 (no TF32, no tensor-core type).
// Every output element sums k = 0..K-1 in that one order with fmaf, one
// rounding per step, whatever M, N or the tile it lies in: no split-K. A
// row therefore gives the same bits in any batch (the two tile shapes below
// do identical arithmetic per element). Operands are rounded as a tile is
// staged into shared memory; weights are never stored rounded.
//
// What bounds it on an H100. At decode (M = batch) the work is reading w
// once: bytes-bound at 3.35 TB/s. At prefill (M = 512) it is 2MNK f32
// operations against 67 TFLOP/s on the CUDA cores. This first design is
// simple: an output tile per block, K-tiles staged through shared memory by
// plain loads, a register micro-tile per thread. It does not use TMA,
// cp.async pipelining or wgmma yet, and at decode it launches few blocks for
// narrow N — the work of a later PR.
#pragma once

#include <cuda_runtime.h>

namespace {

template <class Q, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
quant_gemm_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ out, int M, int N, int K, Q q) {
    constexpr int TX = BN / TN;
    constexpr int TY = BM / TM;
    constexpr int NT = TX * TY;
    __shared__ float As[BK][BM + 1];   // [k][m], padded against conflicts
    __shared__ float Bs[BK][BN];       // [k][n]

    const int tid = threadIdx.x;
    const int tx = tid % TX, ty = tid / TX;
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < K; k0 += BK) {
        const int kc = min(BK, K - k0);
        for (int i = tid; i < BM * BK; i += NT) {
            const int mm = i / BK, kk = i % BK, gm = m0 + mm;
            const float v = (gm < M && kk < kc)
                                ? x[(size_t)gm * K + k0 + kk] : 0.0f;
            As[kk][mm] = q(v);
        }
        for (int i = tid; i < BK * BN; i += NT) {
            const int kk = i / BN, nn = i % BN, gn = n0 + nn;
            const float v = (kk < kc && gn < N)
                                ? w[(size_t)(k0 + kk) * N + gn] : 0.0f;
            Bs[kk][nn] = q(v);
        }
        __syncthreads();
        // only the kc real terms: a zero-padded term could turn an
        // accumulated -0 into +0 and change the bits
        for (int kk = 0; kk < kc; ++kk) {
            float a[TM], b[TN];
#pragma unroll
            for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + i * TY];
#pragma unroll
            for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + j * TX];
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j)
                    acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int gm = m0 + ty + i * TY;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int gn = n0 + tx + j * TX;
            if (gm < M && gn < N) {
                out[(size_t)gm * N + gn] = q(acc[i][j]);
            }
        }
    }
}

template <class Q, int BM, int BN, int BK, int TM, int TN>
void quant_gemm_tiles(const float* x, const float* w, float* out, int M,
                      int N, int K, Q q, cudaStream_t stream) {
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    const dim3 block((BM / TM) * (BN / TN));
    quant_gemm_kernel<Q, BM, BN, BK, TM, TN>
        <<<grid, block, 0, stream>>>(x, w, out, M, N, K, q);
}

// x [M, K], w [K, N], out [M, N]: f32, row-major, contiguous, on the
// device. Launches on ``stream``; returns cudaGetLastError().
template <class Q>
cudaError_t quant_gemm(const void* x, const void* w, void* out, int M, int N,
                       int K, Q q, void* stream) {
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* xp = static_cast<const float*>(x);
    const auto* wp = static_cast<const float*>(w);
    auto* op = static_cast<float*>(out);
    if (M <= 8) {
        quant_gemm_tiles<Q, 8, 32, 32, 1, 1>(xp, wp, op, M, N, K, q, s);
    } else {
        quant_gemm_tiles<Q, 64, 64, 16, 4, 4>(xp, wp, op, M, N, K, q, s);
    }
    return cudaGetLastError();
}

}  // namespace
