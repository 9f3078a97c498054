// The f32 CUDA-core GEMM body of quant_matmul_format.cu and quant_matmul.cu:
// out = q(q(x) @ q(w)) for a rounding functor q (a custom format, or a
// mantissa-only k), f32 accumulation on the CUDA cores.
//
// Arithmetic contract. The certificates assume f32 accumulation, so the
// product runs on the CUDA cores in f32 (no TF32, no tensor-core type).
// Every output element sums k = 0..K-1 in that one order with fmaf, one
// rounding per step, whatever M, N or the tile it lies in: no split-K. A
// row therefore gives the same bits in any batch (the configurations below
// do identical arithmetic per element). Operands are rounded as a tile is
// staged into shared memory; weights are never stored rounded.
//
// Why no tensor cores: TF32 keeps 11 significant bits, fewer than the k = 12
// served, and the f32 accumulation inside Hopper's tensor cores does not
// round each addition to nearest (Fasi, Higham, Mikaitis, Pranesh,
// "Numerical behavior of NVIDIA tensor cores", PeerJ CS 2021), so neither
// wgmma nor mma.sync can give the certified bits. What Hopper offers this
// kernel is asynchronous copies, the large dynamic shared memory and many
// blocks in flight.
//
// Staging (both configurations). K-tiles of x and w flow through a ring of
// dynamic shared memory by cp.async: 16-byte copies where the rows are
// 16-byte aligned (N % 4 == 0 for w; K % 4 == 0 for x at prefill; aligned
// bases), 4-byte copies otherwise, in the same kernel and order. Each
// element is rounded once, by the thread that copied it, after its own
// copies landed (cp.async.wait_group): all its loads, the rounding in
// registers, then all its stores, so that its elements overlap instead of
// waiting on each other through shared memory. The rounding is branch-free
// (quantize_format.cuh) with the functor's integer constants pinned in
// registers. Copies past an edge are zero-filled and the last K-tile adds
// only its real terms: a zero-padded term could turn an accumulated -0
// into +0.
//
// Decode, M <= 8 (what bounds it on an H100: reading w once, 3.35 TB/s).
// A GEMV that streams the weights: a block owns a strip of 32 columns for
// all M rows. F warps run the FMA chains (the rows split among them, a lane
// a column, accumulators in registers, each tile's operands loaded two
// groups of 4 k ahead of their FMAs); NP other warps copy and round, tile
// t+1 while tile t's FMAs run, and one __syncthreads a K-tile hands the
// tiles over. Rows >= M are neither copied, rounded nor summed. Narrow N
// (fewer than two blocks an SM: every Qwen2-7B projection but w_gate/w_up)
// takes 64-deep tiles, 4 FMA and 8 copying warps, one block an SM; wide N
// 32-deep tiles, 2 + 4 warps, several blocks an SM; 8 stages. Without
// split-K the parallelism is the N·M output chains of K dependent FMAs:
// narrow N runs on N/32 SMs, and the per-tile handover (FMA warps' loads,
// the rounding) sets the pace there, not the bytes.
//
// Prefill, M > 8 (what bounds it: 2·M·N·K f32 operations at 67 TFLOP/s).
// A CUDA-core SGEMM of the standard shape: BM x BN block tiles, 8 x 8
// register micro-tiles (4 x 4 on the narrow tile), fragments read as
// float4 from x transposed [k][m] and w [k][n], a 4-stage ring of BK = 16.
// x arrives as raw [m][k] rows and is rounded and transposed in one pass
// into one of two [k][m] tiles; w is rounded in place. 128 x 128 tiles
// where the grid fills half the card, else 32 x 64 (w_k/w_v at M = 512,
// and small M): one rounding per 64 FMAs at 128 x 128.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "gemm_common.cuh"

namespace {

// A thread's share of one staged tile: NW packs of W floats of w, at
// offsets W*(tid + j*NT) of the w slot (copy j of the thread wrote there),
// and NX floats of x at offsets xoff(j) of the x slot, where xok(j). Each
// is rounded once, in registers: all loads, then the rounding, then all
// stores, so that the elements overlap.
template <int W, int NW, int NX>
struct Share {
    Pack<W> w[NW];
    Pack<1> x[NX];

    template <int NT, class XOff, class XOk>
    __device__ __forceinline__ void load(const float* ws, const float* xs,
                                         int pt, XOff xoff, XOk xok) {
#pragma unroll
        for (int j = 0; j < NW; ++j) w[j] = lds_pack<W>(ws + W * (pt + j * NT));
#pragma unroll
        for (int j = 0; j < NX; ++j) x[j].v[0] = xok(j) ? xs[xoff(j)] : 0.0f;
    }

    template <class Q>
    __device__ __forceinline__ void round(const Q& q) {
#pragma unroll
        for (int j = 0; j < NW; ++j)
#pragma unroll
            for (int i = 0; i < W; ++i) w[j].v[i] = q(w[j].v[i]);
#pragma unroll
        for (int j = 0; j < NX; ++j) x[j].v[0] = q(x[j].v[0]);
    }

    template <int NT, class XOff, class XOk>
    __device__ __forceinline__ void store(float* ws, float* xs, int pt,
                                          XOff xoff, XOk xok) {
#pragma unroll
        for (int j = 0; j < NW; ++j) sts_pack(ws + W * (pt + j * NT), w[j]);
#pragma unroll
        for (int j = 0; j < NX; ++j) {
            if (xok(j)) xs[xoff(j)] = x[j].v[0];
        }
    }
};

// Rounds the share of copying thread pt (of NT) of a staged tile in place.
template <int W, int NW, int NX, int NT, class Q, class XOff, class XOk>
__device__ __forceinline__ void round_share(float* ws, float* xs, int pt,
                                            XOff xoff, XOk xok, const Q& q) {
    Share<W, NW, NX> sh;
    sh.template load<NT>(ws, xs, pt, xoff, xok);
    sh.round(q);
    sh.template store<NT>(ws, xs, pt, xoff, xok);
}

// ---------------------------------------------------------------- decode

constexpr int kDecBN = 32;      // columns per block (one per lane)
constexpr int kDecStages = 8;

template <int BK>
constexpr int dec_smem_bytes() {
    return kDecStages * (BK * kDecBN + 8 * BK) * (int)sizeof(float);
}

// One full K-tile of FMAs for R rows (1..4) of one column: per 4 k, the
// column's 4 weights and each row's 4 x values (one float4, the same for
// the whole warp), then R independent chains.
template <int R, int BK>
__device__ __forceinline__ void dec_fma(const float* ws, const float* xs,
                                        float (&acc)[4]) {
    // operands of group g+2 loaded before the FMAs of group g
    constexpr int G = BK / 4;
    float wv[3][4];
    float4 xv[3][R];
    auto load = [&](int g) {
#pragma unroll
        for (int i = 0; i < 4; ++i) wv[g % 3][i] = ws[(4 * g + i) * kDecBN];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            xv[g % 3][r] = *reinterpret_cast<const float4*>(xs + r * BK + 4 * g);
        }
    };
    load(0);
    load(1);
#pragma unroll
    for (int g = 0; g < G; ++g) {
        if (g + 2 < G) load(g + 2);
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const float4 a = xv[g % 3][r];
            acc[r] = fmaf(a.x, wv[g % 3][0], acc[r]);
            acc[r] = fmaf(a.y, wv[g % 3][1], acc[r]);
            acc[r] = fmaf(a.z, wv[g % 3][2], acc[r]);
            acc[r] = fmaf(a.w, wv[g % 3][3], acc[r]);
        }
    }
}

// F FMA warps (rows split among them, at most 4 a warp) and NP copying
// warps.
template <class Q, int BK, int W, int F, int NP>
__global__ void __launch_bounds__(32 * (F + NP))
quant_gemv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ out, int M, int N, int K, Q q) {
    q.pin();
    constexpr int NT = 32 * NP, WS = BK * kDecBN, XS = 8 * BK;
    constexpr int NW = WS / (W * NT), NX = XS / NT;
    static_assert(NW * W * NT == WS && NX * NT == XS, "whole shares");
    extern __shared__ float4 dec_smem4[];
    float* const wring = reinterpret_cast<float*>(dec_smem4);
    float* const xring = wring + kDecStages * WS;

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    // warps 0..F-1 run the FMA chains of rp consecutive rows each, a lane
    // a column; the others copy and round, as copying thread pt
    const bool fma_warp = warp < F;
    const int pt = tid - 32 * F;
    const int rp = (M + F - 1) / F;
    const int row0 = rp * warp;
    const int n0 = blockIdx.x * kDecBN;
    const int T = (K + BK - 1) / BK;
    const int mbk = M * BK;          // x items past it (rows >= M) idle
    auto xoff = [&](int j) { return pt + j * NT; };
    auto xok = [&](int j) { return pt + j * NT < mbk; };

    auto issue = [&](int t) {
        if (t < T) {
            const int s = t % kDecStages, k0 = t * BK;
            copy_w<W, BK, kDecBN, NT>(wring + s * WS, w, pt, k0, n0, N, K);
#pragma unroll
            for (int j = 0; j < NX; ++j) {
                const int i = pt + j * NT, gk = k0 + i % BK;
                if (i < mbk) {
                    cp_async4(xring + s * XS + i,
                              gk < K ? x + (size_t)(i / BK) * K + gk : x,
                              gk < K);
                }
            }
        }
        cp_async_commit();
    };
    auto round_tile = [&](int t) {
        const int s = t % kDecStages;
        round_share<W, NW, NX, NT>(wring + s * WS, xring + s * XS, pt, xoff,
                                   xok, q);
    };

    if (!fma_warp) {
#pragma unroll 1
        for (int t = 0; t < kDecStages - 1; ++t) issue(t);
        if (T > 0) {
            cp_async_wait<kDecStages - 2>();
            round_tile(0);
        }
    }
    __syncthreads();

    // rows of this warp that exist: 0..4 (warp-uniform)
    const int R = fma_warp ? max(0, min(rp, M - row0)) : 0;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 1
    for (int t = 0; t < T; ++t) {
        if (!fma_warp) {
            // tile t+1 rounded while tile t's FMAs run; the copy goes into
            // tile t-1's slot, whose FMAs ended at the last barrier
            issue(t + kDecStages - 1);
            cp_async_wait<kDecStages - 2>();   // own copies of tile t+1
            if (t + 1 < T) round_tile(t + 1);
        } else if (R > 0) {
            const int s = t % kDecStages;
            const float* ws = wring + s * WS + lane;
            const float* xs = xring + s * XS + row0 * BK;
            const int kc = min(BK, K - t * BK);
            if (kc == BK) {
                switch (R) {
                    case 4: dec_fma<4, BK>(ws, xs, acc); break;
                    case 3: dec_fma<3, BK>(ws, xs, acc); break;
                    case 2: dec_fma<2, BK>(ws, xs, acc); break;
                    default: dec_fma<1, BK>(ws, xs, acc); break;
                }
            } else {
                // the last, partial K-tile: only its kc real terms
                for (int kk = 0; kk < kc; ++kk) {
                    const float wk = ws[kk * kDecBN];
#pragma unroll
                    for (int r = 0; r < 4; ++r) {
                        if (r < R) acc[r] = fmaf(xs[r * BK + kk], wk, acc[r]);
                    }
                }
            }
        }
        __syncthreads();
    }
    cp_async_wait<0>();

    const int n = n0 + lane;
    if (n < N) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            if (r < R) out[(size_t)(row0 + r) * N + n] = q(acc[r]);
        }
    }
}

// --------------------------------------------------------------- prefill

constexpr int kPfBK = 16;
constexpr int kPfStages = 4;

template <int BM, int BN>
constexpr int pf_smem_bytes() {
    // a ring of raw x tiles [m][k] and of w tiles [k][n], and two rounded,
    // transposed x tiles [k][m]
    return (kPfStages * kPfBK * (BM + BN) + 2 * kPfBK * (BM + 4)) *
           (int)sizeof(float);
}

// TM x TM register micro-tiles (TM = 8: two float4 fragments a side, at
// ty*4 and BM/2 + ty*4; TM = 4: one). W = 4: x and w are copied 16 bytes
// at a time (K % 4 == N % 4 == 0, aligned bases), else 4.
template <class Q, int BM, int BN, int TM, int W>
__global__ void __launch_bounds__((BM / TM) * (BN / TM),
                                  512 / ((BM / TM) * (BN / TM)))
quant_sgemm_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ out, int M, int N, int K, Q q) {
    q.pin();
    constexpr int BK = kPfBK, S = kPfStages;
    constexpr int TX = BN / TM, NT = (BM / TM) * (BN / TM);
    constexpr int H = TM / 4;                 // float4 fragments a side
    constexpr int HM = BM / H, HN = BN / H;   // their stride
    constexpr int LDA = BM + 4;        // [k][m], padded; rows stay 16B-aligned
    constexpr int XS = BM * BK, AS = BK * LDA, BS = BK * BN;
    constexpr int NA = XS / (W * NT), NB = BS / (W * NT);
    static_assert(NA * W * NT == XS && NB * W * NT == BS, "whole shares");
    extern __shared__ float4 pf_smem4[];
    float* const xring = reinterpret_cast<float*>(pf_smem4);
    float* const bring = xring + S * XS;
    float* const at = bring + S * BS;

    const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
    const int T = (K + BK - 1) / BK;

    // x item j of a thread: W floats of row e / BK from column e % BK of
    // the tile, e = W*(tid + j*NT), at offset e of the raw slot
    auto issue = [&](int t) {
        if (t < T) {
            const int s = t % S, k0 = t * BK;
#pragma unroll
            for (int j = 0; j < NA; ++j) {
                const int e = W * (tid + j * NT);
                const int gm = m0 + e / BK, gk = k0 + e % BK;
                const bool ok = gm < M && gk < K;
                cp_async<W>(xring + s * XS + e,
                            ok ? x + (size_t)gm * K + gk : x, ok);
            }
            copy_w<W, BK, BN, NT>(bring + s * BS, w, tid, k0, n0, N, K);
        }
        cp_async_commit();
    };

    // this thread's share of tile t, rounded once: its x items into the
    // transposed tile at (one of two, alternating), its w items in place
    auto round_tile = [&](int t) {
        const int s = t % S;
        float* const a = at + (t % 2) * AS;
        Pack<W> xv[NA], wv[NB];
#pragma unroll
        for (int j = 0; j < NA; ++j) {
            xv[j] = lds_pack<W>(xring + s * XS + W * (tid + j * NT));
        }
#pragma unroll
        for (int j = 0; j < NB; ++j) {
            wv[j] = lds_pack<W>(bring + s * BS + W * (tid + j * NT));
        }
#pragma unroll
        for (int j = 0; j < NA; ++j)
#pragma unroll
            for (int i = 0; i < W; ++i) xv[j].v[i] = q(xv[j].v[i]);
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
            for (int i = 0; i < W; ++i) wv[j].v[i] = q(wv[j].v[i]);
#pragma unroll
        for (int j = 0; j < NA; ++j) {
            const int e = W * (tid + j * NT), mm = e / BK, kk = e % BK;
#pragma unroll
            for (int i = 0; i < W; ++i) a[(kk + i) * LDA + mm] = xv[j].v[i];
        }
#pragma unroll
        for (int j = 0; j < NB; ++j) {
            sts_pack(bring + s * BS + W * (tid + j * NT), wv[j]);
        }
    };

    float acc[TM][TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = 0.0f;

    // one k of the micro-tile
    auto step = [&](const float* as, const float* bs) {
        float a[TM], b[TM];
#pragma unroll
        for (int h = 0; h < H; ++h) {
            const float4 av =
                *reinterpret_cast<const float4*>(as + h * HM + ty * 4);
            const float4 bv =
                *reinterpret_cast<const float4*>(bs + h * HN + tx * 4);
            a[4 * h] = av.x; a[4 * h + 1] = av.y;
            a[4 * h + 2] = av.z; a[4 * h + 3] = av.w;
            b[4 * h] = bv.x; b[4 * h + 1] = bv.y;
            b[4 * h + 2] = bv.z; b[4 * h + 3] = bv.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    };

#pragma unroll 1
    for (int t = 0; t < S - 1; ++t) issue(t);

#pragma unroll 1
    for (int t = 0; t < T; ++t) {
        cp_async_wait<S - 2>();   // this thread's tile t landed
        round_tile(t);
        __syncthreads();
        issue(t + S - 1);   // into tile t-1's slots

        const float* as = at + (t % 2) * AS;
        const float* bs = bring + (t % S) * BS;
        const int kc = min(BK, K - t * BK);
        if (kc == BK) {
#pragma unroll
            for (int kk = 0; kk < BK; ++kk) step(as + kk * LDA, bs + kk * BN);
        } else {
            // the last, partial K-tile: only its kc real terms
#pragma unroll 1
            for (int kk = 0; kk < kc; ++kk) step(as + kk * LDA, bs + kk * BN);
        }
    }
    cp_async_wait<0>();

#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int gm = m0 + (i / 4) * HM + ty * 4 + i % 4;
        if (gm >= M) continue;
#pragma unroll
        for (int j = 0; j < TM; ++j) {
            const int gn = n0 + (j / 4) * HN + tx * 4 + j % 4;
            if (gn < N) out[(size_t)gm * N + gn] = q(acc[i][j]);
        }
    }
}

// ---------------------------------------------------------------- launch

template <class Q, int BK, int W, int F, int NP>
cudaError_t launch_gemv(const float* x, const float* w, float* out, int M,
                        int N, int K, const Q& q, cudaStream_t s) {
    static_assert(8 <= 4 * F, "at most 4 rows an FMA warp");
    constexpr int smem = dec_smem_bytes<BK>();
    static const cudaError_t attr =
        allow_smem(quant_gemv_kernel<Q, BK, W, F, NP>, smem);
    if (attr != cudaSuccess) return attr;
    quant_gemv_kernel<Q, BK, W, F, NP>
        <<<(N + kDecBN - 1) / kDecBN, 32 * (F + NP), smem, s>>>(x, w, out, M,
                                                                N, K, q);
    return cudaGetLastError();
}

template <class Q, int BM, int BN, int TM, int W>
cudaError_t launch_sgemm(const float* x, const float* w, float* out, int M,
                         int N, int K, const Q& q, cudaStream_t s) {
    constexpr int smem = pf_smem_bytes<BM, BN>();
    static const cudaError_t attr =
        allow_smem(quant_sgemm_kernel<Q, BM, BN, TM, W>, smem);
    if (attr != cudaSuccess) return attr;
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    quant_sgemm_kernel<Q, BM, BN, TM, W>
        <<<grid, (BM / TM) * (BN / TM), smem, s>>>(x, w, out, M, N, K, q);
    return cudaGetLastError();
}

// The configuration and tile for (M, N), with w's copies W floats wide.
template <class Q, int W>
cudaError_t quant_gemm_w(const float* x, const float* w, float* out, int M,
                         int N, int K, const Q& q, cudaStream_t s) {
    const int sms = sm_count();
    if (M <= 8) {
        // wide N: several blocks an SM, each a small ring; narrow N: one
        // block an SM, a deeper ring and more copying warps
        if ((N + kDecBN - 1) / kDecBN >= 2 * sms) {
            return launch_gemv<Q, 32, W, 2, 4>(x, w, out, M, N, K, q, s);
        }
        return launch_gemv<Q, 64, W, 4, 8>(x, w, out, M, N, K, q, s);
    }
    auto blocks = [&](int bm, int bn) {
        return ((M + bm - 1) / bm) * ((N + bn - 1) / bn);
    };
    if (blocks(128, 128) >= sms / 2) {
        return launch_sgemm<Q, 128, 128, 8, W>(x, w, out, M, N, K, q, s);
    }
    return launch_sgemm<Q, 32, 64, 4, W>(x, w, out, M, N, K, q, s);
}

// x [M, K], w [K, N], out [M, N]: f32, row-major, contiguous, on the
// device. Launches one kernel on ``stream``; returns its launch error.
template <class Q>
cudaError_t quant_gemm(const void* x, const void* w, void* out, int M, int N,
                       int K, Q q, void* stream) {
    if (M <= 0 || N <= 0) return cudaSuccess;
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* xp = static_cast<const float*>(x);
    const auto* wp = static_cast<const float*>(w);
    auto* op = static_cast<float*>(out);
    // 16-byte copies need 16-byte-aligned rows: of w (both configurations)
    // and of x (prefill; decode copies x 4 bytes at a time)
    auto aligned = [](const float* p, int cols) {
        return cols % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
    };
    const bool vec = aligned(wp, N) && (M <= 8 || aligned(xp, K));
    if (vec) return quant_gemm_w<Q, 4>(xp, wp, op, M, N, K, q, s);
    return quant_gemm_w<Q, 1>(xp, wp, op, M, N, K, q, s);
}

}  // namespace
