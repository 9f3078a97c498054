// The f32 CUDA-core GEMM body of caa_matmul.cu and interval_matmul.cu:
// two activation operands a0, a1 [M, K] against one weight matrix w [K, N],
// NACC accumulators per output element, one per-term update functor.
//
//   CaaTerm       (a0, a1) = (x, dbar):  val += x·w,  err += t·|w| rounded
//                 up, t = g·|x| + dbar rounded up when the tile is staged
//   IntervalTerm  (a0, a1) = (lo, hi):   lo' += (w≥0 ? lo : hi)·w,
//                 hi' += (w≥0 ? hi : lo)·w,  mag' += max(|lo|,|hi|)·|w|,
//                 max(|lo|,|hi|) staged beside lo and hi
//
// Arithmetic contract (that of quant_gemm.cuh, the body of kernels 1 and
// 3). f32 on the CUDA cores, no TF32 and no tensor cores: directed rounding
// and one rounding per term have no wgmma/mma form. Every output element
// sums k = 0..K-1 in that one order from +0, one fmaf (or __fmaf_ru) per
// term and accumulator, whatever M, N or the tile it lies in: no split-K,
// and a ragged K-tile adds only its real terms (a zero-padded term could
// turn an accumulated -0 into +0). A row therefore gives the same bits in
// any batch and in either configuration below. Each staged activation
// element is transformed once (t, or max(|lo|,|hi|)), by the thread that
// copied it; the sign split and |w| are taken in registers from the one
// staged w tile, the split as two fmas predicated on w ≥ 0 (one runs).
//
// Staging (both configurations). K-tiles go through a ring of dynamic
// shared memory by cp.async: 16-byte copies where the rows and bases are
// aligned (N % 4 == 0 for w; K % 4 == 0 for a0, a1 at prefill), 4-byte
// copies otherwise, in the same kernel and order. Copies past an edge are
// zero-filled and never summed.
//
// Decode, M <= 8 (what bounds it on an H100: reading w once, 3.35 TB/s;
// one Qwen2-7B layer's seven projections, Σ K·N = 233.1 M, about 0.279 ms).
// A GEMV that streams the weights: a block owns a strip of 32 columns for
// all M rows. F warps run the chains (rows split among them, a lane a
// column, M·NACC/F chains a lane, operands loaded one or two groups of 4 k
// ahead); NP copying warps copy tile t+1 and transform its activations
// while tile t's chains run, and one __syncthreads a K-tile hands the tiles
// over. Rows >= M are neither copied, staged nor summed. Wide N (at least
// two blocks an SM: w_gate, w_up) takes 32-deep tiles and 2 + 4 warps,
// narrower N 128-deep tiles and 4 + 8 warps (fewer handovers a column
// chain: these run on N/32 SMs); 6 stages.
//
// Prefill, M > 8 (what bounds it: 2 FMAs a term for CaaTerm, 4·M·ΣKN
// operations, about 7.12 ms at 67 TFLOP/s; 3 for IntervalTerm, about
// 10.69 ms). A CUDA-core SGEMM: fragments read as float4 from activation
// tiles transposed to [k][m] and from w [k][n], a 4-stage ring of BK = 16.
// a0 and a1 arrive as raw [m][k] rows and are transformed and transposed
// in one pass into one of two sets of NS [k][m] tiles. Micro-tiles sized
// for the accumulators: 8 x 8 for CaaTerm (128) on 128 x 128 block tiles,
// 8 x 4 for IntervalTerm (96) on 128 x 64; where that grid fills less than
// half the card, 32 x 64 tiles of 4 x 4 (w_k/w_v at M = 512), and below
// that 16 x 32 of 2 x 2 (the Digits analysis shapes, grids of 1-22
// blocks, where 2 x 2 took 0.4-0.7 of 4 x 4's device time on an H100).
// IntervalTerm issues five FMAs a term (two pairs predicated on the sign,
// and mag's) for the three that run; with the fragment loads, the SASS of
// its 128 x 64 k-loop puts the ceiling at 56 % of its operations bound.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "gemm_common.cuh"

namespace {

struct CaaTerm {
    static constexpr int NACC = 2;   // val, err
    static constexpr int NS = 2;     // staged: x, t
    float g;  // ≥ the analysis's γ(K): the wrapper rounds it up to f32

    struct Wt {
        float w, aw;
    };
    __device__ __forceinline__ Wt prep(float w) const {
        return {w, fabsf(w)};
    }
    __device__ __forceinline__ void stage(float x, float d,
                                          float (&s)[NS]) const {
        s[0] = x;
        s[1] = __fmaf_ru(g, fabsf(x), d);   // t ≥ g·|x| + dbar exactly
    }
    __device__ __forceinline__ void update(const float (&a)[NS], const Wt& w,
                                           float (&acc)[NACC]) const {
        acc[0] = fmaf(a[0], w.w, acc[0]);            // round to nearest
        acc[1] = __fmaf_ru(a[1], w.aw, acc[1]);      // an upper bound
    }
};

struct IntervalTerm {
    static constexpr int NACC = 3;   // lo', hi', mag'
    static constexpr int NS = 3;     // staged: lo, hi, max(|lo|, |hi|)

    struct Wt {
        float w, aw;
    };
    __device__ __forceinline__ Wt prep(float w) const {
        return {w, fabsf(w)};
    }
    __device__ __forceinline__ void stage(float lo, float hi,
                                          float (&s)[NS]) const {
        s[0] = lo;
        s[1] = hi;
        s[2] = fmaxf(fabsf(lo), fabsf(hi));
    }
    // lo' += (w≥0 ? lo : hi)·w and hi' += (w≥0 ? hi : lo)·w as two fmas
    // each, predicated on w ≥ 0 (false for NaN), of which one runs: they
    // stay on the FMA pipe, where a select per operand (FSEL) went to the
    // half-rate ALU pipe and held the prefill tile to half the speed
    __device__ __forceinline__ void update(const float (&a)[NS], const Wt& w,
                                           float (&acc)[NACC]) const {
        asm("{\n\t.reg .pred q;\n\t"
            "setp.ge.f32 q, %2, 0f00000000;\n\t"
            "@q fma.rn.f32 %0, %3, %2, %0;\n\t"
            "@!q fma.rn.f32 %0, %4, %2, %0;\n\t"
            "@q fma.rn.f32 %1, %4, %2, %1;\n\t"
            "@!q fma.rn.f32 %1, %3, %2, %1;\n\t}"
            : "+f"(acc[0]), "+f"(acc[1])
            : "f"(w.w), "f"(a[0]), "f"(a[1]));
        acc[2] = fmaf(a[2], w.aw, acc[2]);
    }
};

__device__ __forceinline__ float lane4(const float4& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// ---------------------------------------------------------------- decode

constexpr int kDecBN = 32;      // columns per block (one per lane)
constexpr int kDecRows = 8;     // M <= 8
constexpr int kDecStages = 6;

// one stage: the w tile [BK][32], then NS activation tiles [8][BK]
template <class Op, int BK>
__host__ __device__ constexpr int dec_stage_floats() {
    return BK * kDecBN + Op::NS * kDecRows * BK;
}

template <class Op, int BK>
constexpr int dec_smem_bytes() {
    return kDecStages * dec_stage_floats<Op, BK>() * (int)sizeof(float);
}

// One full K-tile of terms for R rows (1..4) of one column: per 4 k, the
// column's 4 weights and each row's 4 staged values of each tile (a float4,
// the same for the whole warp), then R·NACC independent chains.
template <class Op, int R, int BK>
__device__ __forceinline__ void dec_fma(const Op& op, const float* ws,
                                        const float* xs,
                                        float (&acc)[4][Op::NACC]) {
    constexpr int NS = Op::NS, XS = kDecRows * BK, G = BK / 4;
    constexpr int D = R * NS <= 6 ? 2 : 1;   // groups loaded ahead
    constexpr int NB = D + 1;
    float wv[NB][4];
    float4 av[NB][R][NS];
    auto load = [&](int g) {
#pragma unroll
        for (int i = 0; i < 4; ++i) wv[g % NB][i] = ws[(4 * g + i) * kDecBN];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
            for (int c = 0; c < NS; ++c)
                av[g % NB][r][c] = *reinterpret_cast<const float4*>(
                    xs + c * XS + r * BK + 4 * g);
    };
#pragma unroll
    for (int g = 0; g < D; ++g) load(g);
#pragma unroll
    for (int g = 0; g < G; ++g) {
        if (g + D < G) load(g + D);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const typename Op::Wt wp = op.prep(wv[g % NB][i]);
#pragma unroll
            for (int r = 0; r < R; ++r) {
                float a[NS];
#pragma unroll
                for (int c = 0; c < NS; ++c) a[c] = lane4(av[g % NB][r][c], i);
                op.update(a, wp, acc[r]);
            }
        }
    }
}

// F chain warps (rows split among them, at most 4 a warp) and NP copying
// warps.
template <class Op, int BK, int W, int F, int NP>
__global__ void __launch_bounds__(32 * (F + NP))
interval_gemv_kernel(const float* __restrict__ a0,
                     const float* __restrict__ a1,
                     const float* __restrict__ w, float* __restrict__ o0,
                     float* __restrict__ o1, float* __restrict__ o2, int M,
                     int N, int K, Op op) {
    constexpr int NS = Op::NS, NACC = Op::NACC;
    constexpr int NT = 32 * NP, WS = BK * kDecBN, XS = kDecRows * BK;
    constexpr int SS = dec_stage_floats<Op, BK>();
    constexpr int NX = XS / NT;
    static_assert(NX * NT == XS, "whole shares");
    extern __shared__ float4 dec_smem4[];
    float* const ring = reinterpret_cast<float*>(dec_smem4);

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    // warps 0..F-1 run the chains of rp consecutive rows each, a lane a
    // column; the others copy and stage, as copying thread pt
    const bool fma_warp = warp < F;
    const int pt = tid - 32 * F;
    const int rp = (M + F - 1) / F;
    const int row0 = rp * warp;
    const int n0 = blockIdx.x * kDecBN;
    const int T = (K + BK - 1) / BK;
    const int mbk = M * BK;          // activation items past it (rows >= M) idle

    auto issue = [&](int t) {
        if (t < T) {
            float* const st = ring + (t % kDecStages) * SS;
            const int k0 = t * BK;
            copy_w<W, BK, kDecBN, NT>(st, w, pt, k0, n0, N, K);
#pragma unroll
            for (int j = 0; j < NX; ++j) {
                const int i = pt + j * NT, gk = k0 + i % BK;
                if (i < mbk) {
                    const size_t off = (size_t)(i / BK) * K + gk;
                    cp_async4(st + WS + i, gk < K ? a0 + off : a0, gk < K);
                    cp_async4(st + WS + XS + i, gk < K ? a1 + off : a1,
                              gk < K);
                }
            }
        }
        cp_async_commit();
    };
    // this thread's activation items of tile t, transformed once in place
    // (and into the third tile): all loads, then the stores
    auto stage_tile = [&](int t) {
        float* const xs = ring + (t % kDecStages) * SS + WS;
        float v0[NX], v1[NX];
#pragma unroll
        for (int j = 0; j < NX; ++j) {
            const int i = pt + j * NT;
            v0[j] = i < mbk ? xs[i] : 0.0f;
            v1[j] = i < mbk ? xs[XS + i] : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < NX; ++j) {
            const int i = pt + j * NT;
            if (i < mbk) {
                float s[NS];
                op.stage(v0[j], v1[j], s);
#pragma unroll
                for (int c = 0; c < NS; ++c) xs[c * XS + i] = s[c];
            }
        }
    };

    if (!fma_warp) {
#pragma unroll 1
        for (int t = 0; t < kDecStages - 1; ++t) issue(t);
        if (T > 0) {
            cp_async_wait<kDecStages - 2>();
            stage_tile(0);
        }
    }
    __syncthreads();

    // rows of this warp that exist: 0..4 (warp-uniform)
    const int R = fma_warp ? max(0, min(rp, M - row0)) : 0;
    float acc[4][NACC];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NACC; ++c) acc[r][c] = 0.0f;
#pragma unroll 1
    for (int t = 0; t < T; ++t) {
        if (!fma_warp) {
            // tile t+1 staged while tile t's chains run; the copy goes into
            // tile t-1's slot, whose chains ended at the last barrier
            issue(t + kDecStages - 1);
            cp_async_wait<kDecStages - 2>();   // own copies of tile t+1
            if (t + 1 < T) stage_tile(t + 1);
        } else if (R > 0) {
            const float* const st = ring + (t % kDecStages) * SS;
            const float* ws = st + lane;
            const float* xs = st + WS + row0 * BK;
            const int kc = min(BK, K - t * BK);
            if (kc == BK) {
                switch (R) {
                    case 4: dec_fma<Op, 4, BK>(op, ws, xs, acc); break;
                    case 3: dec_fma<Op, 3, BK>(op, ws, xs, acc); break;
                    case 2: dec_fma<Op, 2, BK>(op, ws, xs, acc); break;
                    default: dec_fma<Op, 1, BK>(op, ws, xs, acc); break;
                }
            } else {
                // the last, partial K-tile: only its kc real terms
                for (int kk = 0; kk < kc; ++kk) {
                    const typename Op::Wt wp = op.prep(ws[kk * kDecBN]);
#pragma unroll
                    for (int r = 0; r < 4; ++r) {
                        if (r < R) {
                            float a[NS];
#pragma unroll
                            for (int c = 0; c < NS; ++c)
                                a[c] = xs[c * XS + r * BK + kk];
                            op.update(a, wp, acc[r]);
                        }
                    }
                }
            }
        }
        __syncthreads();
    }
    cp_async_wait<0>();

    float* const outs[3] = {o0, o1, o2};
    const int n = n0 + lane;
    if (n < N) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            if (r < R) {
#pragma unroll
                for (int c = 0; c < NACC; ++c)
                    outs[c][(size_t)(row0 + r) * N + n] = acc[r][c];
            }
        }
    }
}

// --------------------------------------------------------------- prefill

constexpr int kPfBK = 16;
constexpr int kPfStages = 4;

template <class Op, int BM, int BN>
constexpr int pf_smem_bytes() {
    // a ring of raw a0, a1 tiles [m][k] and of w tiles [k][n], and two sets
    // of NS staged, transposed tiles [k][m]
    return (kPfStages * kPfBK * (2 * BM + BN) +
            2 * Op::NS * kPfBK * (BM + 4)) * (int)sizeof(float);
}

// A thread's T values along a B-wide row of a tile, thread index u: T = 8
// as two float4 at u*4 and B/2 + u*4; T = 4, 2 contiguous at u*T.
template <int T, int B>
__device__ __forceinline__ void frag(const float* p, int u, float (&v)[T]) {
    if constexpr (T == 8) {
        const float4 a = *reinterpret_cast<const float4*>(p + u * 4);
        const float4 b = *reinterpret_cast<const float4*>(p + B / 2 + u * 4);
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
        v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else if constexpr (T == 4) {
        const float4 a = *reinterpret_cast<const float4*>(p + u * 4);
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    } else {
        static_assert(T == 2, "micro-tiles of 8, 4 or 2");
        const float2 a = *reinterpret_cast<const float2*>(p + u * 2);
        v[0] = a.x; v[1] = a.y;
    }
}

// the tile offset of value i of frag<T, B> for thread u
template <int T, int B>
__device__ __forceinline__ int frag_at(int u, int i) {
    return T == 8 ? (i / 4) * (B / 2) + u * 4 + i % 4 : u * T + i;
}

// TM x TN register micro-tiles of NACC accumulators. W = 4: a0, a1 and w
// are copied 16 bytes at a time (K % 4 == N % 4 == 0, aligned bases),
// else 4.
template <class Op, int BM, int BN, int TM, int TN, int W, int MINB>
__global__ void __launch_bounds__((BM / TM) * (BN / TN), MINB)
interval_sgemm_kernel(const float* __restrict__ a0,
                      const float* __restrict__ a1,
                      const float* __restrict__ w, float* __restrict__ o0,
                      float* __restrict__ o1, float* __restrict__ o2, int M,
                      int N, int K, Op op) {
    constexpr int NS = Op::NS, NACC = Op::NACC;
    constexpr int BK = kPfBK, S = kPfStages;
    constexpr int TX = BN / TN, NT = (BM / TM) * TX;
    constexpr int LDA = BM + 4;        // [k][m], padded; rows stay 16B-aligned
    constexpr int XS = BM * BK, AS = BK * LDA, BS = BK * BN;
    constexpr int NA = (XS + W * NT - 1) / (W * NT);
    extern __shared__ float4 pf_smem4[];
    float* const xring = reinterpret_cast<float*>(pf_smem4);  // [S][2][XS]
    float* const bring = xring + S * 2 * XS;                  // [S][BS]
    float* const at = bring + S * BS;                         // [2][NS][AS]

    const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
    const int T = (K + BK - 1) / BK;
    auto a_item = [&](int j) { return W * (tid + j * NT); };
    auto a_ok = [&](int j) { return XS % (W * NT) == 0 || a_item(j) < XS; };

    // activation item j of a thread: W floats of row e / BK from column
    // e % BK of the tile, e = W*(tid + j*NT), at offset e of the raw slots
    auto issue = [&](int t) {
        if (t < T) {
            const int s = t % S, k0 = t * BK;
#pragma unroll
            for (int j = 0; j < NA; ++j) {
                if (a_ok(j)) {
                    const int e = a_item(j);
                    const int gm = m0 + e / BK, gk = k0 + e % BK;
                    const bool ok = gm < M && gk < K;
                    const size_t off = ok ? (size_t)gm * K + gk : 0;
                    cp_async<W>(xring + (2 * s) * XS + e, a0 + off, ok);
                    cp_async<W>(xring + (2 * s + 1) * XS + e, a1 + off, ok);
                }
            }
            copy_w<W, BK, BN, NT>(bring + s * BS, w, tid, k0, n0, N, K);
        }
        cp_async_commit();
    };

    // this thread's activation items of tile t, transformed once into the
    // transposed tiles (one set of two, alternating)
    auto stage_tile = [&](int t) {
        const int s = t % S;
        float* const a = at + (t % 2) * NS * AS;
        Pack<W> v0[NA], v1[NA];
#pragma unroll
        for (int j = 0; j < NA; ++j) {
            if (a_ok(j)) {
                v0[j] = lds_pack<W>(xring + (2 * s) * XS + a_item(j));
                v1[j] = lds_pack<W>(xring + (2 * s + 1) * XS + a_item(j));
            }
        }
#pragma unroll
        for (int j = 0; j < NA; ++j) {
            if (a_ok(j)) {
                const int e = a_item(j), mm = e / BK, kk = e % BK;
#pragma unroll
                for (int i = 0; i < W; ++i) {
                    float st[NS];
                    op.stage(v0[j].v[i], v1[j].v[i], st);
#pragma unroll
                    for (int c = 0; c < NS; ++c)
                        a[c * AS + (kk + i) * LDA + mm] = st[c];
                }
            }
        }
    };

    float acc[TM][TN][NACC];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
#pragma unroll
            for (int c = 0; c < NACC; ++c) acc[i][j][c] = 0.0f;

    // one k of the micro-tile
    auto step = [&](const float* as, const float* bs) {
        float a[NS][TM], b[TN];
#pragma unroll
        for (int c = 0; c < NS; ++c) frag<TM, BM>(as + c * AS, ty, a[c]);
        frag<TN, BN>(bs, tx, b);
        typename Op::Wt wp[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j) wp[j] = op.prep(b[j]);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            float ai[NS];
#pragma unroll
            for (int c = 0; c < NS; ++c) ai[c] = a[c][i];
#pragma unroll
            for (int j = 0; j < TN; ++j) op.update(ai, wp[j], acc[i][j]);
        }
    };

#pragma unroll 1
    for (int t = 0; t < S - 1; ++t) issue(t);

#pragma unroll 1
    for (int t = 0; t < T; ++t) {
        cp_async_wait<S - 2>();   // this thread's tile t landed
        stage_tile(t);
        __syncthreads();
        issue(t + S - 1);   // into tile t-1's slots

        const float* as = at + (t % 2) * NS * AS;
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

    float* const outs[3] = {o0, o1, o2};
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int gm = m0 + frag_at<TM, BM>(ty, i);
        if (gm >= M) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int gn = n0 + frag_at<TN, BN>(tx, j);
            if (gn < N) {
#pragma unroll
                for (int c = 0; c < NACC; ++c)
                    outs[c][(size_t)gm * N + gn] = acc[i][j][c];
            }
        }
    }
}

// ---------------------------------------------------------------- launch

struct Operands {
    const float *a0, *a1, *w;
    float *o0, *o1, *o2;
    int M, N, K;
};

template <class Op, int BK, int W, int F, int NP>
cudaError_t launch_gemv(const Operands& p, const Op& op, cudaStream_t s) {
    static_assert(kDecRows <= 4 * F, "at most 4 rows a chain warp");
    constexpr int smem = dec_smem_bytes<Op, BK>();
    static const cudaError_t attr =
        allow_smem(interval_gemv_kernel<Op, BK, W, F, NP>, smem);
    if (attr != cudaSuccess) return attr;
    interval_gemv_kernel<Op, BK, W, F, NP>
        <<<(p.N + kDecBN - 1) / kDecBN, 32 * (F + NP), smem, s>>>(
            p.a0, p.a1, p.w, p.o0, p.o1, p.o2, p.M, p.N, p.K, op);
    return cudaGetLastError();
}

template <class Op, int BM, int BN, int TM, int TN, int W, int MINB>
cudaError_t launch_sgemm(const Operands& p, const Op& op, cudaStream_t s) {
    constexpr int smem = pf_smem_bytes<Op, BM, BN>();
    static const cudaError_t attr = allow_smem(
        interval_sgemm_kernel<Op, BM, BN, TM, TN, W, MINB>, smem);
    if (attr != cudaSuccess) return attr;
    const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM);
    interval_sgemm_kernel<Op, BM, BN, TM, TN, W, MINB>
        <<<grid, (BM / TM) * (BN / TN), smem, s>>>(
            p.a0, p.a1, p.w, p.o0, p.o1, p.o2, p.M, p.N, p.K, op);
    return cudaGetLastError();
}

// The configuration and tile for (M, N), with copies W floats wide.
template <class Op, int W>
cudaError_t interval_gemm_w(const Operands& p, const Op& op,
                            cudaStream_t s) {
    const int sms = sm_count();
    if (p.M <= kDecRows) {
        // wide N: several blocks an SM, each a small ring; narrow N: one
        // block an SM, a deeper ring and more copying warps
        if ((p.N + kDecBN - 1) / kDecBN >= 2 * sms) {
            return launch_gemv<Op, 32, W, 2, 4>(p, op, s);
        }
        return launch_gemv<Op, 128, W, 4, 8>(p, op, s);
    }
    auto blocks = [&](int bm, int bn) {
        return ((p.M + bm - 1) / bm) * ((p.N + bn - 1) / bn);
    };
    // the large tile: 8 x 8 micro-tiles for two accumulators, 8 x 4 for
    // three (128 and 96 accumulators a thread), one block an SM
    constexpr int TN = Op::NACC == 2 ? 8 : 4;
    constexpr int BN = 16 * TN;
    if (blocks(128, BN) >= sms / 2) {
        return launch_sgemm<Op, 128, BN, 8, TN, W, 1>(p, op, s);
    }
    if (blocks(32, 64) >= sms / 2) {
        return launch_sgemm<Op, 32, 64, 4, 4, W, 4>(p, op, s);
    }
    return launch_sgemm<Op, 16, 32, 2, 2, W, 4>(p, op, s);
}

// a0, a1 [M, K], w [K, N], outputs [M, N] (Op::NACC of them; o2 unused for
// two): f32, row-major, contiguous, on the device. Launches one kernel on
// ``stream``; returns its launch error.
template <class Op>
cudaError_t interval_gemm(const void* a0, const void* a1, const void* w,
                          void* o0, void* o1, void* o2, int M, int N, int K,
                          Op op, void* stream) {
    if (M <= 0 || N <= 0) return cudaSuccess;
    const auto s = static_cast<cudaStream_t>(stream);
    const Operands p{static_cast<const float*>(a0),
                     static_cast<const float*>(a1),
                     static_cast<const float*>(w), static_cast<float*>(o0),
                     static_cast<float*>(o1), static_cast<float*>(o2), M, N,
                     K};
    // 16-byte copies need 16-byte-aligned rows: of w (both configurations)
    // and of a0, a1 (prefill; decode copies them 4 bytes at a time)
    auto aligned = [](const float* q, int cols) {
        return cols % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
    };
    const bool vec = aligned(p.w, N) &&
                     (M <= kDecRows || (aligned(p.a0, K) && aligned(p.a1, K)));
    if (vec) return interval_gemm_w<Op, 4>(p, op, s);
    return interval_gemm_w<Op, 1>(p, op, s);
}

}  // namespace
