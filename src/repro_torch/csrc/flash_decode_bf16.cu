// flash_decode_bf16: kernel 4's bf16 instance (compute_dtype "bfloat16"),
// the uncertified single-token decode attention of the plain and k serving
// backends for a bf16 q with an f32, bf16 or e4m3 cache. It replaces the
// Pallas TPU kernel _flash_decode_kernel of src/repro/kernels/flash_decode.py
// (wrapper flash_decode_attention) in bf16, where the reference does not
// fuse decode attention (the plain and k backends' decode_attention is
// the default None, src/repro/models/attention.py:100-126): it composes
// einsums and a
// softmax in the compute dtype (repro.models.attention.gqa_attention), and
// in bf16 that path rounds
//   - the scores q·k to bf16 (an einsum: exact products, f32 sums, RNE);
//   - the scale, the softcap (cap·tanh(s·(1/cap)), each op) and the mask
//     (NEG_BIG = -1e9) in bf16, with bf16 constants;
//   - softmax in f32 over the whole row, then the probabilities to bf16;
//   - p·v with f32 sums, then bf16.
// The cache is read as the composed path reads it (bk.input: to bf16; an
// e4m3 or bf16 cache converts exactly, an f32 one rounds by RNE).
//
// One online-softmax pass cannot round p after the row's final max and
// sum, so this is two passes over a lane's chunks of 64 positions (the f32
// instance's chunks, flash_decode.cuh), and no fold of rescaled partial
// sums of p·v:
// 1. scores: one block per (chunk, kv head, lane) computes the chunk's
//    bf16 scores into a scratch row, and each head's chunk max
//    m_c = max(NEG_BIG, s) and sum l_c = Σ exp(s − m_c) in position order;
// 2. fold: one thread per (lane, kv head, head) folds the chunks' (m_c,
//    l_c) in chunk order, from the chunk that holds the window's first
//    position: m' = max(m, m_c), l = fmaf(exp(m − m'), l, exp(m_c − m')·l_c);
// 3. p·v: one block per (chunk, kv head, lane): p = bf16(exp(s − m) / l)
//    (IEEE division), and each head's Σ p·v over the chunk's attended
//    positions in order, an fmaf chain from +0 (products exact: p and v are
//    bf16), into a partial;
// 4. sum: one thread per output element adds the chunks' partials in chunk
//    order and writes the sum in bf16 by RNE.
// A score: lane l holds d = 4l..4l+3 (and 128 + 4l.. where D > 128), an
// fmaf chain over them from its first product, then the butterfly over the
// 32 lanes (xor 16, 8, 4, 2, 1), as in the f32 instance. Positions a lane
// does not attend (at or past its length, below its window) are never
// read and add nothing; a lane of length <= 0 attends all S positions with
// score NEG_BIG (their mean of v). Every output's order depends on the
// lane's own length only. flash_decode.flash_decode_bf16_ref is this
// algorithm in plain PyTorch, bit for bit where its exp, tanh and division
// are the card's (on the card).
//
// What bounds it on an H100: reading k and v up to lengths[b] once (bytes:
// half the f32 instance's for bf16, a quarter for e4m3); the scores' scratch
// row (4 bytes a position and head) is written once and read once. A
// library of its own, built at first use.
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include "flash_decode.cuh"

namespace {

__device__ __forceinline__ float fd16_round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

// A cache element as the composed path reads it: in bf16.
template <class T>
__device__ __forceinline__ float fd16_in(T v) {
    if constexpr (std::is_same<T, float>::value) {
        return fd16_round(v);
    } else {
        return to_f32(v);
    }
}

struct Fd16Consts {
    float scale, cap, inv_cap, neg;  // each a bf16 value
};

// The composed path's score from its dot product x (f32).
__device__ __forceinline__ float fd16_score(float x, const Fd16Consts& c) {
    float s = fd16_round(fd16_round(x) * c.scale);
    if (c.cap > 0.0f) {
        s = fd16_round(fd16_round(tanhf(fd16_round(s * c.inv_cap))) * c.cap);
    }
    return s;
}

// Pass 1. Dynamic shared memory: q [G][DM], s [G][64].
template <int NP, class TKV>
__global__ void __launch_bounds__(kFdThreads)
fd16_scores_kernel(const __nv_bfloat16* __restrict__ q,
                   const TKV* __restrict__ k, const int* __restrict__ lengths,
                   float* __restrict__ scores, float* __restrict__ part_m,
                   float* __restrict__ part_l, int S, int H, int G, int D,
                   int NC, int window, Fd16Consts cs) {
    constexpr int DM = NP * kFdPart;
    extern __shared__ float4 fd16_smem[];
    float* const sq = reinterpret_cast<float*>(fd16_smem);   // [G][DM]
    float* const ss = sq + G * DM;                            // [G][64]
    const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int len = lengths[b];
    const bool empty = len <= 0;
    const int t0 = c * kFdChunk;
    const int n = fd_attended(len, S);
    const int lo = fd_first(len, n, window);
    if (t0 >= n || t0 + kFdChunk <= lo) return;
    const int tc = min(kFdChunk, n - t0);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int r0 = warp * kFdRows;
    const size_t head0 = (size_t)(b * H + h) * G;

    for (int e = threadIdx.x; e < G * DM; e += kFdThreads) {
        const int g = e / DM, d = e % DM;
        sq[e] = d < D ? to_f32(q[(head0 + g) * D + d]) : 0.0f;
    }
    __syncthreads();

    for (int j = 0; j < kFdRows; ++j) {
        const int i = r0 + j, p = t0 + i;
        if (i >= tc) break;
        if (empty || p < lo) {
            if (lane < G) {
                for (int g = lane; g < G; g += 32) ss[g * kFdChunk + i] = cs.neg;
            }
            continue;
        }
        const TKV* row = k + (((size_t)b * S + p) * H + h) * D;
        float kv[NP][4];
#pragma unroll
        for (int pt = 0; pt < NP; ++pt) {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int d = kFdPart * pt + 4 * lane + u;
                kv[pt][u] = d < D ? fd16_in(row[d]) : 0.0f;
            }
        }
        for (int g = 0; g < G; ++g) {
            const float* qg = sq + g * DM + 4 * lane;
            float x = qg[0] * kv[0][0];
            x = fmaf(qg[1], kv[0][1], x);
            x = fmaf(qg[2], kv[0][2], x);
            x = fmaf(qg[3], kv[0][3], x);
#pragma unroll
            for (int pt = 1; pt < NP; ++pt) {
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    x = fmaf(qg[kFdPart * pt + u], kv[pt][u], x);
                }
            }
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
                x += __shfl_xor_sync(kFdFull, x, o);
            }
            if (lane == 0) ss[g * kFdChunk + i] = fd16_score(x, cs);
        }
    }
    __syncthreads();

    for (int e = threadIdx.x; e < G * tc; e += kFdThreads) {
        const int g = e / tc, i = e % tc;
        scores[(head0 + g) * S + t0 + i] = ss[g * kFdChunk + i];
    }
    for (int g = threadIdx.x; g < G; g += kFdThreads) {
        const float* sg = ss + g * kFdChunk;
        float m = cs.neg;
        for (int i = 0; i < tc; ++i) m = fmaxf(m, sg[i]);
        float l = expf(sg[0] - m);
        for (int i = 1; i < tc; ++i) l = __fadd_rn(l, expf(sg[i] - m));
        part_m[(head0 + g) * NC + c] = m;
        part_l[(head0 + g) * NC + c] = l;
    }
}

// Pass 2: each head's (m, l) of the whole row.
__global__ void fd16_fold_kernel(const float* __restrict__ part_m,
                                 const float* __restrict__ part_l,
                                 const int* __restrict__ lengths,
                                 float* __restrict__ row_m,
                                 float* __restrict__ row_l, int S, int H,
                                 int G, int NC, int window, int heads) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= heads) return;
    const int b = r / (H * G);
    const int len = lengths[b];
    const int n = fd_attended(len, S);
    const int nc = fd_chunks(n);
    const int c_lo = fd_first(len, n, window) / kFdChunk;
    const float* pm = part_m + (size_t)r * NC;
    const float* pl = part_l + (size_t)r * NC;
    float m = pm[c_lo], l = pl[c_lo];
    for (int c = c_lo + 1; c < nc; ++c) {
        const float m2 = fmaxf(m, pm[c]);
        l = fmaf(expf(m - m2), l, expf(pm[c] - m2) * pl[c]);
        m = m2;
    }
    row_m[r] = m;
    row_l[r] = l;
}

// Pass 3. Dynamic shared memory: p [G][64], v [64][D].
template <class TKV>
__global__ void __launch_bounds__(kFdThreads)
fd16_pv_kernel(const TKV* __restrict__ v, const int* __restrict__ lengths,
               const float* __restrict__ scores,
               const float* __restrict__ row_m,
               const float* __restrict__ row_l, float* __restrict__ part_acc,
               int S, int H, int G, int D, int NC, int window) {
    extern __shared__ float4 fd16_smem[];
    float* const sp = reinterpret_cast<float*>(fd16_smem);   // [G][64]
    float* const sv = sp + G * kFdChunk;                      // [64][D]
    const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int len = lengths[b];
    const int t0 = c * kFdChunk;
    const int n = fd_attended(len, S);
    const int lo = fd_first(len, n, window);
    if (t0 >= n || t0 + kFdChunk <= lo) return;
    const int tc = min(kFdChunk, n - t0);
    const int ilo = max(0, lo - t0);       // the chunk's first attended row
    const size_t head0 = (size_t)(b * H + h) * G;

    for (int e = ilo * D + threadIdx.x; e < tc * D; e += kFdThreads) {
        const int i = e / D, d = e % D;
        sv[e] = fd16_in(v[(((size_t)b * S + t0 + i) * H + h) * D + d]);
    }
    for (int e = threadIdx.x; e < G * tc; e += kFdThreads) {
        const int g = e / tc, i = e % tc;
        const float s = scores[(head0 + g) * S + t0 + i];
        sp[g * kFdChunk + i] = fd16_round(
            __fdiv_rn(expf(s - row_m[head0 + g]), row_l[head0 + g]));
    }
    __syncthreads();

    for (int e = threadIdx.x; e < G * D; e += kFdThreads) {
        const int g = e / D, d = e % D;
        const float* pg = sp + g * kFdChunk;
        float a = 0.0f;
        for (int i = ilo; i < tc; ++i) a = fmaf(pg[i], sv[i * D + d], a);
        part_acc[((head0 + g) * NC + c) * D + d] = a;
    }
}

// Pass 4: each output element's partials in chunk order, to bf16.
__global__ void fd16_sum_kernel(const float* __restrict__ part_acc,
                                const int* __restrict__ lengths,
                                __nv_bfloat16* __restrict__ out, int S, int H,
                                int G, int D, int NC, int window,
                                long long total) {
    const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (e >= total) return;
    const long long r = e / D;
    const int d = (int)(e % D);
    const int b = (int)(r / (H * G));
    const int len = lengths[b];
    const int n = fd_attended(len, S);
    const int nc = fd_chunks(n);
    const int c_lo = fd_first(len, n, window) / kFdChunk;
    const float* ap = part_acc + (size_t)r * NC * D + d;
    float acc = ap[(size_t)c_lo * D];
    for (int c = c_lo + 1; c < nc; ++c) acc = __fadd_rn(acc, ap[(size_t)c * D]);
    out[e] = __float2bfloat16_rn(acc);
}

// q [B, H, G, D] bf16, k/v [B, S, H, D] of TKV, lengths int32 [B], out like
// q; 1 <= D <= 256. scratch: B·H·G·(S + NC·(D + 2) + 2) floats: the scores
// [B·H·G][S], the chunk partials acc [B·H·G·NC][D], m and l [B·H·G·NC],
// then the rows' m and l [B·H·G]. Four launches on ``stream``; returns the
// first launch error.
template <class TKV>
cudaError_t fd16_launch(const void* q, const void* k, const void* v,
                        const void* lengths, void* out, void* scratch, int B,
                        int S, int H, int G, int D, int window,
                        Fd16Consts cs, cudaStream_t s) {
    const int NC = fd_chunks(S);
    const size_t heads = (size_t)B * H * G;
    float* sc = static_cast<float*>(scratch);
    float* acc = sc + heads * S;
    float* pm = acc + heads * NC * D;
    float* pl = pm + heads * NC;
    float* rm = pl + heads * NC;
    float* rl = rm + heads;
    const auto* lp = static_cast<const int*>(lengths);
    const dim3 grid(NC, H, B);
    const int NP = D <= kFdPart ? 1 : 2;
    const int smem1 = (G * NP * kFdPart + G * kFdChunk) * (int)sizeof(float);
    cudaError_t e;
    if (NP == 1) {
        if ((e = allow_smem(fd16_scores_kernel<1, TKV>, smem1)) != cudaSuccess)
            return e;
        fd16_scores_kernel<1, TKV><<<grid, kFdThreads, smem1, s>>>(
            static_cast<const __nv_bfloat16*>(q), static_cast<const TKV*>(k),
            lp, sc, pm, pl, S, H, G, D, NC, window, cs);
    } else {
        if ((e = allow_smem(fd16_scores_kernel<2, TKV>, smem1)) != cudaSuccess)
            return e;
        fd16_scores_kernel<2, TKV><<<grid, kFdThreads, smem1, s>>>(
            static_cast<const __nv_bfloat16*>(q), static_cast<const TKV*>(k),
            lp, sc, pm, pl, S, H, G, D, NC, window, cs);
    }
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    fd16_fold_kernel<<<(int)((heads + 127) / 128), 128, 0, s>>>(
        pm, pl, lp, rm, rl, S, H, G, NC, window, (int)heads);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    const int smem3 = (G * kFdChunk + kFdChunk * D) * (int)sizeof(float);
    if ((e = allow_smem(fd16_pv_kernel<TKV>, smem3)) != cudaSuccess) return e;
    fd16_pv_kernel<TKV><<<grid, kFdThreads, smem3, s>>>(
        static_cast<const TKV*>(v), lp, sc, rm, rl, acc, S, H, G, D, NC,
        window);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    const long long total = (long long)heads * D;
    fd16_sum_kernel<<<(int)((total + 255) / 256), 256, 0, s>>>(
        acc, lp, static_cast<__nv_bfloat16*>(out), S, H, G, D, NC, window,
        total);
    return cudaGetLastError();
}

}  // namespace

// q bf16 [B, H, G, D], k/v [B, S, H, D] of dtype code tkv (0 f32, 1 bf16,
// 2 e4m3), lengths int32 [B], out bf16 like q; 1 <= D <= 256; scratch as
// fd16_launch's; scale, softcap (0: none), inv_cap and neg: the composed
// path's constants, each a bf16 value. Returns cudaGetLastError() after the
// launches.
extern "C" int repro_flash_decode_bf16(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* out, void* scratch, int B, int S,
                                       int H, int G, int D, float scale,
                                       int window, float softcap,
                                       float inv_cap, float neg, int tkv,
                                       void* stream) {
    if (G < 1 || D < 1 || D > 2 * kFdPart || window < 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Fd16Consts cs{scale, softcap, inv_cap, neg};
    const auto s = static_cast<cudaStream_t>(stream);
    cudaError_t rc = cudaErrorInvalidValue;
    if (tkv == 0) {
        rc = fd16_launch<float>(q, k, v, lengths, out, scratch, B, S, H, G,
                                D, window, cs, s);
    } else if (tkv == 1) {
        rc = fd16_launch<__nv_bfloat16>(q, k, v, lengths, out, scratch, B, S,
                                        H, G, D, window, cs, s);
    } else if (tkv == 2) {
        rc = fd16_launch<__nv_fp8_e4m3>(q, k, v, lengths, out, scratch, B, S,
                                        H, G, D, window, cs, s);
    }
    return static_cast<int>(rc);
}
