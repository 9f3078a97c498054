// latent_decode_bf16: MLA's absorbed single-token decode attention in bf16
// (MiniCPM3 under compute_dtype "bfloat16"). It replaces no Pallas kernel:
// the reference never offers MLA to a fused decode and composes einsums and
// a softmax in the compute dtype (src/repro/models/attention.py:210-220;
// the port's copy is repro_torch/models/attention.py's mla_attention). It
// is the bf16 counterpart of the f32 latent route, which runs kernel 4
// (_flash_decode_kernel of src/repro/kernels/flash_decode.py) as one kv
// head over keys [c | k_rope]. In bf16 the composed path rounds
//   - each score product apart: s_nope = bf16(q_lat·c), s_rope =
//     bf16(q_rope·k_rope) (exact products, f32 sums), then their sum, then
//     the scale, each to bf16 by RNE; the mask (NEG_BIG = -1e9) in bf16;
//   - softmax in f32 over the whole row, then the probabilities to bf16;
//   - out = bf16(Σ p·c) with f32 sums.
// So [c | k_rope] as one key of R + Dr = 288 dims would round once where
// the composed path rounds three times; the two widths stay apart here.
// The latent cache is read as the composed path reads it (bk.input: to
// bf16; a bf16 or e4m3 cache converts exactly, an f32 one rounds by RNE),
// in place: c from the cache's k buffer [B, S, R], k_rope from its v
// buffer [B, S, Dr]; no copy of the cache.
//
// One online-softmax pass cannot round p after the row's final max and
// sum, so this takes kernel 4's bf16 instance's two passes
// (flash_decode_bf16.cu) over a lane's chunks of 64 positions, with one kv
// head and all H query heads in a block:
// 1. scores: one block per (chunk, lane); a score's two dots each as a
//    lane's fmaf chain over its dims (lane l holds d = 4l..4l+3 of each part
//    of 128 dims), then the butterfly over the 32 lanes (xor 16, 8, 4, 2,
//    1); the chunk's scores into a scratch row, and each head's chunk max
//    m_c = max(NEG_BIG, s) and sum l_c = Σ exp(s − m_c) in position order;
// 2. fold: one thread per (lane, head) folds the chunks' (m_c, l_c) in
//    chunk order: m' = max(m, m_c), l = fmaf(exp(m − m'), l, exp(m_c − m')·l_c);
// 3. p·c: one block per (chunk, lane): p = bf16(exp(s − m) / l) (IEEE
//    division), and each (head, latent dim)'s Σ p·c over the chunk's
//    positions in order, an fmaf chain from +0 (products exact: p and c are
//    bf16), into a partial;
// 4. sum: one thread per output element adds the chunks' partials in chunk
//    order and writes the sum in bf16 by RNE.
// Positions at or past a lane's length are never read and add nothing (the
// composed path's exp(NEG_BIG − m) is 0); a lane of length <= 0 attends all
// S positions with score NEG_BIG, as kernel 4. Every output's order depends
// on the lane's own length only. flash_decode.latent_decode_bf16_ref is
// this algorithm in plain PyTorch, bit for bit where its exp and division
// are the card's (on the card).
//
// What bounds it on an H100: reading c and k_rope up to lengths[b] once
// (2 bytes an element in bf16); its f32 FMAs (H·(R + Dr) a position for
// the scores, H·R for p·c) run on the CUDA cores, one chain per output in
// a pinned order. The scores' scratch row (4 bytes a position and head)
// and the chunk partials (4·H·R bytes a chunk) are written once and read
// once. A library of its own, built at first use.
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include "flash_decode.cuh"

namespace {

constexpr int kLdSmemMax = 232448;   // an H100 block's dynamic shared memory

__device__ __forceinline__ float ld_round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

// A cache element as the composed path reads it: in bf16.
template <class T>
__device__ __forceinline__ float ld_in(T v) {
    if constexpr (std::is_same<T, float>::value) {
        return ld_round(v);
    } else {
        return to_f32(v);
    }
}

// One dot product of a warp: lane l's fmaf chain over d = 128·pt + 4l + u
// (pt < NP, u < 4), from its first product, then the 32-lane butterfly.
// q: the head's row in shared memory (NP·128 floats, zero past the width);
// kv: this lane's elements of the cache row (zero past the width).
template <int NP>
__device__ __forceinline__ float ld_dot(const float* q, const float (&kv)[NP][4],
                                        int lane) {
    // 16-byte reads of q: q is 16-byte aligned, a part 128 floats
    const float4* ql = reinterpret_cast<const float4*>(q) + lane;
    float4 a = ql[0];
    float x = a.x * kv[0][0];
    x = fmaf(a.y, kv[0][1], x);
    x = fmaf(a.z, kv[0][2], x);
    x = fmaf(a.w, kv[0][3], x);
#pragma unroll
    for (int pt = 1; pt < NP; ++pt) {
        a = ql[pt * kFdPart / 4];
        x = fmaf(a.x, kv[pt][0], x);
        x = fmaf(a.y, kv[pt][1], x);
        x = fmaf(a.z, kv[pt][2], x);
        x = fmaf(a.w, kv[pt][3], x);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFdFull, x, o);
    return x;
}

template <int NP, class T>
__device__ __forceinline__ void ld_row(float (&kv)[NP][4], const T* row,
                                       int width, int lane) {
#pragma unroll
    for (int pt = 0; pt < NP; ++pt) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int d = kFdPart * pt + 4 * lane + u;
            kv[pt][u] = d < width ? ld_in(row[d]) : 0.0f;
        }
    }
}

// Pass 1. Dynamic shared memory: q_lat [H][NP·128], q_rope [H][128],
// s [H][64].
template <int NP, class TKV>
__global__ void __launch_bounds__(kFdThreads)
ld_scores_kernel(const __nv_bfloat16* __restrict__ q_lat,
                 const __nv_bfloat16* __restrict__ q_rope,
                 const TKV* __restrict__ c, const TKV* __restrict__ k_rope,
                 const int* __restrict__ lengths, float* __restrict__ scores,
                 float* __restrict__ part_m, float* __restrict__ part_l,
                 int S, int H, int R, int DR, int NC, float scale, float neg) {
    constexpr int DL = NP * kFdPart;
    extern __shared__ float4 ld_smem[];
    float* const sq = reinterpret_cast<float*>(ld_smem);   // [H][DL]
    float* const sr = sq + H * DL;                          // [H][128]
    float* const ss = sr + H * kFdPart;                     // [H][64]
    const int ch = blockIdx.x, b = blockIdx.y;
    const int len = lengths[b];
    const bool empty = len <= 0;
    const int t0 = ch * kFdChunk;
    const int n = fd_attended(len, S);
    if (t0 >= n) return;
    const int tc = min(kFdChunk, n - t0);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const size_t head0 = (size_t)b * H;

    for (int e = threadIdx.x; e < H * DL; e += kFdThreads) {
        const int h = e / DL, d = e % DL;
        sq[e] = d < R ? __bfloat162float(q_lat[(head0 + h) * R + d]) : 0.0f;
    }
    for (int e = threadIdx.x; e < H * kFdPart; e += kFdThreads) {
        const int h = e / kFdPart, d = e % kFdPart;
        sr[e] = d < DR ? __bfloat162float(q_rope[(head0 + h) * DR + d]) : 0.0f;
    }
    __syncthreads();

    for (int j = 0; j < kFdRows; ++j) {
        const int i = warp * kFdRows + j, p = t0 + i;
        if (i >= tc) break;
        if (empty) {
            for (int h = lane; h < H; h += 32) ss[h * kFdChunk + i] = neg;
            continue;
        }
        float kc[NP][4], kr[1][4];
        ld_row<NP>(kc, c + ((size_t)b * S + p) * R, R, lane);
        ld_row<1>(kr, k_rope + ((size_t)b * S + p) * DR, DR, lane);
        for (int h = 0; h < H; ++h) {
            const float xl = ld_dot<NP>(sq + h * DL, kc, lane);
            const float xr = ld_dot<1>(sr + h * kFdPart, kr, lane);
            if (lane == 0) {
                ss[h * kFdChunk + i] =
                    ld_round(ld_round(ld_round(xl) + ld_round(xr)) * scale);
            }
        }
    }
    __syncthreads();

    for (int e = threadIdx.x; e < H * tc; e += kFdThreads) {
        const int h = e / tc, i = e % tc;
        scores[(head0 + h) * S + t0 + i] = ss[h * kFdChunk + i];
    }
    for (int h = threadIdx.x; h < H; h += kFdThreads) {
        const float* sh = ss + h * kFdChunk;
        float m = neg;
        for (int i = 0; i < tc; ++i) m = fmaxf(m, sh[i]);
        float l = expf(sh[0] - m);
        for (int i = 1; i < tc; ++i) l = __fadd_rn(l, expf(sh[i] - m));
        part_m[(head0 + h) * NC + ch] = m;
        part_l[(head0 + h) * NC + ch] = l;
    }
}

// Pass 2: each head's (m, l) of the whole row.
__global__ void ld_fold_kernel(const float* __restrict__ part_m,
                               const float* __restrict__ part_l,
                               const int* __restrict__ lengths,
                               float* __restrict__ row_m,
                               float* __restrict__ row_l, int S, int H,
                               int NC, int heads) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= heads) return;
    const int nc = fd_chunks(fd_attended(lengths[r / H], S));
    const float* pm = part_m + (size_t)r * NC;
    const float* pl = part_l + (size_t)r * NC;
    float m = pm[0], l = pl[0];
    for (int ch = 1; ch < nc; ++ch) {
        const float m2 = fmaxf(m, pm[ch]);
        l = fmaf(expf(m - m2), l, expf(pm[ch] - m2) * pl[ch]);
        m = m2;
    }
    row_m[r] = m;
    row_l[r] = l;
}

// Pass 3. Dynamic shared memory: p [H][64], c [64][R].
template <class TKV>
__global__ void __launch_bounds__(kFdThreads)
ld_pc_kernel(const TKV* __restrict__ c, const int* __restrict__ lengths,
             const float* __restrict__ scores, const float* __restrict__ row_m,
             const float* __restrict__ row_l, float* __restrict__ part_acc,
             int S, int H, int R, int NC) {
    extern __shared__ float4 ld_smem[];
    float* const sp = reinterpret_cast<float*>(ld_smem);   // [H][64]
    float* const sc = sp + H * kFdChunk;                    // [64][R]
    const int ch = blockIdx.x, b = blockIdx.y;
    const int t0 = ch * kFdChunk;
    const int n = fd_attended(lengths[b], S);
    if (t0 >= n) return;
    const int tc = min(kFdChunk, n - t0);
    const size_t head0 = (size_t)b * H;

    for (int e = threadIdx.x; e < tc * R; e += kFdThreads) {
        sc[e] = ld_in(c[((size_t)b * S + t0) * R + e]);
    }
    for (int e = threadIdx.x; e < H * tc; e += kFdThreads) {
        const int h = e / tc, i = e % tc;
        const float s = scores[(head0 + h) * S + t0 + i];
        sp[h * kFdChunk + i] = ld_round(
            __fdiv_rn(expf(s - row_m[head0 + h]), row_l[head0 + h]));
    }
    __syncthreads();

    for (int e = threadIdx.x; e < H * R; e += kFdThreads) {
        const int h = e / R, d = e % R;
        const float* ph = sp + h * kFdChunk;
        float a = 0.0f;
        for (int i = 0; i < tc; ++i) a = fmaf(ph[i], sc[i * R + d], a);
        part_acc[((head0 + h) * NC + ch) * R + d] = a;
    }
}

// Pass 4: each output element's partials in chunk order, to bf16.
__global__ void ld_sum_kernel(const float* __restrict__ part_acc,
                              const int* __restrict__ lengths,
                              __nv_bfloat16* __restrict__ out, int S, int H,
                              int R, int NC, long long total) {
    const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (e >= total) return;
    const long long r = e / R;
    const int d = (int)(e % R);
    const int nc = fd_chunks(fd_attended(lengths[r / H], S));
    const float* ap = part_acc + (size_t)r * NC * R + d;
    float acc = ap[0];
    for (int ch = 1; ch < nc; ++ch) acc = __fadd_rn(acc, ap[(size_t)ch * R]);
    out[e] = __float2bfloat16_rn(acc);
}

int ld_smem_scores(int H, int R) {
    const int np = R <= kFdPart ? 1 : 2;
    return H * (np * kFdPart + kFdPart + kFdChunk) * (int)sizeof(float);
}

int ld_smem_pc(int H, int R) {
    return (H * kFdChunk + kFdChunk * R) * (int)sizeof(float);
}

// q_lat bf16 [B, H, R], q_rope bf16 [B, H, DR], c [B, S, R] and k_rope
// [B, S, DR] of TKV, lengths int32 [B], out bf16 [B, H, R]; 1 <= R <= 256,
// 1 <= DR <= 128. scratch: B·H·(S + NC·(R + 2) + 2) floats: the scores
// [B·H][S], the chunk partials acc [B·H·NC][R], m and l [B·H·NC], then the
// rows' m and l [B·H]. Four launches on ``stream``; returns the first
// launch error.
template <class TKV>
cudaError_t ld_launch(const void* q_lat, const void* q_rope, const void* c,
                      const void* k_rope, const void* lengths, void* out,
                      void* scratch, int B, int S, int H, int R, int DR,
                      float scale, float neg, cudaStream_t s) {
    const int NC = fd_chunks(S);
    const size_t heads = (size_t)B * H;
    float* sc = static_cast<float*>(scratch);
    float* acc = sc + heads * S;
    float* pm = acc + heads * NC * R;
    float* pl = pm + heads * NC;
    float* rm = pl + heads * NC;
    float* rl = rm + heads;
    const auto* lp = static_cast<const int*>(lengths);
    const auto* ql = static_cast<const __nv_bfloat16*>(q_lat);
    const auto* qr = static_cast<const __nv_bfloat16*>(q_rope);
    const auto* cc = static_cast<const TKV*>(c);
    const auto* kr = static_cast<const TKV*>(k_rope);
    const dim3 grid(NC, B);
    const int smem1 = ld_smem_scores(H, R);
    cudaError_t e;
    if (R <= kFdPart) {
        if ((e = allow_smem(ld_scores_kernel<1, TKV>, smem1)) != cudaSuccess)
            return e;
        ld_scores_kernel<1, TKV><<<grid, kFdThreads, smem1, s>>>(
            ql, qr, cc, kr, lp, sc, pm, pl, S, H, R, DR, NC, scale, neg);
    } else {
        if ((e = allow_smem(ld_scores_kernel<2, TKV>, smem1)) != cudaSuccess)
            return e;
        ld_scores_kernel<2, TKV><<<grid, kFdThreads, smem1, s>>>(
            ql, qr, cc, kr, lp, sc, pm, pl, S, H, R, DR, NC, scale, neg);
    }
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    ld_fold_kernel<<<(int)((heads + 127) / 128), 128, 0, s>>>(
        pm, pl, lp, rm, rl, S, H, NC, (int)heads);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    const int smem3 = ld_smem_pc(H, R);
    if ((e = allow_smem(ld_pc_kernel<TKV>, smem3)) != cudaSuccess) return e;
    ld_pc_kernel<TKV><<<grid, kFdThreads, smem3, s>>>(cc, lp, sc, rm, rl, acc,
                                                      S, H, R, NC);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    const long long total = (long long)heads * R;
    ld_sum_kernel<<<(int)((total + 255) / 256), 256, 0, s>>>(
        acc, lp, static_cast<__nv_bfloat16*>(out), S, H, R, NC, total);
    return cudaGetLastError();
}

}  // namespace

// As ld_launch, with tkv the cache's dtype code (0 f32, 1 bf16, 2 e4m3) and
// scale / neg the composed path's constants, each a bf16 value. Returns
// cudaGetLastError() after the launches; cudaErrorInvalidValue for shapes
// the kernel does not take (its shared memory included).
extern "C" int repro_latent_decode_bf16(const void* q_lat, const void* q_rope,
                                        const void* c, const void* k_rope,
                                        const void* lengths, void* out,
                                        void* scratch, int B, int S, int H,
                                        int R, int DR, float scale, float neg,
                                        int tkv, void* stream) {
    if (B < 1 || S < 1 || H < 1 || R < 1 || R > 2 * kFdPart || DR < 1 ||
        DR > kFdPart || ld_smem_scores(H, R) > kLdSmemMax ||
        ld_smem_pc(H, R) > kLdSmemMax) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const auto s = static_cast<cudaStream_t>(stream);
    cudaError_t rc = cudaErrorInvalidValue;
    if (tkv == 0) {
        rc = ld_launch<float>(q_lat, q_rope, c, k_rope, lengths, out, scratch,
                              B, S, H, R, DR, scale, neg, s);
    } else if (tkv == 1) {
        rc = ld_launch<__nv_bfloat16>(q_lat, q_rope, c, k_rope, lengths, out,
                                      scratch, B, S, H, R, DR, scale, neg, s);
    } else if (tkv == 2) {
        rc = ld_launch<__nv_fp8_e4m3>(q_lat, q_rope, c, k_rope, lengths, out,
                                      scratch, B, S, H, R, DR, scale, neg, s);
    }
    return static_cast<int>(rc);
}
