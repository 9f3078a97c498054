// The decode-attention body of flash_decode_certified.cu and flash_decode.cu,
// which replace the Pallas TPU kernels _flash_decode_fmt_kernel and
// _flash_decode_kernel of src/repro/kernels/flash_decode.py: one query
// token per (batch, kv-head) group of G query heads attends to its KV cache
// [B, S, K, D] masked by lengths; q, k and v pass through a rounding functor
// as they load (a custom format, or the identity), the softmax runs in f32
// with scale D^-1/2, and the output acc / l passes through the functor once.
// Scores and probabilities are NOT rounded (as in the reference kernels).
//
// What bounds it on an H100: reading k and v up to lengths[b] once, at
// 3.35 TB/s (bytes: a 32K-position Qwen2-7B cache at batch 4 is 537 MB,
// 0.16 ms). The operations, 4·G·D per cached position, and the certified
// kernel's format rounding of every element come second. The TPU kernels
// walked the cache along a sequential grid axis with (m, l, acc) in VMEM;
// one block per (b, kv head) doing the same here left 16 blocks for 132
// SMs, whatever the cache's length. So the cache is split (split-S):
//
// 1. Chunks. One block of 8 warps per (chunk of 64 positions, kv head,
//    batch) computes its chunk's max m_c = max(-1e30, max s), sum l_c and
//    acc_c [G, D] with p = exp(s - m_c), into a scratch buffer that the
//    wrapper allocates. Chunks are fixed, 64 positions from position 0: a
//    32K cache gives 8,192 blocks, and the partials cost ~11 % over the k/v
//    bytes there (~30 MB written and read back against 537 MB), which is
//    kept: larger chunks would leave the short serving cache (145
//    positions, 48 blocks) fewer blocks still.
// 2. Combine. A second kernel folds each lane's chunks in the order 0, 1,
//    2, ... (from chunk 0's partial) by the online recurrence m' = max(m,
//    m_c), α = exp(m - m'), β = exp(m_c - m'), l' = fmaf(α, l, β·l_c),
//    acc' = fmaf(α, acc, β·acc_c), then writes rnd(acc / l). The running max
//    is a prefix max, exact in any order, so 32 chunks' α and β are found at
//    once, one a lane; the fold itself is sequential, and the next 32
//    chunks' loads are in flight while it runs (at 32K the combine reads
//    30 MB: 0.021 ms, 0.033 ms without). No atomics.
//
// Every output's sums run in one order, which depends on the lane's own
// length and on the constants here only: never on B, the lane's index, S
// (for a lane of length > 0) or the other lanes' lengths.
// - A score: lane l holds d = 4l..4l+3 (one 16-byte load of the position's
//   512-byte k row), an fmaf chain over its four, then a butterfly over the
//   32 lanes (xor 16, 8, 4, 2, 1). The 8 (padded) heads share it as a
//   reduce-scatter: lane l keeps head g in slot g ^ (l / 4), so each step
//   sends one half of its slots and keeps the other; 9 shuffles a position
//   instead of 40, and lane l ends with head l / 4.
// - P·V: lane l owns d = 4l..4l+3 of every head, warp w walks its 8
//   positions in order (an fmaf chain from 0), and the 8 warps' sums are
//   added in warp order. l_c likewise: each warp's p in order, then the
//   warps in order.
//
// Memory: each lane copies its 16 bytes of each of its warp's k and v rows
// with cp.async (k and v in two groups, so the scores start while v is in
// flight) and reads back only what it copied: each element is rounded
// once, by the thread that loaded it, with no barrier in between. Positions
// at or beyond lengths[b] are never read, so a stale or non-finite cache
// entry there cannot reach the output.
//
// Masking follows the reference: a position at or beyond lengths[b] scores
// -1e30. A lane of length <= 0 scores -1e30 everywhere, so its chunks'
// maxima are -1e30, every weight exp(0) = 1, every α and β 1, and the output
// is the mean of the rounded v over all S positions (the reference's result,
// with no host sync). Such a lane reads v over all S, and no k.
//
// Arithmetic: expf (not __expf), IEEE division for acc / l, no fast math, no
// tensor cores.
#pragma once

#include <cuda_runtime.h>

#include "gemm_common.cuh"

namespace {

constexpr int kFdChunk = 64;                  // cached positions a block
constexpr int kFdWarps = 8;
constexpr int kFdRows = kFdChunk / kFdWarps;  // positions a warp
constexpr int kFdThreads = 32 * kFdWarps;
constexpr int kFdDMax = 128;                  // head dim: 4 elements a lane
constexpr int kFdGMax = 8;                    // query heads per kv head
constexpr int kFdSRow = kFdChunk + 4;         // score rows on distinct banks
constexpr float kFdNeg = -1e30f;
constexpr unsigned kFdFull = 0xffffffffu;
static_assert(kFdRows >= kFdGMax, "a warp's k rows hold its acc afterwards");
static_assert(kFdDMax == 4 * 32, "4 elements a lane");
static_assert(kFdChunk % 4 == 0, "a head's 4 lanes split the chunk's max");

struct FdSmem {
    float k[kFdChunk][kFdDMax];  // after the scores: warp w's acc, its rows
    float v[kFdChunk][kFdDMax];
    float q[kFdGMax][kFdDMax];
    float s[kFdGMax][kFdSRow];
    float p[kFdChunk][kFdGMax];
    float l[kFdWarps][kFdGMax];
    float m[kFdGMax];
};

__host__ __device__ __forceinline__ int fd_chunks(int S) {
    return (S + kFdChunk - 1) / kFdChunk;
}

// Positions a lane attends: its length, or all S for a length <= 0.
__device__ __forceinline__ int fd_attended(int len, int S) {
    return len <= 0 ? S : min(len, S);
}

template <class Q>
__device__ __forceinline__ float4 fd_load_round(const float* p, const Q& rnd) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    return make_float4(rnd(x.x), rnd(x.y), rnd(x.z), rnd(x.w));
}

template <class Q>
__global__ void __launch_bounds__(kFdThreads, 3)
flash_decode_chunk_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const int* __restrict__ lengths,
                          float* __restrict__ part_acc,
                          float* __restrict__ part_m,
                          float* __restrict__ part_l, int S, int H, int G,
                          int D, int NC, float scale, Q rnd) {
    extern __shared__ float4 fd_smem[];
    FdSmem& sm = *reinterpret_cast<FdSmem*>(fd_smem);
    const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int len = lengths[b];
    const bool empty = len <= 0;
    const int t0 = c * kFdChunk;
    const int n = fd_attended(len, S);
    if (t0 >= n) return;                     // past the lane's length
    const int tc = min(kFdChunk, n - t0);    // positions of this chunk
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int r0 = warp * kFdRows;           // the warp's rows
    const int nr = max(0, min(kFdRows, tc - r0));
    const int d0 = 4 * lane;
    const bool has_d = d0 < D;

    // the warp's k rows (group 0) and v rows (group 1): lane l copies d0..
    const size_t row0 = ((size_t)b * S + t0 + r0) * H + h;
    if (has_d && !empty) {
        for (int j = 0; j < nr; ++j) {
            cp_async16(&sm.k[r0 + j][d0], k + (row0 + (size_t)j * H) * D + d0,
                       true);
        }
    }
    cp_async_commit();
    if (has_d) {
        for (int j = 0; j < nr; ++j) {
            cp_async16(&sm.v[r0 + j][d0], v + (row0 + (size_t)j * H) * D + d0,
                       true);
        }
    }
    cp_async_commit();

    // q, rounded, zero past G and D
    const float* qb = q + (size_t)(b * H + h) * G * D;
    for (int e = threadIdx.x; e < kFdGMax * kFdDMax; e += kFdThreads) {
        const int g = e / kFdDMax, d = e % kFdDMax;
        sm.q[g][d] = g < G && d < D ? rnd(qb[g * D + d]) : 0.0f;
    }
    __syncthreads();

    // scores of the warp's rows; lane l ends with head hl's
    const int hl = lane / 4, i4 = lane % 4;
    if (!empty) {
        float4 qr[kFdGMax];   // slot j: head j ^ hl
#pragma unroll
        for (int j = 0; j < kFdGMax; ++j) {
            qr[j] = *reinterpret_cast<const float4*>(&sm.q[j ^ hl][d0]);
        }
        cp_async_wait<1>();
        for (int j = 0; j < nr; ++j) {
            const float4 kk = has_d ? fd_load_round(&sm.k[r0 + j][d0], rnd)
                                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            float x[kFdGMax];
#pragma unroll
            for (int g = 0; g < kFdGMax; ++g) {
                x[g] = fmaf(qr[g].w, kk.w,
                            fmaf(qr[g].z, kk.z,
                                 fmaf(qr[g].y, kk.y, qr[g].x * kk.x)));
            }
            // reduce-scatter: the partner's slot g + half holds my slot g's
            // head, since its hl differs from mine in that bit
#pragma unroll
            for (int g = 0; g < 4; ++g) {
                x[g] += __shfl_xor_sync(kFdFull, x[g + 4], 16);
            }
#pragma unroll
            for (int g = 0; g < 2; ++g) {
                x[g] += __shfl_xor_sync(kFdFull, x[g + 2], 8);
            }
            x[0] += __shfl_xor_sync(kFdFull, x[1], 4);
            x[0] += __shfl_xor_sync(kFdFull, x[0], 2);
            x[0] += __shfl_xor_sync(kFdFull, x[0], 1);
            if (i4 == 0 && hl < G) sm.s[hl][r0 + j] = x[0] * scale;
        }
    } else if (i4 == 0 && hl < G) {
        for (int j = 0; j < nr; ++j) sm.s[hl][r0 + j] = kFdNeg;
    }
    __syncthreads();

    // the chunk's max of head hl (-1e30 at least, as the reference clamps):
    // each of its 4 lanes takes a quarter of the chunk
    float mx = kFdNeg;
    if (hl < G) {
        const int e = min(kFdChunk / 4 * (i4 + 1), tc);
        for (int i = kFdChunk / 4 * i4; i < e; ++i) {
            mx = fmaxf(mx, sm.s[hl][i]);
        }
    }
    mx = fmaxf(mx, __shfl_xor_sync(kFdFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFdFull, mx, 2));

    // p of the warp's rows (0 for heads past G), then the warp's sum of
    // head hl's p in order
#pragma unroll
    for (int j = i4; j < kFdRows; j += 4) {
        if (j < nr) {
            sm.p[r0 + j][hl] = hl < G ? expf(sm.s[hl][r0 + j] - mx) : 0.0f;
        }
    }
    __syncwarp();
    if (i4 == 0 && nr > 0) {
        float l = sm.p[r0][hl];
        for (int j = 1; j < nr; ++j) l += sm.p[r0 + j][hl];
        sm.l[warp][hl] = l;
        if (warp == 0) sm.m[hl] = mx;
    }

    // P·V over the warp's rows in order: lane l owns d0.. of every head
    float acc[kFdGMax][4];
#pragma unroll
    for (int g = 0; g < kFdGMax; ++g) {
        acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.0f;
    }
    cp_async_wait<0>();
    for (int j = 0; j < nr; ++j) {
        const float4 vv = has_d ? fd_load_round(&sm.v[r0 + j][d0], rnd)
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const float4 pa = *reinterpret_cast<const float4*>(&sm.p[r0 + j][0]);
        const float4 pb = *reinterpret_cast<const float4*>(&sm.p[r0 + j][4]);
        const float pg[kFdGMax] = {pa.x, pa.y, pa.z, pa.w,
                                   pb.x, pb.y, pb.z, pb.w};
#pragma unroll
        for (int g = 0; g < kFdGMax; ++g) {
            acc[g][0] = fmaf(pg[g], vv.x, acc[g][0]);
            acc[g][1] = fmaf(pg[g], vv.y, acc[g][1]);
            acc[g][2] = fmaf(pg[g], vv.z, acc[g][2]);
            acc[g][3] = fmaf(pg[g], vv.w, acc[g][3]);
        }
    }
    // into the warp's own k rows (row r0 + g: head g), read by every warp
    if (nr > 0 && has_d) {
#pragma unroll
        for (int g = 0; g < kFdGMax; ++g) {
            if (g < G) {
                *reinterpret_cast<float4*>(&sm.k[r0 + g][d0]) =
                    make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
            }
        }
    }
    __syncthreads();

    // the chunk's partial: warp g adds head g's sums in warp order
    const int nw = (tc + kFdRows - 1) / kFdRows;
    const int g = warp;
    if (g < G) {
        const size_t prow = ((size_t)(b * H + h) * G + g) * NC + c;
        if (has_d) {
            float4 a = *reinterpret_cast<const float4*>(&sm.k[g][d0]);
            for (int w = 1; w < nw; ++w) {
                const float* row = &sm.k[w * kFdRows + g][d0];
                const float4 t = *reinterpret_cast<const float4*>(row);
                a.x += t.x;
                a.y += t.y;
                a.z += t.z;
                a.w += t.w;
            }
            *reinterpret_cast<float4*>(part_acc + prow * D + d0) = a;
        }
        if (lane == 0) {
            float l = sm.l[0][g];
            for (int w = 1; w < nw; ++w) l += sm.l[w][g];
            part_l[prow] = l;
            part_m[prow] = sm.m[g];
        }
    }
}

// One group of 32 chunk partials from chunk c0 (none past nc): lane j's m
// and l of chunk c0 + j, and thread d's acc of each.
struct FdGroup {
    float x[32];
    float m, l;
};

__device__ __forceinline__ void fd_load_group(FdGroup& gr, const float* ap,
                                              const float* pm,
                                              const float* pl, int c0,
                                              int nc, int D, bool has_d,
                                              int lane) {
    const int cnt = nc - c0;
    gr.m = lane < cnt ? pm[c0 + lane] : -INFINITY;
    gr.l = lane < cnt ? pl[c0 + lane] : 0.0f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
        gr.x[j] = has_d && j < cnt ? ap[(size_t)(c0 + j) * D] : 0.0f;
    }
}

// One block per (head, kv head, batch), thread d: folds the lane's chunk
// partials in chunk order and writes rnd(acc / l). The next group's loads
// are in flight while a group folds.
template <class Q>
__global__ void __launch_bounds__(kFdDMax)
flash_decode_combine_kernel(const float* __restrict__ part_acc,
                            const float* __restrict__ part_m,
                            const float* __restrict__ part_l,
                            const int* __restrict__ lengths,
                            float* __restrict__ out, int S, int H, int G,
                            int D, int NC, Q rnd) {
    const int g = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int d = threadIdx.x, lane = d % 32;
    const bool has_d = d < D;
    const int nc = fd_chunks(fd_attended(lengths[b], S));
    const size_t head = (size_t)(b * H + h) * G + g;
    const float* pm = part_m + head * NC;
    const float* pl = part_l + head * NC;
    const float* ap = part_acc + head * NC * D + d;
    float m = pm[0], l = pl[0];
    float acc = has_d ? ap[0] : 0.0f;
    FdGroup cur;
    fd_load_group(cur, ap, pm, pl, 1, nc, D, has_d, lane);
    for (int c0 = 1; c0 < nc; c0 += 32) {
        FdGroup next;
        fd_load_group(next, ap, pm, pl, c0 + 32, nc, D, has_d, lane);
        const int cnt = min(32, nc - c0);
        // the running max after chunk c0 + lane, and before it
        float mx = cur.m;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const float t = __shfl_up_sync(kFdFull, mx, o);
            if (lane >= o) mx = fmaxf(mx, t);
        }
        mx = fmaxf(mx, m);
        float prev = __shfl_up_sync(kFdFull, mx, 1);
        if (lane == 0) prev = m;
        const float alpha = expf(prev - mx), beta = expf(cur.m - mx);
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            if (j < cnt) {
                const float a = __shfl_sync(kFdFull, alpha, j);
                const float bt = __shfl_sync(kFdFull, beta, j);
                l = fmaf(a, l, bt * __shfl_sync(kFdFull, cur.l, j));
                acc = fmaf(a, acc, bt * cur.x[j]);
            }
        }
        m = __shfl_sync(kFdFull, mx, cnt - 1);
        cur = next;
    }
    if (has_d) out[head * D + d] = rnd(__fdiv_rn(acc, l));
}

// q [B, H, G, D], k/v [B, S, H, D], lengths int32 [B], out like q: f32,
// contiguous, on the device; G <= 8, D <= 128 and D % 4 == 0, k and v
// 16-byte aligned; partials: B·H·G·chunks·(D + 2) floats, 16-byte aligned,
// for acc [rows][D], then m [rows], then l [rows], rows = B·H·G·chunks
// (the wrappers allocate and check). Launches both kernels on
// ``stream``; returns cudaGetLastError().
template <class Q>
cudaError_t flash_decode(const void* q, const void* k, const void* v,
                         const void* lengths, void* out, void* partials,
                         int B, int S, int H, int G, int D, float scale,
                         Q rnd, void* stream) {
    const auto s = static_cast<cudaStream_t>(stream);
    const int NC = fd_chunks(S);
    const size_t rows = (size_t)B * H * G * NC;
    float* acc = static_cast<float*>(partials);
    float* m = acc + rows * D;
    float* l = m + rows;
    static const cudaError_t attr =
        allow_smem(flash_decode_chunk_kernel<Q>, sizeof(FdSmem));
    if (attr != cudaSuccess) return attr;
    flash_decode_chunk_kernel<Q><<<dim3(NC, H, B), kFdThreads, sizeof(FdSmem),
                                   s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const int*>(lengths), acc,
        m, l, S, H, G, D, NC, scale, rnd);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    flash_decode_combine_kernel<Q><<<dim3(G, H, B), kFdDMax, 0, s>>>(
        acc, m, l, static_cast<const int*>(lengths), static_cast<float*>(out),
        S, H, G, D, NC, rnd);
    return cudaGetLastError();
}

}  // namespace
