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
//
// Shapes. Any G: the query heads of a kv head run in tiles of 8 (one
// launch of the chunk kernel a tile, each reading the tile's k and v; the
// combine takes every head at once), and each head's sums run as they do
// in a group of 8 or fewer. Any D >= 1: an instance for D <= 128 holds 4
// elements a lane (above), one for D <= 256 holds 8, as two 4-element
// parts d = 4l.. and 128 + 4l.. (two 16-byte copies a row; a score's fmaf
// chain runs over the first part's four, then the second's). Above 256 the
// wide instance walks D in slices of 256 with that layout: a score is the
// slices' butterfly sums added in slice order (the 8-element chain and
// butterfly within a slice), and P.V runs slice by slice, each slice's
// dims independent of the others' (the shared memory of one 64-row chunk
// at D = 512 would not fit). The combine takes D in slices of 256 threads
// (one block a slice); each dim folds as before. Where D % 4 != 0, or k or
// v is not 16-byte aligned, an instance copies 4 bytes at a time into the
// same layout, zero-filled past D.
//
// Sliding window and softcap (kernel 4 only; kernel 2 passes 0 for both,
// and its instances run as they did). With window w > 0 a lane of length n
// attends positions [max(0, n - w), n): chunks wholly below n - w are
// neither launched into nor folded (the fold starts at the chunk that
// holds n - w, still in chunk order), and the positions below n - w in
// that chunk are not read and score -1e30 (weight 0). With cap > 0 a score
// is cap * tanhf((x * scale) * inv_cap), inv_cap = f32(1 / cap) from the
// host, before the online softmax: the reference's composed order
// (bk.scale, then bk.softcap = scale(tanh(scale(a, 1/cap)), cap)).
//
// Narrow operands (flash_decode_narrow, built in
// flash_decode_certified_narrow.cu). The instances above read f32 q, k and
// v. A bf16 q (TQ; compute_dtype "bfloat16") with an f32, bf16 or e4m3
// cache (TKV), or an f32 q with a bf16 or e4m3 cache (compute_dtype
// "float32" with a narrow cache_dtype), runs the same arithmetic on the
// operands upcast to f32 in registers straight after their loads (exact),
// and the output acc / l, after the functor, is written in TQ (by RNE for
// bf16): bit for bit the f32 instance on the upcast operands followed by
// the cast. A narrow cache is read by plain loads (8
// bytes a lane's part for bf16, 4 for e4m3, where D % 4 == 0 and the cache
// is aligned; element by element otherwise) and stored into the same f32
// shared rows the async copies fill; D <= 256 only (no wide instance).
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include "gemm_common.cuh"

namespace {

constexpr int kFdChunk = 64;                  // cached positions a block
constexpr int kFdWarps = 8;
constexpr int kFdRows = kFdChunk / kFdWarps;  // positions a warp
constexpr int kFdThreads = 32 * kFdWarps;
constexpr int kFdGMax = 8;                    // query heads a tile
constexpr int kFdSRow = kFdChunk + 4;         // score rows on distinct banks
constexpr int kFdPart = 4 * 32;               // elements of a 4-element part
constexpr float kFdNeg = -1e30f;
constexpr unsigned kFdFull = 0xffffffffu;
static_assert(kFdRows >= kFdGMax, "a warp's k rows hold its acc afterwards");
static_assert(kFdChunk % 4 == 0, "a head's 4 lanes split the chunk's max");

// DM = 32 * DL: the head dims an instance holds, DL = 4 or 8 a lane.
template <int DM>
struct FdSmem {
    float k[kFdChunk][DM];  // after the scores: warp w's acc, its rows
    float v[kFdChunk][DM];
    float q[kFdGMax][DM];
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

// The first position a lane of n attended positions attends under a
// sliding window (0: none); 0 for a lane of length <= 0.
__device__ __forceinline__ int fd_first(int len, int n, int window) {
    return window > 0 && len > 0 ? max(0, n - window) : 0;
}

// A score from its dot product x: x * scale, softcapped where cap > 0.
__device__ __forceinline__ float fd_score(float x, float scale, float cap,
                                          float inv_cap) {
    const float s = x * scale;
    return cap > 0.0f ? cap * tanhf(s * inv_cap) : s;
}

template <class Q>
__device__ __forceinline__ float4 fd_load_round(const float* p, const Q& rnd) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    return make_float4(rnd(x.x), rnd(x.y), rnd(x.z), rnd(x.w));
}

// The async copy of one lane's 4-element part of a row: one 16-byte copy
// (V), or four 4-byte ones, each zero-filled past D.
template <bool V>
__device__ __forceinline__ void fd_copy_part(float* dst, const float* src,
                                             int d, int D) {
    if constexpr (V) {
        cp_async16(dst, src, true);
    } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            cp_async4(dst + i, d + i < D ? src + i : src, d + i < D);
        }
    }
}

// A narrow cache's part of a row: four elements of T loaded (one 8- or
// 4-byte load where V, else one at a time, zero past D), upcast to f32 and
// stored as one float4 of the shared row.
template <bool V, class T>
__device__ __forceinline__ void fd_load_part(float* dst, const T* src, int d,
                                             int D) {
    float f[4];
    if constexpr (V) {
        using W = typename std::conditional<sizeof(T) == 2, uint2,
                                            uint32_t>::type;
        const W u = *reinterpret_cast<const W*>(src);
        const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int i = 0; i < 4; ++i) f[i] = to_f32(e[i]);
    } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) f[i] = d + i < D ? to_f32(src[i]) : 0.0f;
    }
    *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
}

// The warp's rows j in [jlo, nr) of one part of k or v into the shared
// rows: async copies of an f32 cache (one group, committed by the caller),
// or a narrow cache's loads.
template <bool V, class TKV, int DM>
__device__ __forceinline__ void fd_rows(float (*dst)[DM], const TKV* src,
                                        size_t row0, int r0, int jlo, int nr,
                                        int H, int d, int dl, int D) {
    if constexpr (std::is_same<TKV, float>::value) {
        for (int j = jlo; j < nr; ++j) {
            fd_copy_part<V>(&dst[r0 + j][dl], src + (row0 + (size_t)j * H) * D + d,
                            d, D);
        }
    } else {
#pragma unroll
        for (int j = 0; j < kFdRows; ++j) {
            if (j >= jlo && j < nr) {
                fd_load_part<V>(&dst[r0 + j][dl],
                                src + (row0 + (size_t)j * H) * D + d, d, D);
            }
        }
    }
}

// One tile of GT <= 8 query heads: q points at the tile's first head, the
// partials at its first head's rows; G is the heads of a kv head (the
// stride of q and of the partials). DL elements a lane, V: 16-byte copies.
template <class Q, int DL, bool V, class TQ = float, class TKV = float>
__global__ void __launch_bounds__(kFdThreads, DL == 4 ? 3 : 1)
flash_decode_chunk_kernel(const TQ* __restrict__ q,
                          const TKV* __restrict__ k,
                          const TKV* __restrict__ v,
                          const int* __restrict__ lengths,
                          float* __restrict__ part_acc,
                          float* __restrict__ part_m,
                          float* __restrict__ part_l, int S, int H, int G,
                          int GT, int D, int NC, float scale, int window,
                          float cap, float inv_cap, Q rnd) {
    constexpr int DM = 32 * DL, NP = DL / 4;
    extern __shared__ float4 fd_smem[];
    FdSmem<DM>& sm = *reinterpret_cast<FdSmem<DM>*>(fd_smem);
    const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int len = lengths[b];
    const bool empty = len <= 0;
    const int t0 = c * kFdChunk;
    const int n = fd_attended(len, S);
    const int lo = fd_first(len, n, window);
    // past the lane's length, or wholly below its window
    if (t0 >= n || t0 + kFdChunk <= lo) return;
    const int tc = min(kFdChunk, n - t0);    // positions of this chunk
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int r0 = warp * kFdRows;           // the warp's rows
    const int nr = max(0, min(kFdRows, tc - r0));
    const int jlo = min(nr, max(0, lo - t0 - r0));  // rows below the window
    const int d0 = 4 * lane;
    // the lane's parts within D
    auto has_d = [&](int pt) { return kFdPart * pt + d0 < D; };

    // the warp's k rows (group 0) and v rows (group 1): lane l copies its
    // parts d0.. and 128 + d0..
    const size_t row0 = ((size_t)b * S + t0 + r0) * H + h;
#pragma unroll
    for (int pt = 0; pt < NP; ++pt) {
        const int d = kFdPart * pt + d0;
        if (has_d(pt) && !empty) {
            fd_rows<V>(sm.k, k, row0, r0, jlo, nr, H, d, d, D);
        }
    }
    cp_async_commit();
#pragma unroll
    for (int pt = 0; pt < NP; ++pt) {
        const int d = kFdPart * pt + d0;
        if (has_d(pt)) {
            fd_rows<V>(sm.v, v, row0, r0, jlo, nr, H, d, d, D);
        }
    }
    cp_async_commit();

    // q, rounded, zero past GT and D
    const TQ* qb = q + (size_t)(b * H + h) * G * D;
    for (int e = threadIdx.x; e < kFdGMax * DM; e += kFdThreads) {
        const int g = e / DM, d = e % DM;
        sm.q[g][d] = g < GT && d < D ? rnd(to_f32(qb[g * D + d])) : 0.0f;
    }
    __syncthreads();

    // scores of the warp's rows; lane l ends with head hl's
    const int hl = lane / 4, i4 = lane % 4;
    if (!empty) {
        float4 qr[NP][kFdGMax];   // slot j: head j ^ hl
#pragma unroll
        for (int pt = 0; pt < NP; ++pt) {
#pragma unroll
            for (int j = 0; j < kFdGMax; ++j) {
                qr[pt][j] = *reinterpret_cast<const float4*>(
                    &sm.q[j ^ hl][kFdPart * pt + d0]);
            }
        }
        cp_async_wait<1>();
        if (i4 == 0 && hl < GT) {
            for (int j = 0; j < jlo; ++j) sm.s[hl][r0 + j] = kFdNeg;
        }
        for (int j = jlo; j < nr; ++j) {
            float x[kFdGMax];
#pragma unroll
            for (int pt = 0; pt < NP; ++pt) {
                const float4 kk =
                    has_d(pt)
                        ? fd_load_round(&sm.k[r0 + j][kFdPart * pt + d0], rnd)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
                for (int g = 0; g < kFdGMax; ++g) {
                    const float4 qq = qr[pt][g];
                    const float a = pt == 0 ? qq.x * kk.x
                                            : fmaf(qq.x, kk.x, x[g]);
                    x[g] = fmaf(qq.w, kk.w,
                                fmaf(qq.z, kk.z, fmaf(qq.y, kk.y, a)));
                }
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
            if (i4 == 0 && hl < GT) {
                sm.s[hl][r0 + j] = fd_score(x[0], scale, cap, inv_cap);
            }
        }
    } else if (i4 == 0 && hl < GT) {
        for (int j = 0; j < nr; ++j) sm.s[hl][r0 + j] = kFdNeg;
    }
    __syncthreads();

    // the chunk's max of head hl (-1e30 at least, as the reference clamps):
    // each of its 4 lanes takes a quarter of the chunk
    float mx = kFdNeg;
    if (hl < GT) {
        const int e = min(kFdChunk / 4 * (i4 + 1), tc);
        for (int i = kFdChunk / 4 * i4; i < e; ++i) {
            mx = fmaxf(mx, sm.s[hl][i]);
        }
    }
    mx = fmaxf(mx, __shfl_xor_sync(kFdFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFdFull, mx, 2));

    // p of the warp's rows (0 for heads past GT), then the warp's sum of
    // head hl's p in order
#pragma unroll
    for (int j = i4; j < kFdRows; j += 4) {
        if (j < nr) {
            sm.p[r0 + j][hl] = hl < GT ? expf(sm.s[hl][r0 + j] - mx) : 0.0f;
        }
    }
    __syncwarp();
    if (i4 == 0 && nr > 0) {
        float l = sm.p[r0][hl];
        for (int j = 1; j < nr; ++j) l += sm.p[r0 + j][hl];
        sm.l[warp][hl] = l;
        if (warp == 0) sm.m[hl] = mx;
    }

    // P·V over the warp's rows in order: lane l owns its parts of every head
    float acc[kFdGMax][DL];
#pragma unroll
    for (int g = 0; g < kFdGMax; ++g) {
#pragma unroll
        for (int i = 0; i < DL; ++i) acc[g][i] = 0.0f;
    }
    cp_async_wait<0>();
    for (int j = jlo; j < nr; ++j) {
        const float4 pa = *reinterpret_cast<const float4*>(&sm.p[r0 + j][0]);
        const float4 pb = *reinterpret_cast<const float4*>(&sm.p[r0 + j][4]);
        const float pg[kFdGMax] = {pa.x, pa.y, pa.z, pa.w,
                                   pb.x, pb.y, pb.z, pb.w};
#pragma unroll
        for (int pt = 0; pt < NP; ++pt) {
            const float4 vv =
                has_d(pt)
                    ? fd_load_round(&sm.v[r0 + j][kFdPart * pt + d0], rnd)
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
            for (int g = 0; g < kFdGMax; ++g) {
                acc[g][4 * pt] = fmaf(pg[g], vv.x, acc[g][4 * pt]);
                acc[g][4 * pt + 1] = fmaf(pg[g], vv.y, acc[g][4 * pt + 1]);
                acc[g][4 * pt + 2] = fmaf(pg[g], vv.z, acc[g][4 * pt + 2]);
                acc[g][4 * pt + 3] = fmaf(pg[g], vv.w, acc[g][4 * pt + 3]);
            }
        }
    }
    // into the warp's own k rows (row r0 + g: head g), read by every warp
    if (nr > 0) {
#pragma unroll
        for (int pt = 0; pt < NP; ++pt) {
            if (!has_d(pt)) continue;
#pragma unroll
            for (int g = 0; g < kFdGMax; ++g) {
                if (g < GT) {
                    *reinterpret_cast<float4*>(
                        &sm.k[r0 + g][kFdPart * pt + d0]) =
                        make_float4(acc[g][4 * pt], acc[g][4 * pt + 1],
                                    acc[g][4 * pt + 2], acc[g][4 * pt + 3]);
                }
            }
        }
    }
    __syncthreads();

    // the chunk's partial: warp g adds head g's sums in warp order
    const int nw = (tc + kFdRows - 1) / kFdRows;
    const int g = warp;
    if (g < GT) {
        const size_t prow = ((size_t)(b * H + h) * G + g) * NC + c;
#pragma unroll
        for (int pt = 0; pt < NP; ++pt) {
            if (!has_d(pt)) continue;
            const int d = kFdPart * pt + d0;
            float4 a = *reinterpret_cast<const float4*>(&sm.k[g][d]);
            for (int w = 1; w < nw; ++w) {
                const float* row = &sm.k[w * kFdRows + g][d];
                const float4 t = *reinterpret_cast<const float4*>(row);
                a.x += t.x;
                a.y += t.y;
                a.z += t.z;
                a.w += t.w;
            }
            float* dst = part_acc + prow * D + d;
            if constexpr (V) {
                *reinterpret_cast<float4*>(dst) = a;
            } else {
                const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    if (d + i < D) dst[i] = av[i];
                }
            }
        }
        if (lane == 0) {
            float l = sm.l[0][g];
            for (int w = 1; w < nw; ++w) l += sm.l[w][g];
            part_l[prow] = l;
            part_m[prow] = sm.m[g];
        }
    }
}

// The wide instance, D > 256: the layout of the D <= 256 instance (two
// 4-element parts a lane) over one slice of 256 dims at a time. Scores: for
// each slice in order, the slice's k rows and q, the 8-element fmaf chain
// and the butterfly, added to the sums of the slices before it. P.V: for
// each slice in order, its v rows, the chain over the warp's rows and the
// sum over the warps in warp order, written to the slice's dims of the
// partial. v's first slice is copied while the scores run. Arguments as
// flash_decode_chunk_kernel's.
template <class Q, bool V>
__global__ void __launch_bounds__(kFdThreads, 1)
flash_decode_chunk_wide_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const int* __restrict__ lengths,
                               float* __restrict__ part_acc,
                               float* __restrict__ part_m,
                               float* __restrict__ part_l, int S, int H,
                               int G, int GT, int D, int NC, float scale,
                               int window, float cap, float inv_cap, Q rnd) {
    constexpr int DM = 2 * kFdPart, NP = 2;
    extern __shared__ float4 fd_smem[];
    FdSmem<DM>& sm = *reinterpret_cast<FdSmem<DM>*>(fd_smem);
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
    const int nr = max(0, min(kFdRows, tc - r0));
    const int jlo = min(nr, max(0, lo - t0 - r0));
    const int d0 = 4 * lane;
    const int hl = lane / 4, i4 = lane % 4;
    const int NS = (D + DM - 1) / DM;
    const size_t row0 = ((size_t)b * S + t0 + r0) * H + h;
    const float* qb = q + (size_t)(b * H + h) * G * D;

    // the warp's attended rows of one slice of k or v, as one group
    auto copy_rows = [&](float (*dst)[DM], const float* src, int ds) {
#pragma unroll
        for (int pt = 0; pt < NP; ++pt) {
            const int d = ds + kFdPart * pt + d0;
            if (d < D) {
                for (int j = jlo; j < nr; ++j) {
                    fd_copy_part<V>(&dst[r0 + j][kFdPart * pt + d0],
                                    src + (row0 + (size_t)j * H) * D + d, d,
                                    D);
                }
            }
        }
        cp_async_commit();
    };
    if (!empty) {
        copy_rows(sm.k, k, 0);
    } else {
        cp_async_commit();
    }
    copy_rows(sm.v, v, 0);

    for (int sl = 0; sl < NS; ++sl) {
        const int ds = sl * DM;
        if (sl > 0) {
            __syncthreads();           // every warp is done with the last q
            if (!empty) copy_rows(sm.k, k, ds);
        }
        for (int e = threadIdx.x; e < kFdGMax * DM; e += kFdThreads) {
            const int g = e / DM, d = e % DM;
            sm.q[g][d] = g < GT && ds + d < D ? rnd(qb[g * D + ds + d])
                                              : 0.0f;
        }
        __syncthreads();
        if (empty) continue;
        float4 qr[NP][kFdGMax];   // slot j: head j ^ hl
#pragma unroll
        for (int pt = 0; pt < NP; ++pt) {
#pragma unroll
            for (int j = 0; j < kFdGMax; ++j) {
                qr[pt][j] = *reinterpret_cast<const float4*>(
                    &sm.q[j ^ hl][kFdPart * pt + d0]);
            }
        }
        if (sl == 0) {
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        for (int j = jlo; j < nr; ++j) {
            float x[kFdGMax];
#pragma unroll
            for (int pt = 0; pt < NP; ++pt) {
                const float4 kk =
                    ds + kFdPart * pt + d0 < D
                        ? fd_load_round(&sm.k[r0 + j][kFdPart * pt + d0], rnd)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
                for (int g = 0; g < kFdGMax; ++g) {
                    const float4 qq = qr[pt][g];
                    const float a = pt == 0 ? qq.x * kk.x
                                            : fmaf(qq.x, kk.x, x[g]);
                    x[g] = fmaf(qq.w, kk.w,
                                fmaf(qq.z, kk.z, fmaf(qq.y, kk.y, a)));
                }
            }
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
            if (i4 == 0 && hl < GT) {
                sm.s[hl][r0 + j] = sl == 0 ? x[0] : sm.s[hl][r0 + j] + x[0];
            }
        }
    }
    // the summed dot products become scores (each written and read by the
    // same thread)
    if (i4 == 0 && hl < GT) {
        for (int j = 0; j < nr; ++j) {
            sm.s[hl][r0 + j] =
                empty || j < jlo
                    ? kFdNeg
                    : fd_score(sm.s[hl][r0 + j], scale, cap, inv_cap);
        }
    }
    __syncthreads();

    // the chunk's max, p and the warp's sum of p, as the D <= 256 instance
    float mx = kFdNeg;
    if (hl < GT) {
        const int e = min(kFdChunk / 4 * (i4 + 1), tc);
        for (int i = kFdChunk / 4 * i4; i < e; ++i) {
            mx = fmaxf(mx, sm.s[hl][i]);
        }
    }
    mx = fmaxf(mx, __shfl_xor_sync(kFdFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFdFull, mx, 2));
#pragma unroll
    for (int j = i4; j < kFdRows; j += 4) {
        if (j < nr) {
            sm.p[r0 + j][hl] = hl < GT ? expf(sm.s[hl][r0 + j] - mx) : 0.0f;
        }
    }
    __syncwarp();
    if (i4 == 0 && nr > 0) {
        float l = sm.p[r0][hl];
        for (int j = 1; j < nr; ++j) l += sm.p[r0 + j][hl];
        sm.l[warp][hl] = l;
        if (warp == 0) sm.m[hl] = mx;
    }

    const int nw = (tc + kFdRows - 1) / kFdRows;
    const int g = warp;
    const size_t prow = ((size_t)(b * H + h) * G + g) * NC + c;
    for (int sl = 0; sl < NS; ++sl) {
        const int ds = sl * DM;
        if (sl > 0) {
            __syncthreads();           // every warp has read the last sums
            copy_rows(sm.v, v, ds);
        }
        float acc[kFdGMax][4 * NP];
#pragma unroll
        for (int gg = 0; gg < kFdGMax; ++gg) {
#pragma unroll
            for (int i = 0; i < 4 * NP; ++i) acc[gg][i] = 0.0f;
        }
        cp_async_wait<0>();
        for (int j = jlo; j < nr; ++j) {
            const float4 pa =
                *reinterpret_cast<const float4*>(&sm.p[r0 + j][0]);
            const float4 pb =
                *reinterpret_cast<const float4*>(&sm.p[r0 + j][4]);
            const float pg[kFdGMax] = {pa.x, pa.y, pa.z, pa.w,
                                       pb.x, pb.y, pb.z, pb.w};
#pragma unroll
            for (int pt = 0; pt < NP; ++pt) {
                const float4 vv =
                    ds + kFdPart * pt + d0 < D
                        ? fd_load_round(&sm.v[r0 + j][kFdPart * pt + d0], rnd)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
                for (int gg = 0; gg < kFdGMax; ++gg) {
                    acc[gg][4 * pt] = fmaf(pg[gg], vv.x, acc[gg][4 * pt]);
                    acc[gg][4 * pt + 1] =
                        fmaf(pg[gg], vv.y, acc[gg][4 * pt + 1]);
                    acc[gg][4 * pt + 2] =
                        fmaf(pg[gg], vv.z, acc[gg][4 * pt + 2]);
                    acc[gg][4 * pt + 3] =
                        fmaf(pg[gg], vv.w, acc[gg][4 * pt + 3]);
                }
            }
        }
        // into the warp's own k rows (row r0 + g: head g)
        if (nr > 0) {
#pragma unroll
            for (int pt = 0; pt < NP; ++pt) {
                if (ds + kFdPart * pt + d0 >= D) continue;
#pragma unroll
                for (int gg = 0; gg < kFdGMax; ++gg) {
                    if (gg < GT) {
                        *reinterpret_cast<float4*>(
                            &sm.k[r0 + gg][kFdPart * pt + d0]) =
                            make_float4(acc[gg][4 * pt], acc[gg][4 * pt + 1],
                                        acc[gg][4 * pt + 2],
                                        acc[gg][4 * pt + 3]);
                    }
                }
            }
        }
        __syncthreads();
        if (g < GT) {
#pragma unroll
            for (int pt = 0; pt < NP; ++pt) {
                const int d = ds + kFdPart * pt + d0;
                if (d >= D) continue;
                const int dl = kFdPart * pt + d0;
                float4 a = *reinterpret_cast<const float4*>(&sm.k[g][dl]);
                for (int w = 1; w < nw; ++w) {
                    const float4 t = *reinterpret_cast<const float4*>(
                        &sm.k[w * kFdRows + g][dl]);
                    a.x += t.x;
                    a.y += t.y;
                    a.z += t.z;
                    a.w += t.w;
                }
                float* dst = part_acc + prow * D + d;
                if constexpr (V) {
                    *reinterpret_cast<float4*>(dst) = a;
                } else {
                    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        if (d + i < D) dst[i] = av[i];
                    }
                }
            }
        }
    }
    if (g < GT && lane == 0) {
        float l = sm.l[0][g];
        for (int w = 1; w < nw; ++w) l += sm.l[w][g];
        part_l[prow] = l;
        part_m[prow] = sm.m[g];
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

// One block of DM threads per (head, kv head, batch), thread d: folds the
// lane's chunk partials in chunk order, from the chunk that holds the
// window's first position (WIN; chunk 0 otherwise, whose partial then
// loads while the lane's length does), and writes rnd(acc / l). WIDE: D in
// slices of DM, one block a slice, blockIdx.x = slice * G + head. The next
// group's loads are in flight while a group folds.
template <class Q, int DM, bool WIN, bool WIDE, class TO = float>
__global__ void __launch_bounds__(DM)
flash_decode_combine_kernel(const float* __restrict__ part_acc,
                            const float* __restrict__ part_m,
                            const float* __restrict__ part_l,
                            const int* __restrict__ lengths,
                            TO* __restrict__ out, int S, int H, int G,
                            int D, int NC, int window, Q rnd) {
    const int g = WIDE ? blockIdx.x % G : blockIdx.x;
    const int h = blockIdx.y, b = blockIdx.z;
    const int d = WIDE ? blockIdx.x / G * DM + threadIdx.x : threadIdx.x;
    const int lane = threadIdx.x % 32;
    const bool has_d = d < D;
    const int len = lengths[b];
    const int n = fd_attended(len, S);
    const int nc = fd_chunks(n);
    const int c_lo = WIN ? fd_first(len, n, window) / kFdChunk : 0;
    const size_t head = (size_t)(b * H + h) * G + g;
    const float* pm = part_m + head * NC;
    const float* pl = part_l + head * NC;
    const float* ap = part_acc + head * NC * D + d;
    float m = pm[c_lo], l = pl[c_lo];
    float acc = has_d ? ap[(size_t)c_lo * D] : 0.0f;
    FdGroup cur;
    fd_load_group(cur, ap, pm, pl, c_lo + 1, nc, D, has_d, lane);
    for (int c0 = c_lo + 1; c0 < nc; c0 += 32) {
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
    if (has_d) store_rn(out + head * D + d, rnd(__fdiv_rn(acc, l)));
}

template <class Q, int DL, bool V, bool WIDE, class TQ, class TKV>
constexpr auto flash_decode_chunk_select() {
    if constexpr (WIDE) {
        return flash_decode_chunk_wide_kernel<Q, V>;
    } else {
        return flash_decode_chunk_kernel<Q, DL, V, TQ, TKV>;
    }
}

// Both kernels of one instance: the chunk kernel (the wide one where
// WIDE) once a tile of 8 heads, then the combine over all G and every
// slice of 32 * DL dims.
template <class Q, int DL, bool V, bool WIDE, class TQ = float,
          class TKV = float>
cudaError_t fd_launch(const TQ* q, const TKV* k, const TKV* v,
                      const int* lengths, TQ* out, float* acc, float* m,
                      float* l, int B, int S, int H, int G, int D, int NC,
                      float scale, int window, float cap, float inv_cap,
                      const Q& rnd, cudaStream_t s) {
    constexpr int DM = 32 * DL;
    constexpr int smem = sizeof(FdSmem<DM>);
    static_assert(!WIDE || (std::is_same<TQ, float>::value &&
                            std::is_same<TKV, float>::value),
                  "the wide instance reads f32 only");
    constexpr auto chunk = flash_decode_chunk_select<Q, DL, V, WIDE, TQ, TKV>();
    static const cudaError_t attr = allow_smem(chunk, smem);
    if (attr != cudaSuccess) return attr;
    for (int g0 = 0; g0 < G; g0 += kFdGMax) {
        const int gt = min(kFdGMax, G - g0);
        const size_t r = (size_t)g0 * NC;   // the tile's first partial row
        chunk<<<dim3(NC, H, B), kFdThreads, smem, s>>>(
            q + (size_t)g0 * D, k, v, lengths, acc + r * D, m + r, l + r, S,
            H, G, gt, D, NC, scale, window, cap, inv_cap, rnd);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return e;
    }
    const dim3 grid(G * ((D + DM - 1) / DM), H, B);
    if (window > 0) {
        flash_decode_combine_kernel<Q, DM, true, WIDE, TQ>
            <<<grid, DM, 0, s>>>(acc, m, l, lengths, out, S, H, G, D, NC,
                                 window, rnd);
    } else {
        flash_decode_combine_kernel<Q, DM, false, WIDE, TQ>
            <<<grid, DM, 0, s>>>(acc, m, l, lengths, out, S, H, G, D, NC,
                                 window, rnd);
    }
    return cudaGetLastError();
}

// q [B, H, G, D], k/v [B, S, H, D], lengths int32 [B], out like q: f32,
// contiguous, on the device; G >= 1, D >= 1; partials: B·H·G·chunks·
// (D + 2) floats, 16-byte aligned, for acc [rows][D], then m [rows], then
// l [rows], rows = B·H·G·chunks (the wrappers allocate and check); window
// (0: none) and cap (0: none; inv_cap = f32(1 / cap)) as above. Launches
// the chunk kernel once a tile of 8 heads, then the combine, on
// ``stream``; returns cudaGetLastError().
template <class Q>
cudaError_t flash_decode(const void* q, const void* k, const void* v,
                         const void* lengths, void* out, void* partials,
                         int B, int S, int H, int G, int D, float scale,
                         int window, float cap, float inv_cap, Q rnd,
                         void* stream) {
    if (G < 1 || D < 1 || window < 0) return cudaErrorInvalidValue;
    const auto s = static_cast<cudaStream_t>(stream);
    const int NC = fd_chunks(S);
    const size_t rows = (size_t)B * H * G * NC;
    float* acc = static_cast<float*>(partials);
    float* m = acc + rows * D;
    float* l = m + rows;
    const auto* qp = static_cast<const float*>(q);
    const auto* kp = static_cast<const float*>(k);
    const auto* vp = static_cast<const float*>(v);
    const auto* lp = static_cast<const int*>(lengths);
    auto* op = static_cast<float*>(out);
    const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0
                     && reinterpret_cast<uintptr_t>(v) % 16 == 0;
#define FD_LAUNCH(DL, V, WIDE)                                            \
    fd_launch<Q, DL, V, WIDE>(qp, kp, vp, lp, op, acc, m, l, B, S, H, G, D, \
                              NC, scale, window, cap, inv_cap, rnd, s)
    if (D <= kFdPart) {
        return vec ? FD_LAUNCH(4, true, false) : FD_LAUNCH(4, false, false);
    }
    if (D <= 2 * kFdPart) {
        return vec ? FD_LAUNCH(8, true, false) : FD_LAUNCH(8, false, false);
    }
    return vec ? FD_LAUNCH(8, true, true) : FD_LAUNCH(8, false, true);
#undef FD_LAUNCH
}

}  // namespace

namespace {

// The instance of one q type TQ (out of the same type) for the cache's
// type code tkv. Returns cudaErrorInvalidValue for a code it lacks.
template <class Q, class TQ>
cudaError_t flash_decode_narrow_q(const void* q, const void* k,
                                  const void* v, const int* lp, void* out,
                                  float* acc, float* m, float* l, int B,
                                  int S, int H, int G, int D, int NC,
                                  float scale, int window, float cap,
                                  float inv_cap, int tkv, const Q& rnd,
                                  cudaStream_t s) {
    const auto* qp = static_cast<const TQ*>(q);
    auto* op = static_cast<TQ*>(out);
    const size_t ek = tkv == kF32 ? 4 : (tkv == kBF16 ? 2 : 1);
    const bool vec = D % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(k) % (4 * ek) == 0 &&
                     reinterpret_cast<uintptr_t>(v) % (4 * ek) == 0 &&
                     (tkv != kF32 || (reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                                      reinterpret_cast<uintptr_t>(v) % 16 == 0));
#define FD_NARROW(TKV, DL, V)                                                \
    fd_launch<Q, DL, V, false, TQ, TKV>(                                     \
        qp, static_cast<const TKV*>(k), static_cast<const TKV*>(v), lp, op,   \
        acc, m, l, B, S, H, G, D, NC, scale, window, cap, inv_cap, rnd, s)
#define FD_NARROW_D(TKV)                                                     \
    (D <= kFdPart ? (vec ? FD_NARROW(TKV, 4, true) : FD_NARROW(TKV, 4, false)) \
                  : (vec ? FD_NARROW(TKV, 8, true) : FD_NARROW(TKV, 8, false)))
    if constexpr (!std::is_same<TQ, float>::value) {
        if (tkv == kF32) return FD_NARROW_D(float);
    }
    if (tkv == kBF16) return FD_NARROW_D(__nv_bfloat16);
    if (tkv == kE4M3) return FD_NARROW_D(__nv_fp8_e4m3);
    return cudaErrorInvalidValue;
#undef FD_NARROW_D
#undef FD_NARROW
}

// The narrow instances: q (and out) of type code tq, k and v of code tkv,
// any pair but f32 / f32 (flash_decode's): a bf16 q with an f32, bf16 or
// e4m3 cache (compute_dtype "bfloat16"), or an f32 q with a bf16 or e4m3
// cache (compute_dtype "float32" with a narrow cache_dtype); D <= 256.
// Arguments and partials as flash_decode's. Returns cudaErrorInvalidValue
// for anything else.
template <class Q>
cudaError_t flash_decode_narrow(const void* q, const void* k, const void* v,
                                const void* lengths, void* out,
                                void* partials, int B, int S, int H, int G,
                                int D, float scale, int window, float cap,
                                float inv_cap, int tq, int tkv, Q rnd,
                                void* stream) {
    if (G < 1 || D < 1 || D > 2 * kFdPart || window < 0) {
        return cudaErrorInvalidValue;
    }
    const auto s = static_cast<cudaStream_t>(stream);
    const int NC = fd_chunks(S);
    const size_t rows = (size_t)B * H * G * NC;
    float* acc = static_cast<float*>(partials);
    float* m = acc + rows * D;
    float* l = m + rows;
    const auto* lp = static_cast<const int*>(lengths);
    if (tq == kBF16) {
        return flash_decode_narrow_q<Q, __nv_bfloat16>(
            q, k, v, lp, out, acc, m, l, B, S, H, G, D, NC, scale, window,
            cap, inv_cap, tkv, rnd, s);
    }
    if (tq == kF32) {
        return flash_decode_narrow_q<Q, float>(
            q, k, v, lp, out, acc, m, l, B, S, H, G, D, NC, scale, window,
            cap, inv_cap, tkv, rnd, s);
    }
    return cudaErrorInvalidValue;
}

}  // namespace
