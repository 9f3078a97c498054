// The decode-attention body of flash_decode_certified.cu and flash_decode.cu:
// one query token per (batch, kv-head) group of G query heads attends to
// its KV cache; q, k and v pass through a rounding functor as they load (a
// custom format, or the identity), the softmax runs online in f32 with scale
// D^-1/2, and the output acc / l passes through the functor once. Scores and
// probabilities are NOT rounded (as in the reference kernels).
//
// The TPU kernels walked the cache in S-blocks along a sequential grid axis
// with the (m, l, acc) state in VMEM scratch; here one block per
// (b, kv-head) walks its cache in 32-position tiles in a loop and keeps the
// state in registers and shared memory. Any S is taken (the Pallas kernels'
// S % block_s rule is a tiling rule, not part of the function).
//
// Masking follows the reference exactly: positions at or beyond lengths[b]
// score -1e30. A lane of length <= 0 therefore scores -1e30 everywhere, its
// running max stays -1e30, every weight is exp(0) = 1 and the output is the
// mean of (rounded) v over all S positions — the reference's result, with
// no host sync to find such lanes.
//
// What bounds it on an H100: reading k and v up to lengths[b] once (bytes,
// 3.35 TB/s); the operations are 4·G·D per cached position. This first
// design launches B·K blocks (16 at the serving shape), so it cannot fill
// the card's 132 SMs for a long cache. It uses no TMA, cp.async or wgmma;
// a split-S pass with a fixed combine order and TMA-fed tiles are the work
// of a later PR.
//
// Arithmetic: expf (not __expf), IEEE division for acc / l, no fast math.
// Dot products run over d = 0..D-1 and positions in order with fmaf.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kFdThreads = 256;
constexpr int kFdTile = 32;     // cached positions per tile (one per lane)
constexpr int kFdDMax = 128;    // head dim
constexpr int kFdGMax = 8;      // query heads per kv head (one warp each)
constexpr float kFdNeg = -1e30f;

template <class Q>
__global__ void __launch_bounds__(kFdThreads)
flash_decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const int* __restrict__ lengths, float* __restrict__ out,
                    int S, int H, int G, int D, float scale, Q rnd) {
    __shared__ float qs[kFdGMax][kFdDMax];
    __shared__ float ks[kFdTile][kFdDMax + 1];   // padded: lanes read rows
    __shared__ float vs[kFdTile][kFdDMax];
    __shared__ float ps[kFdGMax][kFdTile];
    __shared__ float alpha_s[kFdGMax];
    __shared__ float l_s[kFdGMax];

    const int h = blockIdx.x, b = blockIdx.y;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const bool empty = lengths[b] <= 0;    // every position masked
    const int len = empty ? S : min(lengths[b], S);

    const float* qb = q + (size_t)(b * H + h) * G * D;
    for (int i = tid; i < G * D; i += kFdThreads) {
        qs[i / D][i % D] = rnd(qb[i]);
    }

    // warp g owns the running max and sum of head g (replicated in lanes);
    // thread (d, g0) owns acc of heads g0, g0 + 2, g0 + 4, g0 + 6 at dim d
    float m_run = kFdNeg, l_run = 0.0f;
    const int d = tid % kFdDMax, g0 = tid / kFdDMax;
    float acc[kFdGMax / 2] = {0.0f, 0.0f, 0.0f, 0.0f};
    __syncthreads();

    for (int t0 = 0; t0 < len; t0 += kFdTile) {
        const int tc = min(kFdTile, len - t0);
        for (int i = tid; i < kFdTile * D; i += kFdThreads) {
            const int t = i / D, dd = i % D;
            float kv = 0.0f, vv = 0.0f;
            if (t < tc) {
                const size_t off = (((size_t)b * S + t0 + t) * H + h) * D + dd;
                kv = rnd(k[off]);
                vv = rnd(v[off]);
            }
            ks[t][dd] = kv;
            vs[t][dd] = vv;
        }
        __syncthreads();

        if (warp < G) {
            const int g = warp, t = lane;
            float s = kFdNeg;
            if (t < tc && !empty) {
                float dot = 0.0f;
                for (int dd = 0; dd < D; ++dd) {
                    dot = fmaf(qs[g][dd], ks[t][dd], dot);
                }
                s = dot * scale;
            }
            float tmax = s;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
                tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
            }
            const float m_new = fmaxf(m_run, tmax);
            const float alpha = expf(m_run - m_new);
            const float p = t < tc ? expf(s - m_new) : 0.0f;
            float psum = p;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
                psum += __shfl_xor_sync(0xffffffffu, psum, o);
            }
            l_run = alpha * l_run + psum;
            m_run = m_new;
            ps[g][t] = p;
            if (lane == 0) alpha_s[g] = alpha;
        }
        __syncthreads();

        if (d < D) {
#pragma unroll
            for (int j = 0; j < kFdGMax / 2; ++j) {
                const int g = g0 + 2 * j;
                if (g < G) {
                    float pv = 0.0f;
                    for (int t = 0; t < tc; ++t) {
                        pv = fmaf(ps[g][t], vs[t][d], pv);
                    }
                    acc[j] = alpha_s[g] * acc[j] + pv;
                }
            }
        }
        __syncthreads();
    }

    if (warp < G && lane == 0) l_s[warp] = l_run;
    __syncthreads();
    if (d < D) {
#pragma unroll
        for (int j = 0; j < kFdGMax / 2; ++j) {
            const int g = g0 + 2 * j;
            if (g < G) {
                out[((size_t)(b * H + h) * G + g) * D + d] =
                    rnd(__fdiv_rn(acc[j], l_s[g]));
            }
        }
    }
}

// q [B, H, G, D], k/v [B, S, H, D], lengths int32 [B], out like q: f32,
// contiguous, on the device; G <= 8, D <= 128 (the wrappers check).
// Launches on ``stream``; returns cudaGetLastError().
template <class Q>
cudaError_t flash_decode(const void* q, const void* k, const void* v,
                         const void* lengths, void* out, int B, int S, int H,
                         int G, int D, float scale, Q rnd, void* stream) {
    flash_decode_kernel<Q><<<dim3(H, B), kFdThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const int*>(lengths),
        static_cast<float*>(out), S, H, G, D, scale, rnd);
    return cudaGetLastError();
}

}  // namespace
