// flash_decode_certified: one query token per (batch, kv-head) group of G
// query heads attends to its KV cache; q, k and v are rounded into a custom
// (k, emax, emin) format as they load, the softmax runs online in f32, and
// the output acc / l is rounded once into the format. Scores and
// probabilities are NOT rounded (as in the reference kernel).
//
// Replaces the Pallas TPU kernel _flash_decode_fmt_kernel of
// src/repro/kernels/flash_decode.py (wrapper flash_decode_certified). The
// TPU kernel walked the cache in S-blocks along a sequential grid axis with
// the (m, l, acc) state in VMEM scratch; here one block per (b, kv-head)
// walks its cache in S-tiles in a loop and keeps the state in registers and
// shared memory. The format and lengths are runtime arguments.
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
#include "quantize_format.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;     // cached positions per tile (one per lane)
constexpr int kDMax = 128;    // head dim
constexpr int kGMax = 8;      // query heads per kv head (one warp each)
constexpr float kNeg = -1e30f;

__global__ void __launch_bounds__(kThreads)
flash_decode_certified_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const int* __restrict__ lengths,
                              float* __restrict__ out, int S, int H, int G,
                              int D, float scale, QFmt f) {
    __shared__ float qs[kGMax][kDMax];
    __shared__ float ks[kTile][kDMax + 1];   // padded: lanes read rows
    __shared__ float vs[kTile][kDMax];
    __shared__ float ps[kGMax][kTile];
    __shared__ float alpha_s[kGMax];
    __shared__ float l_s[kGMax];

    const int h = blockIdx.x, b = blockIdx.y;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int len = min(max(lengths[b], 0), S);

    const float* qb = q + (size_t)(b * H + h) * G * D;
    for (int i = tid; i < G * D; i += kThreads) {
        qs[i / D][i % D] = repro_quantize_to_format(qb[i], f);
    }

    // warp g owns the running max and sum of head g (replicated in lanes);
    // thread (d, g0) owns acc of heads g0, g0 + 2, g0 + 4, g0 + 6 at dim d
    float m_run = kNeg, l_run = 0.0f;
    const int d = tid % kDMax, g0 = tid / kDMax;
    float acc[kGMax / 2] = {0.0f, 0.0f, 0.0f, 0.0f};
    __syncthreads();

    for (int t0 = 0; t0 < len; t0 += kTile) {
        const int tc = min(kTile, len - t0);
        for (int i = tid; i < kTile * D; i += kThreads) {
            const int t = i / D, dd = i % D;
            float kv = 0.0f, vv = 0.0f;
            if (t < tc) {
                const size_t off = (((size_t)b * S + t0 + t) * H + h) * D + dd;
                kv = repro_quantize_to_format(k[off], f);
                vv = repro_quantize_to_format(v[off], f);
            }
            ks[t][dd] = kv;
            vs[t][dd] = vv;
        }
        __syncthreads();

        if (warp < G) {
            const int g = warp, t = lane;
            float s = kNeg;
            if (t < tc) {
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
            for (int j = 0; j < kGMax / 2; ++j) {
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
        for (int j = 0; j < kGMax / 2; ++j) {
            const int g = g0 + 2 * j;
            if (g < G) {
                out[((size_t)(b * H + h) * G + g) * D + d] =
                    repro_quantize_to_format(__fdiv_rn(acc[j], l_s[g]), f);
            }
        }
    }
}

}  // namespace

// q [B, H, G, D], k/v [B, S, H, D], lengths int32 [B] (each >= 1), out like
// q: f32, contiguous, on the device; G <= 8, D <= 128. Returns
// cudaGetLastError() after the launch.
extern "C" int repro_flash_decode_certified_f32(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, int B, int S, int H, int G, int D, float scale, int kbits,
    int emax, int emin, int has_subnormals, int saturating, void* stream) {
    const QFmt f{kbits, emax, emin, has_subnormals, saturating};
    flash_decode_certified_kernel<<<dim3(H, B), kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const int*>(lengths),
        static_cast<float*>(out), S, H, G, D, scale, f);
    return static_cast<int>(cudaGetLastError());
}
