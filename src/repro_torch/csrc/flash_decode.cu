// flash_decode: uncertified decode attention. One query token per
// (batch, kv-head) group of G query heads attends to its KV cache [B,S,K,D]
// masked by lengths, through a softmax in f32 with scale D^-1/2 and acc / l
// by IEEE division; nothing is rounded.
//
// Replaces the Pallas TPU kernel _flash_decode_kernel of
// src/repro/kernels/flash_decode.py (wrapper flash_decode_attention). It is
// flash_decode_certified.cu with the rounding compiled out: the identity
// functor below.
//
// It also takes a sliding window and a softcap on the scores (Gemma-2's
// and Mixtral's decode, which the reference composes from einsums and a
// softmax: this kernel computes that composed f32 attention, so that a
// lane's bits depend on its own length only).
//
// What bounds it on an H100: reading k and v up to lengths[b] (within the
// window) once, at 3.35 TB/s (bytes). The attention body (split across the cache in chunks
// of 64 positions, combined in chunk order), its masking (a lane of length
// 0 gives the mean of v over all S positions, as the reference does) and
// its fixed summation order are in flash_decode.cuh.
#include "flash_decode.cuh"

namespace {

struct NoRound {
    __device__ __forceinline__ float operator()(float v) const { return v; }
};

}  // namespace

// q [B, H, G, D], k/v [B, S, H, D], lengths int32 [B], out like q: f32,
// contiguous, on the device; G >= 1, D >= 1; partials: the chunk
// partials' scratch (flash_decode.cuh); window: a sliding window (0:
// none), softcap: the scores' cap (0: none), inv_cap = f32(1 / softcap).
// Returns cudaGetLastError() after the launches.
extern "C" int repro_flash_decode_f32(const void* q, const void* k,
                                      const void* v, const void* lengths,
                                      void* out, void* partials, int B, int S,
                                      int H, int G, int D, float scale,
                                      int window, float softcap,
                                      float inv_cap, void* stream) {
    return static_cast<int>(flash_decode(q, k, v, lengths, out, partials, B,
                                         S, H, G, D, scale, window, softcap,
                                         inv_cap, NoRound{}, stream));
}
