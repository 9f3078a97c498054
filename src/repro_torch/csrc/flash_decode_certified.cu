// flash_decode_certified: certificate-aware decode attention. q, k and v
// are rounded into a custom (k, emax, emin) format as they load, the
// softmax runs online in f32, and the output acc / l is rounded once into
// the format. Scores and probabilities are NOT rounded (as in the reference
// kernel).
//
// Replaces the Pallas TPU kernel _flash_decode_fmt_kernel of
// src/repro/kernels/flash_decode.py (wrapper flash_decode_certified). The
// format and lengths are runtime arguments (the TPU kernel got them by
// scalar prefetch).
//
// What bounds it on an H100: reading k and v up to lengths[b] once, at
// 3.35 TB/s (bytes). The attention body, its masking (a lane of length 0
// gives the mean of the rounded v over all S positions, rounded, as the
// reference does) and its design are in flash_decode.cuh, shared with
// flash_decode.cu.
#include "flash_decode.cuh"
#include "quantize_format.cuh"

namespace {

struct FormatRound {
    QFmt f;
    __device__ __forceinline__ float operator()(float v) const {
        return repro_quantize_to_format(v, f);
    }
};

}  // namespace

// q [B, H, G, D], k/v [B, S, H, D], lengths int32 [B], out like q: f32,
// contiguous, on the device; G <= 8, D <= 128. Returns cudaGetLastError()
// after the launch.
extern "C" int repro_flash_decode_certified_f32(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, int B, int S, int H, int G, int D, float scale, int kbits,
    int emax, int emin, int has_subnormals, int saturating, void* stream) {
    const FormatRound rnd{QFmt{kbits, emax, emin, has_subnormals, saturating}};
    return static_cast<int>(flash_decode(q, k, v, lengths, out, B, S, H, G, D,
                                         scale, rnd, stream));
}
