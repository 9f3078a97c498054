// flash_decode_certified: certificate-aware decode attention. q, k and v
// are rounded into a custom (k, emax, emin) format as they load, the
// softmax runs in f32, and the output acc / l is rounded once into the
// format. Scores and probabilities are NOT rounded (as in the reference
// kernel).
//
// Replaces the Pallas TPU kernel _flash_decode_fmt_kernel of
// src/repro/kernels/flash_decode.py (wrapper flash_decode_certified). The
// format and lengths are runtime arguments (the TPU kernel got them by
// scalar prefetch).
//
// What bounds it on an H100: reading k and v up to lengths[b] once, at
// 3.35 TB/s (bytes); the rounding, ~20 operations an element against 2
// FMAs, makes it issue-bound before that at a long cache. So the functor
// carries the format's constants, built once per launch on the host, and
// rounds without a branch (repro_quantize_to_format_t in
// quantize_format.cuh, bitwise the per-element form); whether the format
// has subnormals is a template parameter, one instantiation each. The
// attention body (split across the cache in chunks of 64 positions,
// combined in chunk order), its masking (a lane of length 0 gives the mean
// of the rounded v over all S positions, rounded, as the reference does)
// and its fixed summation order are in flash_decode.cuh, shared with
// flash_decode.cu.
#include "flash_decode.cuh"
#include "quantize_format.cuh"

namespace {

template <bool HS>
struct FormatRound {
    QFmtConsts c;
    __device__ __forceinline__ float operator()(float v) const {
        return repro_quantize_to_format_t<HS>(v, c);
    }
};

}  // namespace

// q [B, H, G, D], k/v [B, S, H, D], lengths int32 [B], out like q: f32,
// contiguous, on the device; G <= 8, D <= 128, D % 4 == 0; partials: the
// chunk partials' scratch (flash_decode.cuh). Returns cudaGetLastError()
// after the launches.
extern "C" int repro_flash_decode_certified_f32(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, void* partials, int B, int S, int H, int G, int D,
    float scale, int kbits, int emax, int emin, int has_subnormals,
    int saturating, void* stream) {
    const QFmtConsts c = repro_format_consts(
        QFmt{kbits, emax, emin, has_subnormals != 0, saturating});
    const cudaError_t rc =
        c.has_subnormals
            ? flash_decode(q, k, v, lengths, out, partials, B, S, H, G, D,
                           scale, FormatRound<true>{c}, stream)
            : flash_decode(q, k, v, lengths, out, partials, B, S, H, G, D,
                           scale, FormatRound<false>{c}, stream);
    return static_cast<int>(rc);
}
