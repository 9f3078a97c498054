// flash_decode_certified's narrow instances: certificate-aware decode
// attention for a bf16 q with an f32, bf16 or e4m3 cache (kernel 2 under
// ServeConfig's compute_dtype "bfloat16" and cache_dtype "bfloat16" /
// "fp8"; the batching engine's cache stays f32), or an f32 q with a bf16 or
// e4m3 cache (compute_dtype "float32" with a narrow cache_dtype), the
// output written in q's dtype. Also kernel 4's f32 instance on a narrow
// cache (repro_flash_decode_narrow: an f32 q with a bf16 or e4m3 cache,
// with its window, softcap and scale), which flash_decode.cu's NoRound
// functor gives on f32 caches.
//
// Replaces the Pallas TPU kernels _flash_decode_fmt_kernel and
// _flash_decode_kernel of src/repro/kernels/flash_decode.py (wrappers
// flash_decode_certified and flash_decode_attention) on bf16 and e4m3
// operands, which they read with astype(f32) inside and whose output they
// write in q's dtype. The body is flash_decode.cuh's, bit for bit the f32
// instance of flash_decode_certified.cu (flash_decode.cu) on the upcast
// operands followed by the cast; what bounds it is there too (a narrow
// cache reads half or a quarter of the bytes). D <= 256. A library of its
// own, built at first use.
#include "flash_decode.cuh"
#include "quantize_format.cuh"

namespace {

struct NoRound {
    __device__ __forceinline__ float operator()(float v) const { return v; }
};

template <bool HS>
struct FormatRound {
    QFmtConsts c;
    __device__ __forceinline__ float operator()(float v) const {
        return repro_quantize_to_format_t<HS>(v, c);
    }
};

}  // namespace

// q [B, H, G, D] and out like it of type code tq (0 f32, 1 bf16), k/v [B,
// S, H, D] of code tkv (0 f32, 1 bf16, 2 e4m3; not f32 with an f32 q),
// lengths int32 [B]: contiguous, on the device; G >= 1, 1 <= D <= 256;
// partials as flash_decode.cuh's.
// Returns cudaGetLastError() after the launches.
extern "C" int repro_flash_decode_certified_narrow(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, void* partials, int B, int S, int H, int G, int D,
    float scale, int kbits, int emax, int emin, int has_subnormals,
    int saturating, int tq, int tkv, void* stream) {
    const QFmtConsts c = repro_format_consts(
        QFmt{kbits, emax, emin, has_subnormals != 0, saturating});
    const cudaError_t rc =
        c.has_subnormals
            ? flash_decode_narrow(q, k, v, lengths, out, partials, B, S, H,
                                  G, D, scale, 0, 0.0f, 0.0f, tq, tkv,
                                  FormatRound<true>{c}, stream)
            : flash_decode_narrow(q, k, v, lengths, out, partials, B, S, H,
                                  G, D, scale, 0, 0.0f, 0.0f, tq, tkv,
                                  FormatRound<false>{c}, stream);
    return static_cast<int>(rc);
}

// Kernel 4 on a narrow cache: q [B, H, G, D] and out like it in f32, k/v
// [B, S, H, D] of type code tkv (1 bf16, 2 e4m3), lengths int32 [B]:
// contiguous, on the device; G >= 1, 1 <= D <= 256; window, softcap and
// inv_cap as repro_flash_decode_f32's. Returns cudaGetLastError() after
// the launches.
extern "C" int repro_flash_decode_narrow(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, void* partials, int B, int S, int H, int G, int D,
    float scale, int window, float softcap, float inv_cap, int tkv,
    void* stream) {
    if (tkv == kF32) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(flash_decode_narrow(
        q, k, v, lengths, out, partials, B, S, H, G, D, scale, window,
        softcap, inv_cap, kF32, tkv, NoRound{}, stream));
}
