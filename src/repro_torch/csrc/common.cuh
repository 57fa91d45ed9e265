// Shared device helpers for the port's Hopper kernels.
//
// Build rule: no --use_fast_math, no -ftz=true.  The E8M0 scales reach
// 2^-127 (an f32 subnormal) and the quantizer's exponent uses logf and
// an IEEE division; flushing every denormal or approximating either would
// move payloads away from the reference.  Where the quantizer's semantics
// flush a subnormal, the kernel says so explicitly (ftz below).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

// fp8 byte (e4m3fn or e5m2) -> f32, exact.
__device__ __forceinline__ float fp8_to_float(uint8_t b, bool e5m2) {
  __half_raw h = __nv_cvt_fp8_to_halfraw(
      static_cast<__nv_fp8_storage_t>(b), e5m2 ? __NV_E5M2 : __NV_E4M3);
  return __half2float(__half(h));
}

// f32 -> fp8 byte, round to nearest even (the caller clamps first).
__device__ __forceinline__ uint8_t float_to_fp8(float v, bool e5m2) {
  return static_cast<uint8_t>(__nv_cvt_float_to_fp8(
      v, __NV_SATFINITE, e5m2 ? __NV_E5M2 : __NV_E4M3));
}

// 2^e for an E8M0 exponent in [-127, 127], built from the bit pattern
// so that 2^-127 (subnormal 0x00400000) is exact.
__device__ __forceinline__ float exp2i(int e) {
  return e > -127 ? __int_as_float((e + 127) << 23)
                  : __int_as_float(0x00400000);
}

// Flush an f32 subnormal to zero (explicitly, where the quantizer's
// semantics call for it: the plain version, repro_torch.core.quant, does
// the same, since the reference runs on XLA's CPU backend with denormals
// flushed; the build itself keeps them, so 2^-127 operands survive).
__device__ __forceinline__ float ftz(float v) {
  return fabsf(v) < 1.17549435e-38f ? 0.f : v;  // 2^-126
}

// The E8M0 exponent of a group whose scale ratio is r (its amax over
// FP8_MAX over the level-1 scale):
//     e = clip(ceil(log2(max(ftz(r), 2^-149)) - 1e-6), +-127)
// with log2(r) = logf(r) * f32(1 / log 2) (how the reference's jitted
// log2 computes), the product and the 1e-6 each rounded on their own
// (__fmul_rn, __fsub_rn): contracted into one FMA they move the ceil
// where log2(r) - 1e-6 lies within an ulp of an integer (~1 group in
// 300k of random data).  Every quantizer of the port takes its exponent
// from here (mx_quant.cu, mx_dw_gemm.cu).
__device__ __forceinline__ int e8m0_exponent(float r, float inv_ln2) {
  r = fmaxf(ftz(r), 1.40129846e-45f);  // 2^-149
  float e = ceilf(__fsub_rn(__fmul_rn(logf(r), inv_ln2), 1e-6f));
  e = fminf(fmaxf(e, -127.f), 127.f);
  return static_cast<int>(e);
}

// A group's effective scale d = ftz(ftz(2^e) * s), as quant_mx divides
// by it.
__device__ __forceinline__ float mx_denom(int e, float s) {
  return ftz(ftz(exp2i(e)) * s);
}

// One element's quotient v / d (an IEEE division; 0 where d is 0),
// clamped to +-FP8_MAX: what the fp8 cast then rounds.
__device__ __forceinline__ float mx_scaled(float v, float denom,
                                           float fmax) {
  const float qv = denom > 0.f ? v / denom : 0.f;
  return fminf(fmaxf(qv, -fmax), fmax);
}

// One element's saturating fp8 payload against its group's effective
// scale, as quant_mx computes it.
__device__ __forceinline__ uint8_t mx_quant_value(float v, int e, float s,
                                                  float fmax, bool e5m2) {
  return float_to_fp8(mx_scaled(v, mx_denom(e, s), fmax), e5m2);
}

// Two clamped quotients -> two fp8 bytes (a in the low byte) in one
// cvt.rn.satfinite.{e4m3,e5m2}x2.f32: the rounding of float_to_fp8,
// which converts one value with the same instruction.
template <bool E5M2>
__device__ __forceinline__ uint32_t float2_to_fp8x2(float a, float b) {
  return static_cast<uint32_t>(__nv_cvt_float2_to_fp8x2(
      make_float2(a, b), __NV_SATFINITE, E5M2 ? __NV_E5M2 : __NV_E4M3));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
