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
// semantics call for it; see mx_fused.cu).
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
// from here (mx_fused.cu, mx_dw_gemm.cu, mx_quant.cu).
__device__ __forceinline__ int e8m0_exponent(float r, float inv_ln2) {
  r = fmaxf(ftz(r), 1.40129846e-45f);  // 2^-149
  float e = ceilf(__fsub_rn(__fmul_rn(logf(r), inv_ln2), 1e-6f));
  e = fminf(fmaxf(e, -127.f), 127.f);
  return static_cast<int>(e);
}

// One element's saturating fp8 payload against its group's effective
// scale d = ftz(ftz(2^e) * s), as quant_mx computes it (0 where d is 0).
__device__ __forceinline__ uint8_t mx_quant_value(float v, int e, float s,
                                                  float fmax, bool e5m2) {
  const float denom = ftz(ftz(exp2i(e)) * s);
  float qv = denom > 0.f ? v / denom : 0.f;
  qv = fminf(fmaxf(qv, -fmax), fmax);
  return float_to_fp8(qv, e5m2);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// The MX GEMM tile shared by mx_gemm and fused_quant_gemm.
//
// A block owns MT output rows and BN output columns and walks the whole
// K dimension (the loop that replaces the TPU kernel's sequential K grid
// axis).  The left operand (Qx·2^sexp, bf16-exact values held as f32) is
// staged in shared memory KC columns at a time by the caller; each of
// the 256 threads streams 4 weight bytes of one k-row per step (8
// threads cover the 32 columns of a k-row, 32 k-slices cover K), so the
// fp8 weights are read once, in 32-byte runs, and upcast in registers.
// Products of bf16 and fp8 values are exact in f32; sums are taken per
// k-slice, then across slices in a fixed order (deterministic).
// ---------------------------------------------------------------------------

namespace mxt {
constexpr int MT = 8;                 // output rows per block
constexpr int BN = 32;                // output columns per block
constexpr int THREADS = 256;
constexpr int CT = BN / 4;            // threads per k-row (4 columns each)
constexpr int KS = THREADS / CT;      // k-slices
constexpr int KC = 512;               // K columns staged per pass
constexpr int WARPS = THREADS / 32;
}  // namespace mxt

struct MxAcc {
  float v[mxt::MT][4];
};

__device__ __forceinline__ void load_w4(const uint8_t* __restrict__ wrow,
                                        int n0, int N, bool vec, bool e5m2,
                                        float w[4]) {
  if (vec) {
    uint32_t packed = *reinterpret_cast<const uint32_t*>(wrow + n0);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = fp8_to_float(static_cast<uint8_t>(packed >> (8 * j)), e5m2);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = (n0 + j < N) ? fp8_to_float(wrow[n0 + j], e5m2) : 0.f;
  }
}

// acc += xs[:, 0:kc] @ qw[k0:k0+kc, n0:n0+4] for this thread's k-slice.
__device__ __forceinline__ void mx_tile_accumulate(
    MxAcc& acc, const float (*xs)[mxt::KC], const uint8_t* __restrict__ qw,
    int k0, int kc, int n0, int N, bool vec, bool w_e5m2, int ks) {
#pragma unroll 4
  for (int kk = ks; kk < kc; kk += mxt::KS) {
    float w[4];
    load_w4(qw + static_cast<size_t>(k0 + kk) * N, n0, N, vec, w_e5m2, w);
#pragma unroll
    for (int m = 0; m < mxt::MT; ++m) {
      const float a = xs[m][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc.v[m][j] = fmaf(a, w[j], acc.v[m][j]);
    }
  }
}

// Sum the per-slice partials and write the (MT, BN) output tile.
__device__ __forceinline__ void mx_tile_store(
    MxAcc& acc, float (*red)[mxt::MT][mxt::BN], float* __restrict__ out,
    int m0, int M, int nb, int N) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int m = 0; m < mxt::MT; ++m) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = acc.v[m][j];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc.v[m][j] = v;
    }
  }
  if (lane < mxt::CT) {
#pragma unroll
    for (int m = 0; m < mxt::MT; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) red[warp][m][4 * lane + j] = acc.v[m][j];
  }
  __syncthreads();
  const int m = tid / mxt::BN, c = tid % mxt::BN;
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < mxt::WARPS; ++w) s += red[w][m][c];
  if (m0 + m < M && nb + c < N)
    out[static_cast<size_t>(m0 + m) * N + nb + c] = s;
}

// ---------------------------------------------------------------------------
// The fused quantizer's lane routine of fused_quant_gemm's M <= 32 kernel
// (mx_fused.cu).  (fused_quant_gemm at M > 32 and moe_gmm quantize with
// the mx_quant kernel; all quantizers share e8m0_exponent and
// mx_quant_value above, so that they cannot drift apart.)
// ---------------------------------------------------------------------------

// One lane's element of a 32-wide group (the warp is the group): the
// group's E8M0 exponent against s, the saturating cast, and the GEMM
// operand bf16(q * 2^e).  With `write`, lane 0 stores the exponent and
// every lane its payload byte.
__device__ __forceinline__ float quant_lane(float v, float s, float fmax,
                                            float inv_ln2, bool e5m2,
                                            bool write, uint8_t* q_at,
                                            int8_t* sexp_at) {
  const float amax = warp_max(fabsf(v));
  const int ei = e8m0_exponent(amax / fmax / s, inv_ln2);
  const uint8_t qb = mx_quant_value(v, ei, s, fmax, e5m2);
  if (write) {
    *q_at = qb;
    if ((threadIdx.x & 31) == 0) *sexp_at = static_cast<int8_t>(ei);
  }
  return bf16_round(fp8_to_float(qb, e5m2) * exp2i(ei));
}

__device__ __forceinline__ float load_x(const void* x, size_t at,
                                        bool x_bf16) {
  return x_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(x)[at])
                : static_cast<const float*>(x)[at];
}
