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

// ---------------------------------------------------------------------------
// The dW tile, shared by mx_dw_gemm (mx_dw_gemm.cu) and the grouped-expert
// moe_dw_gemm (moe_gmm.cu).
// ---------------------------------------------------------------------------

namespace dwt {
constexpr int BK = 128;               // output rows (K) per block
constexpr int BN = 128;               // output columns (N) per block
constexpr int MS = 32;                // tokens per step = one requant group
constexpr int THREADS = 256;
constexpr int HALF = THREADS / BK;    // threads per column (2)
constexpr int PER = MS / HALF;        // tokens per thread per step (16)
}  // namespace dwt

// One BK x BN tile (output rows [k0, k0 + BK), columns [n0, n0 + BN)) of
//   dW[k, n] = sum_{m < m_end} requant_M(Qx * 2^sexp)[k, m] * Qg[m, n]
// over a residual of M rows: qx (M, K) fp8, sexp (M, K/32), qg (M, N) fp8,
// m_end a multiple of 32 (<= M).  The block walks the tokens in 32-token
// steps, each exactly one requant group: per step a thread loads 16
// residual bytes of one column (so it holds the column's values in
// registers for the amax, shared with the other half of the column
// through shared memory), requantizes them and stores the operand in
// shared memory; the gradient tile is upcast beside it; each thread then
// accumulates an 8 x 8 register tile in fixed order.  With
// `write_payload` (and qt / et non-null) the tile writes the requant
// payload q' (K, M) and e' (K, M/32) of its columns for the steps it
// takes.  Ragged K and N are masked.
__device__ __forceinline__ void dw_tile(
    const uint8_t* __restrict__ qx, const int8_t* __restrict__ sexp,
    const uint8_t* __restrict__ qg, float* __restrict__ out,
    uint8_t* __restrict__ qt, int8_t* __restrict__ et, int M, int m_end,
    int N, int K, int k0, int n0, bool x_e5m2, bool g_e5m2, bool e5m2,
    float fmax, float inv_ln2, bool write_payload) {
  __shared__ __align__(16) float as[dwt::MS][dwt::BK];
  __shared__ __align__(16) float gs[dwt::MS][dwt::BN];
  __shared__ float red[dwt::HALF][dwt::BK];
  const int tid = threadIdx.x;
  const int c = tid % dwt::BK, half = tid / dwt::BK;
  const int kc = k0 + c;
  const bool col_ok = kc < K;
  const bool owner = write_payload && qt != nullptr && col_ok;
  const int kg = K / 32;
  const int ty = tid / 16, tx = tid % 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int m0 = 0; m0 < m_end; m0 += dwt::MS) {
    // 1. this thread's 16 tokens of column kc, dequantized (units of s_x)
    float v[dwt::PER];
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < dwt::PER; ++i) {
      const int m = m0 + half + dwt::HALF * i;
      v[i] = 0.f;
      if (col_ok) {
        const size_t at = static_cast<size_t>(m) * K + kc;
        v[i] = fp8_to_float(qx[at], x_e5m2) *
               exp2i(sexp[static_cast<size_t>(m) * kg + kc / 32]);
      }
      amax = fmaxf(amax, fabsf(v[i]));
    }
    red[half][c] = amax;
    __syncthreads();      // also: the previous step's reads of as/gs are done
    amax = fmaxf(red[0][c], red[1][c]);
    // 2. the requant of the column's 32-token group
    const int ei = e8m0_exponent(amax / fmax, inv_ln2);
#pragma unroll
    for (int i = 0; i < dwt::PER; ++i) {
      const int ml = half + dwt::HALF * i;
      const uint8_t qb = mx_quant_value(v[i], ei, 1.f, fmax, e5m2);
      as[ml][c] = bf16_round(fp8_to_float(qb, e5m2) * exp2i(ei));
      if (owner) qt[static_cast<size_t>(kc) * M + m0 + ml] = qb;
    }
    if (owner && half == 0)
      et[static_cast<size_t>(kc) * (M / 32) + m0 / 32] =
          static_cast<int8_t>(ei);
    // 3. the gradient tile, upcast (ragged N reads as 0)
    for (int i = tid; i < dwt::MS * dwt::BN; i += dwt::THREADS) {
      const int ml = i / dwt::BN, nl = i % dwt::BN;
      const int n = n0 + nl;
      gs[ml][nl] = n < N ? fp8_to_float(
                               qg[static_cast<size_t>(m0 + ml) * N + n], g_e5m2)
                         : 0.f;
    }
    __syncthreads();
    // 4. the 8 x 8 register tile over the 32 tokens
#pragma unroll 4
    for (int ml = 0; ml < dwt::MS; ++ml) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[ml][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[ml][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&gs[ml][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&gs[ml][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = k0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (n < N) out[static_cast<size_t>(k) * N + n] = acc[i][j];
    }
  }
}
