// The dW GEMM of the MOSS linear layer for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/mx_bwd.py:mx_dw_gemm_pallas.
//
//   dW[k, n] = sum_m requant_M(Qx * 2^sexp)[k, m] * Qg[m, n]
//
// qx (M, K) fp8 is the forward's residual payload with its E8M0
// exponents sexp (M, K/32) int8 (values in units of s_x); qg (M, N) fp8
// is the per-tensor-quantized gradient (E5M2).  requant_M re-quantizes
// the residual in 32-token groups along M (the contraction), with its
// level-1 scale pinned to s_x, so s_x cancels and never reaches the
// kernel.  Per (column k, 32-token group) it takes the amax of the
// dequantized values, e' = e8m0_exponent(amax / FP8_MAX) (common.cuh),
// q' = sat_fp8(v / d), d = ftz(2^e') (0 where d is 0), and the operand
// is bf16(q' * 2^e'):
// exactly the reference's `ref` branch (quant_mx of the transposed unit
// residual with global scale 1, then the MX GEMM), with the flushes of
// csrc/mx_fused.cu.  The result is the unscaled (K, N) f32 accumulation;
// the caller applies s_x * s_g.  With non-null qt / et the blocks of
// column tile 0 also write the requant payload q' (K, M) and e'
// (K, M/32) (a check of the requant on the card; the training path
// passes null).
//
// What bounds it on the H100: at training shapes (M = 2048 tokens, K
// and N in the thousands) the operations, 2 * M * K * N over the bf16
// tensor-core peak.  This first version runs on the CUDA cores.
//
// The simple design: one block of 256 threads per 128 x 128 output tile,
// walking M in 32-token steps, each exactly one requant group.  Per
// step a thread loads 16 residual bytes of one column (so it holds the
// column's values in registers for the amax, shared with the other half
// of the column through shared memory), requantizes them and stores the
// operand in shared memory; the gradient tile is upcast beside it.  Each
// thread then accumulates an 8 x 8 register tile (rows ty*4 + {0..3} and
// 64 + ty*4 + {0..3}, likewise for columns) in fixed order, so sums are
// deterministic.  M is a multiple of 32 (the caller pads); ragged K and
// N are masked here.
#include "common.cuh"

namespace dwt {
constexpr int BK = 128;               // output rows (K) per block
constexpr int BN = 128;               // output columns (N) per block
constexpr int MS = 32;                // tokens per step = one requant group
constexpr int THREADS = 256;
constexpr int HALF = THREADS / BK;    // threads per column (2)
constexpr int PER = MS / HALF;        // tokens per thread per step (16)
}  // namespace dwt

__global__ void __launch_bounds__(dwt::THREADS)
mx_dw_gemm_kernel(const uint8_t* __restrict__ qx, const int8_t* __restrict__ sexp,
                  const uint8_t* __restrict__ qg, float* __restrict__ out,
                  uint8_t* __restrict__ qt, int8_t* __restrict__ et,
                  int M, int N, int K, bool x_e5m2, bool g_e5m2,
                  bool e5m2, float fmax, float inv_ln2) {
  __shared__ __align__(16) float as[dwt::MS][dwt::BK];
  __shared__ __align__(16) float gs[dwt::MS][dwt::BN];
  __shared__ float red[dwt::HALF][dwt::BK];
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * dwt::BK, n0 = blockIdx.y * dwt::BN;
  const int c = tid % dwt::BK, half = tid / dwt::BK;
  const int kc = k0 + c;
  const bool col_ok = kc < K;
  const bool owner = qt != nullptr && blockIdx.y == 0 && col_ok;
  const int kg = K / 32;
  const int ty = tid / 16, tx = tid % 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int m0 = 0; m0 < M; m0 += dwt::MS) {
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

extern "C" int mx_dw_gemm_launch(const void* qx, const void* sexp,
                                 const void* qg, void* out, void* qt,
                                 void* et, int M, int N, int K, int x_e5m2,
                                 int g_e5m2, int e5m2, float fmax,
                                 float inv_ln2, void* stream) {
  dim3 grid((K + dwt::BK - 1) / dwt::BK, (N + dwt::BN - 1) / dwt::BN);
  mx_dw_gemm_kernel<<<grid, dwt::THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(qx), static_cast<const int8_t*>(sexp),
      static_cast<const uint8_t*>(qg), static_cast<float*>(out),
      static_cast<uint8_t*>(qt), static_cast<int8_t*>(et), M, N, K,
      x_e5m2 != 0, g_e5m2 != 0, e5m2 != 0, fmax, inv_ln2);
  return static_cast<int>(cudaGetLastError());
}
