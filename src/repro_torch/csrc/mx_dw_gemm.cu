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
// The simple design (common.cuh: dw_tile, shared with moe_gmm.cu's
// grouped dW): one block of 256 threads per 128 x 128 output tile,
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

// The dW tile (common.cuh: dw_tile) over all M tokens.
__global__ void __launch_bounds__(dwt::THREADS)
mx_dw_gemm_kernel(const uint8_t* __restrict__ qx, const int8_t* __restrict__ sexp,
                  const uint8_t* __restrict__ qg, float* __restrict__ out,
                  uint8_t* __restrict__ qt, int8_t* __restrict__ et,
                  int M, int N, int K, bool x_e5m2, bool g_e5m2,
                  bool e5m2, float fmax, float inv_ln2) {
  dw_tile(qx, sexp, qg, out, qt, et, M, M, N, K, blockIdx.x * dwt::BK,
          blockIdx.y * dwt::BN, x_e5m2, g_e5m2, e5m2, fmax, inv_ln2,
          blockIdx.y == 0);
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
