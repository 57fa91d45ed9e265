// The dW GEMM of the MOSS linear layer for Hopper, and the requant pass
// that both dW GEMMs (this one and moe_gmm.cu's grouped dW) run first.
//
// Replaces the TPU kernel src/repro/kernels/mx_bwd.py:mx_dw_gemm_pallas
// (:104).
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
// is bf16(q' * 2^e'): exactly the reference's `ref` branch (quant_mx of
// the transposed unit residual with global scale 1, then the MX GEMM).
// The result is the unscaled (K, N) f32 accumulation; the caller
// applies s_x * s_g.
//
// What bounds it on the H100: at training shapes (M = 2048 tokens, K
// and N in the thousands) the operations, 2 * M * K * N over the fp8
// tensor-core peak; the requant alone is bytes (one read of the residual
// and one write of q' and e', ~2.06 * M * K).
//
// The design: two launches.  (1) dw_requant writes q' (K, M) and e'
// (K, M/32) once: the payload transposed, so the contraction is
// contiguous in each of its rows.  (2) wgmma.cuh's tile (MX policy, as
// mx_gemm.cu runs it at M > 32) takes q' as its K-major A operand with
// e' as its exponents and qg as its MN-major B operand, exactly as the
// forward reads its weights: tile rows are the K features, tile columns
// N, the contraction the M tokens (a multiple of 32; M % 64 == 32 reads
// as zeros in the last step).  Requantizing inside the tile would redo
// each 32-token group once per column tile (86 times at N 11008) as a
// reduction across the producers' threads, and the producers already
// set the tile's pace (mx_gemm.cu).
//
// dw_requant: one block of 256 threads per 32 tokens (one requant group)
// x 128 columns.  Each thread loads 16 residual bytes of one token (a
// warp reads four 128-byte lines), the block's exponents beside them,
// into shared memory; then two lanes take one column, 16 tokens each,
// dequantize, share the group's amax by one shuffle, requantize through
// common.cuh's routines (the ones every quantizer of the port uses) and
// store 16 contiguous bytes of the q' row (the two lanes a 32-byte
// sector).  With `sizes` (the grouped dW: E slots of Cp rows) a group
// at or past sizes[e] is written as the plain version's zero group,
// q' 0 and e' -127, without being read.
#include "common.cuh"
#include "wgmma.cuh"

namespace dwr {
constexpr int TOKENS = 32;            // one requant group
constexpr int COLS = 128;             // residual columns per block
constexpr int THREADS = 256;          // 2 per column, 8 per token
}  // namespace dwr

// Block (token group, column block, expert) of the residual qx
// (E * Cp, K) -> qt (E, K, Cp), et (E, K, Cp / 32).
__global__ void __launch_bounds__(dwr::THREADS)
dw_requant_kernel(const uint8_t* __restrict__ qx,
                  const int8_t* __restrict__ sexp,
                  const int* __restrict__ sizes, uint8_t* __restrict__ qt,
                  int8_t* __restrict__ et, int Cp, int K, bool x_e5m2,
                  bool e5m2, float fmax, float inv_ln2) {
  __shared__ __align__(16) uint8_t xs[dwr::TOKENS][dwr::COLS];
  __shared__ int8_t es[dwr::TOKENS][dwr::COLS / 32];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * dwr::TOKENS;
  const int k0 = blockIdx.y * dwr::COLS;
  const int e = blockIdx.z;
  const int kg = K / 32;
  const size_t row0 = static_cast<size_t>(e) * Cp + m0;
  // this thread's output: column c, tokens 16 h .. 16 h + 15 of the group
  const int c = tid / 2, h = tid % 2, k = k0 + c;
  const size_t out_row = static_cast<size_t>(e) * K + k;
  uint8_t* q_at = qt + out_row * Cp + m0 + 16 * h;
  int8_t* e_at = et + out_row * (Cp / 32) + m0 / 32;
  if (sizes != nullptr && m0 >= sizes[e]) {
    if (k < K) {
      *reinterpret_cast<uint4*>(q_at) = make_uint4(0u, 0u, 0u, 0u);
      if (h == 0) *e_at = -127;
    }
    return;
  }
  {
    const int r = tid / 8, kc = k0 + 16 * (tid % 8);
    const uint4 v =
        kc < K ? *reinterpret_cast<const uint4*>(qx + (row0 + r) * K + kc)
               : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(&xs[r][16 * (tid % 8)]) = v;
    if (tid < dwr::TOKENS * 4) {
      const int rr = tid / 4, g = k0 / 32 + tid % 4;
      es[rr][tid % 4] = g < kg ? sexp[(row0 + rr) * kg + g] : 0;
    }
  }
  __syncthreads();
  float v[16];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int r = 16 * h + i;
    v[i] = fp8_to_float(xs[r][c], x_e5m2) * exp2i(es[r][c / 32]);
    amax = fmaxf(amax, fabsf(v[i]));
  }
  amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
  if (k >= K) return;
  const int ei = e8m0_exponent(amax / fmax, inv_ln2);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    w[i / 4] |= static_cast<uint32_t>(mx_quant_value(v[i], ei, 1.f, fmax,
                                                     e5m2))
                << (8 * (i % 4));
  *reinterpret_cast<uint4*>(q_at) = make_uint4(w[0], w[1], w[2], w[3]);
  if (h == 0) *e_at = static_cast<int8_t>(ei);
}

// qx 16-byte aligned; Cp a multiple of 32; sizes null (every group live:
// the dense dW, E 1, Cp = M) or E int32 row counts on the card.
extern "C" int dw_requant_launch(const void* qx, const void* sexp,
                                 const void* sizes, void* qt, void* et,
                                 int E, int Cp, int K, int x_e5m2, int e5m2,
                                 float fmax, float inv_ln2, void* stream) {
  dim3 grid(Cp / dwr::TOKENS, (K + dwr::COLS - 1) / dwr::COLS, E);
  dw_requant_kernel<<<grid, dwr::THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(qx), static_cast<const int8_t*>(sexp),
      static_cast<const int*>(sizes), static_cast<uint8_t*>(qt),
      static_cast<int8_t*>(et), Cp, K, x_e5m2 != 0, e5m2 != 0, fmax,
      inv_ln2);
  return static_cast<int>(cudaGetLastError());
}

// dW (K, N) from the requant payload qt (K, M), et (K, M/32) and qg
// (M, N): wgmma.cuh's tile over (rows K, columns N, contraction M), as
// mx_gemm.cu's mx_gemm_tiled_kernel instances it (an instance of its own,
// so that a trace tells the dW's card time apart from the forward's).
template <bool QE5, bool GE5, bool VEC>
__global__ void __launch_bounds__(wgt::THREADS, 1)
mx_dw_gemm_kernel(const uint8_t* __restrict__ qt,
                  const int8_t* __restrict__ et,
                  const uint8_t* __restrict__ qg, float* __restrict__ out,
                  int M, int N, int K) {
  extern __shared__ uint8_t smem[];
  wgmma_tile<AScale::MX, QE5, GE5, VEC>(qt, et, nullptr, qg, out, K, N, M,
                                        M, blockIdx.x * wgt::BM,
                                        blockIdx.y * wgt::BN, smem);
}

// vec: qt and qg 16-byte aligned and N % 16 == 0 (16-byte loads).
extern "C" int mx_dw_gemm_launch(const void* qt, const void* et,
                                 const void* qg, void* out, int M, int N,
                                 int K, int q_e5m2, int g_e5m2, int vec,
                                 void* stream) {
  using Kernel = void (*)(const uint8_t*, const int8_t*, const uint8_t*,
                          float*, int, int, int);
  static const Kernel kernel[8] = {
      mx_dw_gemm_kernel<false, false, false>,
      mx_dw_gemm_kernel<false, false, true>,
      mx_dw_gemm_kernel<false, true, false>,
      mx_dw_gemm_kernel<false, true, true>,
      mx_dw_gemm_kernel<true, false, false>,
      mx_dw_gemm_kernel<true, false, true>,
      mx_dw_gemm_kernel<true, true, false>,
      mx_dw_gemm_kernel<true, true, true>};
  dim3 grid((K + wgt::BM - 1) / wgt::BM, (N + wgt::BN - 1) / wgt::BN);
  return static_cast<int>(launch_wgmma(
      kernel[wgmma_instance(q_e5m2, g_e5m2, vec)], grid,
      static_cast<cudaStream_t>(stream), static_cast<const uint8_t*>(qt),
      static_cast<const int8_t*>(et), static_cast<const uint8_t*>(qg),
      static_cast<float*>(out), M, N, K));
}
