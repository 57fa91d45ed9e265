// The grouped-expert (MoE) GEMMs of the MOSS training step for Hopper.
//
// Replace the TPU kernels src/repro/kernels/moe_gmm.py:moe_gmm_pallas
// (:129) and moe_dw_gemm_pallas (:232).  The token buffer is the MoE
// dispatch's flat sorted buffer of E capacity slots of C rows each:
// expert e owns rows [e * C, e * C + sizes[e]), and the rest of its slot
// is zero (the dispatch writes nothing there).
//
// moe_gmm: row 2's M > 32 route applied per expert.  The wrapper
// (kernels/moe_gmm.py) first runs the mx_quant kernel over the whole
// (E * C, K) buffer with one level-1 scale s: it writes the payload
// (q, sexp) of every row, also past sizes[e] (the residual covers the
// whole buffer; a zero row gives q = 0 and sexp = -127, bitwise as the
// reference produces it).  Then one launch of wgmma.cuh's tile (MX
// policy) over the grid (row block within the slot, column tile,
// expert): block (i, j, e) takes rows e * C + 128 i up to
// min(e * C + 128 (i + 1), (e + 1) * C) against its expert's (K, N)
// payload qw + e * K * N.  C need not be a multiple of the 128-row tile
// (C = 1336 at full width): the tile masks the ragged last block of
// each slot, so a tile never straddles two experts.  A block whose first
// row is at or past sizes[e] (read on the device) stores zeros, what
// the products of its zero rows give and what the reference's skipped
// dot leaves.  Returns the unscaled f32 accumulation; the caller applies
// s * s_w[e] row by row.  The forward runs it with e4m3 on the
// activations, dx with e5m2 on the gradient against the per-expert
// transposed payloads (E, N, K), which the caller transposes once and
// the tile reads as the forward reads its weights.  Quantizing inside
// the tile would redo each row's 32-groups once per column tile (50
// times at N 6400; kernels/mx_fused.py says why that would set the
// pace).
//
// moe_dw_gemm: the dense dW's two launches (mx_dw_gemm.cu) with an
// expert grid dimension,
//   dW[e, k, n] = sum_m requant_M(Qx_e * 2^sexp_e)[k, m] * Qg_e[m, n]
// over expert e's Cp rows (Cp a multiple of 32, so the 32-token requant
// groups never straddle two experts), the stacked (E, K, N) gradient in
// one tile launch.  The wrapper first runs mx_dw_gemm.cu's dw_requant
// pass over the (E * Cp, K) residual into q' (E, K, Cp) and e'
// (E, K, Cp/32), writing the groups at or past sizes[e] as zero groups
// (q' 0, e' -127) without reading them.  Then block (k tile, n tile, e)
// runs the tile (MX policy) on A = q' + e * K * Cp with its exponents,
// B = qg + e * Cp * N, into out + e * K * N, its contraction stopping at
// m_end = min(round32(sizes[e]), Cp) read on the device (the rows past
// it are zero in both operands, so the steps it skips would add exact
// zeros: ~25% of the slots at full width).  The tile takes Cp as the
// row stride of q' and m_end as its k_stop.  An expert with m_end 0
// stores zeros.  The caller applies s_x * s_g.
//
// What bounds them on the H100: at the training shapes (E 16, C 1336,
// K and N 4096 / 6400) moe_gmm the operations, 2 * sum(sizes) * K * N
// over the fp8 tensor-core peak; moe_dw_gemm the bytes, its 1.68 GB
// f32 (E, K, N) output at 3.35 TB/s (0.50 ms, 0.55 with its inputs),
// above its operations at that peak (0.43 ms).  Both run bf16 wgmma
// products (capped at half the fp8 peak, as mx_gemm.cu says);
// moe_dw_gemm's stores overlap the products of the blocks still running
// (25,600 blocks of at most 21 steps).
#include "common.cuh"
#include "wgmma.cuh"

template <bool XE5, bool WE5, bool VEC>
__global__ void __launch_bounds__(wgt::THREADS, 1)
moe_gmm_kernel(const uint8_t* __restrict__ qx,
               const int8_t* __restrict__ sexp,
               const uint8_t* __restrict__ qw, const int* __restrict__ sizes,
               float* __restrict__ out, int C, int N, int K) {
  extern __shared__ uint8_t smem[];
  const int e = blockIdx.z;
  const int r0 = blockIdx.x * wgt::BM;            // first row in the slot
  const int rows = min(wgt::BM, C - r0);
  const int n0 = blockIdx.y * wgt::BN;
  const size_t row0 = static_cast<size_t>(e) * C + r0;
  float* o = out + row0 * N;
  if (r0 >= sizes[e]) {
    for (int i = threadIdx.x; i < rows * wgt::BN; i += wgt::THREADS) {
      const int n = n0 + i % wgt::BN;
      if (n < N) o[static_cast<size_t>(i / wgt::BN) * N + n] = 0.f;
    }
    return;
  }
  wgmma_tile<AScale::MX, XE5, WE5, VEC>(
      qx + row0 * K, sexp + row0 * (K / 32), nullptr,
      qw + static_cast<size_t>(e) * K * N, o, rows, N, K, K, 0, n0, smem);
}

template <bool QE5, bool GE5, bool VEC>
__global__ void __launch_bounds__(wgt::THREADS, 1)
moe_dw_gemm_kernel(const uint8_t* __restrict__ qt,
                   const int8_t* __restrict__ et,
                   const uint8_t* __restrict__ qg,
                   const int* __restrict__ sizes, float* __restrict__ out,
                   int Cp, int N, int K) {
  extern __shared__ uint8_t smem[];
  const int e = blockIdx.z;
  const int k0 = blockIdx.x * wgt::BM;            // first output row
  const int n0 = blockIdx.y * wgt::BN;
  const int m_end = min((sizes[e] + 31) / 32 * 32, Cp);
  float* o = out + static_cast<size_t>(e) * K * N;
  if (m_end <= 0) {
    const int rows = min(wgt::BM, K - k0);
    for (int i = threadIdx.x; i < rows * wgt::BN; i += wgt::THREADS) {
      const int n = n0 + i % wgt::BN;
      if (n < N) o[static_cast<size_t>(k0 + i / wgt::BN) * N + n] = 0.f;
    }
    return;
  }
  wgmma_tile<AScale::MX, QE5, GE5, VEC>(
      qt + static_cast<size_t>(e) * K * Cp,
      et + static_cast<size_t>(e) * K * (Cp / 32), nullptr,
      qg + static_cast<size_t>(e) * Cp * N, o, K, N, Cp, m_end, k0, n0,
      smem);
}

// qx (E * C, K) and sexp from the mx_quant kernel; vec: qx and qw
// 16-byte aligned and N % 16 == 0 (then e * K * N keeps qw + e * K * N
// aligned too).
extern "C" int moe_gmm_launch(const void* qx, const void* sexp,
                              const void* qw, const void* sizes, void* out,
                              int E, int C, int N, int K, int x_e5m2,
                              int w_e5m2, int vec, void* stream) {
  using Kernel = void (*)(const uint8_t*, const int8_t*, const uint8_t*,
                          const int*, float*, int, int, int);
  static const Kernel kernel[8] = {
      moe_gmm_kernel<false, false, false>, moe_gmm_kernel<false, false, true>,
      moe_gmm_kernel<false, true, false>,  moe_gmm_kernel<false, true, true>,
      moe_gmm_kernel<true, false, false>,  moe_gmm_kernel<true, false, true>,
      moe_gmm_kernel<true, true, false>,   moe_gmm_kernel<true, true, true>};
  dim3 grid((C + wgt::BM - 1) / wgt::BM, (N + wgt::BN - 1) / wgt::BN, E);
  return static_cast<int>(launch_wgmma(
      kernel[wgmma_instance(x_e5m2, w_e5m2, vec)], grid,
      static_cast<cudaStream_t>(stream), static_cast<const uint8_t*>(qx),
      static_cast<const int8_t*>(sexp), static_cast<const uint8_t*>(qw),
      static_cast<const int*>(sizes), static_cast<float*>(out), C, N, K));
}

// qt (E, K, Cp) and et from the dw_requant pass; vec: qt and qg
// 16-byte aligned and N % 16 == 0 (then e * Cp * N keeps qg + e * Cp * N
// aligned too).
extern "C" int moe_dw_gemm_launch(const void* qt, const void* et,
                                  const void* qg, const void* sizes,
                                  void* out, int E, int Cp, int N, int K,
                                  int q_e5m2, int g_e5m2, int vec,
                                  void* stream) {
  using Kernel = void (*)(const uint8_t*, const int8_t*, const uint8_t*,
                          const int*, float*, int, int, int);
  static const Kernel kernel[8] = {
      moe_dw_gemm_kernel<false, false, false>,
      moe_dw_gemm_kernel<false, false, true>,
      moe_dw_gemm_kernel<false, true, false>,
      moe_dw_gemm_kernel<false, true, true>,
      moe_dw_gemm_kernel<true, false, false>,
      moe_dw_gemm_kernel<true, false, true>,
      moe_dw_gemm_kernel<true, true, false>,
      moe_dw_gemm_kernel<true, true, true>};
  dim3 grid((K + wgt::BM - 1) / wgt::BM, (N + wgt::BN - 1) / wgt::BN, E);
  return static_cast<int>(launch_wgmma(
      kernel[wgmma_instance(q_e5m2, g_e5m2, vec)], grid,
      static_cast<cudaStream_t>(stream), static_cast<const uint8_t*>(qt),
      static_cast<const int8_t*>(et), static_cast<const uint8_t*>(qg),
      static_cast<const int*>(sizes), static_cast<float*>(out), Cp, N, K));
}
