// The grouped-expert (MoE) GEMMs of the MOSS training step for Hopper.
//
// Replace the TPU kernels src/repro/kernels/moe_gmm.py:moe_gmm_pallas and
// moe_dw_gemm_pallas.  The token buffer is the MoE dispatch's flat sorted
// buffer of E capacity slots of C rows each: expert e owns rows
// [e * C, e * C + sizes[e]), and the rest of its slot is zero (the
// dispatch writes nothing there).
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
// times at N 6400; mx_fused.cu says why that would set the pace).
//
// moe_dw_gemm: mx_dw_gemm.cu's tile (common.cuh: dw_tile) with an expert
// grid dimension: block (k tile, n tile, e) computes
//   dW[e, k, n] = sum_m requant_M(Qx_e * 2^sexp_e)[k, m] * Qg_e[m, n]
// over expert e's Cp rows (Cp a multiple of 32, so the 32-token requant
// groups never straddle two experts), writing the stacked (E, K, N)
// gradient in one launch.  The token loop stops at sizes[e] rounded up
// to 32: the rows past it are zero in both operands, so the groups it
// skips would add exact zeros.  The caller applies s_x * s_g.
//
// What bounds them on the H100: at the training shapes (E 16, C 1336,
// K and N 4096 / 6400) the operations, 2 * sum(sizes) * K * N over the
// fp8 tensor-core peak.  moe_gmm runs bf16 wgmma products (capped at
// half that peak, as mx_gemm.cu says); moe_dw_gemm runs on the CUDA
// cores (8 x 8 register tiles), like the dense dW kernel it extends.
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
      qw + static_cast<size_t>(e) * K * N, o, rows, N, K, 0, n0, smem);
}

__global__ void __launch_bounds__(dwt::THREADS)
moe_dw_gemm_kernel(const uint8_t* __restrict__ qx,
                   const int8_t* __restrict__ sexp,
                   const uint8_t* __restrict__ qg,
                   const int* __restrict__ sizes, float* __restrict__ out,
                   uint8_t* __restrict__ qt, int8_t* __restrict__ et,
                   int Cp, int N, int K, bool x_e5m2, bool g_e5m2,
                   bool e5m2, float fmax, float inv_ln2) {
  const int e = blockIdx.z;
  const size_t r0 = static_cast<size_t>(e) * Cp;
  const int m_end = min((sizes[e] + 31) / 32 * 32, Cp);
  dw_tile(qx + r0 * K, sexp + r0 * (K / 32), qg + r0 * N,
          out + static_cast<size_t>(e) * K * N,
          qt == nullptr ? nullptr : qt + static_cast<size_t>(e) * K * Cp,
          et == nullptr ? nullptr : et + static_cast<size_t>(e) * K * (Cp / 32),
          Cp, m_end, N, K, blockIdx.x * dwt::BK, blockIdx.y * dwt::BN, x_e5m2,
          g_e5m2, e5m2, fmax, inv_ln2, blockIdx.y == 0);
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

extern "C" int moe_dw_gemm_launch(const void* qx, const void* sexp,
                                  const void* qg, const void* sizes,
                                  void* out, void* qt, void* et, int E,
                                  int Cp, int N, int K, int x_e5m2,
                                  int g_e5m2, int e5m2, float fmax,
                                  float inv_ln2, void* stream) {
  dim3 grid((K + dwt::BK - 1) / dwt::BK, (N + dwt::BN - 1) / dwt::BN, E);
  moe_dw_gemm_kernel<<<grid, dwt::THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(qx), static_cast<const int8_t*>(sexp),
      static_cast<const uint8_t*>(qg), static_cast<const int*>(sizes),
      static_cast<float*>(out), static_cast<uint8_t*>(qt),
      static_cast<int8_t*>(et), Cp, N, K, x_e5m2 != 0, g_e5m2 != 0,
      e5m2 != 0, fmax, inv_ln2);
  return static_cast<int>(cudaGetLastError());
}
