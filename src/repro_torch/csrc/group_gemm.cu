// The per-group (COAT) fp8 GEMM for Hopper: the baseline of the paper's
// Fig. 3a and Table 6.
//
// Replaces the TPU kernel src/repro/kernels/group_gemm.py:group_gemm_pallas.
//
//   out[m, n] = sum_g ( sum_{k in g} Qx[m, k] * Qw[k, n] ) * sx[m, g]
//
// qx (M, K) fp8 with its f32 group scales sx (M, K/128), qw (K, N) fp8
// (per-tensor; the caller applies s_w).  The scales sit along the GEMM's
// inner dimension, so every 128-wide group's partial sum is rescaled in
// f32 inside the K loop: the in-loop dequantization that MOSS moves into
// the operand and the epilogue.  This kernel keeps it, since it is what
// the baseline computes and what Table 6 measures.
//
// What bounds it on the H100: at training shapes (M = 2048 tokens, K and
// N in the thousands) the operations, 2 * M * K * N over the fp8
// tensor-core peak.
//
// The design: the MOSS GEMM's tile (wgmma.cuh: wgmma_tile) under its
// GROUP policy, so that Table 6 sets the two recipes on one mainloop.
// The producers convert both fp8 operands to bf16 unscaled (exact) on
// the integer pipe; the consumers' bf16 wgmma products of a K-128 group
// (two 64-wide steps) sum in the tensor core, exactly where the tile
// promotes each partial sum to f32 registers anyway, and the promotion
// becomes acc = acc + part * sx[m, g], multiply and add each rounded
// (the order of the reference's partial * sx then sum, and of the
// plain version).  Each consumer thread holds two rows of the fragment
// and reads their scales a promotion ahead.  The products of fp8 values
// are exact; a group's partial sum is the tensor core's, the sum over
// groups IEEE f32 in group order (deterministic).  K is a multiple of
// 128 (the caller pads); ragged M and N are masked.
#include "common.cuh"
#include "wgmma.cuh"

template <bool XE5, bool WE5, bool VEC>
__global__ void __launch_bounds__(wgt::THREADS, 1)
group_gemm_kernel(const uint8_t* __restrict__ qx,
                  const float* __restrict__ sx,
                  const uint8_t* __restrict__ qw, float* __restrict__ out,
                  int M, int N, int K) {
  extern __shared__ uint8_t smem[];
  wgmma_tile<AScale::GROUP, XE5, WE5, VEC>(qx, nullptr, sx, qw, out, M, N,
                                           K, K, blockIdx.x * wgt::BM,
                                           blockIdx.y * wgt::BN, smem);
}

// vec: qx and qw 16-byte aligned and N % 16 == 0 (16-byte loads).
extern "C" int group_gemm_launch(const void* qx, const void* sx,
                                 const void* qw, void* out, int M, int N,
                                 int K, int x_e5m2, int w_e5m2, int vec,
                                 void* stream) {
  using Kernel = void (*)(const uint8_t*, const float*, const uint8_t*,
                          float*, int, int, int);
  static const Kernel kernel[8] = {
      group_gemm_kernel<false, false, false>,
      group_gemm_kernel<false, false, true>,
      group_gemm_kernel<false, true, false>,
      group_gemm_kernel<false, true, true>,
      group_gemm_kernel<true, false, false>,
      group_gemm_kernel<true, false, true>,
      nullptr,   // e5m2 x e5m2: no recipe multiplies two gradients
      nullptr};
  const Kernel k = kernel[wgmma_instance(x_e5m2, w_e5m2, vec)];
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((M + wgt::BM - 1) / wgt::BM, (N + wgt::BN - 1) / wgt::BN);
  return static_cast<int>(launch_wgmma(
      k, grid, static_cast<cudaStream_t>(stream),
      static_cast<const uint8_t*>(qx), static_cast<const float*>(sx),
      static_cast<const uint8_t*>(qw), static_cast<float*>(out), M, N, K));
}
