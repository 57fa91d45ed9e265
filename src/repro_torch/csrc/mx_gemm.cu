// MX GEMM for Hopper: acc[m, n] = sum_k (Qx[m, k] * 2^sexp[m, k/32]) * Qw[k, n]
//
// Replaces the TPU kernel src/repro/kernels/mx_gemm.py:mx_gemm_pallas.
// It is the delayed-scale serving forward of every linear layer (prefill
// chunks, decode steps, the LM head), the Table 6 MOSS GEMM and, behind
// the mx_quant kernel, fused_quant_gemm at M > 32; the caller applies
// s_x * s_w.  Two tiles, chosen by the wrapper from M (kernels/mx_gemm.py
// SMALL_M):
//
// M <= 32 (decode steps M = B, verify steps M = B * k, 32-token prefill
// chunks): the bound is the fp8 weight bytes (K * N) over 3.35 TB/s, a
// weight-streaming GEMV; the activation operand is a few KB.  One block
// per (8-row, 32-column) output tile walks all of K (the loop replaces
// the TPU's sequential K grid axis).  Rows go on grid x and columns on
// grid y, so the row tiles of one column tile run together and share its
// weight bytes through L2.  The left operand is dequantized to bf16-exact
// f32 values in shared memory 512 columns at a time; every thread
// streams 4 weight bytes per k-row and keeps 8 x 4 f32 accumulators on
// the CUDA cores.
//
// M > 32 (prefill, Table 6, training): the bound is the operations,
// 2 * M * N * K.  The reference's MXU dot multiplies bf16(q * 2^e) by
// bf16(Qw) with f32 accumulation, and those products are exact in f32,
// so a bf16 wgmma with f32 accumulators computes the same function, only
// the order of the sums differs: the tile is capped by the bf16 peak
// (989 TFLOP/s), half the fp8 rate that bound_ms counts.  An fp8 wgmma
// would need a per-row 2^e rescale of a partial sum every 32-wide K step
// (the in-loop rescale MOSS argues against) and accumulates narrower
// than f32.  The design (wgmma.cuh: wgmma_tile, MX policy): 128 x 128
// output tiles of 512 threads; two producer warpgroups convert the fp8 bytes
// into 128-byte-swizzled bf16 panels (q times 2^e for A, K-major; Qw as
// it lies for B, MN-major, read transposed by the instruction) on the
// integer pipe, a 3-deep mbarrier ring ahead of two consumer warpgroups
// that issue m64n128k16 products and add each K-128 partial sum to f32
// registers (the tensor core's own accumulation truncates: ~1e-5 *
// max|out| at K 10240).  Converting costs ~2 integer instructions an
// element, paid once per (tile, element) and shared by 128 columns or
// rows; the products of a 128 x 128 x 64 step take ~512 SM cycles at the
// bf16 peak.  Measured (H100 at 700 W): ~300 TFLOP/s, the conversion
// and its shared-memory stores holding it (PERF.md).
//
// Ragged M and N are masked in both tiles; K is a multiple of 32 (the
// caller pads), K % 64 == 32 reads as zeros in the last step.
#include "common.cuh"
#include "wgmma.cuh"

__global__ void __launch_bounds__(mxt::THREADS)
mx_gemm_kernel(const uint8_t* __restrict__ qx, const int8_t* __restrict__ sexp,
               const uint8_t* __restrict__ qw, float* __restrict__ out, int M,
               int N, int K, bool x_e5m2, bool w_e5m2, bool vec) {
  __shared__ float xs[mxt::MT][mxt::KC];
  __shared__ float red[mxt::WARPS][mxt::MT][mxt::BN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * mxt::MT;
  const int nb = blockIdx.y * mxt::BN;
  const int n0 = nb + 4 * (tid % mxt::CT);
  const int ks = tid / mxt::CT;
  const bool vec_here = vec && (n0 + 3 < N);
  const int kg = K / 32;
  MxAcc acc;
#pragma unroll
  for (int m = 0; m < mxt::MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc.v[m][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += mxt::KC) {
    const int kc = min(mxt::KC, K - k0);
    __syncthreads();
    for (int i = tid; i < mxt::MT * kc; i += mxt::THREADS) {
      const int m = i / kc, kk = i % kc, row = m0 + m;
      float a = 0.f;
      if (row < M) {
        const int k = k0 + kk;
        a = bf16_round(fp8_to_float(qx[static_cast<size_t>(row) * K + k],
                                    x_e5m2) *
                       exp2i(sexp[static_cast<size_t>(row) * kg + k / 32]));
      }
      xs[m][kk] = a;
    }
    __syncthreads();
    mx_tile_accumulate(acc, xs, qw, k0, kc, n0, N, vec_here, w_e5m2, ks);
  }
  mx_tile_store(acc, red, out, m0, M, nb, N);
}

extern "C" int mx_gemm_launch(const void* qx, const void* sexp, const void* qw,
                              void* out, int M, int N, int K, int x_e5m2,
                              int w_e5m2, int vec, void* stream) {
  dim3 grid((M + mxt::MT - 1) / mxt::MT, (N + mxt::BN - 1) / mxt::BN);
  mx_gemm_kernel<<<grid, mxt::THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(qx), static_cast<const int8_t*>(sexp),
      static_cast<const uint8_t*>(qw), static_cast<float*>(out), M, N, K,
      x_e5m2 != 0, w_e5m2 != 0, vec != 0);
  return static_cast<int>(cudaGetLastError());
}

template <bool XE5, bool WE5, bool VEC>
__global__ void __launch_bounds__(wgt::THREADS, 1)
mx_gemm_tiled_kernel(const uint8_t* __restrict__ qx,
                     const int8_t* __restrict__ sexp,
                     const uint8_t* __restrict__ qw, float* __restrict__ out,
                     int M, int N, int K) {
  extern __shared__ uint8_t smem[];
  wgmma_tile<AScale::MX, XE5, WE5, VEC>(qx, sexp, nullptr, qw, out, M, N, K,
                                        K, blockIdx.x * wgt::BM,
                                        blockIdx.y * wgt::BN, smem);
}

// vec: qx and qw 16-byte aligned and N % 16 == 0 (16-byte loads).
extern "C" int mx_gemm_tiled_launch(const void* qx, const void* sexp,
                                    const void* qw, void* out, int M, int N,
                                    int K, int x_e5m2, int w_e5m2, int vec,
                                    void* stream) {
  using Kernel = void (*)(const uint8_t*, const int8_t*, const uint8_t*,
                          float*, int, int, int);
  static const Kernel kernel[8] = {
      mx_gemm_tiled_kernel<false, false, false>,
      mx_gemm_tiled_kernel<false, false, true>,
      mx_gemm_tiled_kernel<false, true, false>,
      mx_gemm_tiled_kernel<false, true, true>,
      mx_gemm_tiled_kernel<true, false, false>,
      mx_gemm_tiled_kernel<true, false, true>,
      mx_gemm_tiled_kernel<true, true, false>,
      mx_gemm_tiled_kernel<true, true, true>};
  dim3 grid((M + wgt::BM - 1) / wgt::BM, (N + wgt::BN - 1) / wgt::BN);
  return static_cast<int>(launch_wgmma(
      kernel[wgmma_instance(x_e5m2, w_e5m2, vec)], grid,
      static_cast<cudaStream_t>(stream), static_cast<const uint8_t*>(qx),
      static_cast<const int8_t*>(sexp), static_cast<const uint8_t*>(qw),
      static_cast<float*>(out), M, N, K));
}
