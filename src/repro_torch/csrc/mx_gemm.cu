// MX GEMM for Hopper: acc[m, n] = sum_k (Qx[m, k] * 2^sexp[m, k/32]) * Qw[k, n]
//
// Replaces the TPU kernel src/repro/kernels/mx_gemm.py:mx_gemm_pallas.
// It is the delayed-scale serving forward of every linear layer (prefill
// chunks, decode steps, the LM head); the caller applies s_x * s_w.
//
// What bounds it on the H100: at decode M is the batch (<= 4), so the
// product is a weight-streaming GEMV and the bound is the fp8 weight
// bytes (K * N) over 3.35 TB/s; the activation operand is a few KB.
//
// The simple design: one block per (8-row, 32-column) output tile that
// walks all of K (the loop replaces the TPU's sequential K grid axis).
// Rows go on grid x and columns on grid y, so the row tiles of one
// column tile run together and share its weight bytes through L2.  The
// left operand is dequantized to bf16-exact f32 values in shared memory
// 512 columns at a time; every thread streams 4 weight bytes per k-row
// and keeps 8 x 4 f32 accumulators.  Ragged M and N are masked in the
// kernel; K is a multiple of 32 (the caller pads).  Plain FMA on
// bf16-exact values, no tensor cores yet: wgmma, TMA and warp
// specialisation are later work.
#include "common.cuh"

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
