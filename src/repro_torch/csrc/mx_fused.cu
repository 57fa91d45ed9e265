// Fused two-level quantize + MX GEMM for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/mx_fused.py:fused_quant_gemm_pallas.
// Per 32-wide group of each row of x it takes the amax, derives the E8M0
// exponent against the level-1 scale s (common.cuh: e8m0_exponent of
// amax / FP8_MAX / s), casts q = sat_fp8(x / d) with d = ftz(ftz(2^e) * s)
// (0 where d is 0), and accumulates (q * 2^e) @ Qw in f32.  ftz() flushes
// an f32 subnormal to 0 at exactly the places the plain version
// (repro_torch.core.quant) does: the reference runs on XLA's CPU backend
// with denormals flushed, and the payloads must match it bit for bit.
// The build itself keeps denormals (no -ftz): 2^-127 operands survive.
// It returns the unscaled accumulation and the payload (q, sexp); the
// caller applies s * s_w.
// Both e4m3 (forward) and e5m2 (dx) go through the same kernel.
//
// M <= 32 (the serving path's calibration forward) only: the MX GEMM
// tile of mx_gemm.cu with the quantizer fused into the shared-memory
// staging of x.  There the fp8 weight bytes dominate, so the bound is
// K * N bytes over 3.35 TB/s, and a block of 8 rows x 32 columns streams
// its weight strip once.  The quantizer is one warp per (row, 32-group),
// lane = element.  q and sexp are written once per row panel, by the
// blocks of column tile 0 (the TPU kernel rewrites them for every N
// block).  Ragged M and N are masked here; K is a multiple of 32.
//
// M > 32 (training: the forward, the remat recompute and dx) takes no
// kernel of this file: the wrapper (kernels/mx_fused.py) launches the
// mx_quant kernel (mx_quant.cu), which writes q and sexp once per
// element, then mx_gemm.cu's wgmma tile on them.  Quantizing inside a
// 128 x 128 GEMM tile would redo each row's 32-groups once per column
// tile (86 times at N 11008), and the quantizer (a warp max, two
// divisions, a logf and an IEEE division: ~60-100 instructions an
// element) costs ~8,192 x 100 / 128 ~ 6k SM cycles per 128 x 128 x 64
// step against ~512 cycles of bf16 tensor-core products: it, not the
// GEMM, would set the pace.
#include "common.cuh"

__global__ void __launch_bounds__(mxt::THREADS)
fused_quant_gemm_kernel(const void* __restrict__ x, const float* __restrict__ s_ptr,
                        const uint8_t* __restrict__ qw, float* __restrict__ out,
                        uint8_t* __restrict__ q_out, int8_t* __restrict__ sexp_out,
                        int M, int N, int K, bool x_bf16, bool e5m2, bool w_e5m2,
                        bool vec, float fmax, float inv_ln2) {
  __shared__ float xs[mxt::MT][mxt::KC];
  __shared__ float red[mxt::WARPS][mxt::MT][mxt::BN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * mxt::MT;
  const int nb = blockIdx.y * mxt::BN;
  const int n0 = nb + 4 * (tid % mxt::CT);
  const int ks = tid / mxt::CT;
  const bool vec_here = vec && (n0 + 3 < N);
  const bool owner = blockIdx.y == 0;     // writes q / sexp for its rows
  const int kg = K / 32;
  const float s = fmaxf(*s_ptr, 1e-30f);
  MxAcc acc;
#pragma unroll
  for (int m = 0; m < mxt::MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc.v[m][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += mxt::KC) {
    const int kc = min(mxt::KC, K - k0);
    const int groups = kc / 32;
    __syncthreads();
    for (int gi = warp; gi < mxt::MT * groups; gi += mxt::WARPS) {
      const int m = gi / groups, g = gi % groups, row = m0 + m;
      const int k = k0 + 32 * g + lane;
      const size_t at = static_cast<size_t>(row) * K + k;
      const float v = row < M ? load_x(x, at, x_bf16) : 0.f;
      xs[m][32 * g + lane] = quant_lane(v, s, fmax, inv_ln2, e5m2,
                                        owner && row < M, q_out + at,
                                        sexp_out + static_cast<size_t>(row)
                                        * kg + k / 32);
    }
    __syncthreads();
    mx_tile_accumulate(acc, xs, qw, k0, kc, n0, N, vec_here, w_e5m2, ks);
  }
  mx_tile_store(acc, red, out, m0, M, nb, N);
}

extern "C" int fused_quant_gemm_launch(const void* x, const void* s,
                                       const void* qw, void* out, void* q,
                                       void* sexp, int M, int N, int K,
                                       int x_bf16, int e5m2, int w_e5m2,
                                       int vec, float fmax, float inv_ln2,
                                       void* stream) {
  dim3 grid((M + mxt::MT - 1) / mxt::MT, (N + mxt::BN - 1) / mxt::BN);
  fused_quant_gemm_kernel<<<grid, mxt::THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<const float*>(s), static_cast<const uint8_t*>(qw),
      static_cast<float*>(out), static_cast<uint8_t*>(q),
      static_cast<int8_t*>(sexp), M, N, K, x_bf16 != 0, e5m2 != 0,
      w_e5m2 != 0, vec != 0, fmax, inv_ln2);
  return static_cast<int>(cudaGetLastError());
}
