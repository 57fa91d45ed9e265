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
// Two tiles, chosen by the wrapper from M:
//
// M <= 32 (the serving path's calibration forward): the MX GEMM tile of
// mx_gemm.cu with the quantizer fused into the shared-memory staging of
// x.  There the fp8 weight bytes dominate, so the bound is K * N bytes
// over 3.35 TB/s, and a block of 8 rows x 32 columns streams its weight
// strip once.
//
// M > 32 (training: the forward, the remat recompute and dx at 2048
// tokens): the bound is the operations, 2 * M * K * N over the bf16
// tensor-core peak, and the small tile would re-read the weight strip
// once per 8 rows.  The large tile gives each block 128 x 128 outputs:
// per 32-wide K step (one micro-group) it quantizes its 128 rows into a
// transposed operand panel and upcasts a 32 x 128 weight panel, both in
// shared memory, and each of 256 threads accumulates an 8 x 8 register
// tile on the CUDA cores (tensor cores are later work).
//
// In both, the quantizer is one warp per (row, 32-group), lane =
// element.  q and sexp are written once per row panel, by the blocks of
// column tile 0 (the TPU kernel rewrites them for every N block).
// Ragged M and N are masked here; K is a multiple of 32.
#include "common.cuh"

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

namespace fqt {
constexpr int BM = 128;               // output rows per block
constexpr int BN = 128;               // output columns per block
constexpr int KS = 32;                // K per step = one micro-group
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int AST = BM + 4;           // padded row of the operand panel
}  // namespace fqt

__global__ void __launch_bounds__(fqt::THREADS)
fused_quant_gemm_tiled_kernel(const void* __restrict__ x,
                              const float* __restrict__ s_ptr,
                              const uint8_t* __restrict__ qw,
                              float* __restrict__ out,
                              uint8_t* __restrict__ q_out,
                              int8_t* __restrict__ sexp_out, int M, int N,
                              int K, bool x_bf16, bool e5m2, bool w_e5m2,
                              bool vec, float fmax, float inv_ln2) {
  // as[k][m]: the quantized x panel, transposed; bs[k][n]: the weights
  __shared__ __align__(16) float as[fqt::KS][fqt::AST];
  __shared__ __align__(16) float bs[fqt::KS][fqt::BN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * fqt::BM, n0 = blockIdx.y * fqt::BN;
  const bool owner = blockIdx.y == 0;     // writes q / sexp for its rows
  const int kg = K / 32;
  const float s = fmaxf(*s_ptr, 1e-30f);
  const int ty = tid / 16, tx = tid % 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += fqt::KS) {
    __syncthreads();                      // the last step's reads are done
    for (int r = warp; r < fqt::BM; r += fqt::WARPS) {
      const int row = m0 + r;
      const size_t at = static_cast<size_t>(row) * K + k0 + lane;
      const float v = row < M ? load_x(x, at, x_bf16) : 0.f;
      as[lane][r] = quant_lane(v, s, fmax, inv_ln2, e5m2, owner && row < M,
                               q_out + at,
                               sexp_out + static_cast<size_t>(row) * kg +
                                   k0 / 32);
    }
    for (int i = tid; i < fqt::KS * (fqt::BN / 4); i += fqt::THREADS) {
      const int kk = i / (fqt::BN / 4), c = 4 * (i % (fqt::BN / 4));
      float w[4];
      load_w4(qw + static_cast<size_t>(k0 + kk) * N, n0 + c, N,
              vec && n0 + c + 3 < N, w_e5m2, w);
      *reinterpret_cast<float4*>(&bs[kk][c]) =
          make_float4(w[0], w[1], w[2], w[3]);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < fqt::KS; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&as[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&bs[kk][64 + tx * 4]);
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
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (n < N) out[static_cast<size_t>(m) * N + n] = acc[i][j];
    }
  }
}

extern "C" int fused_quant_gemm_launch(const void* x, const void* s,
                                       const void* qw, void* out, void* q,
                                       void* sexp, int M, int N, int K,
                                       int x_bf16, int e5m2, int w_e5m2,
                                       int vec, int tiled, float fmax,
                                       float inv_ln2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(s);
  const uint8_t* w = static_cast<const uint8_t*>(qw);
  float* o = static_cast<float*>(out);
  uint8_t* qo = static_cast<uint8_t*>(q);
  int8_t* eo = static_cast<int8_t*>(sexp);
  if (tiled) {
    dim3 grid((M + fqt::BM - 1) / fqt::BM, (N + fqt::BN - 1) / fqt::BN);
    fused_quant_gemm_tiled_kernel<<<grid, fqt::THREADS, 0, st>>>(
        x, sp, w, o, qo, eo, M, N, K, x_bf16 != 0, e5m2 != 0, w_e5m2 != 0,
        vec != 0, fmax, inv_ln2);
  } else {
    dim3 grid((M + mxt::MT - 1) / mxt::MT, (N + mxt::BN - 1) / mxt::BN);
    fused_quant_gemm_kernel<<<grid, mxt::THREADS, 0, st>>>(
        x, sp, w, o, qo, eo, M, N, K, x_bf16 != 0, e5m2 != 0, w_e5m2 != 0,
        vec != 0, fmax, inv_ln2);
  }
  return static_cast<int>(cudaGetLastError());
}
