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
// N in the thousands) the operations, 2 * M * K * N over the tensor-core
// peak; this first version runs on the CUDA cores, like mx_dw_gemm.cu.
//
// The simple design (the shape of mx_dw_gemm.cu): one block of 256
// threads per 128 x 128 output tile.  Per 32-wide K step it upcasts the
// fp8 x panel (128 rows x 32, each thread 16 bytes, stored transposed)
// and the fp8 weight panel (32 x 128, each thread 16 bytes) into shared
// memory (fp8 -> f32 is exact), and each thread accumulates an 8 x 8
// register tile of the group's partial sum.  After the group's four steps
// each thread adds partial * sx[m, g] to its 8 x 8 accumulator, the
// groups in order.  Products of fp8 values are exact in f32; sums are
// taken in a fixed order (deterministic).  K is a multiple of 128 (the
// caller pads); ragged M and N are masked here.
#include "common.cuh"

namespace ggt {
constexpr int BM = 128;               // output rows per block
constexpr int BN = 128;               // output columns per block
constexpr int GROUP = 128;            // K per scale group
constexpr int KS = 32;                // K per staged step
constexpr int THREADS = 256;
constexpr int AST = BM + 4;           // padded row of the x panel
}  // namespace ggt

__device__ __forceinline__ void upcast16(uint4 raw, bool e5m2, float* dst) {
  const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
  for (int j = 0; j < 16; ++j) dst[j] = fp8_to_float(b[j], e5m2);
}

__global__ void __launch_bounds__(ggt::THREADS)
group_gemm_kernel(const uint8_t* __restrict__ qx, const float* __restrict__ sx,
                  const uint8_t* __restrict__ qw, float* __restrict__ out,
                  int M, int N, int K, bool x_e5m2, bool w_e5m2, bool vec) {
  __shared__ __align__(16) float as[ggt::KS][ggt::AST];   // as[k][m]
  __shared__ __align__(16) float bs[ggt::KS][ggt::BN];    // bs[k][n]
  __shared__ float ss[ggt::BM];                           // sx[m0 + i, g]
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * ggt::BM, n0 = blockIdx.y * ggt::BN;
  const int ty = tid / 16, tx = tid % 16;
  const int groups = K / ggt::GROUP;
  // the x panel: row xr, 16 bytes at column xh (a warp covers 32 rows,
  // so its transposed shared-memory stores hit 32 banks)
  const int xr = tid % ggt::BM, xh = (tid / ggt::BM) * 16;
  const int xrow = m0 + xr;
  // the weight panel: k-row wk, 16 columns at wc
  const int wk = tid / 8, wc = (tid % 8) * 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int g = 0; g < groups; ++g) {
    float part[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) part[i][j] = 0.f;
    for (int k0 = g * ggt::GROUP; k0 < (g + 1) * ggt::GROUP; k0 += ggt::KS) {
      __syncthreads();                    // the last reads are done
      {
        float v[16];
        const uint4 raw =
            xrow < M ? *reinterpret_cast<const uint4*>(
                           qx + static_cast<size_t>(xrow) * K + k0 + xh)
                     : make_uint4(0u, 0u, 0u, 0u);
        upcast16(raw, x_e5m2, v);
#pragma unroll
        for (int j = 0; j < 16; ++j) as[xh + j][xr] = v[j];
      }
      {
        float v[16];
        const uint8_t* wrow = qw + static_cast<size_t>(k0 + wk) * N;
        const int n = n0 + wc;
        if (vec && n + 15 < N) {
          upcast16(*reinterpret_cast<const uint4*>(wrow + n), w_e5m2, v);
        } else {
#pragma unroll
          for (int j = 0; j < 16; ++j)
            v[j] = n + j < N ? fp8_to_float(wrow[n + j], w_e5m2) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 16; j += 4)
          *reinterpret_cast<float4*>(&bs[wk][wc + j]) =
              make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
      }
      if (k0 == g * ggt::GROUP && tid < ggt::BM)
        ss[tid] = m0 + tid < M
                      ? sx[static_cast<size_t>(m0 + tid) * groups + g]
                      : 0.f;
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < ggt::KS; ++kk) {
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
          for (int j = 0; j < 8; ++j)
            part[i][j] = fmaf(a[i], b[j], part[i][j]);
      }
    }
    // the in-loop rescale: this group's partial times its row scales
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float s = ss[i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4)];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(part[i][j], s));
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

extern "C" int group_gemm_launch(const void* qx, const void* sx,
                                 const void* qw, void* out, int M, int N,
                                 int K, int x_e5m2, int w_e5m2, int vec,
                                 void* stream) {
  dim3 grid((M + ggt::BM - 1) / ggt::BM, (N + ggt::BN - 1) / ggt::BN);
  group_gemm_kernel<<<grid, ggt::THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(qx), static_cast<const float*>(sx),
      static_cast<const uint8_t*>(qw), static_cast<float*>(out), M, N, K,
      x_e5m2 != 0, w_e5m2 != 0, vec != 0);
  return static_cast<int>(cudaGetLastError());
}
