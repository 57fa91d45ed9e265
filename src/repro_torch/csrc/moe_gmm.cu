// The grouped-expert (MoE) GEMMs of the MOSS training step for Hopper.
//
// Replace the TPU kernels src/repro/kernels/moe_gmm.py:moe_gmm_pallas and
// moe_dw_gemm_pallas.  The token buffer is the MoE dispatch's flat sorted
// buffer of E capacity slots of C rows each: expert e owns rows
// [e * C, e * C + sizes[e]), and the rest of its slot is zero (the
// dispatch writes nothing there).
//
// moe_gmm: the fused two-level quantize + MX GEMM of mx_fused.cu's large
// tile (common.cuh: fused_tile) over the whole (E * C, K) buffer, each
// row block against its own expert's (K, N) fp8 weight payload
// qw + e * K * N, with one level-1 scale s for the buffer.  The grid is
// (row block within the slot, column tile, expert): C need not be a
// multiple of the 128-row tile (C = 1336 at full width), so a tile never
// straddles two experts and the ragged last block of each slot is
// masked.  Every row is quantized, also in blocks past sizes[e]: the
// residual covers the whole buffer, and a zero row gives q = 0 and
// sexp = -127, bitwise as the reference produces it.  Only the products
// are skipped for a block that starts at or past sizes[e]; its output
// is 0 (what the products of its zero rows give).  Returns the unscaled
// f32 accumulation and the payload (q, sexp); the caller applies
// s * s_w[e] row by row.  The forward runs it with e4m3 on the
// activations, dx with e5m2 on the gradient against the per-expert
// transposed payloads (E, N, K), which the caller transposes once.
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
// fp8 tensor-core peak.  These first versions run on the CUDA cores
// (8 x 8 register tiles), like the dense kernels they extend.
#include "common.cuh"

__global__ void __launch_bounds__(fqt::THREADS)
moe_gmm_kernel(const void* __restrict__ x, const float* __restrict__ s_ptr,
               const uint8_t* __restrict__ qw, const int* __restrict__ sizes,
               float* __restrict__ out, uint8_t* __restrict__ q_out,
               int8_t* __restrict__ sexp_out, int C, int N, int K,
               bool x_bf16, bool e5m2, bool w_e5m2, bool vec, float fmax,
               float inv_ln2) {
  const int e = blockIdx.z;
  const int r0 = blockIdx.x * fqt::BM;            // first row in the slot
  const size_t row0 = static_cast<size_t>(e) * C + r0;
  fused_tile(x, row0, min(fqt::BM, C - r0),
             qw + static_cast<size_t>(e) * K * N, out, q_out, sexp_out,
             blockIdx.y * fqt::BN, N, K, x_bf16, e5m2, w_e5m2, vec,
             fmaxf(*s_ptr, 1e-30f), fmax, inv_ln2, blockIdx.y == 0,
             r0 < sizes[e]);
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

extern "C" int moe_gmm_launch(const void* x, const void* s, const void* qw,
                              const void* sizes, void* out, void* q,
                              void* sexp, int E, int C, int N, int K,
                              int x_bf16, int e5m2, int w_e5m2, int vec,
                              float fmax, float inv_ln2, void* stream) {
  dim3 grid((C + fqt::BM - 1) / fqt::BM, (N + fqt::BN - 1) / fqt::BN, E);
  moe_gmm_kernel<<<grid, fqt::THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<const float*>(s), static_cast<const uint8_t*>(qw),
      static_cast<const int*>(sizes), static_cast<float*>(out),
      static_cast<uint8_t*>(q), static_cast<int8_t*>(sexp), C, N, K,
      x_bf16 != 0, e5m2 != 0, w_e5m2 != 0, vec != 0, fmax, inv_ln2);
  return static_cast<int>(cudaGetLastError());
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
