// Decode attention for Hopper (one query position per slot), over the
// floating page pool or over a contiguous (ring) cache.
//
// Replaces the TPU kernels (q_len = 1)
//   src/repro/kernels/decode_attn.py:decode_attn_paged_pallas  (paged)
//   src/repro/kernels/decode_attn.py:decode_attn_pallas        (contiguous)
// For batch row b and kv head h, over the live slots t < n:
//     s_t = (q . k_t) * sm_scale * k_scale[t]       (bf16-rounded q and k)
//     w_t = exp(s_t - max s) / sum exp(s - max s) * v_scale[t]
//     out = sum_t bf16(w_t) * v_t
// in f32, the operation order of the reference einsum path.  The cache is
// e4m3 with per-(token, kv-head) f32 scales, or bf16 without scales.
//   paged:      n = min(n_valid[b], NP * T); slot t lives in physical page
//               block_table[b, t / T] at offset t % T of the (P, KV, T, Dh)
//               pool;
//   contiguous: n = min(n_valid[b], C); slot t lives at (b, h, t) of the
//               (B, KV, C, Dh) cache.  A wrapped ring (n_valid >= C) is
//               fully live, and slot order does not matter to the softmax.
//
// What bounds it on the H100: the live KV bytes, 2 * n * Dh * (1 or 2)
// bytes per (b, h) plus the scales, over 3.35 TB/s (h2o-danube-3-4b's
// decode, B 4, KV 8, C 4096, Dh 120, fp8: ~32 MB, ~9.7 us).
//
// The simple design: one block per (b, kv head, 8 query rows); four warps
// walk the live slots, so no slot past n is ever touched.  Three passes
// over the live slots recompute q . k (the keys of one row stay in L1/L2):
// the max, the sum of exponentials, then the weighted sum of V.  This keeps
// the reference's order (divide by the sum before the bf16 rounding of the
// weights) at any context length with no shared-memory ceiling.  Lane l
// holds head dims l, l + 32, ... (DPL of them: 4 up to Dh 128, 8 up to Dh
// 256); lanes past Dh hold zeros.  The two layouts share this kernel and
// differ only in the slot address, so they sum in one order: the same
// bytes give the same bits through either.
#include "common.cuh"

namespace da {
constexpr int ROWS = 8;      // query rows per block
constexpr int WARPS = 4;
}  // namespace da

template <bool FP8>
__device__ __forceinline__ float kv_elem(const void* base, size_t i) {
  if constexpr (FP8)
    return fp8_to_float(static_cast<const uint8_t*>(base)[i], false);
  else
    return __bfloat162float(static_cast<const __nv_bfloat16*>(base)[i]);
}

// PAGED: T is the page size and NP the pages per slot; contiguous: T is C
// and NP is 1.
template <bool FP8, bool PAGED, int DPL>
__global__ void __launch_bounds__(da::WARPS * 32)
decode_attn_kernel(const float* __restrict__ q, const void* __restrict__ k,
                   const void* __restrict__ v,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   const int* __restrict__ n_valid,
                   const int* __restrict__ block_table,
                   float* __restrict__ out, int KV, int R, int Dh, int T,
                   int NP, float sm_scale) {
  __shared__ float qs[da::ROWS][DPL * 32];
  __shared__ float stat[da::WARPS][da::ROWS];
  __shared__ float red[da::WARPS][da::ROWS][DPL * 32];
  const int b = blockIdx.x, h = blockIdx.y, r0 = blockIdx.z * da::ROWS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rows = min(da::ROWS, R - r0);
  const float* qb = q + ((static_cast<size_t>(b) * KV + h) * R + r0) * Dh;
  for (int i = threadIdx.x; i < da::ROWS * DPL * 32; i += da::WARPS * 32) {
    const int r = i / (DPL * 32), d = i % (DPL * 32);
    qs[r][d] = (r < rows && d < Dh) ? bf16_round(qb[r * Dh + d]) : 0.f;
  }
  __syncthreads();
  const int n = min(n_valid[b], NP * T);
  const int* bt = PAGED ? block_table + static_cast<size_t>(b) * NP : nullptr;

  // score of slot t for every row, in every lane; also hands back the
  // slot's flat index for the scale arrays
  auto scores = [&](int t, float s[da::ROWS], size_t& slot) {
    if constexpr (PAGED)
      slot = (static_cast<size_t>(bt[t / T]) * KV + h) * T + t % T;
    else
      slot = (static_cast<size_t>(b) * KV + h) * T + t;
    float kf[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      kf[i] = d < Dh ? kv_elem<FP8>(k, slot * Dh + d) : 0.f;
    }
    float ks = 1.f;
    if constexpr (FP8) ks = k_scale[slot];
#pragma unroll
    for (int r = 0; r < da::ROWS; ++r) {
      float p = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) p = fmaf(qs[r][lane + 32 * i], kf[i], p);
      p = warp_sum(p) * sm_scale;
      if constexpr (FP8) p *= ks;
      s[r] = p;
    }
  };

  // pass 1: row max
  float mx[da::ROWS];
#pragma unroll
  for (int r = 0; r < da::ROWS; ++r) mx[r] = -__int_as_float(0x7f800000);  // -inf
  for (int t = warp; t < n; t += da::WARPS) {
    float s[da::ROWS];
    size_t slot;
    scores(t, s, slot);
#pragma unroll
    for (int r = 0; r < da::ROWS; ++r) mx[r] = fmaxf(mx[r], s[r]);
  }
  if (lane == 0)
#pragma unroll
    for (int r = 0; r < da::ROWS; ++r) stat[warp][r] = mx[r];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < da::ROWS; ++r) {
    float m = stat[0][r];
    for (int w = 1; w < da::WARPS; ++w) m = fmaxf(m, stat[w][r]);
    mx[r] = m;
  }
  __syncthreads();

  // pass 2: sum of exponentials, compensated (Kahan): a warp adds up to
  // C / 4 terms one after another, and a plain f32 running sum drifts by
  // ~1e-6 relative over a 4096-slot ring, enough to flip the bf16
  // rounding of the weights against the plain version's reduction
  float sum[da::ROWS], comp[da::ROWS];
#pragma unroll
  for (int r = 0; r < da::ROWS; ++r) sum[r] = comp[r] = 0.f;
  for (int t = warp; t < n; t += da::WARPS) {
    float s[da::ROWS];
    size_t slot;
    scores(t, s, slot);
#pragma unroll
    for (int r = 0; r < da::ROWS; ++r) {
      const float y = expf(s[r] - mx[r]) - comp[r];
      const float u = sum[r] + y;
      comp[r] = (u - sum[r]) - y;
      sum[r] = u;
    }
  }
  if (lane == 0)
#pragma unroll
    for (int r = 0; r < da::ROWS; ++r) stat[warp][r] = sum[r];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < da::ROWS; ++r) {
    float l = 0.f;
    for (int w = 0; w < da::WARPS; ++w) l += stat[w][r];
    sum[r] = l;
  }

  // pass 3: weighted sum of V
  float acc[da::ROWS][DPL];
#pragma unroll
  for (int r = 0; r < da::ROWS; ++r)
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  for (int t = warp; t < n; t += da::WARPS) {
    float s[da::ROWS];
    size_t slot;
    scores(t, s, slot);
    float vs = 1.f;
    if constexpr (FP8) vs = v_scale[slot];
    float vf[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      vf[i] = d < Dh ? kv_elem<FP8>(v, slot * Dh + d) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < da::ROWS; ++r) {
      float w = expf(s[r] - mx[r]) / sum[r];
      if constexpr (FP8) w *= vs;
      w = bf16_round(w);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(w, vf[i], acc[r][i]);
    }
  }
#pragma unroll
  for (int r = 0; r < da::ROWS; ++r)
#pragma unroll
    for (int i = 0; i < DPL; ++i) red[warp][r][lane + 32 * i] = acc[r][i];
  __syncthreads();
  float* ob = out + ((static_cast<size_t>(b) * KV + h) * R + r0) * Dh;
  for (int i = threadIdx.x; i < rows * Dh; i += da::WARPS * 32) {
    const int r = i / Dh, d = i % Dh;
    float o = 0.f;
    for (int w = 0; w < da::WARPS; ++w) o += red[w][r][d];
    ob[r * Dh + d] = o;
  }
}

template <bool FP8, bool PAGED>
static void launch_dpl(dim3 grid, cudaStream_t st, const float* q,
                       const void* k, const void* v, const float* ks,
                       const float* vs, const int* nv, const int* bt,
                       float* o, int KV, int R, int Dh, int T, int NP,
                       float sm_scale) {
  if (Dh <= 128)
    decode_attn_kernel<FP8, PAGED, 4><<<grid, da::WARPS * 32, 0, st>>>(
        q, k, v, ks, vs, nv, bt, o, KV, R, Dh, T, NP, sm_scale);
  else
    decode_attn_kernel<FP8, PAGED, 8><<<grid, da::WARPS * 32, 0, st>>>(
        q, k, v, ks, vs, nv, bt, o, KV, R, Dh, T, NP, sm_scale);
}

template <bool PAGED>
static int launch(const void* q, const void* k, const void* v,
                  const void* k_scale, const void* v_scale,
                  const void* n_valid, const void* block_table, void* out,
                  int B, int KV, int R, int Dh, int T, int NP,
                  float sm_scale, int fp8, void* stream) {
  if (Dh > 256) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(B, KV, (R + da::ROWS - 1) / da::ROWS);
  auto st = static_cast<cudaStream_t>(stream);
  auto qf = static_cast<const float*>(q);
  auto ks = static_cast<const float*>(k_scale);
  auto vs = static_cast<const float*>(v_scale);
  auto nv = static_cast<const int*>(n_valid);
  auto bt = static_cast<const int*>(block_table);
  auto o = static_cast<float*>(out);
  if (fp8)
    launch_dpl<true, PAGED>(grid, st, qf, k, v, ks, vs, nv, bt, o, KV, R, Dh,
                            T, NP, sm_scale);
  else
    launch_dpl<false, PAGED>(grid, st, qf, k, v, ks, vs, nv, bt, o, KV, R,
                             Dh, T, NP, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int decode_attn_paged_launch(const void* q, const void* k,
                                        const void* v, const void* k_scale,
                                        const void* v_scale,
                                        const void* n_valid,
                                        const void* block_table, void* out,
                                        int B, int KV, int R, int Dh, int T,
                                        int NP, float sm_scale, int fp8,
                                        void* stream) {
  return launch<true>(q, k, v, k_scale, v_scale, n_valid, block_table, out,
                      B, KV, R, Dh, T, NP, sm_scale, fp8, stream);
}

extern "C" int decode_attn_launch(const void* q, const void* k, const void* v,
                                  const void* k_scale, const void* v_scale,
                                  const void* n_valid, void* out, int B,
                                  int KV, int R, int Dh, int C,
                                  float sm_scale, int fp8, void* stream) {
  return launch<false>(q, k, v, k_scale, v_scale, n_valid, nullptr, out, B,
                       KV, R, Dh, C, 1, sm_scale, fp8, stream);
}
