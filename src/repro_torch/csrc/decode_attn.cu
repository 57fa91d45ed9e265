// Paged decode attention for Hopper (one query position per slot).
//
// Replaces the TPU kernel
// src/repro/kernels/decode_attn.py:decode_attn_paged_pallas (q_len = 1).
// For batch row b and kv head h, over the logical slots t < n =
// min(n_valid[b], NP * T), slot t living in physical page
// block_table[b, t / T] at offset t % T of the (P, KV, T, Dh) pool:
//     s_t = (q . k_t) * sm_scale * k_scale[t]       (bf16-rounded q and k)
//     w_t = exp(s_t - max s) / sum exp(s - max s) * v_scale[t]
//     out = sum_t bf16(w_t) * v_t
// in f32, the operation order of the reference einsum path.  The pool is
// e4m3 with per-(token, kv-head) f32 scales, or bf16 without scales.
//
// What bounds it on the H100: the KV bytes of the live pages,
// 2 * n * Dh * (1 or 2) bytes per (b, h) plus the scales, over 3.35
// TB/s; at phi3-mini decode (Dh = 96, short contexts) that is small
// beside the weight stream of the GEMMs.
//
// The simple design: one block per (b, kv head, 8 query rows); four warps
// walk the live slots, each block reading its own block-table entries,
// so no page past the frontier is ever touched and stale pages never
// enter the sums.  Three passes over the live slots recompute q . k
// (the keys of one row stay in L1/L2): the max, the sum of exponentials,
// then the weighted sum of V.  This keeps the reference's order (divide
// by the sum before the bf16 rounding of the weights) at any context
// length with no shared-memory ceiling.  Lane l holds head dims l, l+32,
// l+64, l+96 (Dh <= 128).
#include "common.cuh"

namespace da {
constexpr int ROWS = 8;      // query rows per block
constexpr int WARPS = 4;
constexpr int DPL = 4;       // head dims per lane: Dh <= 128
}  // namespace da

template <bool FP8>
__device__ __forceinline__ float kv_elem(const void* base, size_t i) {
  if constexpr (FP8)
    return fp8_to_float(static_cast<const uint8_t*>(base)[i], false);
  else
    return __bfloat162float(static_cast<const __nv_bfloat16*>(base)[i]);
}

template <bool FP8>
__global__ void __launch_bounds__(da::WARPS * 32)
decode_attn_paged_kernel(const float* __restrict__ q, const void* __restrict__ k,
                         const void* __restrict__ v,
                         const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale,
                         const int* __restrict__ n_valid,
                         const int* __restrict__ block_table,
                         float* __restrict__ out, int KV, int R, int Dh, int T,
                         int NP, float sm_scale) {
  __shared__ float qs[da::ROWS][da::DPL * 32];
  __shared__ float stat[da::WARPS][da::ROWS];
  __shared__ float red[da::WARPS][da::ROWS][da::DPL * 32];
  const int b = blockIdx.x, h = blockIdx.y, r0 = blockIdx.z * da::ROWS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rows = min(da::ROWS, R - r0);
  const float* qb = q + ((static_cast<size_t>(b) * KV + h) * R + r0) * Dh;
  for (int i = threadIdx.x; i < da::ROWS * da::DPL * 32; i += da::WARPS * 32) {
    const int r = i / (da::DPL * 32), d = i % (da::DPL * 32);
    qs[r][d] = (r < rows && d < Dh) ? bf16_round(qb[r * Dh + d]) : 0.f;
  }
  __syncthreads();
  const int n = min(n_valid[b], NP * T);
  const int* bt = block_table + static_cast<size_t>(b) * NP;

  // score of slot t for every row, in every lane; also hands back the
  // slot's flat (page, h, offset) index for the scale arrays
  auto scores = [&](int t, float s[da::ROWS], size_t& slot) {
    const int page = bt[t / T];
    slot = (static_cast<size_t>(page) * KV + h) * T + t % T;
    float kf[da::DPL];
#pragma unroll
    for (int i = 0; i < da::DPL; ++i) {
      const int d = lane + 32 * i;
      kf[i] = d < Dh ? kv_elem<FP8>(k, slot * Dh + d) : 0.f;
    }
    float ks = 1.f;
    if constexpr (FP8) ks = k_scale[slot];
#pragma unroll
    for (int r = 0; r < da::ROWS; ++r) {
      float p = 0.f;
#pragma unroll
      for (int i = 0; i < da::DPL; ++i) p = fmaf(qs[r][lane + 32 * i], kf[i], p);
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

  // pass 2: sum of exponentials
  float sum[da::ROWS];
#pragma unroll
  for (int r = 0; r < da::ROWS; ++r) sum[r] = 0.f;
  for (int t = warp; t < n; t += da::WARPS) {
    float s[da::ROWS];
    size_t slot;
    scores(t, s, slot);
#pragma unroll
    for (int r = 0; r < da::ROWS; ++r) sum[r] += expf(s[r] - mx[r]);
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
  float acc[da::ROWS][da::DPL];
#pragma unroll
  for (int r = 0; r < da::ROWS; ++r)
#pragma unroll
    for (int i = 0; i < da::DPL; ++i) acc[r][i] = 0.f;
  for (int t = warp; t < n; t += da::WARPS) {
    float s[da::ROWS];
    size_t slot;
    scores(t, s, slot);
    float vs = 1.f;
    if constexpr (FP8) vs = v_scale[slot];
    float vf[da::DPL];
#pragma unroll
    for (int i = 0; i < da::DPL; ++i) {
      const int d = lane + 32 * i;
      vf[i] = d < Dh ? kv_elem<FP8>(v, slot * Dh + d) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < da::ROWS; ++r) {
      float w = expf(s[r] - mx[r]) / sum[r];
      if constexpr (FP8) w *= vs;
      w = bf16_round(w);
#pragma unroll
      for (int i = 0; i < da::DPL; ++i) acc[r][i] = fmaf(w, vf[i], acc[r][i]);
    }
  }
#pragma unroll
  for (int r = 0; r < da::ROWS; ++r)
#pragma unroll
    for (int i = 0; i < da::DPL; ++i) red[warp][r][lane + 32 * i] = acc[r][i];
  __syncthreads();
  float* ob = out + ((static_cast<size_t>(b) * KV + h) * R + r0) * Dh;
  for (int i = threadIdx.x; i < rows * Dh; i += da::WARPS * 32) {
    const int r = i / Dh, d = i % Dh;
    float o = 0.f;
    for (int w = 0; w < da::WARPS; ++w) o += red[w][r][d];
    ob[r * Dh + d] = o;
  }
}

extern "C" int decode_attn_paged_launch(const void* q, const void* k,
                                        const void* v, const void* k_scale,
                                        const void* v_scale,
                                        const void* n_valid,
                                        const void* block_table, void* out,
                                        int B, int KV, int R, int Dh, int T,
                                        int NP, float sm_scale, int fp8,
                                        void* stream) {
  dim3 grid(B, KV, (R + da::ROWS - 1) / da::ROWS);
  auto st = static_cast<cudaStream_t>(stream);
  auto qf = static_cast<const float*>(q);
  auto ks = static_cast<const float*>(k_scale);
  auto vs = static_cast<const float*>(v_scale);
  auto nv = static_cast<const int*>(n_valid);
  auto bt = static_cast<const int*>(block_table);
  auto o = static_cast<float*>(out);
  if (fp8)
    decode_attn_paged_kernel<true><<<grid, da::WARPS * 32, 0, st>>>(
        qf, k, v, ks, vs, nv, bt, o, KV, R, Dh, T, NP, sm_scale);
  else
    decode_attn_paged_kernel<false><<<grid, da::WARPS * 32, 0, st>>>(
        qf, k, v, ks, vs, nv, bt, o, KV, R, Dh, T, NP, sm_scale);
  return static_cast<int>(cudaGetLastError());
}
