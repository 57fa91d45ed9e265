// Decode attention for Hopper, over the floating page pool or over a
// contiguous (ring) cache: one query position per slot (decode), or
// q_len draft positions per slot (the speculative verify step).
//
// Replaces the TPU kernels (q_len >= 1)
//   src/repro/kernels/decode_attn.py:decode_attn_paged_pallas  (paged)
//   src/repro/kernels/decode_attn.py:decode_attn_pallas        (contiguous)
// Batch row b and kv head h hold R = q_len * G query rows, draft-major:
// row r belongs to draft j = r / G and sees the live slots t < n_r,
//     n_r = min(n_valid[b] - (q_len - 1 - j), NP * T)
// (n_valid is the depth after this step's write; at q_len = 1 every row
// sees t < min(n_valid[b], NP * T)).  Over those slots
//     s_t = (q . k_t) * sm_scale * k_scale[t]       (bf16-rounded q and k)
//     w_t = exp(s_t - max s) / sum exp(s - max s) * v_scale[t]
//     out = sum_t bf16(w_t) * v_t
// in f32, the operation order of the reference einsum path.  The cache is
// e4m3 with per-(token, kv-head) f32 scales, or bf16 without scales.
//   paged:      slot t lives in physical page block_table[b, t / T] at
//               offset t % T of the (P, KV, T, Dh) pool;
//   contiguous: T is C and NP is 1; slot t lives at (b, h, t) of the
//               (B, KV, C, Dh) cache.  A wrapped ring (n_valid >= C) is
//               fully live, and slot order does not matter to the softmax
//               (q_len > 1 needs an unwrapped cache: the wrapper checks).
//
// What bounds it on the H100: the live KV bytes, 2 * n * Dh * (1 or 2)
// bytes per (b, h) plus the scales, over 3.35 TB/s (h2o-danube-3-4b's
// decode, B 4, KV 8, C 4096, Dh 120, fp8: ~32 MB, ~9.7 us).  The q_len
// draft rows share that one read.
//
// The simple design: one block per (b, kv head, 8 query rows); four warps
// walk the slots, so no slot past the block's largest n_r is ever
// touched.  Three passes over the slots recompute q . k (the keys of one
// row stay in L1/L2): the max, the sum of exponentials, then the weighted
// sum of V.  This keeps the reference's order (divide by the sum before
// the bf16 rounding of the weights) at any context length with no
// shared-memory ceiling.  Lane l holds head dims l, l + 32, ... (DPL of
// them: 4 up to Dh 128, 8 up to Dh 256); lanes past Dh hold zeros.  The
// two layouts share this kernel and differ only in the slot address, so
// they sum in one order: the same bytes give the same bits through
// either.
//
// Per-row limits (q_len > 1): the block's rows differ in limit by at most
// q_len - 1 slots.  Each pass walks the slots below the least limit with
// no check, then the few up to the largest, where a row whose limit is
// passed keeps its state (a select, not a masked term: a zero term would
// still move the compensated sum, and 0 * v turns a NaN in a rejected
// draft's or a trash page's bytes into the sum).  A warp visits its slots
// (t % 4) in the same order whatever the limits, and both stretches
// compute a row's update with the same operations, so each row sums in
// the order of a q_len = 1 launch at its own limit: draft j's row is
// bitwise that launch's output.  At q_len = 1 every limit is the same and
// the checked stretch is empty.
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
// and NP is 1.  R = q_len * G.
template <bool FP8, bool PAGED, int DPL>
__global__ void __launch_bounds__(da::WARPS * 32)
decode_attn_kernel(const float* __restrict__ q, const void* __restrict__ k,
                   const void* __restrict__ v,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   const int* __restrict__ n_valid,
                   const int* __restrict__ block_table,
                   float* __restrict__ out, int KV, int R, int G, int Dh,
                   int T, int NP, float sm_scale) {
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
  // each row's limit (the block's rows past R, never stored, take the
  // last draft's), and the least and largest of them
  const int q_len = R / G;
  int lim[da::ROWS];
  int lo = NP * T, hi = 0;
#pragma unroll
  for (int r = 0; r < da::ROWS; ++r) {
    const int j = min((r0 + r) / G, q_len - 1);
    lim[r] = min(n_valid[b] - (q_len - 1 - j), NP * T);
    lo = min(lo, lim[r]);
    hi = max(hi, lim[r]);
  }
  const int* bt = PAGED ? block_table + static_cast<size_t>(b) * NP : nullptr;

  // visit(t, live) for this warp's slots t below hi: below lo every row
  // is live, above it live(r) tests row r's limit
  auto walk = [&](auto&& visit) {
    int t = warp;
    for (; t < lo; t += da::WARPS) visit(t, [](int) { return true; });
    for (; t < hi; t += da::WARPS)
      visit(t, [&](int r) { return t < lim[r]; });
  };

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
  walk([&](int t, auto live) {
    float s[da::ROWS];
    size_t slot;
    scores(t, s, slot);
#pragma unroll
    for (int r = 0; r < da::ROWS; ++r)
      mx[r] = live(r) ? fmaxf(mx[r], s[r]) : mx[r];
  });
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
  walk([&](int t, auto live) {
    float s[da::ROWS];
    size_t slot;
    scores(t, s, slot);
#pragma unroll
    for (int r = 0; r < da::ROWS; ++r) {
      const float y = expf(s[r] - mx[r]) - comp[r];
      const float u = sum[r] + y;
      const float c = (u - sum[r]) - y;
      const bool ok = live(r);
      comp[r] = ok ? c : comp[r];
      sum[r] = ok ? u : sum[r];
    }
  });
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
  walk([&](int t, auto live) {
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
      const bool ok = live(r);
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const float a = fmaf(w, vf[i], acc[r][i]);
        acc[r][i] = ok ? a : acc[r][i];
      }
    }
  });
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
                       float* o, int KV, int R, int G, int Dh, int T,
                       int NP, float sm_scale) {
  if (Dh <= 128)
    decode_attn_kernel<FP8, PAGED, 4><<<grid, da::WARPS * 32, 0, st>>>(
        q, k, v, ks, vs, nv, bt, o, KV, R, G, Dh, T, NP, sm_scale);
  else
    decode_attn_kernel<FP8, PAGED, 8><<<grid, da::WARPS * 32, 0, st>>>(
        q, k, v, ks, vs, nv, bt, o, KV, R, G, Dh, T, NP, sm_scale);
}

template <bool PAGED>
static int launch(const void* q, const void* k, const void* v,
                  const void* k_scale, const void* v_scale,
                  const void* n_valid, const void* block_table, void* out,
                  int B, int KV, int R, int q_len, int Dh, int T, int NP,
                  float sm_scale, int fp8, void* stream) {
  if (Dh > 256 || q_len < 1 || R % q_len)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = R / q_len;
  dim3 grid(B, KV, (R + da::ROWS - 1) / da::ROWS);
  auto st = static_cast<cudaStream_t>(stream);
  auto qf = static_cast<const float*>(q);
  auto ks = static_cast<const float*>(k_scale);
  auto vs = static_cast<const float*>(v_scale);
  auto nv = static_cast<const int*>(n_valid);
  auto bt = static_cast<const int*>(block_table);
  auto o = static_cast<float*>(out);
  if (fp8)
    launch_dpl<true, PAGED>(grid, st, qf, k, v, ks, vs, nv, bt, o, KV, R, G,
                            Dh, T, NP, sm_scale);
  else
    launch_dpl<false, PAGED>(grid, st, qf, k, v, ks, vs, nv, bt, o, KV, R,
                             G, Dh, T, NP, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int decode_attn_paged_launch(const void* q, const void* k,
                                        const void* v, const void* k_scale,
                                        const void* v_scale,
                                        const void* n_valid,
                                        const void* block_table, void* out,
                                        int B, int KV, int R, int q_len,
                                        int Dh, int T, int NP,
                                        float sm_scale, int fp8,
                                        void* stream) {
  return launch<true>(q, k, v, k_scale, v_scale, n_valid, block_table, out,
                      B, KV, R, q_len, Dh, T, NP, sm_scale, fp8, stream);
}

extern "C" int decode_attn_launch(const void* q, const void* k, const void* v,
                                  const void* k_scale, const void* v_scale,
                                  const void* n_valid, void* out, int B,
                                  int KV, int R, int q_len, int Dh, int C,
                                  float sm_scale, int fp8, void* stream) {
  return launch<false>(q, k, v, k_scale, v_scale, n_valid, nullptr, out, B,
                       KV, R, q_len, Dh, C, 1, sm_scale, fp8, stream);
}
