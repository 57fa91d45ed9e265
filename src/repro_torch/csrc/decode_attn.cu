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
//     w_t = bf16(exp(s_t - max s) / sum exp(s - max s) * v_scale[t])
//     out = sum_t w_t * v_t
// in f32, the operation order of the reference einsum path: the max is
// exact, the weights are rounded to bf16 after the division, so the
// global max and sum must be known before any V is weighted (a split
// that rescales partial outputs afterwards computes another function).
// The cache is e4m3 with per-(token, kv-head) f32 scales, or bf16.
//   paged:      slot t lives in physical page block_table[b, t / T] at
//               offset t % T of the (P, KV, T, Dh) pool;
//   contiguous: T is C and NP is 1; slot t lives at (b, h, t) of the
//               (B, KV, C, Dh) cache.  A wrapped ring (n_valid >= C) is
//               fully live, and slot order does not matter to the softmax
//               (q_len > 1 needs an unwrapped cache: the wrapper checks).
//
// What bounds it on the H100: the live KV bytes, 2 * n * Dh * (1 or 2)
// bytes per (b, h) plus the scales, over 3.35 TB/s (h2o-danube-3-4b's
// decode, B 4, KV 8, C 4096, Dh 120, fp8: ~17 MB, ~5 us).  The R rows
// share that one read; their products (4 * n * R * Dh operations) stay
// far below the card's rate.
//
// The design: one thread-block cluster of CL = 8 CTAs of 256 threads per
// (b, kv head), so that h2o's 32 (b, h) pairs fill 256 CTAs and
// recurrentgemma-2b's 4 pairs 32.  The slots are cut into chunks of CH =
// 32; chunk c belongs to the CTA of rank c % CL, which keeps its chunks'
// slots, in order, as its local slots u.  Split boundaries are fixed
// multiples of CH and the owner of a slot depends on t alone, never on
// the capacity, q_len, the other rows' limits or the number of SMs.  A
// CTA touches no slot at or past its rows' largest limit, and one that
// holds no chunk below it leaves after the cluster's opening barrier: the
// active CTAs then meet at barriers of their own (mbarriers in each one's
// shared memory).  In one launch:
//   1. scores: the CTA first reads every local slot's row index (the
//      block table) at once.  A thread owns a slot, two at a time where
//      a sweep takes at most 4 rows: it asks for their scales and K rows
//      together (16- or 8-byte loads, 64-byte blocks) and takes the dot
//      product of every row against q in shared memory, each row's sum
//      in head-dim order.  The products of bf16 q and k are exact in f32
//      (e4m3 k: 12 significant bits; bf16 k: 16); their sum rounds only
//      where a product's low bits fall below the running sum's ulp: rare
//      with e4m3 k, whose sums stay f32, and common enough with bf16 k
//      that its sums run in f64 (a 96-term f32 chain there flipped a
//      bf16 weight that put phi3-mini's bf16 verify form past
//      chip_smoke's attn_limit).  Each score is computed once and kept
//      in shared memory beside the slot's row index and V scale (past
//      SCORES_SMEM_MAX bytes, in a scratch buffer the wrapper
//      allocates).  Per-row maxima: thread, warp (shuffles, once per
//      row), CTA, then the active CTAs through distributed shared
//      memory.
//   2. p = exp(s - max) in place; per-row sums in f64 in a fixed tree
//      (each thread's slots in order, warp butterfly, warps in order,
//      then the CTAs in rank order), rounded to f32 once: every CTA
//      holds the same L, the correctly rounded sum of the p.
//   3. w = bf16(p / L * v_scale) in place (__fdiv_rn, __fmul_rn: pinned
//      roundings, as nvcc could otherwise contract).
//   4. V: a thread owns 8 head dims of every SG-th local slot (SG =
//      threads / (Dh / 8), a function of Dh alone), the next 4 (bf16: 2)
//      slots' loads in flight while it adds these, fmaf into f32; its partial
//      sums are added over the slot groups in order, then over the CTAs
//      in rank order.
// An inactive CTA's terms are the identities of these combines (-inf,
// +0, +0), so leaving it out changes no bit.  No floating-point atomics;
// every sum's order depends only on slot indices and on the row's own
// limit.  The two layouts differ only in the slot address, so the same
// bytes give the same bits through either, and a cache of another
// capacity with the same live bytes gives the same bits.
//
// Per-row limits (q_len > 1): a row whose limit is passed keeps its state
// by a select, never by adding a masked term (0 * v turns a NaN in a
// rejected draft's or a trash page's bytes into the sum).  Each row's
// arithmetic is then that of a q_len = 1 launch at its own limit, so
// draft j's rows are bitwise that launch's output.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace da {
constexpr int CL = 8;          // CTAs per cluster, one cluster per (b, h)
constexpr int CH = 32;         // slots per chunk
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// rows per sweep of the V pass (at most) and CTAs an SM holds (the
// register budget: 80 or 128 a thread): launches of more than 4 rows
// take the wide instance, whose CTAs' shared memory holds them to 2 an
// SM anyway (with e4m3 k; bf16 k keeps sweeps of 4, whose smaller
// slot-group buffer keeps 2 an SM beside its f64 q)
constexpr int RBV = 4, RBV_WIDE = 8;
constexpr int MIN_BLOCKS = 3, MIN_BLOCKS_WIDE = 2;
constexpr int NBARS = 4;       // the active CTAs' barriers
constexpr int VE = 8;          // head dims per group
constexpr int BLK_BYTES = 64;  // bytes of a K row per load block
// scores kept in shared memory up to this many bytes a CTA; past it the
// wrapper passes a scratch buffer (kernels/decode_attn.py mirrors it)
constexpr int SCORES_SMEM_MAX = 96 * 1024;
}  // namespace da

// local slots a CTA holds room for: its share of the chunks below cap
__host__ __device__ inline int da_local_slots(int cap) {
  const int chunks = (cap + da::CH - 1) / da::CH;
  return (chunks + da::CL - 1) / da::CL * da::CH;
}

__host__ __device__ inline int da_round4(int n) { return (n + 3) & ~3; }

// The dynamic shared memory of one CTA, offsets in floats (each a
// multiple of 4: 16-byte aligned).  qs (R, Dh padded to 8) holds floats
// (e4m3 k) or doubles (bf16 k); part (R, Dh), the CTA's partial output,
// reuses it once the scores are taken; wred (per-warp maxima, then
// per-warp sums) and csum hold doubles, bars the mbarriers.
struct DaSmem {
  int qs, sc, red, wred, cmax, csum, gstat, lim, bars, total;
  __host__ __device__ DaSmem(int R, int Dh, int U, bool scores_here,
                             bool fp8) {
    const int groups = (Dh + da::VE - 1) / da::VE, dp = groups * da::VE;
    const int sg = da::THREADS / groups;
    const int rmax = fp8 ? da::RBV_WIDE : da::RBV;
    const int rbv = R < rmax ? R : rmax;
    qs = 0;
    sc = qs + (fp8 ? 1 : 2) * R * dp;
    red = sc + (scores_here ? (R + 2) * U : 0);
    wred = red + sg * rbv * dp;
    cmax = wred + da_round4(2 * da::WARPS * R);
    csum = cmax + da_round4(R);
    gstat = csum + da_round4(2 * R);
    lim = gstat + da_round4(2 * R);
    bars = lim + da_round4(R);
    total = bars + 2 * da::NBARS;
  }
};

// Slot t of CTA `rank`'s local slot u.
__device__ __forceinline__ int chunk_slot(int u, int rank) {
  return (rank + (u / da::CH) * da::CL) * da::CH + u % da::CH;
}

// The flat (row) index of slot t of (b, h) in the k/v arrays and the
// scale arrays.
template <bool PAGED>
__device__ __forceinline__ size_t slot_index(const int* bt, int b, int h,
                                             int t, int KV, int T) {
  if constexpr (PAGED)
    return (static_cast<size_t>(bt[t / T]) * KV + h) * T + t % T;
  else
    return (static_cast<size_t>(b) * KV + h) * T + t;
}

__device__ __forceinline__ uint32_t da_prmt(uint32_t a, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(0u), "r"(sel));
  return d;
}

// Four e4m3 bytes of a word -> f32 (exact), low byte first, on the
// integer pipe (as wgmma.cuh's fp8x16_to_bf16): prmt puts two bytes each
// in the low byte of a 16-bit half with its sign replicated above it; a
// shift and a mask leave f32 bits with the sign at bit 31 and exponent
// and mantissa under f32's, which read q * 2^-120 (subnormals included),
// and one multiply by 2^120 gives q.  The conversion instructions (cvt)
// issue at 16 a clock per SM, a quarter of the integer pipe's rate.
// (fp8 NaN, which the saturating quantizer never writes, reads as 480.)
__device__ __forceinline__ void e4m3x4(uint32_t w, float* f) {
  const uint32_t a = da_prmt(w, 0x9180u), c = da_prmt(w, 0xB3A2u);
  f[0] = __uint_as_float((a << 20) & 0x87f00000u) * 0x1p120f;
  f[1] = __uint_as_float((a << 4) & 0x87f00000u) * 0x1p120f;
  f[2] = __uint_as_float((c << 20) & 0x87f00000u) * 0x1p120f;
  f[3] = __uint_as_float((c << 4) & 0x87f00000u) * 0x1p120f;
}

// Two bf16 of a word -> f32 (exact), low half first.
__device__ __forceinline__ void bf16x2(uint32_t w, float* f) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}

// Element group g (VE values) of a block of words, as f32.
template <bool FP8, int WORDS>
__device__ __forceinline__ void group_values(const uint32_t (&w)[WORDS],
                                             int g, float f[da::VE]) {
  if constexpr (FP8) {
    e4m3x4(w[2 * g], f);
    e4m3x4(w[2 * g + 1], f + 4);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) bf16x2(w[4 * g + i], f + 2 * i);
  }
}

// `nb` valid bytes at p (a multiple of vb when vb is 16 or 8, and p is
// then vb-aligned) into WORDS words, zeros past them; vb 0: byte loads.
template <int WORDS>
__device__ __forceinline__ void load_words(const uint8_t* p, int nb, int vb,
                                           uint32_t (&w)[WORDS]) {
  if (vb == 16) {
#pragma unroll
    for (int i = 0; i < WORDS / 4; ++i) {
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (16 * i < nb) x = __ldg(reinterpret_cast<const uint4*>(p) + i);
      w[4 * i] = x.x;
      w[4 * i + 1] = x.y;
      w[4 * i + 2] = x.z;
      w[4 * i + 3] = x.w;
    }
  } else if (vb == 8) {
#pragma unroll
    for (int i = 0; i < WORDS / 2; ++i) {
      uint2 x = make_uint2(0u, 0u);
      if (8 * i < nb) x = __ldg(reinterpret_cast<const uint2*>(p) + i);
      w[2 * i] = x.x;
      w[2 * i + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < WORDS; ++i) {
      uint32_t x = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * i + j < nb) x |= static_cast<uint32_t>(p[4 * i + j]) << (8 * j);
      w[i] = x;
    }
  }
}

// The cluster's barriers among its active CTAs (those with live slots;
// the others have left).  Barrier i of every active CTA counts one arrival
// from each active CTA; one thread per target arrives with release
// semantics at cluster scope, and every thread waits on its own CTA's
// barrier with acquire semantics.  A wait that outlasts ~2^22 polls traps
// (a launch error) rather than hang the card.
__device__ __forceinline__ void da_arrive(uint64_t* bar, int target) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
  uint32_t ra;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(ra) : "r"(a), "r"(target));
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];"
      ::"r"(ra) : "memory");
}

__device__ __forceinline__ void da_wait(uint64_t* bar) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
  for (int i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "0;\n\tselp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(a) : "memory");
    if (done) return;
    if (i > (1 << 22)) __trap();
  }
}

// Barrier `i` of the active CTAs: this CTA's writes to its shared memory
// before it become visible to every active CTA after it.
__device__ __forceinline__ void da_barrier(uint64_t* bars, int i, int na) {
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < na) da_arrive(bars + i, threadIdx.x);
  da_wait(bars + i);
}

// What a CTA's passes share.
struct DaCtx {
  const void* qs;      // (R, dp) bf16-rounded q: f32 (e4m3 k) or f64
  float* sc;           // (R, U) scores, then p, then weights
  uint32_t* sidx;      // (U) each local slot's row index in k/v
  float* vscl;         // (U) each local slot's V scale
  float* wred;         // (WARPS, R) per-warp maxima
  float* red;          // (SG, rbv, dp) per-slot-group partial outputs
  float* part;         // (R, Dh) the CTA's partial output
  const int* lim;
  const uint8_t* kb;
  const uint8_t* vbytes;
  const float* k_scale;
  const float* v_scale;
  const int* bt;
  int b, h, KV, T, U, R, Dh, dp, groups, nu, rank, vb, cap;
  float sm_scale;
};

// Pass 1 for rows [rb, rb + NR): each row's score of every local slot,
// kept in c.sc, and the rows' per-warp maxima over their live slots in
// c.wred; the first sweep also keeps each slot's V scale.  A thread takes
// SP of its slots at a time: their scales and K rows (64-byte blocks) are
// asked for together, and each q value read serves them all.  (Asking L2
// ahead for the next slots' K rows or for the V rows moved nothing or
// competed with these loads.)  NR is the sweep's true row count
// (a fixed count with idle rows would issue their instructions all the
// same).
template <int NR, int SP, bool FP8, bool PAGED>
__device__ __forceinline__ void score_sweep(const DaCtx& c, int rb) {
  constexpr int ELT = FP8 ? 1 : 2;
  constexpr int BLK = da::BLK_BYTES / ELT;     // head dims per K block
  constexpr int BWORDS = da::BLK_BYTES / 4;
  const int tid = threadIdx.x;
  const bool first = rb == 0;
  const size_t row = static_cast<size_t>(c.Dh) * ELT;
  float mx[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) mx[r] = -__int_as_float(0x7f800000);
  for (int u0 = tid; u0 < c.nu; u0 += SP * da::THREADS) {
    bool ok[SP];
    size_t slot[SP];
    float ksc[SP];
#pragma unroll
    for (int j = 0; j < SP; ++j) {
      const int u = u0 + j * da::THREADS;
      ok[j] = u < c.nu;
      slot[j] = c.sidx[ok[j] ? u : u0];      // a spare slot reads u0's row
      ksc[j] = 1.f;
      if constexpr (FP8) ksc[j] = c.k_scale[slot[j]];
      if (first && ok[j]) {
        float vs = 1.f;
        if constexpr (FP8) vs = c.v_scale[slot[j]];
        c.vscl[u] = vs;
      }
    }
    // f32 sums of the products with e4m3 k, f64 with bf16 k (see the
    // head of this file)
    using Acc = std::conditional_t<FP8, float, double>;
    const Acc* qs = static_cast<const Acc*>(c.qs);
    Acc acc[SP][NR];
#pragma unroll
    for (int j = 0; j < SP; ++j)
#pragma unroll
      for (int r = 0; r < NR; ++r) acc[j][r] = 0;
    for (int e0 = 0; e0 < c.Dh; e0 += BLK) {
      uint32_t w[SP][BWORDS];
#pragma unroll
      for (int j = 0; j < SP; ++j)
        load_words<BWORDS>(c.kb + slot[j] * row + e0 * ELT,
                           min(c.Dh - e0, BLK) * ELT, c.vb, w[j]);
#pragma unroll
      for (int g = 0; g < BLK / da::VE; ++g) {
        if (e0 + g * da::VE < c.Dh) {
          const int d0 = e0 + g * da::VE;
          if constexpr (FP8) {
            // f32: each q value, read once, serves the SP slots
            float kf[SP][da::VE];
#pragma unroll
            for (int j = 0; j < SP; ++j)
              group_values<FP8, BWORDS>(w[j], g, kf[j]);
#pragma unroll
            for (int r = 0; r < NR; ++r) {
              const float4* qp =
                  reinterpret_cast<const float4*>(qs + (rb + r) * c.dp + d0);
              const float4 x = qp[0], y = qp[1];
#pragma unroll
              for (int j = 0; j < SP; ++j) {
                float sum = acc[j][r];
                sum = fmaf(x.x, kf[j][0], sum);
                sum = fmaf(x.y, kf[j][1], sum);
                sum = fmaf(x.z, kf[j][2], sum);
                sum = fmaf(x.w, kf[j][3], sum);
                sum = fmaf(y.x, kf[j][4], sum);
                sum = fmaf(y.y, kf[j][5], sum);
                sum = fmaf(y.z, kf[j][6], sum);
                sum = fmaf(y.w, kf[j][7], sum);
                acc[j][r] = sum;
              }
            }
          } else {
            // f64: a slot at a time, to keep the doubles in registers
#pragma unroll
            for (int j = 0; j < SP; ++j) {
              float kf[da::VE];
              group_values<FP8, BWORDS>(w[j], g, kf);
              double kd[da::VE];
#pragma unroll
              for (int i = 0; i < da::VE; ++i) kd[i] = kf[i];
#pragma unroll
              for (int r = 0; r < NR; ++r) {
                const double2* qp = reinterpret_cast<const double2*>(
                    qs + (rb + r) * c.dp + d0);
                double sum = acc[j][r];
#pragma unroll
                for (int i = 0; i < da::VE / 2; ++i) {
                  const double2 x = qp[i];
                  sum = __fma_rn(x.x, kd[2 * i], sum);
                  sum = __fma_rn(x.y, kd[2 * i + 1], sum);
                }
                acc[j][r] = sum;
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < SP; ++j) {
      if (!ok[j]) continue;
      const int u = u0 + j * da::THREADS;
      const int t = chunk_slot(u, c.rank);
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        float s = __fmul_rn(static_cast<float>(acc[j][r]), c.sm_scale);
        if constexpr (FP8) s = __fmul_rn(s, ksc[j]);
        c.sc[static_cast<size_t>(rb + r) * c.U + u] = s;
        mx[r] = t < c.lim[rb + r] ? fmaxf(mx[r], s) : mx[r];
      }
    }
  }
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const float m = warp_max(mx[r]);
    if (lane == 0) c.wred[warp * c.R + rb + r] = m;
  }
}

// Pass 4 for rows [rb, rb + NR): a thread owns 8 head dims of every
// SG-th local slot; the next VB slots' loads are in flight while it adds
// these VB.  Its partial sums go to c.red, then, added over the slot
// groups in order, to c.part.
template <int NR, bool FP8>
__device__ __forceinline__ void v_sweep(const DaCtx& c, int rb) {
  constexpr int ELT = FP8 ? 1 : 2;
  constexpr int GWORDS = da::VE * ELT / 4;     // words of a V group
  constexpr int VB = FP8 ? 4 : 2;              // slots a batch loads
  const int tid = threadIdx.x;
  const int sgs = da::THREADS / c.groups;
  const int sg = tid / c.groups, dv = tid - sg * c.groups;
  const int rbv = min(FP8 ? da::RBV_WIDE : da::RBV, c.R);
  const int d0 = dv * da::VE;
  const int gvb = FP8 ? min(c.vb, 8) : c.vb;   // a V group's load width
  const int gnb = min(c.Dh - d0, da::VE) * ELT;
  float acc[NR][da::VE];
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int i = 0; i < da::VE; ++i) acc[r][i] = 0.f;
  if (sg < sgs) {
    int lo = c.cap;
#pragma unroll
    for (int r = 0; r < NR; ++r) lo = min(lo, c.lim[rb + r]);
    // a slot below every row's limit skips the selects (the same fmaf
    // for each live row either way)
    auto add = [&](int u, int t, const uint32_t (&raw)[GWORDS]) {
      float vf[da::VE];
      group_values<FP8, GWORDS>(raw, 0, vf);
      if (t < lo) {
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          const float w = c.sc[static_cast<size_t>(rb + r) * c.U + u];
#pragma unroll
          for (int i = 0; i < da::VE; ++i)
            acc[r][i] = fmaf(w, vf[i], acc[r][i]);
        }
        return;
      }
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const float w = c.sc[static_cast<size_t>(rb + r) * c.U + u];
        const bool live = t < c.lim[rb + r];
#pragma unroll
        for (int i = 0; i < da::VE; ++i) {
          const float a = fmaf(w, vf[i], acc[r][i]);
          acc[r][i] = live ? a : acc[r][i];
        }
      }
    };
    auto load = [&](int u0, uint32_t (&raw)[VB][GWORDS]) {
#pragma unroll
      for (int j = 0; j < VB; ++j) {
        const int u = u0 + j * sgs;
        if (u < c.nu)
          load_words<GWORDS>(
              c.vbytes + (static_cast<size_t>(c.sidx[u]) * c.Dh + d0) * ELT,
              gnb, gvb, raw[j]);
      }
    };
    uint32_t cur[VB][GWORDS], nxt[VB][GWORDS];
    if (sg < c.nu) load(sg, cur);
    for (int u0 = sg; u0 < c.nu; u0 += VB * sgs) {
      if (u0 + VB * sgs < c.nu) load(u0 + VB * sgs, nxt);
#pragma unroll
      for (int j = 0; j < VB; ++j) {
        const int u = u0 + j * sgs;
        if (u < c.nu) add(u, chunk_slot(u, c.rank), cur[j]);
      }
#pragma unroll
      for (int j = 0; j < VB; ++j)
#pragma unroll
        for (int i = 0; i < GWORDS; ++i) cur[j][i] = nxt[j][i];
    }
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int i = 0; i < da::VE; ++i)
        c.red[(sg * rbv + r) * c.dp + d0 + i] = acc[r][i];
  }
  __syncthreads();
  for (int e = tid; e < NR * c.Dh; e += da::THREADS) {
    const int r = e / c.Dh, d = e - r * c.Dh;
    float o = 0.f;
    for (int s = 0; s < sgs; ++s)
      o = __fadd_rn(o, c.red[(s * rbv + r) * c.dp + d]);
    c.part[(rb + r) * c.Dh + d] = o;
  }
  __syncthreads();
}

// f(std::integral_constant<int, NR>, rb) over rows [0, R) in blocks of
// 8 (if MAX is 8), 4, 2 and 1 rows: each block's rows in registers at
// once.
template <int MAX, typename F>
__device__ __forceinline__ void row_blocks(int R, F&& f) {
  for (int rb = 0; rb < R;) {
    const int left = R - rb;
    if constexpr (MAX >= 8) {
      if (left >= 8) {
        f(std::integral_constant<int, 8>{}, rb);
        rb += 8;
        continue;
      }
    }
    if (left >= 4) {
      f(std::integral_constant<int, 4>{}, rb);
      rb += 4;
    } else if (left >= 2) {
      f(std::integral_constant<int, 2>{}, rb);
      rb += 2;
    } else {
      f(std::integral_constant<int, 1>{}, rb);
      rb += 1;
    }
  }
}

// Pass 2 for rows [rb, rb + NR): p = exp(s - m) in place and each row's
// per-warp sum over its live slots (f64, a thread's slots in order, then
// the warp butterfly) in wsum.
template <int NR>
__device__ __forceinline__ void exp_sweep(const DaCtx& c, int rb,
                                          const float* mx, double* wsum) {
  const int tid = threadIdx.x;
  float m[NR];
  int lr[NR];
  double sum[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    m[r] = mx[rb + r];
    lr[r] = c.lim[rb + r];
    sum[r] = 0.0;
  }
  for (int u = tid; u < c.nu; u += da::THREADS) {
    const int t = chunk_slot(u, c.rank);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      float* e = c.sc + static_cast<size_t>(rb + r) * c.U + u;
      const bool live = t < lr[r];
      const float p = expf(__fsub_rn(*e, m[r]));
      *e = live ? p : 0.f;
      sum[r] = live ? __dadd_rn(sum[r], static_cast<double>(p)) : sum[r];
    }
  }
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum[r] = __dadd_rn(sum[r], __shfl_xor_sync(0xffffffffu, sum[r], o));
    if (lane == 0) wsum[warp * c.R + rb + r] = sum[r];
  }
}

// Pass 3 for rows [rb, rb + NR): w = bf16(p / L * v_scale) in place.
template <bool FP8, int NR>
__device__ __forceinline__ void weight_sweep(const DaCtx& c, int rb,
                                             const float* l) {
  float lsum[NR];
  int lr[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    lsum[r] = l[rb + r];
    lr[r] = c.lim[rb + r];
  }
  for (int u = threadIdx.x; u < c.nu; u += da::THREADS) {
    const int t = chunk_slot(u, c.rank);
    const float vsc = c.vscl[u];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      float* e = c.sc + static_cast<size_t>(rb + r) * c.U + u;
      float w = __fdiv_rn(*e, lsum[r]);
      if constexpr (FP8) w = __fmul_rn(w, vsc);
      *e = t < lr[r] ? bf16_round(w) : 0.f;
    }
  }
}

template <bool FP8, bool PAGED, bool WIDE>
__global__ void __cluster_dims__(da::CL, 1, 1)
    __launch_bounds__(da::THREADS,
                      WIDE ? da::MIN_BLOCKS_WIDE : da::MIN_BLOCKS)
decode_attn_kernel(const float* __restrict__ q, const void* __restrict__ k,
                   const void* __restrict__ v,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   const int* __restrict__ n_valid,
                   const int* __restrict__ block_table,
                   float* __restrict__ out, float* __restrict__ scratch,
                   int KV, int R, int G, int Dh, int T, int NP, int U, int vb,
                   float sm_scale) {
  extern __shared__ __align__(16) float da_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int groups = (Dh + da::VE - 1) / da::VE, dp = groups * da::VE;
  const int cap = NP * T;
  const float neg_inf = -__int_as_float(0x7f800000);
  const DaSmem L(R, Dh, U, scratch == nullptr, FP8);
  using QT = std::conditional_t<FP8, float, double>;
  QT* qs = reinterpret_cast<QT*>(da_smem + L.qs);
  float* sc = scratch != nullptr
                  ? scratch + ((static_cast<size_t>(b) * KV + h) * da::CL +
                               rank) * (R + 2) * static_cast<size_t>(U)
                  : da_smem + L.sc;
  // beside the R rows of scores: each local slot's row index in the k/v
  // arrays and its V scale, taken in pass 1 for passes 3 and 4
  uint32_t* sidx =
      reinterpret_cast<uint32_t*>(sc + static_cast<size_t>(R) * U);
  float* vscl = sc + static_cast<size_t>(R + 1) * U;
  float* red = da_smem + L.red;
  float* wred = da_smem + L.wred;
  double* wsum = reinterpret_cast<double*>(da_smem + L.wred);
  float* cmax = da_smem + L.cmax;
  double* csum = reinterpret_cast<double*>(da_smem + L.csum);
  float* gstat = da_smem + L.gstat;
  int* lim = reinterpret_cast<int*>(da_smem + L.lim);
  uint64_t* bars = reinterpret_cast<uint64_t*>(da_smem + L.bars);
  const uint8_t* kb = static_cast<const uint8_t*>(k);
  const uint8_t* vbytes = static_cast<const uint8_t*>(v);
  const int* bt = PAGED ? block_table + static_cast<size_t>(b) * NP : nullptr;

  // the last draft's limit, min(n_valid, cap), is the rows' largest: the
  // CTAs that hold a chunk below it are active (rank 0 always, to write
  // the output); the others leave after the opening barrier
  const int q_len = R / G, nv = n_valid[b];
  const int hi = min(nv, cap);
  const int na = hi > 0 ? min(da::CL, (hi + da::CH - 1) / da::CH) : 1;
  if (tid < da::NBARS) {
    const uint32_t a =
        static_cast<uint32_t>(__cvta_generic_to_shared(bars + tid));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(a), "r"(na)
                 : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  cluster.sync();
  if (rank >= na) return;

  for (int r = tid; r < R; r += da::THREADS)
    lim[r] = min(nv - (q_len - 1 - r / G), cap);
  // this CTA's local slots below hi: its whole chunks, then the partial
  // chunk `full` if it is this CTA's (its local chunk is then `mine`)
  int nu = 0;
  if (hi > 0) {
    const int full = hi / da::CH, rem = hi % da::CH;
    const int mine = full > rank ? (full - rank + da::CL - 1) / da::CL : 0;
    nu = mine * da::CH + (rem > 0 && full % da::CL == rank ? rem : 0);
  }
  // every local slot's row index in k/v (the block table's reads in one
  // round trip)
  for (int u = tid; u < nu; u += da::THREADS)
    sidx[u] = static_cast<uint32_t>(
        slot_index<PAGED>(bt, b, h, chunk_slot(u, rank), KV, T));
  const float* qb = q + (static_cast<size_t>(b) * KV + h) * R * Dh;
  for (int i = tid; i < R * dp; i += da::THREADS) {
    const int r = i / dp, d = i - r * dp;
    qs[i] = d < Dh ? bf16_round(qb[r * Dh + d]) : 0.f;
  }
  __syncthreads();

  const DaCtx c{qs, sc, sidx, vscl, wred, red, da_smem + L.qs, lim,
                kb, vbytes, k_scale, v_scale, bt, b, h, KV, T, U, R, Dh,
                dp, groups, nu, rank, vb, cap, sm_scale};

  // 1. scores, kept; the rows' maxima over their live slots (sweeps of
  // 8, 4, 2 and 1 rows; two slots a thread at a time but at 8 rows in
  // the 80-register instance)
  row_blocks<8>(R, [&](auto nr, int rb) {
    constexpr int NR = decltype(nr)::value;
    score_sweep<NR, NR < 8 || WIDE ? 2 : 1, FP8, PAGED>(c, rb);
  });
  __syncthreads();
  for (int r = tid; r < R; r += da::THREADS) {
    float m = wred[r];
    for (int w = 1; w < da::WARPS; ++w) m = fmaxf(m, wred[w * R + r]);
    cmax[r] = m;
  }
  da_barrier(bars, 0, na);
  for (int r = tid; r < R; r += da::THREADS) {
    float m = neg_inf;
    for (int j = 0; j < na; ++j)
      m = fmaxf(m, cluster.map_shared_rank(cmax, j)[r]);
    gstat[r] = m;
  }
  __syncthreads();

  // 2. p = exp(s - max) in place; the rows' sums, in f64 and rounded
  // to f32 once: L is then the correctly rounded sum of the f32 terms
  // (but in rare ties), as the plain version's reduction nearly always
  // gives; one f32 ulp of L flips the bf16 rounding of a weight in ~2^-16
  // of them
  row_blocks<8>(R, [&](auto nr, int rb) {
    exp_sweep<decltype(nr)::value>(c, rb, gstat, wsum);
  });
  __syncthreads();
  for (int r = tid; r < R; r += da::THREADS) {
    double l = wsum[r];
    for (int w = 1; w < da::WARPS; ++w) l = __dadd_rn(l, wsum[w * R + r]);
    csum[r] = l;
  }
  da_barrier(bars, 1, na);
  for (int r = tid; r < R; r += da::THREADS) {
    double l = 0.0;
    for (int j = 0; j < na; ++j)
      l = __dadd_rn(l, cluster.map_shared_rank(csum, j)[r]);
    gstat[R + r] = static_cast<float>(l);
  }
  __syncthreads();

  // 3. w = bf16(p / L * v_scale) in place
  row_blocks<8>(R, [&](auto nr, int rb) {
    weight_sweep<FP8, decltype(nr)::value>(c, rb, gstat + R);
  });
  __syncthreads();

  // 4. the weighted sum of V (sweeps of 8 (the wide instance, e4m3 k),
  // 4, 2 and 1 rows); part (R, Dh) takes the place of qs
  row_blocks<WIDE && FP8 ? 8 : 4>(R, [&](auto nr, int rb) {
    v_sweep<decltype(nr)::value, FP8>(c, rb);
  });
  float* part = da_smem + L.qs;

  // the active CTAs' partial outputs in rank order (the others' are
  // zeros), each active CTA a share of them
  da_barrier(bars, 2, na);
  const int n = R * Dh;
  float* ob = out + (static_cast<size_t>(b) * KV + h) * n;
  for (int e = rank * da::THREADS + tid; e < n; e += na * da::THREADS) {
    float o = 0.f;
    for (int j = 0; j < na; ++j)
      o = __fadd_rn(o, cluster.map_shared_rank(part, j)[e]);
    ob[e] = o;
  }
  da_barrier(bars, 3, na);   // no CTA leaves while another reads its part
}

template <bool FP8, bool PAGED>
static int launch_kernel(cudaStream_t st, const void* q, const void* k,
                         const void* v, const void* ks, const void* vs,
                         const void* nv, const void* bt, void* out,
                         void* scratch, int B, int KV, int R, int G, int Dh,
                         int T, int NP, float sm_scale) {
  const int U = da_local_slots(T * NP);
  const bool here = scratch == nullptr;
  if (here && static_cast<long long>(R + 2) * U * 4 > da::SCORES_SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const DaSmem L(R, Dh, U, here, FP8);
  const size_t bytes = static_cast<size_t>(L.total) * sizeof(float);
  // wide loads where every row starts on their alignment
  const int row = Dh * (FP8 ? 1 : 2);
  const uintptr_t al =
      reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v);
  const int vb = (row % 16 == 0 && al % 16 == 0) ? 16
                 : (row % 8 == 0 && al % 8 == 0) ? 8
                                                 : 0;
  auto kern = R > da::RBV ? decode_attn_kernel<FP8, PAGED, true>
                           : decode_attn_kernel<FP8, PAGED, false>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(da::CL, KV, B);
  kern<<<grid, da::THREADS, bytes, st>>>(
      static_cast<const float*>(q), k, v, static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(nv),
      static_cast<const int*>(bt), static_cast<float*>(out),
      static_cast<float*>(scratch), KV, R, G, Dh, T, NP, U, vb, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool PAGED>
static int launch(const void* q, const void* k, const void* v,
                  const void* k_scale, const void* v_scale,
                  const void* n_valid, const void* block_table, void* out,
                  void* scratch, int B, int KV, int R, int q_len, int Dh,
                  int T, int NP, float sm_scale, int fp8, void* stream) {
  if (Dh < 1 || Dh > 256 || q_len < 1 || R % q_len)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = R / q_len;
  auto st = static_cast<cudaStream_t>(stream);
  if (fp8)
    return launch_kernel<true, PAGED>(st, q, k, v, k_scale, v_scale, n_valid,
                                      block_table, out, scratch, B, KV, R, G,
                                      Dh, T, NP, sm_scale);
  return launch_kernel<false, PAGED>(st, q, k, v, k_scale, v_scale, n_valid,
                                     block_table, out, scratch, B, KV, R, G,
                                     Dh, T, NP, sm_scale);
}

extern "C" int decode_attn_paged_launch(const void* q, const void* k,
                                        const void* v, const void* k_scale,
                                        const void* v_scale,
                                        const void* n_valid,
                                        const void* block_table, void* out,
                                        void* scratch, int B, int KV, int R,
                                        int q_len, int Dh, int T, int NP,
                                        float sm_scale, int fp8,
                                        void* stream) {
  return launch<true>(q, k, v, k_scale, v_scale, n_valid, block_table, out,
                      scratch, B, KV, R, q_len, Dh, T, NP, sm_scale, fp8,
                      stream);
}

extern "C" int decode_attn_launch(const void* q, const void* k, const void* v,
                                  const void* k_scale, const void* v_scale,
                                  const void* n_valid, void* out,
                                  void* scratch, int B, int KV, int R,
                                  int q_len, int Dh, int C, float sm_scale,
                                  int fp8, void* stream) {
  return launch<false>(q, k, v, k_scale, v_scale, n_valid, nullptr, out,
                       scratch, B, KV, R, q_len, Dh, C, 1, sm_scale, fp8,
                       stream);
}
