// Hopper tensor-core building blocks (sm_90a) and the port's fp8 GEMM
// tile built from them: shared-memory matrix descriptors, the bf16
// warpgroup products wgmma.mma_async m64n128k16 and m64n32k16 with f32
// accumulators, TMA loads behind mbarriers, the exact fp8 -> bf16
// operand conversion into 128-byte-swizzled panels, and one
// warp-specialised mainloop with two A-operand policies (MX: mx_gemm.cu
// for rows 1-2 at M > 32, mx_dw_gemm.cu for row 5 on its requant
// payload, moe_gmm.cu for rows 7 and 8; GROUP: group_gemm.cu, row 6).
// (mx_gemm.cu's M <= 32 tile is built from the same blocks.)
//
// Panel layouts (each 1024-byte aligned, 128-byte swizzle: the 16-byte
// chunk c of a 128-byte line r lies at chunk c ^ (r % 8)):
//   A, K-major: 128 rows x 64 k of bf16, one 128-byte line per row.  A
//     warpgroup's 64 rows start at 64 * 128 bytes; 8-row groups are
//     1024 bytes apart (SBO); the k16 step kk starts 32 * kk bytes in.
//   B, MN-major (N contiguous, as the (K, N) weights lie): two halves
//     of 64 columns, 8192 bytes apart (LBO), each 64 k-lines of 128
//     bytes; 8-line groups 1024 bytes apart (SBO); the k16 step kk
//     starts 2048 * kk bytes in.  wgmma reads it transposed (imm-trans-b
//     1), so no transposed copy of the weights is made.
#pragma once

#include "common.cuh"

namespace wgt {
constexpr int BM = 128;                   // output rows per block
constexpr int BN = 128;                   // output columns per block
constexpr int BK = 64;                    // K per pipeline step
constexpr int THREADS = 512;              // 2 consumer + 2 producer warpgroups
constexpr int STAFF = 256;                // threads per role
constexpr int STAGES = 3;                 // bf16 panel ring depth
constexpr int RAW = 4;                    // fp8 byte ring depth (cp.async)
constexpr int PROMOTE = 2;                // steps per f32 promotion (K 128)
constexpr int CONSUMER_REGS = 168;        // setmaxnreg: 256 x (168 + 88)
constexpr int PRODUCER_REGS = 88;         //   = the register file
constexpr int A_BYTES = BM * BK * 2;      // 16 KB bf16
constexpr int B_BYTES = BK * BN * 2;      // 16 KB bf16
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int RAW_BYTES = 4 * STAFF * 16; // a producer's 4 chunks: 16 KB
constexpr int BAR_OFFSET = STAGES * STAGE_BYTES + RAW * RAW_BYTES;
constexpr int SMEM_BYTES = BAR_OFFSET + 2 * STAGES * 8 + 1024;
}  // namespace wgt

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A shared-memory matrix descriptor with the 128-byte swizzle; the
// offsets in bytes.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Generic-proxy shared-memory writes made visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keep the compiler from moving accumulator reads or writes across a
// wgmma wait.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = A (64 x 16, K-major) @ B (16 x 128, MN-major) (+ d if accumulate),
// f32 accumulation in the tensor core.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d = A (64 x 16, MN-major: read transposed, imm-trans-a 1) @ B (16 x
// 32, K-major) (+ d if accumulate), f32 accumulation in the tensor core:
// the operands of mx_gemm.cu's M <= 32 tile, where A is a strip of the
// (K, N) weights as they lie and B the activation rows.
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(0u), "r"(sel));
  return d;
}

// d = a * b + (-0) on two bf16 values, IEEE round to nearest even
// (subnormals kept): exact for a power-of-two b unless the product is
// a bf16 subnormal, where it rounds once.
__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d) : "r"(a), "r"(b), "r"(0x80008000u));
  return d;
}

// The bf16 bits of 2^e, e in [-127, 127] (2^-127 a bf16 subnormal), in
// both halves (e + 120 <= 127 only where e is an exponent plus a bias).
__device__ __forceinline__ uint32_t bf16x2_exp2(int e) {
  const uint32_t h = e > -127 ? static_cast<uint32_t>(e + 127) << 7 : 0x40u;
  return h | (h << 16);
}

// 16 fp8 bytes -> 16 bf16 values (two 16-byte chunks) on the integer
// pipe: prmt puts each byte in the low byte of a 16-bit half with its
// sign replicated above it; a shift and one mask leave the sign at bit
// 15 and the exponent and mantissa bits under bf16's, which reads
// q * 2^-120 (e4m3, subnormals included) or q * 2^-112 (e5m2).  One
// bf16x2 multiply by 2^120 (2^112) restores q exactly and, for A, one
// more by 2^e rounds q * 2^e once to bf16 (one multiply by 2^(e + 120)
// where that is a bf16 value, e <= 7): common.cuh's
// bf16_round(fp8_to_float(q) * exp2i(e)), whose f32 product is exact.
// (fp8 NaN and Inf, which the saturating quantizers never write, read
// as finite values here.)  The conversion instructions (cvt, 16 a clock
// per SM) would take ~2,000 SM cycles per 64-wide step of a 128 x 128
// tile, four times its products.
template <bool E5M2, bool SCALED>
__device__ __forceinline__ void fp8x16_to_bf16(uint4 raw, int e, uint4& lo,
                                               uint4& hi) {
  const uint32_t shift = E5M2 ? 5 : 4;
  const uint32_t mask = E5M2 ? 0x8fe08fe0u : 0x87f087f0u;
  const int bias = E5M2 ? 112 : 120;
  const uint32_t unbias = bf16x2_exp2(bias);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = (prmt(w[i], 0x9180u) << shift) & mask;        // b0, b1
    o[2 * i + 1] = (prmt(w[i], 0xB3A2u) << shift) & mask;    // b2, b3
  }
  if (SCALED && e + bias <= 127) {
    // one multiply by 2^(e + bias): q * 2^e rounded once
    const uint32_t scale = bf16x2_exp2(e + bias);
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = bf16x2_mul(o[i], scale);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = bf16x2_mul(o[i], unbias);
    if (SCALED) {
      const uint32_t scale = bf16x2_exp2(e);
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i] = bf16x2_mul(o[i], scale);
    }
  }
  lo = make_uint4(o[0], o[1], o[2], o[3]);
  hi = make_uint4(o[4], o[5], o[6], o[7]);
}

// 16 bytes from global memory by byte loads (rows not 16-byte aligned):
// the first `valid`, the rest 0.
__device__ __forceinline__ uint4 load16_bytes(const uint8_t* __restrict__ p,
                                              int valid) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (i < valid) w[i / 4] |= static_cast<uint32_t>(p[i]) << (8 * (i % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void st_shared16(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ uint4 ld_shared16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// 16 bytes global -> shared, asynchronous; the bytes past `valid` (all
// of them when valid is 0) are zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait for the completion of the barrier's phase of this parity; a wait
// that outlasts ~2^22 polls traps (a launch error) rather than hang the
// card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (int i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (i > (1 << 22)) __trap();
  }
}

// This thread's arrival on the barrier, and the bytes of asynchronous
// copies the barrier's phase waits for besides.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
}

// One box of a 2-D tensor map (c0 the inner coordinate) into shared
// memory by the TMA; its bytes complete on `bar`.  Out-of-bounds
// elements arrive as zeros.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
        "r"(c1)
      : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// The fp8 GEMM tile on the tensor cores, for the BM x BN output tile at
// (m0, n0), f32, unscaled, with one of two A-operand policies:
//   MX (MOSS; mx_gemm, fused_quant_gemm, moe_gmm, and both dW GEMMs on
//     their requant payload): the exponent goes into the operand,
//       out[m, n] = sum_k bf16(fp8(qx[m, k]) * 2^sexp[m, k/32])
//                         * fp8(qw[k, n]);
//   GROUP (COAT; group_gemm): each 128-wide K group's partial sum is
//     rescaled by the row's f32 scale inside the K loop,
//       out[m, n] = sum_g (sum_{k in g} fp8(qx[m, k]) * fp8(qw[k, n]))
//                         * sx[m, g]
//     (K a multiple of 128, sx (M, K/128)).
//
// Warp-specialised, 512 threads.  Two producer warpgroups stage each
// 64-wide K step: a producer owns two 16-byte chunks of qx (with their
// rows' exponents, read one step ahead, under MX) and two of qw, which
// cp.async brings into its own slots of a 4-deep byte ring three steps
// ahead; it converts them into the swizzled bf16 panels of a 3-deep ring
// and arrives on the stage's `full` barrier.  Two consumer warpgroups
// wait on it, issue four m64n128k16 products each on their 64 rows and
// release the stage on its `empty` barrier once the products have read
// it.  No block-wide barrier in the loop: the conversion of later steps
// overlaps the products of earlier ones.  (Staging and products in
// turn, one block-wide barrier a step, put every load, store, fence and
// barrier of a step in one chain of latencies.)  setmaxnreg gives the
// consumers the registers of their two accumulator sets.
//
// The tensor core's f32 accumulation truncates: over K 10240 its sums
// drift by ~1e-5 * max|out| from a correctly rounded one.  So the
// products of PROMOTE steps (K 128) accumulate in the tensor core, and
// each such partial sum is then added to f32 registers in IEEE
// arithmetic; the error then stays that of any f32 sum order.  That
// promotion is where COAT rescales: under GROUP it is
// acc = acc + part * sx[row, g], multiply and add rounded each on its
// own (__fmul_rn, __fadd_rn: no contraction into an FMA), the order of
// the reference's partial * sx then sum.  A consumer thread's rows'
// scales come from global memory into registers one promotion ahead.
// The producers are the same under both policies, but for the
// exponents: GROUP converts A unscaled (exact).
//
// K is the row stride of qx (and K / 32 of sexp, K / 128 of sx); the
// contraction stops at k_stop <= K, a multiple of 32 (the grouped dW
// stops at its expert's token count; every other caller passes K).
// Ragged M, N and k_stop read as zeros; the epilogue stores the f32
// tile, masked.  No split-K, no atomics: two calls give the same
// bits.
// ---------------------------------------------------------------------------
enum class AScale { MX, GROUP };

template <AScale P, bool XE5, bool WE5, bool VEC>
__device__ __forceinline__ void wgmma_producer(
    const uint8_t* __restrict__ qx, const int8_t* __restrict__ sexp,
    const uint8_t* __restrict__ qw, int M, int N, int K, int k_stop, int m0,
    int n0, uint32_t base, int tid) {
  const uint32_t raw0 = base + wgt::STAGES * wgt::STAGE_BYTES;
  const uint32_t full = base + wgt::BAR_OFFSET;
  const uint32_t empty = full + wgt::STAGES * 8;
  const int kg = K / 32;
  const int steps = (k_stop + wgt::BK - 1) / wgt::BK;

  // this thread's chunks: A (row, 16-byte column) and B (k-line,
  // 16-column group), two of each; eight neighbouring threads store to
  // eight different bank groups of the swizzled panels
  int a_row[2], a_kc[2], b_kr[2], b_nc[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int id = tid + wgt::STAFF * j;
    a_row[j] = id / 4;
    a_kc[j] = id % 4;
    const int g = id / 8, q = id % 8;
    b_kr[j] = 2 * (g % 32) + q / 4;
    b_nc[j] = q % 4 + 4 * (g / 32);
  }

  // the chunks' sources at k 0, fixed once: a step adds 64 bytes to an
  // A chunk's address, 64 k-lines to a B chunk's
  const uint8_t* src_a[2];
  const uint8_t* src_b[2];
  const int8_t* src_e[2];
  bool ok_a[2], ok_b[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = m0 + a_row[j], n = n0 + 16 * b_nc[j];
    ok_a[j] = row < M;
    ok_b[j] = n < N;
    src_a[j] = qx + (ok_a[j] ? static_cast<size_t>(row) * K + 16 * a_kc[j]
                             : 0);
    if constexpr (P == AScale::MX)
      src_e[j] = sexp + (ok_a[j] ? static_cast<size_t>(row) * kg +
                                       a_kc[j] / 2
                                 : 0);
    src_b[j] = qw + (ok_b[j] ? static_cast<size_t>(b_kr[j]) * N + n : 0);
  }

  // the byte ring: slot r holds this thread's 4 chunks at
  // raw0 + r * RAW_BYTES + (c * STAFF + tid) * 16 (A: c 0-1, B: c 2-3)
  auto fetch = [&](int step) {
    if (step >= steps) return;
    const uint32_t slot = raw0 + (step % wgt::RAW) * wgt::RAW_BYTES + tid * 16;
    const int k0 = step * wgt::BK;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool ok = ok_a[j] && k0 + 16 * a_kc[j] < k_stop;
      const bool okb = ok_b[j] && k0 + b_kr[j] < k_stop;
      const uint8_t* pa = ok ? src_a[j] + k0 : qx;
      const uint8_t* pb = okb ? src_b[j] + static_cast<size_t>(k0) * N : qw;
      const uint32_t da = slot + j * wgt::STAFF * 16;
      const uint32_t db = slot + (2 + j) * wgt::STAFF * 16;
      if (VEC) {
        cp_async16(da, pa, ok ? 16 : 0);
        cp_async16(db, pb, okb ? 16 : 0);
      } else {
        st_shared16(da, load16_bytes(pa, ok ? 16 : 0));
        st_shared16(db, load16_bytes(pb, okb ? N - n0 - 16 * b_nc[j] : 0));
      }
    }
  };
  auto exps = [&](int step, int (&e)[2]) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if constexpr (P == AScale::MX)
        e[j] = ok_a[j] && step * wgt::BK + 16 * a_kc[j] < k_stop
                   ? src_e[j][2 * step] : 0;
      else
        e[j] = 0;
    }
  };

  // one cp.async group per step, empty past the end, so that "step s
  // has landed" is always "at most RAW - 1 groups pending"
#pragma unroll
  for (int s = 0; s < wgt::RAW - 1; ++s) {
    fetch(s);
    cp_async_commit();
  }
  int e_now[2], e_next[2];
  exps(0, e_now);
  for (int step = 0; step < steps; ++step) {
    fetch(step + wgt::RAW - 1);
    cp_async_commit();
    exps(step + 1, e_next);
    cp_async_wait<wgt::RAW - 1>();
    const uint32_t slot =
        raw0 + (step % wgt::RAW) * wgt::RAW_BYTES + tid * 16;
    uint4 raw[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      raw[c] = ld_shared16(slot + c * wgt::STAFF * 16);
    const int stage = step % wgt::STAGES;
    mbar_wait(empty + stage * 8, ((step / wgt::STAGES) & 1) ^ 1);
    const uint32_t pa = base + stage * wgt::STAGE_BYTES;
    const uint32_t pb = pa + wgt::A_BYTES;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint4 lo, hi;
      fp8x16_to_bf16<XE5, P == AScale::MX>(raw[j], e_now[j], lo, hi);
      const int r = a_row[j], c = 2 * a_kc[j];
      st_shared16(pa + r * 128 + ((c ^ (r & 7)) << 4), lo);
      st_shared16(pa + r * 128 + (((c + 1) ^ (r & 7)) << 4), hi);
      fp8x16_to_bf16<WE5, false>(raw[2 + j], 0, lo, hi);
      const int kr = b_kr[j], cb = 2 * (b_nc[j] % 4);
      const uint32_t line = pb + (b_nc[j] / 4) * 8192 + kr * 128;
      st_shared16(line + ((cb ^ (kr & 7)) << 4), lo);
      st_shared16(line + (((cb + 1) ^ (kr & 7)) << 4), hi);
    }
    e_now[0] = e_next[0];
    e_now[1] = e_next[1];
    fence_proxy_async();        // the panel stores, visible to wgmma
    mbar_arrive(full + stage * 8);
  }
  cp_async_wait<0>();
}

// GROUP: the f32 scales of group g of a consumer thread's two rows,
// row and row + 8 (0 past M or past the last group).
__device__ __forceinline__ void group_scales(const float* __restrict__ sx,
                                             int row, int M, int groups,
                                             int g, float (&s)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    s[h] = r < M && g < groups
               ? __ldg(sx + static_cast<size_t>(r) * groups + g) : 0.f;
  }
}

// A complete partial sum into the f32 registers: acc += part (MX), or
// acc = acc + part * s of the element's row (GROUP; d[i] lies in row
// + 8 * ((i >> 1) & 1), see the consumer's epilogue).
template <AScale P>
__device__ __forceinline__ void promote(float (&acc)[64],
                                        const float (&part)[64],
                                        const float (&s)[2]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if constexpr (P == AScale::MX)
      acc[i] += part[i];
    else
      acc[i] = __fadd_rn(acc[i], __fmul_rn(part[i], s[(i >> 1) & 1]));
  }
}

template <AScale P>
__device__ __forceinline__ void wgmma_consumer(float* __restrict__ out,
                                               const float* __restrict__ sx,
                                               int M, int N, int K,
                                               int k_stop, int m0, int n0,
                                               uint32_t base, int tid) {
  const uint32_t full = base + wgt::BAR_OFFSET;
  const uint32_t empty = full + wgt::STAGES * 8;
  const int wg = tid / 128;
  const int steps = (k_stop + wgt::BK - 1) / wgt::BK;
  // d[4j + {0,1}] at (row, 8j + 2(lane % 4) + {0,1}), d[4j + {2,3}] at
  // row + 8; row = 16 * warp + lane / 4 within the warpgroup's 64
  const int t = tid % 128, lane = t % 32;
  const int row = m0 + wg * 64 + (t / 32) * 16 + lane / 4;
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
  // GROUP: the scales of the group in `part` (s_now) and the next one
  const int groups = K / (wgt::PROMOTE * wgt::BK);
  float s_now[2] = {0.f, 0.f}, s_next[2] = {0.f, 0.f};
  if constexpr (P == AScale::GROUP) {
    group_scales(sx, row, M, groups, 0, s_now);
    group_scales(sx, row, M, groups, 1, s_next);
  }

  for (int step = 0; step < steps; ++step) {
    const int stage = step % wgt::STAGES;
    mbar_wait(full + stage * 8, (step / wgt::STAGES) & 1);
    const bool fresh = step % wgt::PROMOTE == 0;
    const bool promoting = fresh && step > 0;
    if (promoting) {
      // the last partial sum is complete
      wgmma_wait<0>();
      fence_acc(part);
      promote<P>(acc, part, s_now);
      if constexpr (P == AScale::GROUP) {
        s_now[0] = s_next[0];
        s_now[1] = s_next[1];
        group_scales(sx, row, M, groups, step / wgt::PROMOTE + 1, s_next);
      }
      mbar_arrive(empty + ((step - 1) % wgt::STAGES) * 8);
    }
    const uint32_t pa = base + stage * wgt::STAGE_BYTES + wg * 64 * 128;
    const uint32_t pb = base + stage * wgt::STAGE_BYTES + wgt::A_BYTES;
    fence_acc(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < wgt::BK / 16; ++kk)
      wgmma_m64n128k16(part, gmma_desc(pa + 32 * kk, 16, 1024),
                       gmma_desc(pb + 2048 * kk, 8192, 1024),
                       !(fresh && kk == 0));
    wgmma_commit();
    fence_acc(part);
    if (!promoting && step > 0) {
      wgmma_wait<1>();          // step - 1's products have read their stage
      fence_acc(part);
      mbar_arrive(empty + ((step - 1) % wgt::STAGES) * 8);
    }
  }
  wgmma_wait<0>();
  fence_acc(part);
  promote<P>(acc, part, s_now);

#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      if (r >= M) continue;
      float* o = out + static_cast<size_t>(r) * N + col;
      if (col < N) o[0] = acc[4 * j + 2 * h];
      if (col + 1 < N) o[1] = acc[4 * j + 2 * h + 1];
    }
  }
}

// One output tile; `sexp` is read under MX, `sx` under GROUP.
template <AScale P, bool XE5, bool WE5, bool VEC>
__device__ __forceinline__ void wgmma_tile(
    const uint8_t* __restrict__ qx, const int8_t* __restrict__ sexp,
    const float* __restrict__ sx, const uint8_t* __restrict__ qw,
    float* __restrict__ out, int M, int N, int K, int k_stop, int m0,
    int n0, uint8_t* smem_raw) {
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + wgt::BAR_OFFSET;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < wgt::STAGES; ++i) {
      mbar_init(full + i * 8, wgt::STAFF);
      mbar_init(full + (wgt::STAGES + i) * 8, wgt::STAFF);
    }
  }
  __syncthreads();
  if (tid >= wgt::STAFF) {
    setmaxnreg_dec<wgt::PRODUCER_REGS>();
    wgmma_producer<P, XE5, WE5, VEC>(qx, sexp, qw, M, N, K, k_stop, m0, n0,
                                     base, tid - wgt::STAFF);
  } else {
    setmaxnreg_inc<wgt::CONSUMER_REGS>();
    wgmma_consumer<P>(out, sx, M, N, K, k_stop, m0, n0, base, tid);
  }
}

// Launch a kernel of the tile: its dynamic shared memory opted in, one
// block of THREADS per output tile of `grid`.
template <typename... Params, typename... Args>
cudaError_t launch_wgmma(void (*kernel)(Params...), dim3 grid,
                         cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wgt::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<grid, wgt::THREADS, wgt::SMEM_BYTES, stream>>>(args...);
  return cudaGetLastError();
}

// The index of a kernel's instance in a table of 8 ordered as
// <XE5, WE5, VEC> in binary: x_e5m2 * 4 + w_e5m2 * 2 + vec.
inline int wgmma_instance(int x_e5m2, int w_e5m2, int vec) {
  return (x_e5m2 ? 4 : 0) | (w_e5m2 ? 2 : 0) | (vec ? 1 : 0);
}
