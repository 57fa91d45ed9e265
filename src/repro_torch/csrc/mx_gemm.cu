// MX GEMM for Hopper: acc[m, n] = sum_k (Qx[m, k] * 2^sexp[m, k/32]) * Qw[k, n]
//
// Replaces the TPU kernel src/repro/kernels/mx_gemm.py:61 mx_gemm_pallas.
// It is the delayed-scale serving forward of every linear layer (decode
// and verify steps, prefill chunks, whole-prompt prefill, the LM head),
// the Table 6 MOSS GEMM and, behind the mx_quant kernel, fused_quant_gemm
// at every M (the calibration forward, training); the caller applies
// s_x * s_w.  Two tiles, chosen by the wrapper from M (kernels/mx_gemm.py
// SMALL_M, tile_for):
//
// M <= 32 (decode steps M = B, verify steps M = B * k, 32-token prefill
// chunks, the calibration forward): mx_gemm_kernel below.  What bounds
// it is the fp8 weight bytes, K * N over 3.35 TB/s (7.5 us at K 3072,
// N 8192); the activations are at most 32 x K, a few hundred KB read
// from L2.  So every weight byte is read from device memory once, for
// all M rows together (no row-tile grid axis), with many bytes in flight
// (~1 us of latency at 3.35 TB/s asks for ~25-30 KB per SM).  The design:
// one CTA per 64-column strip of Qw (times a K split, below) computes
// D^T (64 columns x 32 rows) = Qw^T (64 x K) @ (Qx * 2^e)^T (K x 32) with
// wgmma m64n32k16, operands swapped: A is the weight strip as it lies
// (MN-major, read transposed), B the activation rows (K-major), always
// 32 of them, rows >= M zero.  Every row so runs the same arithmetic at
// any M <= 32 and at any position in the batch: a row's bits do not
// depend on the batch (decode M 4, verify M 16 and prefill chunks M 32
// agree bitwise; the serving stream checks rely on it), and the products
// cost 2 * 32 * K * N at the bf16 rate (~1.6 us at K 3072, N 8192),
// under the byte bound.  One producer thread keeps a 5-deep ring of raw
// stages in flight by TMA (a 128 k x 64 n box of fp8 weights, 8 KB, and
// the 128 k x M box of fp8 activations), each behind an mbarrier; two
// converter warpgroups, taking alternate stages, turn a stage into bf16
// panels (the weights by wgmma.cuh's integer-pipe conversion, exact; the
// activations as bf16(q * 2^e), the reference's operand) in a 2-deep
// ring; one consumer warpgroup issues the stage's eight products and adds
// each K-128 partial sum to f32 registers (the tensor core's own f32
// accumulation truncates: ~1e-5 * max|out| at K 10240).  Two CTAs an SM
// (~110 KB of shared memory each): ~90 KB of weight bytes in flight per
// SM.  Where the strips are few (N 3072: 48; h2o-danube-3-4b's k and v
// at N 960: 15), K is split over the CTAs of a thread-block cluster (2-8;
// kernels/mx_gemm.py small_split picks it from K and N alone, never from
// M) and the partial sums are added through distributed shared memory in
// rank order: no atomics, two calls give the same bits.  Operands that
// the TMA cannot take (N % 16 != 0, unaligned) take byte loads by the
// producer warp into the same ring.  Its times beside the bound and
// torch.matmul's: PERF.md (chip_smoke.py's kernel phase).
//
// M > 32 (prefill, Table 6, training): the bound is the operations,
// 2 * M * N * K.  The reference's MXU dot multiplies bf16(q * 2^e) by
// bf16(Qw) with f32 accumulation, and those products are exact in f32,
// so a bf16 wgmma with f32 accumulators computes the same function, only
// the order of the sums differs: the tile is capped by the bf16 peak
// (989 TFLOP/s), half the fp8 rate that bound_ms counts.  An fp8 wgmma
// would need a per-row 2^e rescale of a partial sum every 32-wide K step
// (the in-loop rescale MOSS argues against) and accumulates narrower
// than f32.  The design (wgmma.cuh: wgmma_tile, MX policy): 128 x 128
// output tiles of 512 threads; two producer warpgroups convert the fp8 bytes
// into 128-byte-swizzled bf16 panels (q times 2^e for A, K-major; Qw as
// it lies for B, MN-major, read transposed by the instruction) on the
// integer pipe, a 3-deep mbarrier ring ahead of two consumer warpgroups
// that issue m64n128k16 products and add each K-128 partial sum to f32
// registers.  Converting costs ~2 integer instructions an
// element, paid once per (tile, element) and shared by 128 columns or
// rows; the products of a 128 x 128 x 64 step take ~512 SM cycles at the
// bf16 peak.  Measured (H100 at 700 W): ~300 TFLOP/s, the conversion
// and its shared-memory stores holding it (PERF.md).
//
// Ragged M and N are masked in both tiles; K is a multiple of 32 (the
// caller pads), K % 64 == 32 reads as zeros in the last step.
#include <cooperative_groups.h>
#include <cuda.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace cg = cooperative_groups;

// The M <= 32 tile.  Shared memory, from a 1024-byte aligned base: PAN
// bf16 panel stages (A: 128 k-lines of the strip's 64 columns, 128 bytes
// each, MN-major, 128-byte swizzle, the k16 step kk at 2048 * kk; B: the
// 32 rows in two 64-k halves of 32 lines of 128 bytes, K-major, swizzled,
// the step kk at 4096 * (kk / 4) + 32 * (kk % 4)), then RAW raw stages
// (the TMA boxes: the weights' 128 k-rows of 64 bytes, then the
// activations' M rows of 128 bytes), then the barriers.
namespace wst {
constexpr int BN = 64;                    // output columns per CTA
constexpr int ROWS = 32;                  // activation rows (wgmma's n)
constexpr int BK = 128;                   // K per stage = per promotion
constexpr int RAW = 5;                    // raw (TMA) ring depth
constexpr int PAN = 2;                    // bf16 panel ring depth
constexpr int CONSUMERS = 128;            // one warpgroup: the products
constexpr int GROUP = 128;                // a converter warpgroup
constexpr int CONVERTERS = 2 * GROUP;     // two: the panels
constexpr int THREADS = CONSUMERS + CONVERTERS + 32;  // + the producer
constexpr int A_BYTES = BK * BN * 2;      // 16 KB
constexpr int B_HALF = ROWS * 128;        // 4 KB: 32 rows x 64 k
constexpr int B_BYTES = 2 * B_HALF;
constexpr int PAN_BYTES = A_BYTES + B_BYTES;
constexpr int W_BYTES = BK * BN;          // 8 KB of fp8 weights
constexpr int RAW_BYTES = W_BYTES + ROWS * BK;
constexpr int RAW_OFFSET = PAN * PAN_BYTES;
constexpr int BAR_OFFSET = RAW_OFFSET + RAW * RAW_BYTES;
constexpr int SMEM_BYTES = BAR_OFFSET + 2 * (RAW + PAN) * 8 + 1024;
constexpr int MAX_SPLIT = 8;
static_assert(PAN == 2, "converter group g owns panel stage g");
// A group waits for stage t's raw slot only after the consumer took stage
// t - 4 (its panel, two of the group's stages back, was released), so
// the slot's previous load, stage t - RAW, has landed: the parity it
// waits on cannot alias.
static_assert(RAW >= 4, "a raw slot's parity could alias");
}  // namespace wst

// The tile's barriers: raw stage i full (the TMA's bytes, or the
// producer warp's 32 arrivals) and empty (the converters'), panel stage
// i full (the converters') and empty (the consumers').
struct WstBars {
  uint32_t b;
  __device__ uint32_t raw_full(int i) const { return b + 8 * i; }
  __device__ uint32_t raw_empty(int i) const { return b + 8 * (wst::RAW + i); }
  __device__ uint32_t pan_full(int i) const {
    return b + 8 * (2 * wst::RAW + i);
  }
  __device__ uint32_t pan_empty(int i) const {
    return b + 8 * (2 * wst::RAW + wst::PAN + i);
  }
};

// One thread (TMA) or the whole producer warp (byte loads) fills raw
// stage t of this CTA's K range: k0 its first k.
template <bool TMA>
__device__ __forceinline__ void wst_producer(
    const CUtensorMap* tw, const CUtensorMap* tx,
    const uint8_t* __restrict__ qx, const uint8_t* __restrict__ qw, int M,
    int N, int K, int n0, int s_begin, int T, uint32_t base, WstBars bars,
    int lane) {
  if (TMA && lane != 0) return;
  for (int t = 0; t < T; ++t) {
    const int slot = t % wst::RAW;
    const int k0 = (s_begin + t) * wst::BK;
    const uint32_t rw = base + wst::RAW_OFFSET + slot * wst::RAW_BYTES;
    const uint32_t rx = rw + wst::W_BYTES;
    mbar_wait(bars.raw_empty(slot), ((t / wst::RAW) & 1) ^ 1);
    if constexpr (TMA) {
      mbar_arrive_expect_tx(bars.raw_full(slot),
                            wst::W_BYTES + wst::BK * M);
      tma_load_2d(rw, tw, bars.raw_full(slot), n0, k0);
      tma_load_2d(rx, tx, bars.raw_full(slot), k0, 0);
    } else {
      // the weights: 512 chunks of 16 bytes (k-line c / 4, 16 columns
      // at 16 * (c % 4)); the activations: 8 chunks a row below M
      for (int c = lane; c < wst::BK * wst::BN / 16; c += 32) {
        const int k = k0 + c / 4, n = n0 + 16 * (c % 4);
        const int valid = k < K ? max(0, min(16, N - n)) : 0;
        st_shared16(rw + 16 * c,
                    load16_bytes(valid ? qw + static_cast<size_t>(k) * N + n
                                       : qw,
                                 valid));
      }
      for (int c = lane; c < 8 * M; c += 32) {
        const int k = k0 + 16 * (c % 8);
        const int valid = k < K ? 16 : 0;
        st_shared16(rx + 16 * c,
                    load16_bytes(valid ? qx + static_cast<size_t>(c / 8) * K
                                             + k
                                       : qx,
                                 valid));
      }
      mbar_arrive(bars.raw_full(slot));
    }
  }
}

// The converters: two warpgroups, group g taking the stages t = g mod 2
// into panel stage g, so that one group's chain of waits, loads,
// conversions and stores overlaps the other's.  A thread c of a group
// per stage: four weight chunks (chunk j = c + 128 i: k-line j / 4,
// columns 16 (j % 4) + [0, 16)) and up to two activation chunks (chunk
// j = c + 128 i: row j / 8 below M, k 16 (j % 8) + [0, 16)), read from
// the raw stage, converted and stored into the panel stage.
template <bool XE5, bool WE5>
__device__ __forceinline__ void wst_converter(
    const int8_t* __restrict__ sexp, int M, int K, int s_begin, int T,
    uint32_t base, WstBars bars, int g, int c) {
  const int kg = K / 32;
  bool xa[2];
  const int8_t* se_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = c + wst::GROUP * i;
    xa[i] = j / 8 < M;
    se_row[i] = sexp + (xa[i] ? static_cast<size_t>(j / 8) * kg : 0);
  }
  auto exponents = [&](int t, int (&e)[2]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = (s_begin + t) * wst::BK + 16 * (c % 8);
      e[i] = xa[i] && t < T && k < K ? se_row[i][k / 32] : 0;
    }
  };
  const uint32_t pa = base + g * wst::PAN_BYTES;
  const uint32_t pb = pa + wst::A_BYTES;
  int e_next[2];
  exponents(g, e_next);
  for (int t = g; t < T; t += 2) {
    const int slot = t % wst::RAW;
    const int e[2] = {e_next[0], e_next[1]};
    exponents(t + 2, e_next);          // this group's next stage
    const uint32_t rw = base + wst::RAW_OFFSET + slot * wst::RAW_BYTES;
    mbar_wait(bars.raw_full(slot), (t / wst::RAW) & 1);
    uint4 w[4], x[2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = ld_shared16(rw + 16 * (c + wst::GROUP * i));
#pragma unroll
    for (int i = 0; i < 2; ++i)
      x[i] = xa[i] ? ld_shared16(rw + wst::W_BYTES +
                                 16 * (c + wst::GROUP * i))
                   : make_uint4(0u, 0u, 0u, 0u);
    // the slot's generic-proxy reads ordered before the TMA's next
    // (async-proxy) writes into it: without the fence, at two CTAs an SM
    // whole strips came out wrong in most calls at (32, 3072, 8192)
    // split 2
    fence_proxy_async();
    mbar_arrive(bars.raw_empty(slot));
    mbar_wait(bars.pan_empty(g), ((t / 2) & 1) ^ 1);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = c + wst::GROUP * i, kr = j / 4, q = 2 * (j % 4);
      uint4 lo, hi;
      fp8x16_to_bf16<WE5, false>(w[i], 0, lo, hi);
      const uint32_t line = pa + kr * 128;
      st_shared16(line + ((q ^ (kr & 7)) << 4), lo);
      st_shared16(line + (((q + 1) ^ (kr & 7)) << 4), hi);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!xa[i]) continue;
      const int j = c + wst::GROUP * i, m = j / 8, kc = j % 8;
      const int q = 2 * (kc % 4);
      uint4 lo, hi;
      fp8x16_to_bf16<XE5, true>(x[i], e[i], lo, hi);
      const uint32_t line = pb + (kc / 4) * wst::B_HALF + m * 128;
      st_shared16(line + ((q ^ (m & 7)) << 4), lo);
      st_shared16(line + (((q + 1) ^ (m & 7)) << 4), hi);
    }
    fence_proxy_async();        // the panel stores, visible to wgmma
    mbar_arrive(bars.pan_full(g));
  }
}

// The consumer warpgroup: per stage its eight m64n32k16 products into
// `part`, then acc += part (the K-128 promotion) and the panel stage
// released at once, so that the group converting two stages ahead can
// start.  (Issuing stage t + 1 before promoting stage t, with two partial
// sums, released each panel a stage later and was slower at every timed
// shape: it put every conversion behind the previous one.)
__device__ __forceinline__ void wst_consumer(float (&acc)[16], int T,
                                             uint32_t base, WstBars bars) {
  float part[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = part[i] = 0.f;
  for (int t = 0; t < T; ++t) {
    const int stage = t % wst::PAN;
    mbar_wait(bars.pan_full(stage), (t / wst::PAN) & 1);
    const uint32_t pa = base + stage * wst::PAN_BYTES;
    const uint32_t pb = pa + wst::A_BYTES;
    fence_acc(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < wst::BK / 16; ++kk)
      wgmma_m64n32k16(part, gmma_desc(pa + 2048 * kk, 8192, 1024),
                      gmma_desc(pb + (kk / 4) * wst::B_HALF + 32 * (kk % 4),
                                16, 1024),
                      kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(part);
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] += part[i];
    mbar_arrive(bars.pan_empty(stage));
  }
}

// Element i of a consumer thread's fragment: d[4j + 2h + b] lies at the
// strip's column 16 * warp + lane / 4 + 8h and activation row
// 8j + 2 (lane % 4) + b.
__device__ __forceinline__ void wst_store(float* __restrict__ out, float v,
                                          int i, int tid, int n0, int M,
                                          int N) {
  const int lane = tid % 32;
  const int n = n0 + 16 * (tid / 32) + lane / 4 + 8 * ((i >> 1) & 1);
  const int m = 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
  if (m < M && n < N) out[static_cast<size_t>(m) * N + n] = v;
}

// grid (split, strips): the `split` CTAs of a cluster share one strip's
// K, CTA r taking stages [r * S / split, (r + 1) * S / split) of the
// S = ceil(K / 128).  tw, tx: the TMA maps of Qw and Qx (TMA only).
template <bool XE5, bool WE5, bool TMA>
__global__ void __launch_bounds__(wst::THREADS, 2)
mx_gemm_kernel(const __grid_constant__ CUtensorMap tw,
               const __grid_constant__ CUtensorMap tx,
               const uint8_t* __restrict__ qx,
               const int8_t* __restrict__ sexp,
               const uint8_t* __restrict__ qw, float* __restrict__ out,
               int M, int N, int K, int split) {
  extern __shared__ uint8_t smem[];
  const uint32_t raw_base = smem_addr(smem);
  const uint32_t base = (raw_base + 1023u) & ~1023u;
  const WstBars bars{base + wst::BAR_OFFSET};
  const int tid = threadIdx.x;
  const int rank = blockIdx.x;          // the cluster spans grid x
  const int n0 = blockIdx.y * wst::BN;
  const int stages = (K + wst::BK - 1) / wst::BK;
  const int s_begin = rank * stages / split;
  const int T = (rank + 1) * stages / split - s_begin;

  if (tid == 0) {
    for (int i = 0; i < wst::RAW; ++i) {
      mbar_init(bars.raw_full(i), TMA ? 1 : 32);
      mbar_init(bars.raw_empty(i), wst::GROUP);
    }
    for (int i = 0; i < wst::PAN; ++i) {
      mbar_init(bars.pan_full(i), wst::GROUP);
      mbar_init(bars.pan_empty(i), wst::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the B panels zeroed once: rows >= M are never written
  for (int i = tid; i < wst::PAN * wst::B_BYTES / 16; i += wst::THREADS) {
    const int stage = i / (wst::B_BYTES / 16), o = i % (wst::B_BYTES / 16);
    st_shared16(base + stage * wst::PAN_BYTES + wst::A_BYTES + 16 * o,
                make_uint4(0u, 0u, 0u, 0u));
  }
  fence_proxy_async();
  __syncthreads();

  float acc[16];
  if (tid < wst::CONSUMERS)
    wst_consumer(acc, T, base, bars);
  else if (tid < wst::CONSUMERS + wst::CONVERTERS)
    wst_converter<XE5, WE5>(sexp, M, K, s_begin, T, base, bars,
                            (tid - wst::CONSUMERS) / wst::GROUP,
                            tid % wst::GROUP);
  else
    wst_producer<TMA>(&tw, &tx, qx, qw, M, N, K, n0, s_begin, T, base,
                      bars, tid % 32);
  __syncwarp();                 // the producer warp converged again

  if (split == 1) {
    if (tid < wst::CONSUMERS) {
#pragma unroll
      for (int i = 0; i < 16; ++i) wst_store(out, acc[i], i, tid, n0, M, N);
    }
    return;
  }
  // split K: each CTA's partial sums into its shared memory (the first
  // panel stage, idle now), then CTA r adds element i in [16 r / split,
  // 16 (r + 1) / split) of every fragment over the cluster, rank 0 first
  cg::cluster_group cluster = cg::this_cluster();
  float* red = reinterpret_cast<float*>(smem + (base - raw_base));
  if (tid < wst::CONSUMERS) {
#pragma unroll
    for (int i = 0; i < 16; ++i) red[i * wst::CONSUMERS + tid] = acc[i];
  }
  cluster.sync();
  if (tid < wst::CONSUMERS) {
    const int per = 16 / split;
    for (int i = rank * per; i < (rank + 1) * per; ++i) {
      float v = cluster.map_shared_rank(red, 0)[i * wst::CONSUMERS + tid];
      for (int r = 1; r < split; ++r)
        v = __fadd_rn(v, cluster.map_shared_rank(red, r)
                             [i * wst::CONSUMERS + tid]);
      wst_store(out, v, i, tid, n0, M, N);
    }
  }
  cluster.sync();               // no CTA leaves while its sums are read
}

// cuTensorMapEncodeTiled, from the CUDA driver API through the runtime
// (no link against libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                            : nullptr;
  }();
  return fn;
}

// A 2-D uint8 tensor map over `rows` x `cols` (row stride `cols` bytes)
// with boxes of box_rows x box_cols; 0 on success.
static int encode_2d(CUtensorMap* map, const void* ptr, int rows, int cols,
                     int box_rows, int box_cols) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dim[2] = {static_cast<cuuint64_t>(cols),
                             static_cast<cuuint64_t>(rows)};
  const cuuint64_t stride[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t one[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                         const_cast<void*>(ptr), dim, stride, box, one,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + static_cast<int>(r);
}

// tma: qx and qw 16-byte aligned and N % 16 == 0 (the TMA's rule for a
// row stride); else byte loads.  split: 1, 2, 4 or 8 (a cluster along K).
// Returns a CUDA error code, or 1000 + a CUresult where a map is refused.
extern "C" int mx_gemm_launch(const void* qx, const void* sexp, const void* qw,
                              void* out, int M, int N, int K, int x_e5m2,
                              int w_e5m2, int tma, int split, void* stream) {
  if (M < 1 || M > wst::ROWS || split < 1 || split > wst::MAX_SPLIT ||
      wst::CONSUMERS % split != 0 ||
      (split > 1 && (K + wst::BK - 1) / wst::BK < split))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tw{}, tx{};
  if (tma) {
    int code = encode_2d(&tw, qw, K, N, wst::BK, wst::BN);
    if (code == 0) code = encode_2d(&tx, qx, M, K, M, wst::BK);
    if (code != 0) return code;
  }
  using Kernel = void (*)(const CUtensorMap, const CUtensorMap,
                          const uint8_t*, const int8_t*, const uint8_t*,
                          float*, int, int, int, int);
  static const Kernel kernel[8] = {
      mx_gemm_kernel<false, false, false>, mx_gemm_kernel<false, false, true>,
      mx_gemm_kernel<false, true, false>,  mx_gemm_kernel<false, true, true>,
      mx_gemm_kernel<true, false, false>,  mx_gemm_kernel<true, false, true>,
      mx_gemm_kernel<true, true, false>,   mx_gemm_kernel<true, true, true>};
  const Kernel k = kernel[wgmma_instance(x_e5m2, w_e5m2, tma)];
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, wst::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (N + wst::BN - 1) / wst::BN, 1);
  cfg.blockDim = dim3(wst::THREADS, 1, 1);
  cfg.dynamicSmemBytes = wst::SMEM_BYTES;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, k, tw, tx, static_cast<const uint8_t*>(qx),
                           static_cast<const int8_t*>(sexp),
                           static_cast<const uint8_t*>(qw),
                           static_cast<float*>(out), M, N, K, split);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool XE5, bool WE5, bool VEC>
__global__ void __launch_bounds__(wgt::THREADS, 1)
mx_gemm_tiled_kernel(const uint8_t* __restrict__ qx,
                     const int8_t* __restrict__ sexp,
                     const uint8_t* __restrict__ qw, float* __restrict__ out,
                     int M, int N, int K) {
  extern __shared__ uint8_t smem[];
  wgmma_tile<AScale::MX, XE5, WE5, VEC>(qx, sexp, nullptr, qw, out, M, N, K,
                                        K, blockIdx.x * wgt::BM,
                                        blockIdx.y * wgt::BN, smem);
}

// vec: qx and qw 16-byte aligned and N % 16 == 0 (16-byte loads).
extern "C" int mx_gemm_tiled_launch(const void* qx, const void* sexp,
                                    const void* qw, void* out, int M, int N,
                                    int K, int x_e5m2, int w_e5m2, int vec,
                                    void* stream) {
  using Kernel = void (*)(const uint8_t*, const int8_t*, const uint8_t*,
                          float*, int, int, int);
  static const Kernel kernel[8] = {
      mx_gemm_tiled_kernel<false, false, false>,
      mx_gemm_tiled_kernel<false, false, true>,
      mx_gemm_tiled_kernel<false, true, false>,
      mx_gemm_tiled_kernel<false, true, true>,
      mx_gemm_tiled_kernel<true, false, false>,
      mx_gemm_tiled_kernel<true, false, true>,
      mx_gemm_tiled_kernel<true, true, false>,
      mx_gemm_tiled_kernel<true, true, true>};
  dim3 grid((M + wgt::BM - 1) / wgt::BM, (N + wgt::BN - 1) / wgt::BN);
  return static_cast<int>(launch_wgmma(
      kernel[wgmma_instance(x_e5m2, w_e5m2, vec)], grid,
      static_cast<cudaStream_t>(stream), static_cast<const uint8_t*>(qx),
      static_cast<const int8_t*>(sexp), static_cast<const uint8_t*>(qw),
      static_cast<float*>(out), M, N, K));
}
