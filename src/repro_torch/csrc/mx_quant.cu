// The two-level microscaling quantizer for Hopper: the level-1 scale
// (one pass over x) and the group pass.
//
// global_amax_kernel computes the level-1 scale
//     s = max(amax|x|, TINY) / FP8_MAX
// as the reference's src/repro/kernels/ref.py:global_scale_ref does in one
// fused XLA reduction outside its Pallas quantizer.  It replaces no TPU
// kernel; it replaces the plain torch the port ran there (a widened copy
// of x, an abs copy, an amax, a clamp and a division: about five
// launches, three passes over x's f32 bytes and a host-to-device copy of
// FP8_MAX).  The max is taken over the non-negative floats' bit patterns
// as unsigned integers, which is exact and orders a NaN (sign cleared)
// above inf, so a NaN propagates as torch.amax and jnp.max propagate it;
// the division is IEEE, as the plain version's.  What bounds it on the
// H100: one read of x (at (2048, 4096) bf16 16.8 MB, 5.0 us at 3.35
// TB/s).  The design: a grid of a few blocks an SM, each thread four
// 16-byte loads in flight before it takes their maxima; a block writes
// its maximum to a partials buffer, and the last block to finish (a
// threadfence and a counter) reduces the partials, writes s and sets the
// counter back to 0, so the next launch needs no memset.  The partials
// and the counter are one buffer a device, which the wrapper keeps: the
// port issues its kernels on one stream, so no two launches share it.
//
// mx_quant_kernel replaces the TPU kernel
// src/repro/kernels/mx_quant.py:mx_quant_pallas.  Given x (M, K) f32 or
// bf16 and s, it writes per 32-wide group of each row the E8M0 exponent
// e = e8m0_exponent(amax / FP8_MAX / s) and the saturating fp8 payload
// q = sat_fp8(x / d), d = ftz(ftz(2^e) * s), through the device routines
// every quantizer of the port shares (common.cuh), so that they cannot
// drift apart.  It is the quantizing half of fused_quant_gemm at every M
// (kernels/mx_fused.py) and of moe_gmm.  Payloads match the plain version
// (quant_mx with the supplied s) bit for bit.  What bounds it: the
// bytes, one read of x and one write of q and sexp (at (2048, 4096)
// bf16 25.4 MB, 7.6 us at 3.35 TB/s; at (2048, 11008) f32 113 MB, 34
// us); on the H100, behind an L2 full of dirty lines, a device copy of
// the same bytes takes 12 and 41 us (PERF.md).  Per element it does an
// IEEE division, two compares and half a paired conversion, per group
// two divisions and a log.
//
// The design: K is a multiple of 32, so every group lies inside one row
// and the groups are consecutive 32-element runs of the flat tensor
// (group g is sexp's flat element g).  A warp takes one step of CH
// chunks of 32 lanes x 16 bytes (a lane holds 4 f32 or 8 bf16 values, a
// group's eighth or quarter): both loads issued, with the streaming hint
// (x is read once more at most), before any arithmetic.  CH is 2 where
// such steps fill the card and 1 for few groups (the serving rows, M <=
// 32); the grid covers the steps, one a warp (a grid sized to the SMs
// that strides over the groups, with 4 or 8 chunks a step, measured
// slower).  A group's amax is a shuffle reduction over the lanes that
// hold it; a lane converts its values in pairs and writes its 4 or 8
// payload bytes in one store; the step's exponents reach lanes 0.. by
// shuffles and leave in one store.  No shared memory; M needs no
// padding.
#include "common.cuh"

namespace mxq {
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int AMAX_UNROLL = 4;        // 16-byte loads in flight a thread
constexpr unsigned NAN_BITS = 0x7f800000u;   // |x| bits above: a NaN

// the current device's SM count (the wrapper selects the device)
inline int sm_count() {
  static int cache[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && cache[dev]) return cache[dev];
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (dev < 64) cache[dev] = n;
  return n;
}

// blocks of `kernel` one SM holds at THREADS threads
template <typename K>
int resident(K kernel) {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS, 0);
  return n > 0 ? n : 1;
}
}  // namespace mxq

// |x| of 8 bf16 (BF16) or 4 f32 values as bits, reduced into m: bf16 as
// two 16-bit lanes of a 32-bit word (__vmaxu2), f32 as one word.
template <bool BF16>
__device__ __forceinline__ unsigned absmax_bits(unsigned m, uint4 v) {
  const unsigned mask = BF16 ? 0x7fff7fffu : 0x7fffffffu;
  const unsigned a = v.x & mask, b = v.y & mask, c = v.z & mask,
                 d = v.w & mask;
  if constexpr (BF16) {
    return __vmaxu2(m, __vmaxu2(__vmaxu2(a, b), __vmaxu2(c, d)));
  } else {
    return max(m, max(max(a, b), max(c, d)));
  }
}

// ws[0]: the count of finished blocks; ws[1 + b]: block b's maximum.
template <bool BF16>
__global__ void __launch_bounds__(mxq::THREADS)
global_amax_kernel(const void* __restrict__ x, long long n,
                   unsigned* __restrict__ ws, float* __restrict__ s_out,
                   float fmax) {
  constexpr int VEC = BF16 ? 8 : 4;             // values a 16-byte load
  const uint4* xv = static_cast<const uint4*>(x);
  const long long nvec = n / VEC;
  const long long stride = static_cast<long long>(gridDim.x) * mxq::THREADS;
  long long i = static_cast<long long>(blockIdx.x) * mxq::THREADS +
                threadIdx.x;
  const long long first = i;
  unsigned m = 0;                   // BF16: two 16-bit maxima in one word
  for (; i + (mxq::AMAX_UNROLL - 1) * stride < nvec;
       i += mxq::AMAX_UNROLL * stride) {
    uint4 v[mxq::AMAX_UNROLL];
#pragma unroll
    for (int u = 0; u < mxq::AMAX_UNROLL; ++u)
      v[u] = __ldcg(xv + i + u * stride);
#pragma unroll
    for (int u = 0; u < mxq::AMAX_UNROLL; ++u)
      m = absmax_bits<BF16>(m, v[u]);
  }
  for (; i < nvec; i += stride) m = absmax_bits<BF16>(m, __ldcg(xv + i));
  if constexpr (BF16) {
    m = max(m & 0xffffu, m >> 16) << 16;        // the f32 bits of the max
    const uint16_t* xs = static_cast<const uint16_t*>(x);
    for (long long j = nvec * VEC + first; j < n; j += stride)
      m = max(m, static_cast<unsigned>(xs[j] & 0x7fffu) << 16);
  } else {
    const unsigned* xs = static_cast<const unsigned*>(x);
    for (long long j = nvec * VEC + first; j < n; j += stride)
      m = max(m, xs[j] & 0x7fffffffu);
  }
  m = __reduce_max_sync(mxq::FULL, m);
  __shared__ unsigned warp_max[mxq::WARPS];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned b = 0;
#pragma unroll
    for (int w = 0; w < mxq::WARPS; ++w) b = max(b, warp_max[w]);
    ws[1 + blockIdx.x] = b;
    __threadfence();
    last = atomicAdd(ws, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  unsigned t = 0;
  for (unsigned b = threadIdx.x; b < gridDim.x; b += mxq::THREADS)
    t = max(t, __ldcg(ws + 1 + b));
  t = __reduce_max_sync(mxq::FULL, t);
  if (lane == 0) warp_max[warp] = t;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < mxq::WARPS; ++w) t = max(t, warp_max[w]);
    const float a = __uint_as_float(t);
    // clamp_min(amax, TINY), which keeps a NaN (fmaxf would drop it)
    const float c = t > mxq::NAN_BITS ? a : fmaxf(a, 1e-30f);
    *s_out = __fdiv_rn(c, fmax);
    ws[0] = 0;
  }
}

// 16 bytes of x -> VEC floats: 4 f32, or 8 bf16 widened exactly.
template <int VEC>
__device__ __forceinline__ void unpack(uint4 r, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    v[0] = __uint_as_float(r.x); v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z); v[3] = __uint_as_float(r.w);
  } else {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// VEC elements a lane: 4 (f32 input) or 8 (bf16 input); CH chunks of
// 32 lanes a warp, each warp one step of CH * VEC groups.
template <int VEC, int CH, bool E5M2>
__global__ void __launch_bounds__(mxq::THREADS)
mx_quant_kernel(const void* __restrict__ x, const float* __restrict__ s_ptr,
                uint8_t* __restrict__ q_out, int8_t* __restrict__ sexp_out,
                long long groups, float fmax, float inv_ln2) {
  constexpr int LANES = 32 / VEC;       // lanes a group
  constexpr int GPC = 32 / LANES;       // groups a chunk
  constexpr int GPS = CH * GPC;         // groups a warp step (<= 32)
  constexpr int ESIZE = 16 / VEC;       // bytes an element of x
  static_assert(GPS <= 32, "a step's exponents fill at most one warp");
  const int lane = threadIdx.x & 31;
  const long long st = static_cast<long long>(blockIdx.x) * mxq::WARPS +
                       threadIdx.x / 32;
  const float s = fmaxf(__ldg(s_ptr), 1e-30f);
  const long long g0 = st * GPS;        // the step's first group
  if (g0 >= groups) return;             // the whole warp
  uint4 raw[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const long long g = g0 + c * GPC + lane / LANES;
    const size_t at = static_cast<size_t>(g0 + c * GPC) * 32 +
                      static_cast<size_t>(lane) * VEC;
    raw[c] = g < groups
                 ? __ldcs(reinterpret_cast<const uint4*>(
                       static_cast<const char*>(x) + at * ESIZE))
                 : make_uint4(0u, 0u, 0u, 0u);
  }
  int ex[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    float v[VEC];
    unpack<VEC>(raw[c], v);
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) amax = fmaxf(amax, fabsf(v[i]));
#pragma unroll
    for (int o = LANES / 2; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(mxq::FULL, amax, o));
    const int e = e8m0_exponent(amax / fmax / s, inv_ln2);
    ex[c] = e;
    const long long g = g0 + c * GPC + lane / LANES;
    if (g >= groups) continue;
    const float d = mx_denom(e, s);
    uint32_t w[VEC / 4];
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const uint32_t lo = float2_to_fp8x2<E5M2>(
          mx_scaled(v[i], d, fmax), mx_scaled(v[i + 1], d, fmax));
      const uint32_t hi = float2_to_fp8x2<E5M2>(
          mx_scaled(v[i + 2], d, fmax), mx_scaled(v[i + 3], d, fmax));
      w[i / 4] = lo | (hi << 16);
    }
    uint8_t* out = q_out + static_cast<size_t>(g0 + c * GPC) * 32 +
                   static_cast<size_t>(lane) * VEC;
    if constexpr (VEC == 4) {
      *reinterpret_cast<uint32_t*>(out) = w[0];
    } else {
      *reinterpret_cast<uint2*>(out) = make_uint2(w[0], w[1]);
    }
  }
  // group g0 + l's exponent to lane l (it sits in chunk l / GPC, lane
  // (l % GPC) * LANES), then one store of the step's GPS bytes
  int mine = 0;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int t = __shfl_sync(mxq::FULL, ex[c], (lane % GPC) * LANES);
    if (lane / GPC == c) mine = t;
  }
  if (lane < GPS && g0 + lane < groups)
    sexp_out[g0 + lane] = static_cast<int8_t>(mine);
}

template <int VEC, int CH, bool E5M2>
static void launch_steps(const void* x, const float* s, uint8_t* q,
                         int8_t* sexp, long long groups, float fmax,
                         float inv_ln2, cudaStream_t st) {
  const long long steps = (groups + CH * VEC - 1) / (CH * VEC);
  mx_quant_kernel<VEC, CH, E5M2>
      <<<static_cast<unsigned>((steps + mxq::WARPS - 1) / mxq::WARPS),
         mxq::THREADS, 0, st>>>(x, s, q, sexp, groups, fmax, inv_ln2);
}

// Two chunks a warp where the steps so made fill the card (a full SM
// holds 64 warps), else one.
template <int VEC, bool E5M2>
static int launch_quant(const void* x, const float* s, uint8_t* q,
                        int8_t* sexp, long long groups, float fmax,
                        float inv_ln2, cudaStream_t st) {
  if (groups / (2 * VEC) >= 64LL * mxq::sm_count()) {
    launch_steps<VEC, 2, E5M2>(x, s, q, sexp, groups, fmax, inv_ln2, st);
  } else {
    launch_steps<VEC, 1, E5M2>(x, s, q, sexp, groups, fmax, inv_ln2, st);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mx_quant_launch(const void* x, const void* s, void* q,
                               void* sexp, long long groups, int x_bf16,
                               int e5m2, float fmax, float inv_ln2,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(s);
  uint8_t* qo = static_cast<uint8_t*>(q);
  int8_t* eo = static_cast<int8_t*>(sexp);
  if (x_bf16) {
    return e5m2 ? launch_quant<8, true>(x, sp, qo, eo, groups, fmax,
                                        inv_ln2, st)
                : launch_quant<8, false>(x, sp, qo, eo, groups, fmax,
                                         inv_ln2, st);
  }
  return e5m2 ? launch_quant<4, true>(x, sp, qo, eo, groups, fmax, inv_ln2,
                                      st)
              : launch_quant<4, false>(x, sp, qo, eo, groups, fmax, inv_ln2,
                                       st);
}

template <bool BF16>
static int launch_amax(const void* x, long long n, unsigned* ws, int cap,
                       float* s_out, float fmax, cudaStream_t st) {
  auto kernel = global_amax_kernel<BF16>;
  static int per_sm = mxq::resident(kernel);
  const long long per_block = static_cast<long long>(mxq::THREADS) *
                              mxq::AMAX_UNROLL * (BF16 ? 8 : 4);
  long long blocks = static_cast<long long>(per_sm) * mxq::sm_count();
  const long long want = (n + per_block - 1) / per_block;
  if (want < blocks) blocks = want;
  if (blocks > cap) blocks = cap;
  kernel<<<static_cast<unsigned>(blocks), mxq::THREADS, 0, st>>>(
      x, n, ws, s_out, fmax);
  return static_cast<int>(cudaGetLastError());
}

// ws: 1 + cap words, zero before the first launch (the kernel leaves
// the counter at 0); x 16-byte aligned, n > 0.
extern "C" int global_amax_launch(const void* x, long long n, int x_bf16,
                                  void* ws, int cap, void* s_out, float fmax,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned* w = static_cast<unsigned*>(ws);
  float* so = static_cast<float*>(s_out);
  return x_bf16 ? launch_amax<true>(x, n, w, cap, so, fmax, st)
                : launch_amax<false>(x, n, w, cap, so, fmax, st);
}
