// The standalone two-level microscaling quantizer for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/mx_quant.py:mx_quant_pallas.
// Given x (M, K) f32 or bf16 and the level-1 scale s (computed outside,
// one global amax), it writes per 32-wide group of each row the E8M0
// exponent e = e8m0_exponent(amax / FP8_MAX / s) and the saturating fp8
// payload q = sat_fp8(x / d), d = ftz(ftz(2^e) * s), through the device
// routines every quantizer of the port shares (common.cuh), so that they
// cannot drift apart.  It is the quantizing half of fused_quant_gemm at
// every M (kernels/mx_fused.py) and of moe_gmm.  Payloads match the plain
// version (quant_mx with the supplied s) bit for bit.
//
// What bounds it on the H100: the bytes, one read of x and one write of
// q and sexp (at (2048, 11008) f32 about 113 MB, 34 us at 3.35 TB/s);
// per element it does a division and a compare, per group a log.
//
// The design: K is a multiple of 32, so every group lies inside one row
// and the groups are consecutive 32-element runs of the flat tensor
// (group g is sexp's flat element g).  Each lane loads 16 bytes (4 f32
// or 8 bf16 values, one group's quarter or eighth), so a warp reads 512
// or 256 contiguous bytes; the group's amax is a shuffle reduction over
// the 8 (f32) or 4 (bf16) lanes that hold it.  Each lane writes its 4 or
// 8 payload bytes in one store, and the first lane of a group its
// exponent.  No shared memory; M needs no padding.
#include "common.cuh"

namespace mxq {
constexpr int THREADS = 256;
}  // namespace mxq

template <int VEC>
__device__ __forceinline__ void load_vec(const void* x, size_t at, bool ok,
                                         float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    float4 f = ok ? *reinterpret_cast<const float4*>(
                        static_cast<const float*>(x) + at)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
    uint4 raw = ok ? *reinterpret_cast<const uint4*>(
                         static_cast<const __nv_bfloat16*>(x) + at)
                   : make_uint4(0u, 0u, 0u, 0u);
    const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(b[i]);
  }
}

// VEC elements per lane: 4 (f32 input) or 8 (bf16 input).
template <int VEC>
__global__ void __launch_bounds__(mxq::THREADS)
mx_quant_kernel(const void* __restrict__ x, const float* __restrict__ s_ptr,
                uint8_t* __restrict__ q_out, int8_t* __restrict__ sexp_out,
                long long groups, bool e5m2, float fmax, float inv_ln2) {
  constexpr int LANES = 32 / VEC;                  // lanes per group
  const long long warp =
      (static_cast<long long>(blockIdx.x) * mxq::THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  const long long g = warp * VEC + lane / LANES;   // this lane's group
  const bool ok = g < groups;
  const size_t at = static_cast<size_t>(warp) * 32 * VEC +
                    static_cast<size_t>(lane) * VEC;
  const float s = fmaxf(*s_ptr, 1e-30f);
  float v[VEC];
  load_vec<VEC>(x, at, ok, v);
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < VEC; ++i) amax = fmaxf(amax, fabsf(v[i]));
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (!ok) return;
  const int e = e8m0_exponent(amax / fmax / s, inv_ln2);
  uint8_t qb[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) qb[i] = mx_quant_value(v[i], e, s, fmax, e5m2);
  if constexpr (VEC == 4) {
    *reinterpret_cast<uint32_t*>(q_out + at) =
        qb[0] | (qb[1] << 8) | (qb[2] << 16) | (static_cast<uint32_t>(qb[3]) << 24);
  } else {
    uint2 w;
    w.x = qb[0] | (qb[1] << 8) | (qb[2] << 16) | (static_cast<uint32_t>(qb[3]) << 24);
    w.y = qb[4] | (qb[5] << 8) | (qb[6] << 16) | (static_cast<uint32_t>(qb[7]) << 24);
    *reinterpret_cast<uint2*>(q_out + at) = w;
  }
  if (lane % LANES == 0) sexp_out[g] = static_cast<int8_t>(e);
}

extern "C" int mx_quant_launch(const void* x, const void* s, void* q,
                               void* sexp, long long groups, int x_bf16,
                               int e5m2, float fmax, float inv_ln2,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(s);
  uint8_t* qo = static_cast<uint8_t*>(q);
  int8_t* eo = static_cast<int8_t*>(sexp);
  const int per_block = mxq::THREADS / 32;         // warps per block
  if (x_bf16) {
    const long long warps = (groups + 7) / 8;
    const unsigned blocks =
        static_cast<unsigned>((warps + per_block - 1) / per_block);
    mx_quant_kernel<8><<<blocks, mxq::THREADS, 0, st>>>(
        x, sp, qo, eo, groups, e5m2 != 0, fmax, inv_ln2);
  } else {
    const long long warps = (groups + 3) / 4;
    const unsigned blocks =
        static_cast<unsigned>((warps + per_block - 1) / per_block);
    mx_quant_kernel<4><<<blocks, mxq::THREADS, 0, st>>>(
        x, sp, qo, eo, groups, e5m2 != 0, fmax, inv_ln2);
  }
  return static_cast<int>(cudaGetLastError());
}
