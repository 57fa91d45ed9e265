"""What one card gives a bare TMA stream of a (K, N) fp8 weight matrix
read in 64-column strips, the way ``mx_gemm``'s M <= 32 tile reads it:
the floor under that tile's time with no conversion and no products
behind the loads.

Each CTA streams its strip (a 128 k x 64 n box, 8 KB, per stage) through
a ring of R stages behind mbarriers (one thread issues the copies, four
warps read each stage once and release it), its K split over a cluster
of `split` CTAs as the tile splits it; unpadded, or with its shared
memory padded to keep one CTA an SM.  Beside it, a device-to-device
copy of the same bytes (which reads and writes them).  Times:
chip_smoke.py's Timer (L2 flushed, batched).  Needs the CUDA toolkit
and a card.

    python3 tools/tma_stream.py
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SOURCE = r'''
#include <cuda.h>
#include "wgmma.cuh"

__global__ void __launch_bounds__(160) tma_stream_kernel(
    const __grid_constant__ CUtensorMap tw, int K, int R, int split,
    float* out) {
  extern __shared__ uint8_t smem[];
  const uint32_t base = (smem_addr(smem) + 1023u) & ~1023u;
  const uint32_t bars = base + R * 8192;
  const int tid = threadIdx.x, rank = blockIdx.x, n0 = blockIdx.y * 64;
  const int stages = (K + 127) / 128, s0 = rank * stages / split;
  const int T = (rank + 1) * stages / split - s0;
  if (tid == 0) {
    for (int i = 0; i < R; ++i) {
      mbar_init(bars + 8 * i, 1);
      mbar_init(bars + 8 * (R + i), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  uint32_t acc = 0;
  if (tid == 128) {
    for (int t = 0; t < T; ++t) {
      const int slot = t % R;
      mbar_wait(bars + 8 * (R + slot), ((t / R) & 1) ^ 1);
      mbar_arrive_expect_tx(bars + 8 * slot, 8192);
      tma_load_2d(base + slot * 8192, &tw, bars + 8 * slot, n0,
                  (s0 + t) * 128);
    }
  } else if (tid < 128) {
    for (int t = 0; t < T; ++t) {
      const int slot = t % R;
      mbar_wait(bars + 8 * slot, (t / R) & 1);
      for (int i = 0; i < 4; ++i) {
        const uint4 v = ld_shared16(base + slot * 8192 + 16 * (tid + 128 * i));
        acc ^= v.x ^ v.y ^ v.z ^ v.w;
      }
      fence_proxy_async();
      mbar_arrive(bars + 8 * (R + slot));
    }
  }
  if (acc == 0x12345678u) out[0] = 1.f;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

extern "C" int tma_stream(const void* w, int K, int N, int R, int split,
                          int pad, void* out, void* stream) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
  cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                   cudaEnableDefault, &q);
  if (q != cudaDriverEntryPointSuccess) return 999;
  CUtensorMap tw{};
  const cuuint64_t dim[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t stride[1] = {(cuuint64_t)N};
  const cuuint32_t box[2] = {64, 128}, one[2] = {1, 1};
  const CUresult r = reinterpret_cast<EncodeTiled>(p)(
      &tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), dim,
      stride, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return 1000 + r;
  const int smem = R * 8192 + 16 * R + 1024 + pad;
  cudaFuncSetAttribute(tma_stream_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (N + 63) / 64, 1);
  cfg.blockDim = dim3(160, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, tma_stream_kernel, tw, K,
                                           R, split, (float*)out);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
'''

# (K, N): phi3-mini-3.8b's gate/up, down and head; h2o-danube-3-4b's k/v
SHAPES = [(3072, 8192), (8192, 3072), (3072, 32064), (3840, 960)]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from chip_smoke import Timer
    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    with tempfile.TemporaryDirectory() as tmp:
        src, lib_path = Path(tmp) / "tma_stream.cu", Path(tmp) / "t.so"
        src.write_text(SOURCE)
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared",
                        "-I", str(_build.CSRC), str(src), "-o",
                        str(lib_path)], check=True)
        lib = ctypes.CDLL(str(lib_path))
    v, i = ctypes.c_void_p, ctypes.c_int
    lib.tma_stream.argtypes = [v, i, i, i, i, i, v, v]
    lib.tma_stream.restype = i
    timer = Timer(torch)
    out = torch.zeros(1, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for k, n in SHAPES:
        w = torch.randint(0, 255, (k, n), dtype=torch.uint8, device="cuda")
        dst = torch.empty_like(w)
        copy = timer.ms(lambda: dst.copy_(w), batched=True)
        print(f"K={k} N={n}: {k * n / 1e6:.2f} MB, byte bound "
              f"{k * n / 3.35e12 * 1e6:.2f} us, copy (read + write) "
              f"{copy * 1e3:.2f} us")
        for ring in (4, 8):
            for split in (1, 2, 4, 8):
                if -(-k // 128) < 2 * split:
                    continue
                for pad in (0, 120000):
                    args = (w.data_ptr(), k, n, ring, split, pad,
                            out.data_ptr(), stream)
                    code = lib.tma_stream(*args)
                    if code:
                        raise RuntimeError(f"tma_stream: error {code}")
                    torch.cuda.synchronize()
                    t = timer.ms(lambda: lib.tma_stream(*args), batched=True)
                    print(f"  ring {ring} split {split} "
                          f"{'1 CTA an SM' if pad else 'unpadded'}: "
                          f"{t * 1e3:.2f} us, {k * n / t / 1e9:.2f} TB/s, "
                          f"{k * n / 3.35e9 / t:.1%} of the byte bound")
    return 0


if __name__ == "__main__":
    sys.exit(main())
