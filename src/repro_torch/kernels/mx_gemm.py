"""MX GEMM: the wrapper of the Hopper kernel ``csrc/mx_gemm.cu`` and
its plain PyTorch version.

``acc = (Qx · 2^sexp) @ Qw`` in f32, unscaled: the caller
(``kernels.dispatch.mx_matmul``) applies ``s_x · s_w``.  Replaces the
TPU kernel ``repro.kernels.mx_gemm.mx_gemm_pallas``; the plain version
follows ``repro.kernels.ref.mx_gemm_ref``.

A CPU tensor takes the plain version.  A CUDA tensor launches the
kernel, or raises: there is no fallback.  The kernel has two tiles on
the tensor cores, chosen from M (``tile_for``): up to ``SMALL_M`` rows
(decode and verify steps, 32-token prefill chunks, the calibration
forward behind ``mx_fused``) a weight-streaming tile reads each weight
byte once for all rows, 64 output columns a CTA, its K split over a
cluster where the columns are few (``small_split``, from K and N alone,
so a row's bits never depend on M); above it (whole-prompt prefill,
Table 6, training behind ``mx_fused``) a 128 x 128 tile.
"""

from __future__ import annotations

import torch

from repro_torch.core.formats import is_fp8
from repro_torch.core.quant import mx_operand
from repro_torch.core.runtime_flags import mm

from ._build import LaunchCounter, check, library

MICRO = 32
SMALL_M = 32          # the largest M that takes the weight-streaming tile
STRIP = 64            # its output columns per CTA
STAGE_K = 128         # its K per pipeline stage (and per f32 promotion)
MAX_SPLIT = 8         # its largest cluster along K

counter = LaunchCounter("mx_gemm")              # the M <= 32 tile
counter_tiled = LaunchCounter("mx_gemm_tiled")  # the M > 32 wgmma tile


def tile_for(m: int) -> str:
    """The tile that takes M rows on the card: "small" (the
    weight-streaming tile, all rows in one pass) or "tiled" (128 x 128)."""
    return "small" if m <= SMALL_M else "tiled"


def small_split(k: int, n: int) -> int:
    """The CTAs that share one 64-column strip's K in the M <= 32 tile
    (a cluster; their partial sums are added in rank order).  It depends
    on K and N alone, never on M, so that a row gives the same bits in a
    decode, verify or chunk step: doubled while the strips fill fewer
    than 120 of the H100's 132 SMs and each CTA keeps two 128-deep
    stages or more, at most ``MAX_SPLIT``."""
    strips = -(-n // STRIP)
    stages = -(-k // STAGE_K)
    split = 1
    while (split < MAX_SPLIT and strips * split < 120
           and stages >= 4 * split):
        split *= 2
    return split


def mx_gemm_plain(qx: torch.Tensor, sexp: torch.Tensor,
                  qw: torch.Tensor) -> torch.Tensor:
    """(M, K) fp8, (M, K/32) int8, (K, N) fp8 -> (M, N) f32."""
    return mm(mx_operand(qx, sexp), qw, out_dtype=torch.float32)


def _check(qx, sexp, qw):
    m, k = qx.shape
    if not (is_fp8(qx) and is_fp8(qw) and sexp.dtype == torch.int8):
        raise TypeError(f"mx_gemm: dtypes {qx.dtype}, {sexp.dtype}, "
                        f"{qw.dtype}: expected fp8, int8, fp8")
    if k % MICRO or sexp.shape != (m, k // MICRO) or qw.shape[0] != k:
        raise ValueError(f"mx_gemm: shapes {tuple(qx.shape)}, "
                         f"{tuple(sexp.shape)}, {tuple(qw.shape)}")


def mx_gemm(qx: torch.Tensor, sexp: torch.Tensor,
            qw: torch.Tensor) -> torch.Tensor:
    """Unscaled MX GEMM accumulation (M, N) f32."""
    _check(qx, sexp, qw)
    if qx.device.type == "cpu":
        return mx_gemm_plain(qx, sexp, qw)
    dev = qx.device
    if dev.type != "cuda" or sexp.device != dev or qw.device != dev:
        raise ValueError(f"mx_gemm: devices {qx.device}, {sexp.device}, "
                         f"{qw.device}")
    if not (qx.is_contiguous() and sexp.is_contiguous()
            and qw.is_contiguous()):
        raise ValueError("mx_gemm: operands must be contiguous")
    m, k = qx.shape
    n = qw.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if tile_for(m) == "tiled":
        launch_tiled(qx, sexp, qw, out)
    else:
        launch_small(qx, sexp, qw, out)
    return out


def launch_small(qx: torch.Tensor, sexp: torch.Tensor, qw: torch.Tensor,
                 out: torch.Tensor) -> None:
    """The weight-streaming tile (1 <= M <= 32) into ``out`` (M, N) f32,
    on checked contiguous CUDA operands (also ``mx_fused``'s GEMM at
    M <= 32).  The TMA brings the operands where N % 16 == 0 and both
    payloads are 16-byte aligned, byte loads elsewhere."""
    m, k = qx.shape
    n = qw.shape[1]
    if not (m and n):
        return
    tma = int(k > 0 and n % 16 == 0 and qx.data_ptr() % 16 == 0
              and qw.data_ptr() % 16 == 0)
    dev = qx.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = library().mx_gemm_launch(
            qx.data_ptr(), sexp.data_ptr(), qw.data_ptr(), out.data_ptr(),
            m, n, k, int(qx.dtype == torch.float8_e5m2),
            int(qw.dtype == torch.float8_e5m2), tma, small_split(k, n),
            stream)
    check(code, "mx_gemm")
    counter.hit()


def launch_tiled(qx: torch.Tensor, sexp: torch.Tensor, qw: torch.Tensor,
                 out: torch.Tensor) -> None:
    """The wgmma tile into ``out`` (M, N) f32, on checked contiguous CUDA
    operands (also ``mx_fused``'s M > 32 GEMM)."""
    m, k = qx.shape
    n = qw.shape[1]
    vec = int(n % 16 == 0 and qx.data_ptr() % 16 == 0
              and qw.data_ptr() % 16 == 0)
    dev = qx.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = library().mx_gemm_tiled_launch(
            qx.data_ptr(), sexp.data_ptr(), qw.data_ptr(), out.data_ptr(),
            m, n, k, int(qx.dtype == torch.float8_e5m2),
            int(qw.dtype == torch.float8_e5m2), vec, stream)
    check(code, "mx_gemm_tiled")
    counter_tiled.hit()
