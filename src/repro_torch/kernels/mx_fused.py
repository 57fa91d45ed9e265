"""Fused two-level quantize + MX GEMM: the wrapper of the Hopper
kernel ``csrc/mx_fused.cu`` and its plain PyTorch version.

Given x (M, K) f32/bf16, the level-1 scale ``s`` and the fp8 weight
payload, returns ``(acc (M, N) f32 unscaled, q (M, K) fp8,
sexp (M, K/32) int8)``: the E8M0 exponents of every 32-wide group of x
against ``s``, the saturating fp8 payload, and ``(q · 2^sexp) @ Qw``.
The caller (``kernels.dispatch.fused_quant_matmul``) computes ``s``
(one global amax) and applies ``s · s_w``.  Replaces the TPU kernel
``repro.kernels.mx_fused.fused_quant_gemm_pallas``; the plain version
follows ``repro.core.quant.quant_mx`` and ``mx_gemm``.

A CPU tensor takes the plain version.  A CUDA tensor launches the
kernel, or raises: there is no fallback.  Up to ``SMALL_M`` rows (the
serving path's calibration forward) one fused kernel quantizes x into
the staging of an 8-row tile that streams its weight strip once.  Above
it (training: the forward, the remat recompute and dx) the call is two
launches into the same outputs: the ``mx_quant`` kernel writes q and
sexp once per element, then ``mx_gemm``'s 128 x 128 ``wgmma`` tile
computes acc from them.  A quantizer inside a 128 x 128 GEMM tile
re-quantizes its rows once per column tile (N/128 times), at ~60-100
instructions an element against ~512 SM cycles of tensor-core products
per 128 x 128 x 64 step, so it, not the GEMM, would set the pace; one
pass costs a read of x and a write of the payload.  The payload and
acc are what the fused kernel computes: the two quantizers share
``csrc/common.cuh``'s routines, and ``fused_quant_gemm_plain`` equals
``mx_quant_plain`` followed by ``mx_gemm_plain`` bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.core.formats import INV_LN2_F32, fp8_dtype, fp8_max, is_fp8
from repro_torch.core.quant import mx_operand, quant_mx
from repro_torch.core.runtime_flags import mm

from . import mx_gemm, mx_quant
from ._build import LaunchCounter, check, library

MICRO = 32
SMALL_M = mx_gemm.SMALL_M  # the largest M that takes the fused 8-row kernel

counter = LaunchCounter("fused_quant_gemm")              # the M <= 32 kernel
# calls at M > 32 (each launches mx_quant and mx_gemm_tiled, which count
# their own launches)
counter_tiled = LaunchCounter("fused_quant_gemm_tiled")


def fused_quant_gemm_plain(x: torch.Tensor, s: torch.Tensor,
                           qw: torch.Tensor, fmt: str = "e4m3"):
    xq = quant_mx(x, MICRO, fmt, global_scale=s)
    acc = mm(mx_operand(xq.q, xq.sexp), qw, out_dtype=torch.float32)
    return acc, xq.q, xq.sexp


def fused_quant_gemm(x: torch.Tensor, s: torch.Tensor, qw: torch.Tensor,
                     fmt: str = "e4m3"):
    """(acc f32 (M, N), q fp8 (M, K), sexp int8 (M, K/32))."""
    m, k = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16) or not is_fp8(qw):
        raise TypeError(f"fused_quant_gemm: dtypes {x.dtype}, {qw.dtype}")
    if k % MICRO or qw.shape[0] != k or s.numel() != 1:
        raise ValueError(f"fused_quant_gemm: shapes {tuple(x.shape)}, "
                         f"{tuple(s.shape)}, {tuple(qw.shape)}")
    if fmt not in ("e4m3", "e5m2"):
        raise ValueError(f"fused_quant_gemm: fmt {fmt!r}")
    if x.device.type == "cpu":
        return fused_quant_gemm_plain(x, s, qw, fmt)
    dev = x.device
    if dev.type != "cuda" or s.device != dev or qw.device != dev:
        raise ValueError(f"fused_quant_gemm: devices {x.device}, "
                         f"{s.device}, {qw.device}")
    if not (x.is_contiguous() and qw.is_contiguous()):
        raise ValueError("fused_quant_gemm: operands must be contiguous")
    n = qw.shape[1]
    s32 = s.to(torch.float32).reshape(()).contiguous()
    acc = torch.empty((m, n), dtype=torch.float32, device=dev)
    q = torch.empty((m, k), dtype=fp8_dtype(fmt), device=dev)
    sexp = torch.empty((m, k // MICRO), dtype=torch.int8, device=dev)
    if m > SMALL_M:
        if x.data_ptr() % 16:         # mx_quant reads 16-byte vectors
            x = x.clone()
        mx_quant.launch(x, s32, q, sexp, fmt)
        mx_gemm.launch_tiled(q, sexp, qw, acc)
        counter_tiled.hit()
        return acc, q, sexp
    vec = int(n % 4 == 0 and qw.data_ptr() % 4 == 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = library().fused_quant_gemm_launch(
            x.data_ptr(), s32.data_ptr(), qw.data_ptr(), acc.data_ptr(),
            q.data_ptr(), sexp.data_ptr(), m, n, k,
            int(x.dtype == torch.bfloat16), int(fmt == "e5m2"),
            int(qw.dtype == torch.float8_e5m2), vec, fp8_max(fmt),
            INV_LN2_F32, stream)
    check(code, "fused_quant_gemm")
    counter.hit()
    return acc, q, sexp
