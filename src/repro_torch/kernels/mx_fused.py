"""Fused two-level quantize + MX GEMM: the quantizer kernel then the MX
GEMM kernel, and its plain PyTorch version.

Given x (M, K) f32/bf16, the level-1 scale ``s`` and the fp8 weight
payload, returns ``(acc (M, N) f32 unscaled, q (M, K) fp8,
sexp (M, K/32) int8)``: the E8M0 exponents of every 32-wide group of x
against ``s``, the saturating fp8 payload, and ``(q · 2^sexp) @ Qw``.
The caller (``kernels.dispatch.fused_quant_matmul``) computes ``s``
(one global amax) and applies ``s · s_w``.  Replaces the TPU kernel
``repro.kernels.mx_fused.fused_quant_gemm_pallas``; the plain version
follows ``repro.core.quant.quant_mx`` and ``mx_gemm``.

A CPU tensor takes the plain version.  A CUDA tensor launches the
kernels, or raises: there is no fallback.  At every M the call is two
launches into the same outputs: the ``mx_quant`` kernel
(``csrc/mx_quant.cu``) writes q and sexp once per element, then
``mx_gemm``'s tile for M (``csrc/mx_gemm.cu``: the weight-streaming
tile up to 32 rows, the serving path's calibration forward; the
128 x 128 tile above, training's forward, remat recompute and dx)
computes acc from them.  A quantizer inside a GEMM tile would
re-quantize its rows once per column tile (N/64 or N/128 times), at
~60-100 instructions an element (a warp max, a logf, an IEEE
division), against ~2 integer instructions an element for the tile's
own operand conversion: it, not the GEMM, would set the pace; one pass
costs a read of x and a write of the payload.  ``fused_quant_gemm_plain``
equals ``mx_quant_plain`` followed by ``mx_gemm_plain`` bit for bit,
and every quantizer of the port rounds through ``csrc/common.cuh``'s
``e8m0_exponent`` and ``mx_quant_value``.
"""

from __future__ import annotations

import torch

from repro_torch.core.formats import fp8_dtype, is_fp8
from repro_torch.core.quant import mx_operand, quant_mx
from repro_torch.core.runtime_flags import mm

from . import mx_gemm, mx_quant
from ._build import LaunchCounter

MICRO = 32

# calls, each one mx_quant launch plus one launch of mx_gemm's tile for
# M (which count their own launches): at M <= 32 (the calibration
# forward) and at M > 32 (training)
counter = LaunchCounter("fused_quant_gemm")
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
    acc = torch.empty((m, n), dtype=torch.float32, device=dev)
    q = torch.empty((m, k), dtype=fp8_dtype(fmt), device=dev)
    sexp = torch.empty((m, k // MICRO), dtype=torch.int8, device=dev)
    if x.data_ptr() % 16:             # mx_quant reads 16-byte vectors
        x = x.clone()
    mx_quant.launch(x, s, q, sexp, fmt)
    if mx_gemm.tile_for(m) == "tiled":
        mx_gemm.launch_tiled(q, sexp, qw, acc)
        counter_tiled.hit()
    else:
        mx_gemm.launch_small(q, sexp, qw, acc)
        counter.hit()
    return acc, q, sexp
