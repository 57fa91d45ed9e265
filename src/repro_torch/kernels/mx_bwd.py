"""The dW GEMM of the MOSS linear layer: the wrapper of the Hopper kernel
``csrc/mx_dw_gemm.cu`` and its plain PyTorch version.

Given the forward's fp8 residual ``qx`` (M, K) with its E8M0 exponents
``sexp`` (M, K/32) and the per-tensor fp8 gradient payload ``qg``
(M, N), returns the unscaled (K, N) f32 accumulation of
``requant_M(Qx · 2^sexp)ᵀ @ Qg``: the residual in units of s_x,
transposed and re-quantized in 32-token groups along M (the
contraction) with its level-1 scale pinned to s_x, so s_x cancels.  The
caller (``kernels.dispatch.mx_matmul_dw``) applies ``s_x · s_g``.
Replaces the TPU kernel ``repro.kernels.mx_bwd.mx_dw_gemm_pallas``; the
plain version follows the reference dispatch's ``ref`` branch
(``quant_mx(x_unit.T, 32, fmt, global_scale=1)``, then the MX GEMM).

M is a multiple of 32 (the caller pads).  A CPU tensor takes the plain
version.  A CUDA tensor launches the kernel, or raises: there is no
fallback.
"""

from __future__ import annotations

import torch

from repro_torch.core.formats import INV_LN2_F32, fp8_dtype, fp8_max, is_fp8
from repro_torch.core.quant import MxQ, mx_operand, quant_mx
from repro_torch.core.runtime_flags import mm

from ._build import LaunchCounter, check, library

MICRO = 32

counter = LaunchCounter("mx_dw_gemm")


def requant_m(qx: torch.Tensor, sexp: torch.Tensor,
              fmt: str = "e4m3") -> MxQ:
    """The residual ``Qx · 2^sexp`` (units of s_x) transposed to (K, M)
    and quantized in 32-token groups with level-1 scale 1."""
    one = torch.ones((), dtype=torch.float32, device=qx.device)
    x_unit = MxQ(qx, sexp, one).dequant(torch.float32)
    return quant_mx(x_unit.T, MICRO, fmt, global_scale=one)


def mx_dw_gemm_plain(qx: torch.Tensor, sexp: torch.Tensor,
                     qg: torch.Tensor, fmt: str = "e4m3",
                     payload: bool = False):
    xt = requant_m(qx, sexp, fmt)
    acc = mm(mx_operand(xt.q, xt.sexp), qg, out_dtype=torch.float32)
    return (acc, xt.q, xt.sexp) if payload else acc


def _check(qx, sexp, qg, fmt):
    m, k = qx.shape
    if not (is_fp8(qx) and is_fp8(qg)) or sexp.dtype != torch.int8:
        raise TypeError(f"mx_dw_gemm: dtypes {qx.dtype}, {sexp.dtype}, "
                        f"{qg.dtype}")
    if m % MICRO or k % MICRO or sexp.shape != (m, k // MICRO) or \
            qg.dim() != 2 or qg.shape[0] != m:
        raise ValueError(f"mx_dw_gemm: shapes {tuple(qx.shape)}, "
                         f"{tuple(sexp.shape)}, {tuple(qg.shape)}")
    if fmt not in ("e4m3", "e5m2"):
        raise ValueError(f"mx_dw_gemm: fmt {fmt!r}")


def mx_dw_gemm(qx: torch.Tensor, sexp: torch.Tensor, qg: torch.Tensor,
               fmt: str = "e4m3", payload: bool = False):
    """acc f32 (K, N); with ``payload`` also the requant's fp8 q (K, M)
    and int8 exponents (K, M/32)."""
    _check(qx, sexp, qg, fmt)
    if qx.device.type == "cpu":
        return mx_dw_gemm_plain(qx, sexp, qg, fmt, payload)
    dev = qx.device
    if dev.type != "cuda" or sexp.device != dev or qg.device != dev:
        raise ValueError(f"mx_dw_gemm: devices {qx.device}, {sexp.device}, "
                         f"{qg.device}")
    if not (qx.is_contiguous() and sexp.is_contiguous()
            and qg.is_contiguous()):
        raise ValueError("mx_dw_gemm: operands must be contiguous")
    m, k = qx.shape
    n = qg.shape[1]
    acc = torch.empty((k, n), dtype=torch.float32, device=dev)
    qt = et = None
    if payload:
        qt = torch.empty((k, m), dtype=fp8_dtype(fmt), device=dev)
        et = torch.empty((k, m // MICRO), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = library().mx_dw_gemm_launch(
            qx.data_ptr(), sexp.data_ptr(), qg.data_ptr(), acc.data_ptr(),
            None if qt is None else qt.data_ptr(),
            None if et is None else et.data_ptr(), m, n, k,
            int(qx.dtype == torch.float8_e5m2),
            int(qg.dtype == torch.float8_e5m2), int(fmt == "e5m2"),
            fp8_max(fmt), INV_LN2_F32, stream)
    check(code, "mx_dw_gemm")
    counter.hit()
    return (acc, qt, et) if payload else acc
