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
version.  A CUDA tensor launches the kernels, or raises: there is no
fallback.  On the card a call is two launches: ``csrc/mx_dw_gemm.cu``'s
requant pass (``dw_requant``, counter ``dw_requant``) writes the
payload q' (K, M) and e' (K, M/32) of ``requant_m``, then the 128 x
128 ``wgmma`` tile of ``mx_gemm``'s M > 32 route (``csrc/wgmma.cuh``,
its own instance) computes ``(q' · 2^e') @ Qg`` from it: the call
counts on ``mx_dw_gemm``, not on ``mx_gemm_tiled``.  The grouped dW
(``kernels.moe_gmm.moe_dw_gemm``) runs the same pass.
"""

from __future__ import annotations

import torch

from repro_torch.core.formats import INV_LN2_F32, fp8_dtype, fp8_max, is_fp8
from repro_torch.core.quant import MxQ, mx_operand, quant_mx
from repro_torch.core.runtime_flags import mm

from ._build import LaunchCounter, check, library

MICRO = 32

counter = LaunchCounter("mx_dw_gemm")           # the tile on q', e'
counter_requant = LaunchCounter("dw_requant")  # the requant pass (both dWs)


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


def _check(name, qx, sexp, qg, fmt):
    m, k = qx.shape
    if not is_fp8(qx) or sexp.dtype != torch.int8 or \
            (qg is not None and not is_fp8(qg)):
        raise TypeError(f"{name}: dtypes {qx.dtype}, {sexp.dtype}, "
                        f"{None if qg is None else qg.dtype}")
    if m % MICRO or k % MICRO or sexp.shape != (m, k // MICRO) or \
            (qg is not None and (qg.dim() != 2 or qg.shape[0] != m)):
        raise ValueError(f"{name}: shapes {tuple(qx.shape)}, "
                         f"{tuple(sexp.shape)}, "
                         f"{None if qg is None else tuple(qg.shape)}")
    if fmt not in ("e4m3", "e5m2"):
        raise ValueError(f"{name}: fmt {fmt!r}")


def _on_card(name, *ts):
    dev = ts[0].device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"{name}: devices {[str(t.device) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: operands must be contiguous")


def launch_requant(qx: torch.Tensor, sexp: torch.Tensor, qt: torch.Tensor,
                   et: torch.Tensor, fmt: str,
                   sizes: torch.Tensor | None = None) -> None:
    """The requant pass into ``qt`` (E, K, Cp) and ``et`` (E, K, Cp/32),
    on checked contiguous CUDA operands: the residual ``qx`` (E·Cp, K)
    with ``sexp``, each slot of Cp rows requantized on its own; with
    ``sizes`` (E,) int32 the groups at or past ``sizes[e]`` are written
    as zero groups (q' 0, e' -127) unread."""
    e, k, cp = qt.shape
    if not qt.numel():
        return
    if qx.data_ptr() % 16:            # the pass reads 16-byte vectors
        qx = qx.clone()
    with torch.cuda.device(qx.device):
        stream = torch.cuda.current_stream(qx.device).cuda_stream
        code = library().dw_requant_launch(
            qx.data_ptr(), sexp.data_ptr(),
            None if sizes is None else sizes.data_ptr(), qt.data_ptr(),
            et.data_ptr(), e, cp, k, int(qx.dtype == torch.float8_e5m2),
            int(fmt == "e5m2"), fp8_max(fmt), INV_LN2_F32, stream)
    check(code, "dw_requant")
    counter_requant.hit()


def dw_requant(qx: torch.Tensor, sexp: torch.Tensor, fmt: str = "e4m3"):
    """The requant pass alone: ``requant_m``'s (q' fp8 (K, M),
    e' int8 (K, M/32))."""
    _check("dw_requant", qx, sexp, None, fmt)
    if qx.device.type == "cpu":
        xt = requant_m(qx, sexp, fmt)
        return xt.q, xt.sexp
    _on_card("dw_requant", qx, sexp)
    m, k = qx.shape
    qt = torch.empty((k, m), dtype=fp8_dtype(fmt), device=qx.device)
    et = torch.empty((k, m // MICRO), dtype=torch.int8, device=qx.device)
    launch_requant(qx, sexp, qt.view(1, k, m), et.view(1, k, m // MICRO),
                   fmt)
    return qt, et


def mx_dw_gemm(qx: torch.Tensor, sexp: torch.Tensor, qg: torch.Tensor,
               fmt: str = "e4m3", payload: bool = False):
    """acc f32 (K, N); with ``payload`` also the requant's fp8 q (K, M)
    and int8 exponents (K, M/32)."""
    _check("mx_dw_gemm", qx, sexp, qg, fmt)
    if qx.device.type == "cpu":
        return mx_dw_gemm_plain(qx, sexp, qg, fmt, payload)
    _on_card("mx_dw_gemm", qx, sexp, qg)
    qt, et = dw_requant(qx, sexp, fmt)
    m, k = qx.shape
    n = qg.shape[1]
    acc = torch.empty((k, n), dtype=torch.float32, device=qx.device)
    vec = int(n % 16 == 0 and qt.data_ptr() % 16 == 0
              and qg.data_ptr() % 16 == 0)
    with torch.cuda.device(qx.device):
        stream = torch.cuda.current_stream(qx.device).cuda_stream
        code = library().mx_dw_gemm_launch(
            qt.data_ptr(), et.data_ptr(), qg.data_ptr(), acc.data_ptr(), m,
            n, k, int(fmt == "e5m2"), int(qg.dtype == torch.float8_e5m2),
            vec, stream)
    check(code, "mx_dw_gemm")
    counter.hit()
    return (acc, qt, et) if payload else acc
