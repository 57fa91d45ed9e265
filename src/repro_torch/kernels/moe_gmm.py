"""The grouped-expert (MoE) GEMMs of the MOSS training step: the wrappers
of the Hopper kernels in ``csrc/moe_gmm.cu`` and their plain PyTorch
versions.

The token buffer is the MoE dispatch's flat sorted buffer of E capacity
slots of C rows: expert e owns rows ``[e·C, e·C + sizes[e])`` and the
rest of its slot is zero.  ``sizes`` (E,) int32 are the ragged
per-expert row counts; the kernels skip the products of rows past them
(exact, since those rows are zero), the plain versions compute every
row, as the reference's oracles do, and take no sizes.

``moe_gmm(x, s, qw_stack, sizes, capacity, fmt)``
    x (E·C, K) f32/bf16, the level-1 scale ``s`` (one global amax, from
    the caller), the per-expert fp8 payloads ``qw_stack`` (E, K, N).
    Returns ``(acc (E·C, N) f32 unscaled, q (E·C, K) fp8,
    sexp (E·C, K/32) int8)``: the two-level quantize of every row (as
    ``kernels.mx_fused``) and each slot's rows against its expert's
    payload.  The caller (``kernels.dispatch.moe_grouped_matmul``)
    applies ``s · s_w[e]`` row by row.  dx runs it on the E5M2 gradient
    against the per-expert transposed payloads (E, N, K): the caller
    transposes the stack once (``.transpose(1, 2).contiguous()``) and
    the kernel reads it row-major, as the forward reads its weights.
    On the card a call is two launches into the same outputs, as
    ``mx_fused`` takes M > 32: the ``mx_quant`` kernel over the whole
    buffer, then the 128 x 128 ``wgmma`` tile of ``csrc/moe_gmm.cu`` per
    (row block, column tile, expert); ``moe_gmm_plain`` equals
    ``mx_quant_plain`` followed by ``mx_gemm_plain`` on each expert's
    slot bit for bit.  Replaces ``repro.kernels.moe_gmm.moe_gmm_pallas``;
    the plain version is the reference dispatch's ``ref`` branch
    (``quant_mx`` with the global scale, then ``ref.moe_gmm_ref``).

``moe_dw_gemm(qx, sexp, qg, sizes, capacity, fmt)``
    The forward's residual (E·Cp, K) fp8 with its exponents and the
    per-tensor fp8 gradient (E·Cp, N), Cp a multiple of 32.  Returns
    the unscaled (E, K, N) f32 ``requant_M(Qx_e · 2^sexp_e)ᵀ @ Qg_e``
    per expert (``kernels.mx_bwd`` within each expert's Cp rows); the
    caller (``kernels.dispatch.moe_grouped_matmul_dw``) applies
    ``s_x · s_g``.  On the card a call is two launches: ``kernels.mx_bwd``'s
    requant pass over the whole residual into q' (E, K, Cp) and e'
    (E, K, Cp/32) (the groups at or past each expert's size written as
    zero groups, unread), then the ``wgmma`` tile of ``csrc/moe_gmm.cu``
    per (k tile, n tile, expert), its contraction stopping at
    ``sizes[e]`` rounded up to 32.  Replaces
    ``repro.kernels.moe_gmm.moe_dw_gemm_pallas``; the plain version is
    ``ref.moe_dw_ref``.

A CPU tensor takes the plain version.  A CUDA tensor launches the
kernel, or raises: there is no fallback.
"""

from __future__ import annotations

import torch

from repro_torch.core.formats import fp8_dtype, is_fp8
from repro_torch.core.quant import mx_operand, quant_mx
from repro_torch.core.runtime_flags import einsum, mm

from . import mx_quant
from ._build import LaunchCounter, check, library
from .mx_bwd import launch_requant, requant_m

MICRO = 32

counter = LaunchCounter("moe_gmm")          # the grouped wgmma tile
counter_dw = LaunchCounter("moe_dw_gemm")  # the grouped dW tile


def moe_gmm_plain(x: torch.Tensor, s: torch.Tensor, qw_stack: torch.Tensor,
                  capacity: int, fmt: str = "e4m3"):
    e, k, n = qw_stack.shape
    xq = quant_mx(x, MICRO, fmt, global_scale=s)
    opnd = mx_operand(xq.q, xq.sexp).reshape(e, capacity, k)
    acc = einsum("eck,ekn->ecn", opnd, qw_stack, out_dtype=torch.float32)
    return acc.reshape(e * capacity, n), xq.q, xq.sexp


def _check_sizes(sizes, e, name):
    if sizes.dtype != torch.int32 or sizes.shape != (e,):
        raise ValueError(f"{name}: sizes {sizes.dtype} {tuple(sizes.shape)}, "
                         f"expected int32 ({e},)")


def moe_gmm(x: torch.Tensor, s: torch.Tensor, qw_stack: torch.Tensor,
            sizes: torch.Tensor, capacity: int, fmt: str = "e4m3"):
    """(acc f32 (E·C, N), q fp8 (E·C, K), sexp int8 (E·C, K/32))."""
    t, k = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16) or not is_fp8(qw_stack):
        raise TypeError(f"moe_gmm: dtypes {x.dtype}, {qw_stack.dtype}")
    if qw_stack.dim() != 3 or k % MICRO or qw_stack.shape[1] != k or \
            t != qw_stack.shape[0] * capacity or s.numel() != 1:
        raise ValueError(f"moe_gmm: shapes {tuple(x.shape)}, "
                         f"{tuple(s.shape)}, {tuple(qw_stack.shape)}, "
                         f"capacity {capacity}")
    if fmt not in ("e4m3", "e5m2"):
        raise ValueError(f"moe_gmm: fmt {fmt!r}")
    e, _, n = qw_stack.shape
    _check_sizes(sizes, e, "moe_gmm")
    if x.device.type == "cpu":
        return moe_gmm_plain(x, s, qw_stack, capacity, fmt)
    dev = x.device
    if dev.type != "cuda" or any(a.device != dev for a in (s, qw_stack,
                                                           sizes)):
        raise ValueError(f"moe_gmm: devices {x.device}, {s.device}, "
                         f"{qw_stack.device}, {sizes.device}")
    if not (x.is_contiguous() and qw_stack.is_contiguous()
            and sizes.is_contiguous()):
        raise ValueError("moe_gmm: operands must be contiguous")
    s32 = s.to(torch.float32).reshape(()).contiguous()
    acc = torch.empty((t, n), dtype=torch.float32, device=dev)
    q = torch.empty((t, k), dtype=fp8_dtype(fmt), device=dev)
    sexp = torch.empty((t, k // MICRO), dtype=torch.int8, device=dev)
    if x.data_ptr() % 16:             # mx_quant reads 16-byte vectors
        x = x.clone()
    mx_quant.launch(x, s32, q, sexp, fmt)
    if not (t and n):
        return acc, q, sexp
    vec = int(n % 16 == 0 and qw_stack.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = library().moe_gmm_launch(
            q.data_ptr(), sexp.data_ptr(), qw_stack.data_ptr(),
            sizes.data_ptr(), acc.data_ptr(), e, capacity, n, k,
            int(fmt == "e5m2"), int(qw_stack.dtype == torch.float8_e5m2),
            vec, stream)
    check(code, "moe_gmm")
    counter.hit()
    return acc, q, sexp


def moe_dw_gemm_plain(qx: torch.Tensor, sexp: torch.Tensor,
                      qg: torch.Tensor, capacity: int, fmt: str = "e4m3",
                      payload: bool = False):
    accs, qts, ets = [], [], []
    for qx_e, se_e, qg_e in zip(qx.split(capacity), sexp.split(capacity),
                                qg.split(capacity)):
        xt = requant_m(qx_e, se_e, fmt)
        accs.append(mm(mx_operand(xt.q, xt.sexp), qg_e,
                       out_dtype=torch.float32))
        qts.append(xt.q)
        ets.append(xt.sexp)
    acc = torch.stack(accs)
    return (acc, torch.stack(qts), torch.stack(ets)) if payload else acc


def moe_dw_gemm(qx: torch.Tensor, sexp: torch.Tensor, qg: torch.Tensor,
                sizes: torch.Tensor, capacity: int, fmt: str = "e4m3",
                payload: bool = False):
    """acc f32 (E, K, N); with ``payload`` also the requant's fp8 q
    (E, K, Cp) and int8 exponents (E, K, Cp/32)."""
    t, k = qx.shape
    if not (is_fp8(qx) and is_fp8(qg)) or sexp.dtype != torch.int8:
        raise TypeError(f"moe_dw_gemm: dtypes {qx.dtype}, {sexp.dtype}, "
                        f"{qg.dtype}")
    if capacity % MICRO or t % capacity or k % MICRO or \
            sexp.shape != (t, k // MICRO) or qg.dim() != 2 or \
            qg.shape[0] != t:
        raise ValueError(f"moe_dw_gemm: shapes {tuple(qx.shape)}, "
                         f"{tuple(sexp.shape)}, {tuple(qg.shape)}, "
                         f"capacity {capacity} (a multiple of {MICRO})")
    if fmt not in ("e4m3", "e5m2"):
        raise ValueError(f"moe_dw_gemm: fmt {fmt!r}")
    e, n = t // capacity, qg.shape[1]
    _check_sizes(sizes, e, "moe_dw_gemm")
    if qx.device.type == "cpu":
        return moe_dw_gemm_plain(qx, sexp, qg, capacity, fmt, payload)
    dev = qx.device
    if dev.type != "cuda" or any(a.device != dev for a in (sexp, qg, sizes)):
        raise ValueError(f"moe_dw_gemm: devices {qx.device}, {sexp.device}, "
                         f"{qg.device}, {sizes.device}")
    if not (qx.is_contiguous() and sexp.is_contiguous()
            and qg.is_contiguous() and sizes.is_contiguous()):
        raise ValueError("moe_dw_gemm: operands must be contiguous")
    acc = torch.empty((e, k, n), dtype=torch.float32, device=dev)
    qt = torch.empty((e, k, capacity), dtype=fp8_dtype(fmt), device=dev)
    et = torch.empty((e, k, capacity // MICRO), dtype=torch.int8,
                     device=dev)
    launch_requant(qx, sexp, qt, et, fmt, sizes)
    vec = int(n % 16 == 0 and qt.data_ptr() % 16 == 0
              and qg.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = library().moe_dw_gemm_launch(
            qt.data_ptr(), et.data_ptr(), qg.data_ptr(), sizes.data_ptr(),
            acc.data_ptr(), e, capacity, n, k, int(fmt == "e5m2"),
            int(qg.dtype == torch.float8_e5m2), vec, stream)
    check(code, "moe_dw_gemm")
    counter_dw.hit()
    return (acc, qt, et) if payload else acc
