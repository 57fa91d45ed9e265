"""Kernel dispatch: the one entry point for the quantized GEMMs of the
training and serving paths and the paged decode attention.

Counterpart of ``repro.kernels.dispatch``.  What the reference keeps
here stays here: the single global amax of the fused quantizer's
level-1 scale, the f32 epilogues (``acc · s_x · s_w``, and
``acc · s_x · s_g`` for dW with its ``out_rows`` slice), and on the
plain path the padding of the GQA group rows to 8 and the slice back.
The Hopper kernels mask ragged M, N and query rows themselves, so no
operand is padded or copied for them; K is a multiple of 32, padded by
the caller (``core.linear._pad_axis``), and so is dW's M.

The device decides the route: CPU tensors take each kernel's plain
version, CUDA tensors launch the kernel (``kernels.mx_gemm``,
``kernels.mx_fused``, ``kernels.mx_bwd``, ``kernels.decode_attn``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.formats import TINY, div_c, fp8_max
from repro_torch.core.quant import MxQ, PerTensorQ

from .decode_attn import decode_attn_paged
from .mx_bwd import mx_dw_gemm
from .mx_fused import fused_quant_gemm
from .mx_gemm import mx_gemm

MICRO = 32


def _ceil_to(v: int, mult: int) -> int:
    return v + (-v) % mult


def global_scale(x: torch.Tensor, fmt: str = "e4m3") -> torch.Tensor:
    """Level-1 scale: max(amax|x|, TINY) / FP8_MAX (as
    ``repro.kernels.ref.global_scale_ref``)."""
    amax = x.to(torch.float32).abs().amax()
    return div_c(torch.clamp_min(amax, TINY), fp8_max(fmt))


def mx_matmul(xq: MxQ, wq: PerTensorQ,
              out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """MOSS GEMM (paper Fig. 3b): ``(Qx · 2^sexp) @ Qw · s_x · s_w``."""
    micro = xq.q.shape[-1] // xq.sexp.shape[-1]
    if micro != MICRO or xq.q.dim() != 2:
        raise NotImplementedError(
            f"mx_matmul: micro-group {micro}, rank {xq.q.dim()} (the "
            "kernel takes 2-D operands with 32-wide groups)")
    acc = mx_gemm(xq.q.contiguous(), xq.sexp.contiguous(), wq.q)
    return (acc * (xq.s * wq.s)).to(out_dtype)


def fused_quant_matmul(x2d: torch.Tensor, wq: PerTensorQ,
                       fmt: str = "e4m3", micro_group: int = MICRO,
                       out_dtype: torch.dtype = torch.bfloat16
                       ) -> tuple[torch.Tensor, MxQ]:
    """Fused two-level quantize + MOSS GEMM: x (M, K) in, the finished
    GEMM and the fp8 residual out."""
    if x2d.shape[-1] % micro_group:
        raise ValueError(f"K={x2d.shape[-1]} not divisible by "
                         f"micro_group={micro_group}")
    if micro_group != MICRO:
        raise NotImplementedError(f"micro_group={micro_group}")
    s = global_scale(x2d, fmt)
    acc, q, sexp = fused_quant_gemm(x2d.contiguous(), s, wq.q, fmt)
    y = (acc * (s * wq.s)).to(out_dtype)
    return y, MxQ(q=q, sexp=sexp, s=s)


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """Zero rows appended up to ``rows`` (fp8 through a uint8 view)."""
    if t.shape[0] == rows:
        return t
    raw = t.view(torch.uint8) if t.element_size() == 1 else t
    out = raw.new_zeros((rows, *t.shape[1:]))
    out[:t.shape[0]] = raw
    return out.view(t.dtype)


def mx_matmul_dw(xq: MxQ, gq: PerTensorQ, fmt: str = "e4m3",
                 out_dtype: torch.dtype = torch.float32,
                 out_rows: int | None = None) -> torch.Tensor:
    """The dW GEMM: ``requant_M(x̂)ᵀ @ Qg · s_x · s_g``, where x̂ is the
    fp8 forward residual re-quantized in 32-token groups along M with
    level-1 scale s_x (fused into the kernel).  ``out_rows`` is the
    caller's true K: the residual's K carries the micro-group padding,
    so the result is sliced to ``[:out_rows, :n]`` here."""
    micro = xq.q.shape[-1] // xq.sexp.shape[-1]
    if micro != MICRO:
        raise NotImplementedError(f"mx_matmul_dw: micro-group {micro}")
    m, k = xq.q.shape
    n = gq.q.shape[-1]
    mp = _ceil_to(m, MICRO)
    acc = mx_dw_gemm(_pad_rows(xq.q, mp).contiguous(),
                     _pad_rows(xq.sexp, mp).contiguous(),
                     _pad_rows(gq.q, mp).contiguous(), fmt)
    acc = acc[:k if out_rows is None else out_rows, :n]
    return (acc * (xq.s * gq.s)).to(out_dtype)


def decode_attention_paged(q, k, v, k_scale, v_scale, n_valid,
                           block_table, *,
                           sm_scale: float | None = None) -> torch.Tensor:
    """Single-step decode attention over the floating page pool.
    q (B, KV, G, Dh); the pool and table as in
    ``kernels.decode_attn``.  Returns (B, KV, G, Dh) f32.  The kernel
    takes the G rows as they are; the plain path pads them to the
    8-row tile and slices back, as the reference does, so its sums
    keep the reference's shapes."""
    if q.dim() != 4:
        raise NotImplementedError(
            "batched-query (speculative verify) decode attention: "
            "ROADMAP queue 1 item 9")
    b, _, g, dh = q.shape
    if sm_scale is None:
        sm_scale = dh ** -0.5
    nv = n_valid.to(torch.int32).reshape(-1).expand(b).contiguous()
    bt = block_table.to(torch.int32).contiguous()
    if q.device.type != "cpu":
        return decode_attn_paged(q, k, v, k_scale, v_scale, nv, bt,
                                 sm_scale=sm_scale)
    gp = _ceil_to(max(g, 8), 8)
    qp = F.pad(q, (0, 0, 0, gp - g)) if gp != g else q
    out = decode_attn_paged(qp, k, v, k_scale, v_scale, nv, bt,
                            sm_scale=sm_scale)
    return out[:, :, :g]
