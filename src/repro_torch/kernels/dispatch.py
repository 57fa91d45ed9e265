"""Kernel dispatch: the one entry point for the quantizers and quantized
GEMMs of the training and serving paths and the decode attention (paged
and contiguous).

Counterpart of ``repro.kernels.dispatch``.  What the reference keeps
here stays here: the single global amax of the two-level quantizers'
level-1 scale (on the card one launch of ``kernels.mx_quant``'s
``global_amax`` kernel), the f32 epilogues (``acc · s_x · s_w``, ``acc · s_w``
after the per-group GEMM, and ``acc · s_x · s_g`` for dW with its
``out_rows`` slice), and on the plain path the padding of the GQA group
rows to 8 and the slice back.  The reference pads M and N to its Pallas
blocks (M to 8 for ``mx_quantize``, M and N to 128 for the GEMMs); the
Hopper kernels mask ragged M, N and query rows themselves, so no
operand is padded or copied for them.  K is a multiple of 32 (128 for
the per-group GEMM), padded by the caller (``core.quant.pad_axis``),
and so is dW's M.

The device decides the route: CPU tensors take each kernel's plain
version, CUDA tensors launch the kernel (``kernels.mx_gemm``,
``kernels.mx_fused``, ``kernels.mx_bwd``, ``kernels.mx_quant``,
``kernels.group_gemm``, ``kernels.moe_gmm``, ``kernels.decode_attn``).
The per-tensor (TE) GEMM has no kernel in the reference either
(``pt_matmul``): it is the plain upcast product on both devices.  The
grouped-expert entries add the MoE epilogues: the per-expert weight
scales row by row (``s · repeat(s_w, C)``), and dW's per-expert row
padding to 32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.quant import (MxQ, PerGroupQ, PerTensorQ, pad_axis,
                                    pt_gemm)

from .decode_attn import (decode_attn, decode_attn_paged,
                          decode_attn_paged_plain, decode_attn_ref,
                          plain_rows)
from .group_gemm import GROUP, group_gemm
from .moe_gmm import moe_dw_gemm, moe_gmm
from .mx_bwd import mx_dw_gemm
from .mx_fused import fused_quant_gemm
from .mx_gemm import mx_gemm
from .mx_quant import global_amax, mx_quant

MICRO = 32


def _ceil_to(v: int, mult: int) -> int:
    return v + (-v) % mult


def global_scale(x: torch.Tensor, fmt: str = "e4m3") -> torch.Tensor:
    """Level-1 scale: max(amax|x|, TINY) / FP8_MAX (as
    ``repro.kernels.ref.global_scale_ref``): one launch of the
    ``global_amax`` kernel on the card, its plain version on the CPU
    (``kernels.mx_quant``)."""
    return global_amax(x.contiguous(), fmt)


def mx_quantize(x2d: torch.Tensor, fmt: str = "e4m3",
                micro_group: int = MICRO) -> MxQ:
    """Two-level microscaling quantize of a (M, K) tensor: the level-1
    scale here (one global amax), the groups in the kernel."""
    if x2d.shape[-1] % micro_group:
        raise ValueError(f"K={x2d.shape[-1]} not divisible by "
                         f"micro_group={micro_group}")
    if micro_group != MICRO:
        raise NotImplementedError(f"micro_group={micro_group}")
    x2d = x2d.contiguous()
    s = global_scale(x2d, fmt)
    q, sexp = mx_quant(x2d, s, fmt)
    return MxQ(q=q, sexp=sexp, s=s)


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
    x2d = x2d.contiguous()
    s = global_scale(x2d, fmt)
    acc, q, sexp = fused_quant_gemm(x2d, s, wq.q, fmt)
    y = (acc * (s * wq.s)).to(out_dtype)
    return y, MxQ(q=q, sexp=sexp, s=s)


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
    k = xq.q.shape[1]
    n = gq.q.shape[-1]
    acc = mx_dw_gemm(pad_axis(xq.q, 0, MICRO).contiguous(),
                     pad_axis(xq.sexp, 0, MICRO).contiguous(),
                     pad_axis(gq.q, 0, MICRO).contiguous(), fmt)
    acc = acc[:k if out_rows is None else out_rows, :n]
    return (acc * (xq.s * gq.s)).to(out_dtype)


def moe_grouped_matmul(x2d: torch.Tensor, group_sizes: torch.Tensor,
                       qw_stack: torch.Tensor, w_scales: torch.Tensor, *,
                       capacity: int, fmt: str = "e4m3",
                       micro_group: int = MICRO,
                       out_dtype: torch.dtype = torch.bfloat16
                       ) -> tuple[torch.Tensor, MxQ]:
    """Fused two-level quantize + grouped-expert GEMM over the flat
    sorted token buffer x2d (E·C, K) (expert e owns rows ``[e·C, e·C +
    group_sizes[e])``, the rest of its slot zero) against ``qw_stack``
    (E, K, N): one global amax for the whole buffer, the per-expert
    weight scales ``w_scales`` (E,) applied row by row in the epilogue,
    ``acc · s · repeat(w_scales, C)``.  Returns the finished GEMM
    (E·C, N) and the fp8 residual of the whole buffer."""
    if x2d.shape[-1] % micro_group:
        raise ValueError(f"K={x2d.shape[-1]} not divisible by "
                         f"micro_group={micro_group}")
    if micro_group != MICRO:
        raise NotImplementedError(f"micro_group={micro_group}")
    x2d = x2d.contiguous()
    s = global_scale(x2d, fmt)
    acc, q, sexp = moe_gmm(x2d, s, qw_stack.contiguous(),
                           group_sizes.to(torch.int32).contiguous(),
                           capacity, fmt)
    row_scale = s * w_scales.to(torch.float32).repeat_interleave(capacity)
    y = (acc * row_scale[:, None]).to(out_dtype)
    return y, MxQ(q=q, sexp=sexp, s=s)


def moe_grouped_matmul_dw(xq: MxQ, gq: PerTensorQ,
                          group_sizes: torch.Tensor, *, capacity: int,
                          fmt: str = "e4m3",
                          out_dtype: torch.dtype = torch.float32,
                          out_rows: int | None = None) -> torch.Tensor:
    """The grouped dW: per expert ``requant_M(x̂_e)ᵀ @ Qg_e · s_x · s_g``
    over its row range, all experts in one launch, the gradient with
    one per-tensor scale.  Each expert's rows are padded here to a
    multiple of 32, so that the along-token micro-groups never straddle
    two experts.  Returns (E, K, N), K sliced to ``out_rows`` (the
    residual's K carries the micro-group padding)."""
    micro = xq.q.shape[-1] // xq.sexp.shape[-1]
    if micro != MICRO:
        raise NotImplementedError(f"moe_grouped_matmul_dw: micro-group "
                                  f"{micro}")
    t, k = xq.q.shape
    e, n = t // capacity, gq.q.shape[-1]
    cp = _ceil_to(capacity, MICRO)

    def pad_rows(a):
        if cp == capacity:
            return a.contiguous()
        return pad_axis(a.reshape(e, capacity, -1), 1, MICRO).reshape(
            e * cp, -1).contiguous()

    acc = moe_dw_gemm(pad_rows(xq.q), pad_rows(xq.sexp), pad_rows(gq.q),
                      group_sizes.to(torch.int32).contiguous(), cp, fmt)
    acc = acc[:, :k if out_rows is None else out_rows, :n]
    return (acc * (xq.s * gq.s)).to(out_dtype)


def group_matmul(xq: PerGroupQ, wq: PerTensorQ,
                 out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """COAT-style GEMM (paper Fig. 3a): the per-group f32 rescale of
    every partial sum inside the K loop (the kernel), then ``· s_w``."""
    group = xq.q.shape[-1] // xq.s.shape[-1]
    if group != GROUP or xq.q.dim() != 2:
        raise NotImplementedError(
            f"group_matmul: group {group}, rank {xq.q.dim()} (the kernel "
            "takes 2-D operands with 128-wide groups)")
    acc = group_gemm(xq.q.contiguous(), xq.s.contiguous(),
                     wq.q.contiguous())
    return (acc * wq.s).to(out_dtype)


def pt_matmul(xq: PerTensorQ, wq: PerTensorQ,
              out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """TE-style per-tensor GEMM, epilogue-only dequant: ``(Qx @ Qw) ·
    s_x · s_w``.  The reference computes it outside any kernel (there
    is nothing for a hand-written kernel to fuse), as the upcast product
    with f32 accumulation; so does this, on either device: the fp8
    products are exact in f32 and only the order of the f32 sum differs
    between devices.  (cuBLASLt's fp8 GEMM, ``torch._scaled_mm``, would
    not do: Hopper's fp8 tensor cores accumulate in less than f32.)"""
    return pt_gemm(xq, wq, out_dtype=out_dtype)


def _decode_rows(q, n_valid, sm_scale):
    """Shared front of both decode routes: default sm_scale, broadcast a
    scalar or (B,) n_valid to (B,) int32, and flatten q to the kernel's
    (B, KV, S·G', Dh) rows, draft-major, where S is 1 for a 4-D q and
    the draft count of a 5-D (B, KV, S, G, Dh) one.  On the card G' is
    the true G (no padded copy); on the CPU each draft's G rows are
    padded to the 8-row tile, as the reference pads them."""
    b, kvh, g, dh = q.shape[0], q.shape[1], q.shape[-2], q.shape[-1]
    s_len = q.shape[2] if q.dim() == 5 else 1
    nv = n_valid.to(torch.int32).reshape(-1)
    if nv.shape[0] not in (1, b):
        raise ValueError(f"n_valid {tuple(n_valid.shape)}: expected (), "
                         f"(1,) or ({b},)")
    nv = nv.expand(b).contiguous()
    gp = g if q.device.type != "cpu" else _ceil_to(max(g, 8), 8)
    qp = F.pad(q, (0, 0, 0, gp - g)) if gp != g else q
    qp = qp.reshape(b, kvh, s_len * gp, dh)
    sm = dh ** -0.5 if sm_scale is None else sm_scale

    def unflatten(out):
        out = out.reshape(b, kvh, s_len, gp, dh)[:, :, :, :g]
        return out if q.dim() == 5 else out[:, :, 0]

    return qp, nv, s_len, sm, unflatten


def decode_attention(q, k, v, k_scale, v_scale, n_valid, *,
                     sm_scale: float | None = None) -> torch.Tensor:
    """Decode attention over the contiguous (ring) cache.  q
    (B, KV, G, Dh); k/v (B, KV, C, Dh) and scales as in
    ``kernels.decode_attn``; n_valid the cache ``idx``, a scalar shared
    by every row or (B,) per-slot depths.  Returns (B, KV, G, Dh) f32.

    A 5-D q (B, KV, S, G, Dh) is the speculative verify form: S draft
    queries per row; n_valid is the depth after the S-token write
    (every entry >= S, the cache unwrapped) and draft j sees the slots
    below ``min(n_valid[b] - (S-1-j), C)``.  Returns (B, KV, S, G, Dh)
    f32; the S·G rows share one read of the cache."""
    qp, nv, s_len, sm, unflatten = _decode_rows(q, n_valid, sm_scale)
    return unflatten(decode_attn(qp, k, v, k_scale, v_scale, nv,
                                 sm_scale=sm, q_len=s_len))


def decode_attention_paged(q, k, v, k_scale, v_scale, n_valid,
                           block_table, *,
                           sm_scale: float | None = None) -> torch.Tensor:
    """Decode attention over the floating page pool: q (B, KV, G, Dh) or
    the 5-D verify form, as ``decode_attention``; the pool and table as
    in ``kernels.decode_attn``."""
    qp, nv, s_len, sm, unflatten = _decode_rows(q, n_valid, sm_scale)
    return unflatten(decode_attn_paged(
        qp, k, v, k_scale, v_scale, nv,
        block_table.to(torch.int32).contiguous(), sm_scale=sm,
        q_len=s_len))


def decode_attention_plain(q, k, v, k_scale, v_scale, n_valid,
                           block_table=None, *,
                           sm_scale: float | None = None) -> torch.Tensor:
    """The decode kernels' plain versions, on either device, on the rows
    that ``decode_attention`` (``block_table`` None) or
    ``decode_attention_paged`` hands its kernel: the reference's
    ``REPRO_DECODE_ATTN=einsum`` path (``models.attention._attend``).
    On the CPU it is what those two run, bit for bit."""
    qp, nv, s_len, sm, unflatten = _decode_rows(q, n_valid, sm_scale)
    if block_table is None:
        return unflatten(plain_rows(decode_attn_ref, qp, s_len, k, v,
                                    k_scale, v_scale, nv, sm_scale=sm))
    return unflatten(plain_rows(
        decode_attn_paged_plain, qp, s_len, k, v, k_scale, v_scale, nv,
        block_table.to(torch.int32).contiguous(), sm_scale=sm))
