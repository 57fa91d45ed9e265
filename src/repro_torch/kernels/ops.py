"""The quantizer/GEMM ablation entry points (the paper's Table 6), over
``kernels.dispatch``: the counterpart of ``repro.kernels.ops``.  The
training path (``core.linear``) calls ``kernels.dispatch`` directly.

  mx_quantize   two-level quantize (``kernels.mx_quant``)
  mx_matmul     the MOSS GEMM on pre-quantized operands (``mx_gemm``)
  coat_matmul   the COAT per-group GEMM (``group_gemm``)
  moss_linear   the fused quantize + MOSS GEMM of x against a weight
"""

from __future__ import annotations

import torch

from repro_torch.core.quant import MxQ, PerGroupQ, PerTensorQ, pad_axis, \
    quant_per_tensor

from . import dispatch


def mx_quantize(x: torch.Tensor, fmt: str = "e4m3"):
    """Two-level microscaling quantize of x (M, K): (q, sexp, s)."""
    q = dispatch.mx_quantize(x, fmt=fmt)
    return q.q, q.sexp, q.s


def mx_matmul(qx, sexp, qw, s_x, s_w, out_dtype=torch.bfloat16):
    """The MOSS GEMM: the kernel's main loop, then ``· s_x · s_w``."""
    return dispatch.mx_matmul(MxQ(q=qx, sexp=sexp, s=s_x),
                              PerTensorQ(q=qw, s=s_w), out_dtype=out_dtype)


def coat_matmul(qx, sx, qw, s_w, out_dtype=torch.bfloat16):
    """The COAT per-group GEMM (in-loop dequant), then ``· s_w``."""
    return dispatch.group_matmul(PerGroupQ(q=qx, s=sx),
                                 PerTensorQ(q=qw, s=s_w),
                                 out_dtype=out_dtype)


def moss_linear(x: torch.Tensor, w: torch.Tensor,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """The MOSS linear layer through the kernel path: the fused
    two-level quantize + GEMM of x against the per-tensor fp8 weight.
    K is zero-padded to a multiple of 32 (exact: a zero group
    quantizes to zero)."""
    x2d = pad_axis(x.reshape(-1, x.shape[-1]), -1, dispatch.MICRO)
    w = pad_axis(w, 0, dispatch.MICRO)
    y, _ = dispatch.fused_quant_matmul(x2d, quant_per_tensor(w),
                                       out_dtype=out_dtype)
    return y.reshape(*x.shape[:-1], w.shape[-1])
