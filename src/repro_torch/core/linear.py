"""Quantized linear layers: the counterpart of ``repro.core.linear``.

``qlinear(x, QT(w, s, a), cfg)`` computes ``x @ w`` under the recipe:

  bf16        ``mm`` with bf16 operands and f32 accumulation, both ways;
  moss,
  per_group,
  per_tensor  ``qmm``, the training GEMM with its own backward (below);
              in moss, with a calibrated ``ActScale`` in ``a``, the
              reduction-free delayed-scale serving forward
              ``_qmm_delayed`` through ``kernels.dispatch.mx_matmul``.

``qmm`` is a ``torch.autograd.Function`` (the reference's custom VJP).
Its forward saves only the fp8 residuals of x (``MxQ``, ``PerGroupQ``
or ``PerTensorQ``) and the ``PerTensorQ`` of w, never x or w.

  moss        y  = fused quantize + MX GEMM (E4M3), ``· s_x · s_w``;
              dx = the same fused operator on the E5M2 gradient against
                   Wᵀ (``dispatch.fused_quant_matmul``);
              dW = the fp8 residual re-quantized along the tokens
                   against the per-tensor E5M2 gradient
                   (``dispatch.mx_matmul_dw``).
  per_group   (COAT) x and the gradient quantized per 128 along K, the
              GEMMs through ``dispatch.group_matmul``; dW re-quantizes
              the dequantized residual's transpose per 128 tokens.
  per_tensor  (TE) one scale per tensor, the GEMMs through
              ``dispatch.pt_matmul``; dW re-quantizes the dequantized
              residual's transpose.

``qmm_grouped`` (``qlinear_grouped``) is the MoE experts' counterpart
(the reference's grouped custom VJP, moss and bf16): the flat sorted
token buffer (E·C, K) against the stacked expert weights (E, K, N),
every expert in one grouped launch per GEMM (``dispatch.
moe_grouped_matmul`` forward and dx, ``moe_grouped_matmul_dw`` dW),
one global amax per buffer and the per-expert weight scales.

The weight scale ``w_scale`` is the predicted one under automatic
scaling (``core.autoscale``); it gets no gradient.  Weights may also
arrive pre-quantized (fp8 payload + build-time scale) on the serving
path.  Serving the per_group and per_tensor recipes (their delayed
forward and calibration) is a later ROADMAP slice.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .actscale import REC, ActScale
from .formats import QuantConfig, is_fp8
from .quant import (
    MxQ,
    PerGroupQ,
    PerTensorQ,
    pad_axis,
    prequant_weight,
    quant_mx_delayed,
    quant_per_group,
    quant_per_tensor,
)


class QT(NamedTuple):
    """A weight bundled with its fp8 scale ``s`` (None: bf16 mode or
    never-quantized) and the site's activation-scale state ``a``: None
    (just-in-time), an ``ActScale`` (calibrated delayed scales) or a
    site tag string (calibration: record, then run just-in-time)."""

    w: torch.Tensor
    s: torch.Tensor | None = None
    a: Any = None


def _is_fp8(w: torch.Tensor) -> bool:
    return is_fp8(w)


def _unsupported(cfg: QuantConfig) -> None:
    if cfg.mode != "moss":
        raise NotImplementedError(
            f"serving quant mode {cfg.mode!r} (delayed activation "
            "scales): ROADMAP next slices, serving the baselines")


def _quantize_w(cfg: QuantConfig, w: torch.Tensor,
                w_scale: torch.Tensor) -> PerTensorQ:
    """Per-tensor weight quantization; pre-quantized fp8 weights pass
    straight through with their build-time scale."""
    if _is_fp8(w):
        return PerTensorQ(q=w, s=torch.as_tensor(
            w_scale, dtype=torch.float32, device=w.device))
    if cfg.weight_cast_bf16:
        w = w.to(torch.bfloat16)
    if cfg.weight_scaling == "auto":
        return quant_per_tensor(w, cfg.fwd_format, scale=w_scale)
    return quant_per_tensor(w, cfg.fwd_format)


def _fwd_gemm(cfg: QuantConfig, x2d: torch.Tensor, wq: PerTensorQ):
    """The forward GEMM and the fp8 residual of x.  moss: fused
    quantize + MX GEMM, one pass over x, the residual (q, sexp) from
    the same kernel; per_group: K padded to the group, the COAT GEMM;
    per_tensor: the TE GEMM."""
    from repro_torch.kernels import dispatch

    if cfg.mode == "moss":
        wq_p = PerTensorQ(q=pad_axis(wq.q, 0, cfg.micro_group), s=wq.s)
        return dispatch.fused_quant_matmul(
            pad_axis(x2d, -1, cfg.micro_group), wq_p, fmt=cfg.fwd_format,
            micro_group=cfg.micro_group, out_dtype=torch.float32)
    if cfg.mode == "per_group":
        xq = quant_per_group(pad_axis(x2d, -1, cfg.group_size),
                             cfg.group_size, cfg.fwd_format)
        wq_p = PerTensorQ(q=pad_axis(wq.q, 0, cfg.group_size), s=wq.s)
        return dispatch.group_matmul(xq, wq_p, out_dtype=torch.float32), xq
    xq = quant_per_tensor(x2d, cfg.fwd_format)
    return dispatch.pt_matmul(xq, wq, out_dtype=torch.float32), xq


def _qmm_bwd_moss(cfg: QuantConfig, xq: MxQ, wq: PerTensorQ,
                  g: torch.Tensor, w_dtype: torch.dtype):
    """dx and dW from the fp8 residuals (``_qmm_bwd`` of the
    reference, moss branch)."""
    from repro_torch.kernels import dispatch

    lead = g.shape[:-1]
    k, n = wq.q.shape
    g2d = g.reshape(-1, n).to(torch.float32)
    bfmt = cfg.bwd_format
    micro = cfg.micro_group
    # dx = g @ Wᵀ: the fused quantize + GEMM on the E5M2 gradient
    wqT = PerTensorQ(q=pad_axis(wq.q.T.contiguous(), 0, micro), s=wq.s)
    dx2d, _ = dispatch.fused_quant_matmul(
        pad_axis(g2d, -1, micro), wqT, fmt=bfmt, micro_group=micro,
        out_dtype=torch.float32)
    dx = dx2d[:, :k].reshape(*lead, k).to(g.dtype)
    # dW = xᵀ @ g: the residual re-quantized along the tokens
    g_pt = quant_per_tensor(g2d, bfmt)
    dw = dispatch.mx_matmul_dw(xq, g_pt, fmt=cfg.fwd_format,
                               out_dtype=torch.float32, out_rows=k)
    return dx, dw.to(w_dtype)


def _qmm_bwd_baseline(cfg: QuantConfig, xq, wq: PerTensorQ,
                      g: torch.Tensor, w_dtype: torch.dtype):
    """dx and dW of the per_group and per_tensor recipes (``_qmm_bwd``
    of the reference): dx quantizes the gradient along N against Wᵀ;
    dW dequantizes the fp8 residual to bf16 and re-quantizes its
    transpose along the tokens (per 128 tokens in per_group, the
    gradient padded along M to match; one scale in per_tensor)."""
    from repro_torch.kernels import dispatch

    lead = g.shape[:-1]
    k, n = wq.q.shape
    g2d = g.reshape(-1, n).to(torch.float32)
    bfmt = cfg.bwd_format
    if cfg.mode == "per_group":
        gs = cfg.group_size
        gq = quant_per_group(pad_axis(g2d, -1, gs), gs, bfmt)
        wqT = PerTensorQ(q=pad_axis(wq.q.T.contiguous(), 0, gs), s=wq.s)
        dx2d = dispatch.group_matmul(gq, wqT, out_dtype=torch.float32)
        x2d = xq.dequant(torch.bfloat16)[:, :k]
        xTq = quant_per_group(pad_axis(x2d.T, -1, gs), gs,
                              cfg.fwd_format)
        g_pt = quant_per_tensor(pad_axis(g2d, 0, gs), bfmt)
        dw = dispatch.group_matmul(xTq, g_pt, out_dtype=torch.float32)
    else:
        gq = quant_per_tensor(g2d, bfmt)
        dx2d = dispatch.pt_matmul(gq, PerTensorQ(q=wq.q.T, s=wq.s),
                                  out_dtype=torch.float32)
        xTq = quant_per_tensor(xq.dequant(torch.bfloat16).T, cfg.fwd_format)
        dw = dispatch.pt_matmul(xTq, gq, out_dtype=torch.float32)
    dx = dx2d[:, :k].reshape(*lead, k).to(g.dtype)
    return dx, dw.to(w_dtype)


_RESIDUAL = {"moss": MxQ, "per_group": PerGroupQ, "per_tensor": PerTensorQ}


class _QMM(torch.autograd.Function):
    """The reference's ``qmm`` custom VJP (all four recipes)."""

    @staticmethod
    def forward(ctx, cfg: QuantConfig, x, w, w_scale):
        orig_dtype = x.dtype
        *lead, k = x.shape
        ctx.cfg, ctx.w_dtype = cfg, w.dtype
        if cfg.mode == "bf16":
            from .runtime_flags import mm

            # residual: the bf16 activation (what MOSS avoids storing)
            ctx.x_dtype = orig_dtype
            ctx.save_for_backward(x.to(torch.bfloat16),
                                  w.to(torch.bfloat16))
            return mm(x, w, out_dtype=torch.float32).to(orig_dtype)
        wq = _quantize_w(cfg, w, w_scale)
        y2d, xq = _fwd_gemm(cfg, x.reshape(-1, k), wq)
        ctx.save_for_backward(*xq, wq.q, wq.s)
        return y2d.reshape(*lead, w.shape[-1]).to(orig_dtype)

    @staticmethod
    def backward(ctx, g):
        cfg = ctx.cfg
        if cfg.mode == "bf16":
            from .runtime_flags import mm

            x_bf16, w_bf16 = ctx.saved_tensors
            *lead, k = x_bf16.shape
            g2d = g.reshape(-1, g.shape[-1])
            dx = mm(g2d, w_bf16.T, out_dtype=torch.float32)
            dw = mm(x_bf16.reshape(-1, k).T, g2d, out_dtype=torch.float32)
            return (None, dx.reshape(*lead, k).to(ctx.x_dtype),
                    dw.to(ctx.w_dtype), None)
        *res, wq_q, wq_s = ctx.saved_tensors
        xq, wq = _RESIDUAL[cfg.mode](*res), PerTensorQ(wq_q, wq_s)
        bwd = _qmm_bwd_moss if cfg.mode == "moss" else _qmm_bwd_baseline
        dx, dw = bwd(cfg, xq, wq, g, ctx.w_dtype)
        return None, dx, dw, None


def qmm(cfg: QuantConfig, x: torch.Tensor, w: torch.Tensor,
        w_scale: torch.Tensor) -> torch.Tensor:
    """``x @ w`` under ``cfg`` with the recipe's backward (see the
    module docstring)."""
    return _QMM.apply(cfg, x, w, w_scale)


def _quantize_w_stack(cfg: QuantConfig, w: torch.Tensor,
                      w_scale: torch.Tensor) -> PerTensorQ:
    """Per-expert per-tensor quantization of the (E, K, N) stack:
    ``_quantize_w`` for every expert slice, with the predicted
    per-expert scales ``w_scale`` (E,) under automatic scaling (no
    max-reduction over the stack), the measured ones otherwise.  A
    pre-quantized fp8 stack passes straight through with its build-time
    scales (a MoE prompt past the dense combine's limit, served)."""
    if _is_fp8(w):
        return PerTensorQ(q=w, s=torch.as_tensor(
            w_scale, dtype=torch.float32, device=w.device))
    if cfg.weight_cast_bf16:
        w = w.to(torch.bfloat16)
    q, s = prequant_weight(
        w, 1, cfg.fwd_format,
        scale=w_scale if cfg.weight_scaling == "auto" else None)
    return PerTensorQ(q=q, s=s)


class _QMMGrouped(torch.autograd.Function):
    """The reference's ``qmm_grouped`` custom VJP (moss and bf16): the
    flat sorted token buffer x (E·C, K) against the stacked expert
    weights (E, K, N), every expert's GEMM in one grouped launch.

    moss   y  = ``dispatch.moe_grouped_matmul`` (one global amax, the
                per-expert weight scales row by row); saved: the fp8
                residual of the whole buffer and the quantized stack;
           dx = the same grouped fused GEMM on the E5M2 gradient
                against the per-expert transposed payloads;
           dW = ``dispatch.moe_grouped_matmul_dw`` against the
                per-tensor E5M2 gradient.
    bf16   the einsums with bf16 operands and f32 accumulation; saved:
           x and the stack in bf16."""

    @staticmethod
    def forward(ctx, cfg: QuantConfig, capacity: int, x, w_stack, w_scale,
                group_sizes):
        from repro_torch.kernels import dispatch
        from .runtime_flags import einsum

        orig_dtype = x.dtype
        e, k, n = w_stack.shape
        ctx.cfg, ctx.capacity = cfg, capacity
        ctx.x_dtype, ctx.w_dtype = orig_dtype, w_stack.dtype
        if cfg.mode == "bf16":
            ctx.save_for_backward(x.to(torch.bfloat16),
                                  w_stack.to(torch.bfloat16))
            y = einsum("eck,ekn->ecn", x.reshape(e, capacity, k), w_stack,
                       out_dtype=torch.float32)
            return y.reshape(e * capacity, n).to(orig_dtype)
        if cfg.mode != "moss":
            raise NotImplementedError(
                f"qmm_grouped takes moss and bf16, not {cfg.mode!r} (the "
                "baselines run the experts one by one)")
        micro = cfg.micro_group
        wq = _quantize_w_stack(cfg, w_stack, w_scale)
        y, xq = dispatch.moe_grouped_matmul(
            pad_axis(x, -1, micro), group_sizes, pad_axis(wq.q, 1, micro),
            wq.s, capacity=capacity, fmt=cfg.fwd_format, micro_group=micro,
            out_dtype=torch.float32)
        ctx.save_for_backward(*xq, wq.q, wq.s, group_sizes)
        return y.to(orig_dtype)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.kernels import dispatch
        from .runtime_flags import einsum

        cfg, c = ctx.cfg, ctx.capacity
        if cfg.mode == "bf16":
            x_bf16, w_bf16 = ctx.saved_tensors
            e, k, n = w_bf16.shape
            g3 = g.reshape(e, c, n)
            dx = einsum("ecn,ekn->eck", g3, w_bf16, out_dtype=torch.float32)
            dw = einsum("eck,ecn->ekn", x_bf16.reshape(e, c, k), g3,
                        out_dtype=torch.float32)
            return (None, None, dx.reshape(e * c, k).to(ctx.x_dtype),
                    dw.to(ctx.w_dtype), None, None)
        q, sexp, sx, wq_q, wq_s, sizes = ctx.saved_tensors
        xq = MxQ(q, sexp, sx)
        k = wq_q.shape[1]
        micro = cfg.micro_group
        g2d = g.to(torch.float32)
        # dx: the grouped fused GEMM on the E5M2 gradient against each
        # expert's transposed payload (E, N, K), transposed once here
        wqT = pad_axis(wq_q.transpose(1, 2).contiguous(), 1, micro)
        dx, _ = dispatch.moe_grouped_matmul(
            pad_axis(g2d, -1, micro), sizes, wqT, wq_s, capacity=c,
            fmt=cfg.bwd_format, micro_group=micro, out_dtype=torch.float32)
        # dW: the residual re-quantized along each expert's tokens
        g_pt = quant_per_tensor(g2d, cfg.bwd_format)
        dw = dispatch.moe_grouped_matmul_dw(
            xq, g_pt, sizes, capacity=c, fmt=cfg.fwd_format,
            out_dtype=torch.float32, out_rows=k)
        return (None, None, dx.to(g.dtype), dw.to(ctx.w_dtype), None, None)


def qmm_grouped(cfg: QuantConfig, capacity: int, x: torch.Tensor,
                w_stack: torch.Tensor, w_scale: torch.Tensor,
                group_sizes: torch.Tensor) -> torch.Tensor:
    """The grouped-expert ``x @ w_stack[e]`` for each capacity slot of
    x under ``cfg`` (moss or bf16), with its backward."""
    return _QMMGrouped.apply(cfg, capacity, x, w_stack, w_scale,
                             group_sizes)


def qlinear(x: torch.Tensor, wt: QT, cfg: QuantConfig) -> torch.Tensor:
    """Quantized ``x @ w`` (see module docstring)."""
    if cfg.mode == "bf16":
        return qmm(cfg, x, wt.w, torch.zeros((), dtype=torch.float32))
    a = wt.a
    if isinstance(a, str):
        # calibration pass: report this site's activation amax, then
        # run the normal just-in-time forward (what is calibrated)
        if REC.recording:
            REC.record(a, x, cfg)
        a = None
    if isinstance(a, ActScale):
        return _qmm_delayed(cfg, x, wt, a)
    if a is not None:
        raise NotImplementedError(
            "quant-health taps: ROADMAP queue 1 item 12")
    s = wt.s
    if s is None:
        if cfg.weight_scaling == "auto":
            cfg = QuantConfig(**{**cfg.__dict__, "weight_scaling": "jit"})
        s = torch.ones((), dtype=torch.float32)
    return qmm(cfg, x, wt.w, s)


def qlinear_grouped(x_flat: torch.Tensor, wt: QT,
                    group_sizes: torch.Tensor, capacity: int,
                    cfg: QuantConfig) -> torch.Tensor:
    """Grouped-expert qlinear: the flat sorted token buffer
    ``x_flat`` (E·C, K) against the stacked expert weights ``wt.w``
    (E, K, N) with their per-expert predicted scales ``wt.s`` (E,);
    without scales, measured per expert (jit scaling), as ``qlinear``."""
    e = wt.w.shape[0]
    dev = wt.w.device
    if cfg.mode == "bf16":
        return qmm_grouped(cfg, capacity, x_flat, wt.w,
                           torch.zeros((e,), dtype=torch.float32,
                                       device=dev), group_sizes)
    s = wt.s
    if s is None:
        if cfg.weight_scaling == "auto":
            cfg = QuantConfig(**{**cfg.__dict__, "weight_scaling": "jit"})
        s = torch.ones((e,), dtype=torch.float32, device=dev)
    return qmm_grouped(cfg, capacity, x_flat, wt.w, s, group_sizes)


@torch.inference_mode()
def _qmm_delayed(cfg: QuantConfig, x: torch.Tensor, wt: QT,
                 a: ActScale) -> torch.Tensor:
    """Serving forward against the site's calibrated activation scales:
    the quantize is a rescale and a saturating cast with no reduction,
    and the GEMM is the MX GEMM kernel."""
    from repro_torch.kernels import dispatch

    _unsupported(cfg)
    orig_dtype = x.dtype
    *lead, k = x.shape
    x2d = x.reshape(-1, k)
    if wt.s is None and not _is_fp8(wt.w):
        wcfg = QuantConfig(**{**cfg.__dict__, "weight_scaling": "jit"}) \
            if cfg.weight_scaling == "auto" else cfg
        wq = _quantize_w(wcfg, wt.w, torch.ones((), dtype=torch.float32))
    else:
        wq = _quantize_w(cfg, wt.w, wt.s if wt.s is not None
                         else torch.ones((), dtype=torch.float32))
    x2d = pad_axis(x2d, -1, cfg.micro_group)
    xq = quant_mx_delayed(x2d, a.s, a.sub, cfg.micro_group,
                          cfg.fwd_format)
    wq_p = PerTensorQ(q=pad_axis(wq.q, 0, cfg.micro_group), s=wq.s)
    y2d = dispatch.mx_matmul(xq, wq_p, out_dtype=torch.float32)
    return y2d.reshape(*lead, wt.w.shape[-1]).to(orig_dtype)


def dense_general(x: torch.Tensor, wt: QT, cfg: QuantConfig,
                  out_features_shape: tuple[int, ...] | None = None):
    """qlinear for weights whose out-dim is multi-axis (e.g. (K, H, Dh)):
    flattens the trailing axes for the GEMM and reshapes back."""
    w = wt.w
    if w.dim() > 2:
        k = w.shape[0]
        y = qlinear(x, QT(w.reshape(k, -1), wt.s, wt.a), cfg)
        return y.reshape(*x.shape[:-1], *w.shape[1:])
    y = qlinear(x, wt, cfg)
    if out_features_shape:
        y = y.reshape(*x.shape[:-1], *out_features_shape)
    return y
