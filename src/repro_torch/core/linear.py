"""Quantized linear layers: the forward half of ``repro.core.linear``.

``qlinear(x, QT(w, s, a), cfg)`` computes ``x @ w`` under the recipe:

  bf16   ``mm`` with bf16 operands and f32 accumulation;
  moss   the fused two-level quantize + MX GEMM
         (``kernels.dispatch.fused_quant_matmul``) -- the calibration
         forward -- or, with a calibrated ``ActScale`` in ``a``, the
         reduction-free delayed-scale forward ``_qmm_delayed`` (the
         serving steps) through ``kernels.dispatch.mx_matmul``.

Weights arrive pre-quantized (fp8 payload + f32 scale, from
``train.steps.prequantize_params``) or raw with a scale to quantize
against.  Only the forward exists in this slice; the training VJP
(``qmm`` as an autograd Function with fp8 residuals) is ROADMAP queue 1
item 3.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from .actscale import REC, ActScale
from .formats import QuantConfig, is_fp8
from .quant import PerTensorQ, quant_mx_delayed, quant_per_tensor


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


def _pad_axis(x: torch.Tensor, axis: int, mult: int) -> torch.Tensor:
    """Zero-pad ``axis`` up to a multiple of ``mult`` (zeros are exact
    under every quantizer here)."""
    n = x.shape[axis]
    pad = (-n) % mult
    if pad == 0:
        return x
    axis = axis % x.dim()
    widths = [0, 0] * (x.dim() - 1 - axis) + [0, pad]
    return F.pad(x, widths)


def _unsupported(cfg: QuantConfig) -> None:
    if cfg.mode not in ("moss", "bf16"):
        raise NotImplementedError(
            f"quant mode {cfg.mode!r}: ROADMAP queue 1 item 6 (baseline "
            "recipes)")


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
    """The moss forward GEMM: fused quantize + MX GEMM, one pass over
    x, the residual (q, sexp) from the same kernel."""
    from repro_torch.kernels import dispatch

    _unsupported(cfg)
    wq_p = PerTensorQ(q=_pad_axis(wq.q, 0, cfg.micro_group), s=wq.s)
    return dispatch.fused_quant_matmul(
        _pad_axis(x2d, -1, cfg.micro_group), wq_p, fmt=cfg.fwd_format,
        micro_group=cfg.micro_group, out_dtype=torch.float32)


@torch.inference_mode()
def qmm(cfg: QuantConfig, x: torch.Tensor, w: torch.Tensor,
        w_scale: torch.Tensor) -> torch.Tensor:
    """Forward of the reference's ``qmm`` custom VJP (no gradient)."""
    orig_dtype = x.dtype
    *lead, k = x.shape
    if cfg.mode == "bf16":
        from .runtime_flags import mm

        return mm(x, w, out_dtype=torch.float32).to(orig_dtype)
    wq = _quantize_w(cfg, w, w_scale)
    y2d, _ = _fwd_gemm(cfg, x.reshape(-1, k), wq)
    return y2d.reshape(*lead, w.shape[-1]).to(orig_dtype)


def qlinear(x: torch.Tensor, wt: QT, cfg: QuantConfig) -> torch.Tensor:
    """Quantized ``x @ w`` (see module docstring)."""
    if cfg.mode == "bf16":
        return qmm(cfg, x, wt.w, torch.zeros((), dtype=torch.float32))
    _unsupported(cfg)
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


@torch.inference_mode()
def _qmm_delayed(cfg: QuantConfig, x: torch.Tensor, wt: QT,
                 a: ActScale) -> torch.Tensor:
    """Serving forward against the site's calibrated activation scales:
    the quantize is a rescale and a saturating cast with no reduction,
    and the GEMM is the MX GEMM kernel."""
    from repro_torch.kernels import dispatch

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
    x2d = _pad_axis(x2d, -1, cfg.micro_group)
    xq = quant_mx_delayed(x2d, a.s, a.sub, cfg.micro_group,
                          cfg.fwd_format)
    wq_p = PerTensorQ(q=_pad_axis(wq.q, 0, cfg.micro_group), s=wq.s)
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
