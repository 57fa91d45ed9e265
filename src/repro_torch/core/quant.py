"""Quantizers and the MOSS GEMM reference (PyTorch).

Counterpart of ``repro.core.quant``: the same formulas in the same
order, so payloads (fp8 ``q``, int8 ``sexp``, f32 scales) are bitwise
equal to the reference's on the same inputs.  Quantization groups along
the last axis (the GEMM's inner K dimension).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .formats import (
    TINY,
    FP8Format,
    QuantConfig,
    cast_fp8,
    div_c,
    ftz,
    e8m0_decode,
    e8m0_encode,
    fp8_dtype,
    fp8_max,
    is_fp8,
)


def pad_axis(x: torch.Tensor, axis: int, mult: int) -> torch.Tensor:
    """Zero-pad ``axis`` up to a multiple of ``mult`` (zeros are exact
    under every quantizer here; fp8 through a uint8 view)."""
    n = x.shape[axis]
    pad = (-n) % mult
    if pad == 0:
        return x
    axis = axis % x.dim()
    widths = [0, 0] * (x.dim() - 1 - axis) + [0, pad]
    if is_fp8(x):
        return F.pad(x.view(torch.uint8), widths).view(x.dtype)
    return F.pad(x, widths)


class PerTensorQ(NamedTuple):
    """Per-tensor quantization: q ≈ x / s."""

    q: torch.Tensor          # fp8
    s: torch.Tensor          # f32 scalar

    def dequant(self, dtype=torch.float32) -> torch.Tensor:
        return self.q.to(torch.float32).to(dtype) * self.s.to(dtype)


class PerGroupQ(NamedTuple):
    """COAT-style per-group quantization along the last axis: fp8 ``q``
    (..., K) and f32 scales ``s`` (..., K // group)."""

    q: torch.Tensor
    s: torch.Tensor

    def dequant(self, dtype=torch.float32) -> torch.Tensor:
        g = self.q.shape[-1] // self.s.shape[-1]
        qf = self.q.to(torch.float32).reshape(*self.q.shape[:-1], -1, g)
        x = qf * self.s[..., None]
        return x.reshape(self.q.shape).to(dtype)


class MxQ(NamedTuple):
    """MOSS two-level microscaled tensor: fp8 ``q`` (..., K), int8 E8M0
    exponents ``sexp`` (..., K // micro_group) and the f32 level-1
    scale ``s``; group g's effective scale is ``s · 2^sexp[g]``."""

    q: torch.Tensor
    sexp: torch.Tensor
    s: torch.Tensor

    def dequant(self, dtype=torch.float32) -> torch.Tensor:
        g = self.q.shape[-1] // self.sexp.shape[-1]
        qf = self.q.to(torch.float32).reshape(*self.q.shape[:-1], -1, g)
        ss = e8m0_decode(self.sexp)
        x = qf * (ss * self.s)[..., None]
        return x.reshape(self.q.shape).to(dtype)


class PrequantParams(NamedTuple):
    """A model's weights pre-quantized for serving: ``qweights`` is the
    params tree with every quantized linear weight replaced by its fp8
    payload, ``scales`` the matching tree of f32 per-(layer) scales
    (ones for never-quantized leaves)."""

    qweights: dict
    scales: dict


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def prequant_weight(w: torch.Tensor, n_stacked: int,
                    fmt: FP8Format = "e4m3",
                    scale: torch.Tensor | None = None,
                    cast_bf16: bool = False
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Build-time per-tensor fp8 quantization of one stacked weight
    leaf: each of the ``w.shape[:n_stacked]`` slices gets its own scale
    ``max(amax, TINY) / FP8_MAX`` (or the supplied one), and
    ``q = saturating_cast(slice / scale)``.  Returns ``(q, scale)``."""
    if cast_bf16:
        w = w.to(torch.bfloat16)
    wf = w.to(torch.float32)
    if scale is None:
        axes = tuple(range(n_stacked, w.dim()))
        amax = wf.abs().amax(dim=axes) if axes else wf.abs()
        scale = div_c(torch.clamp_min(amax, TINY), fp8_max(fmt))
    scale = _f32(scale, w.device)
    sb = scale.reshape(scale.shape + (1,) * (w.dim() - scale.dim()))
    return cast_fp8(wf / sb, fmt), scale


def quant_per_tensor(x: torch.Tensor, fmt: FP8Format = "e4m3",
                     scale: torch.Tensor | None = None) -> PerTensorQ:
    """One f32 scale for the whole tensor (or the supplied one)."""
    xf = x.to(torch.float32)
    if scale is None:
        scale = div_c(torch.clamp_min(xf.abs().amax(), TINY), fp8_max(fmt))
    scale = _f32(scale, x.device)
    return PerTensorQ(q=cast_fp8(xf / scale, fmt), s=scale)


def quant_per_group(x: torch.Tensor, group: int = 128,
                    fmt: FP8Format = "e4m3",
                    scale: torch.Tensor | None = None) -> PerGroupQ:
    """COAT-style scales along the last axis: per ``group`` elements
    ``max(amax, TINY) / FP8_MAX`` (or the supplied ``(..., K // group)``
    scales), then the saturating cast of ``x / s``.  A subnormal input
    counts as a signed 0 (the reference's flush: it decides e5m2
    payloads of groups whose amax is below TINY)."""
    *lead, k = x.shape
    if k % group:
        raise ValueError(f"K={k} not divisible by group={group}")
    xg = ftz(x.to(torch.float32)).reshape(*lead, k // group, group)
    if scale is None:
        s = div_c(torch.clamp_min(xg.abs().amax(dim=-1), TINY),
                  fp8_max(fmt))
    else:
        s = _f32(scale, x.device)
    return PerGroupQ(q=cast_fp8(xg / s[..., None], fmt).reshape(x.shape),
                     s=s)


def group_denominator(sexp: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Each group's effective scale ``2^sexp · s`` as the quantizers
    divide by it, with the reference's flush: 2^-127 (subnormal) and a
    product below the smallest normal count as 0."""
    return ftz(ftz(e8m0_decode(sexp)) * s)


def _guarded_cast(xg: torch.Tensor, denom: torch.Tensor,
                  fmt: FP8Format) -> torch.Tensor:
    # a group whose effective scale underflows f32 to 0 quantizes to 0
    # (dequant multiplies by the same 0: consistent)
    ok = denom > 0
    return cast_fp8(torch.where(ok, xg / torch.where(ok, denom, 1.0),
                                0.0), fmt)


def quant_mx(x: torch.Tensor, micro_group: int = 32,
             fmt: FP8Format = "e4m3",
             global_scale: torch.Tensor | None = None) -> MxQ:
    """MOSS two-level microscaling (paper Eqs. 2-3): per-group fine
    scale ``amax_g / FP8_MAX``, level-1 ``s`` = their max (or
    supplied), level-2 ``2^ceil(log2(s_g / s))``, then the saturating
    cast of ``x / (s · 2^sexp)``."""
    *lead, k = x.shape
    if k % micro_group:
        raise ValueError(f"K={k} not divisible by {micro_group}")
    xg = x.to(torch.float32).reshape(*lead, k // micro_group, micro_group)
    s_g = div_c(xg.abs().amax(dim=-1), fp8_max(fmt))
    if global_scale is None:
        s = torch.clamp_min(s_g.amax(), TINY)
    else:
        s = torch.clamp_min(_f32(global_scale, x.device), TINY)
    sexp = e8m0_encode(s_g / s)
    denom = group_denominator(sexp, s)[..., None]
    q = _guarded_cast(xg, denom, fmt).reshape(x.shape)
    return MxQ(q=q, sexp=sexp, s=s)


def quant_mx_delayed(x: torch.Tensor, global_scale: torch.Tensor,
                     sexp: torch.Tensor, micro_group: int = 32,
                     fmt: FP8Format = "e4m3") -> MxQ:
    """Two-level quantization against calibrated scales: no amax
    reduction, just the rescale and the saturating cast.  ``sexp`` is
    (K // micro_group,) int8 (or already broadcast) and is broadcast
    to the per-row grid the MX GEMM consumes."""
    *lead, k = x.shape
    if k % micro_group:
        raise ValueError(f"K={k} not divisible by {micro_group}")
    xg = x.to(torch.float32).reshape(*lead, k // micro_group, micro_group)
    s = torch.clamp_min(_f32(global_scale, x.device), TINY)
    sexp = torch.as_tensor(sexp, dtype=torch.int8, device=x.device
                           ).expand(*lead, k // micro_group)
    denom = group_denominator(sexp, s)[..., None]
    q = _guarded_cast(xg, denom, fmt).reshape(x.shape)
    return MxQ(q=q, sexp=sexp, s=s)


def quant_excursions(x_abs: torch.Tensor, scale: torch.Tensor,
                     fmt: FP8Format = "e4m3"):
    """Out-of-range accounting for a saturating fp8 cast of ``x_abs /
    scale`` (the quant-health tap, ``repro_torch.obs.quant_health``):

      saturated   elements whose magnitude exceeds ``scale · FP8_MAX``
                  (the cast clamps them to ±FP8_MAX)
      underflowed nonzero elements the cast rounds to exactly 0
      nonzero     the underflow denominator

    ``x_abs`` is |x| (any shape) and ``scale`` broadcasts against it; a
    non-positive scale quantizes its group to 0, as the quantizers'
    zero-denominator guard does.  Returns f32 count scalars (exact below
    2^24 elements).  Round to nearest even sends ``v`` to 0 exactly when
    ``v <= smallest_subnormal / 2``, so underflow is that compare, not a
    cast.  Nothing here feeds the GEMM."""
    fmax = fp8_max(fmt)
    fi = torch.finfo(fp8_dtype(fmt))
    tie = fi.smallest_normal * fi.eps / 2.0   # half the smallest subnormal
    xf = x_abs.to(torch.float32)
    pos = scale > 0
    sat = ((xf > scale * fmax) & pos).to(torch.float32).sum()
    nonzero = xf > 0
    under = (nonzero & ((xf <= scale * tie) | ~pos)).to(torch.float32).sum()
    return sat, under, nonzero.to(torch.float32).sum()


def mx_operand(q: torch.Tensor, sexp: torch.Tensor) -> torch.Tensor:
    """The MX GEMM's left operand ``Qx · 2^sexp`` in bf16: the fp8
    payload upcast to bf16 times the bf16 power of two, rounded to bf16
    as the reference does (exact except for subnormal bf16 results)."""
    *lead, k = q.shape
    g = k // sexp.shape[-1]
    ss = e8m0_decode(sexp).to(torch.bfloat16)
    xf = q.to(torch.bfloat16).reshape(*lead, k // g, g)
    return (xf * ss[..., None]).reshape(*lead, k)


def mx_gemm(xq: MxQ, wq: PerTensorQ,
            out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """MOSS GEMM (paper Fig. 3b): ``(Qx · 2^sexp) @ Qw · (s_x · s_w)``
    with f32 accumulation and the one f32 epilogue multiply."""
    from .runtime_flags import mm

    acc = mm(mx_operand(xq.q, xq.sexp), wq.q, out_dtype=torch.float32)
    return (acc * (xq.s * wq.s)).to(out_dtype)


def group_gemm(xq: PerGroupQ, wq: PerGroupQ | PerTensorQ,
               out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """COAT-style GEMM (paper Fig. 3a): each K group's f32 partial sum
    rescaled by ``s_x[m, g] · s_w``, then summed over the groups (the
    reference's formula; the kernel path applies s_w after the sum,
    ``kernels.dispatch.group_matmul``)."""
    from .runtime_flags import einsum

    *lead, k = xq.q.shape
    g = k // xq.s.shape[-1]
    n = wq.q.shape[-1]
    xf = xq.q.reshape(*lead, k // g, g)
    if isinstance(wq, PerTensorQ):
        w_s = wq.s.reshape(1, 1).expand(k // g, n)
    else:
        w_s = wq.s
    wf = wq.q.reshape(k // g, g, n)
    partial = einsum("...gk,gkn->...gn", xf, wf, out_dtype=torch.float32)
    y = (partial * (xq.s[..., None] * w_s)).sum(dim=-2)
    return y.to(out_dtype)


def pt_gemm(xq: PerTensorQ, wq: PerTensorQ,
            out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """TE-style per-tensor GEMM: the dequant is the one epilogue
    multiply ``s_x · s_w``.  The product is f32 over the fp8 values
    (exact in f32), a serving step's rows one by one on the card
    (``row_order.matmul``)."""
    from . import row_order

    acc = row_order.matmul(xq.q.to(torch.float32), wq.q.to(torch.float32))
    return (acc * (xq.s * wq.s)).to(out_dtype)


# Fidelity (paper Eq. 4, and the uniform-noise model of Theorem 1 that
# the paper's Eqs. 5-7 and Table 7 read).

def snr_db(x: torch.Tensor, x_hat: torch.Tensor) -> torch.Tensor:
    """Quantization signal-to-noise ratio in dB."""
    x = x.to(torch.float32)
    noise = x_hat.to(torch.float32) - x
    p_noise = torch.clamp_min((noise * noise).mean(), TINY)
    return 10.0 * torch.log10((x * x).mean() / p_noise)


def scheme_snr(x: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """SNR of quantize -> dequantize under the configured scheme."""
    if cfg.mode == "per_tensor":
        dq = quant_per_tensor(x, cfg.fwd_format).dequant()
    elif cfg.mode == "per_group":
        dq = quant_per_group(x, cfg.group_size, cfg.fwd_format).dequant()
    elif cfg.mode == "moss":
        dq = quant_mx(x, cfg.micro_group, cfg.fwd_format).dequant()
    else:
        dq = x.to(torch.bfloat16).to(torch.float32)
    return snr_db(x, dq)


def _uniform_model_snr(x: torch.Tensor,
                       noise_power: torch.Tensor) -> torch.Tensor:
    sigma2 = x.to(torch.float32).square().mean()
    return 10.0 * torch.log10(sigma2 / torch.clamp_min(noise_power, TINY))


def model_snr_per_tensor(x: torch.Tensor,
                         fmt: FP8Format = "e4m3") -> torch.Tensor:
    """Paper Eq. (5): noise s^2 / 12 with s = max|X| / FP8_MAX."""
    s = div_c(x.to(torch.float32).abs().amax(), fp8_max(fmt))
    return _uniform_model_snr(x, div_c(s * s, 12.0))


def model_snr_per_group(x: torch.Tensor, group: int = 128,
                        fmt: FP8Format = "e4m3") -> torch.Tensor:
    """Paper Eq. (6): noise mean_g s_g^2 / 12."""
    *lead, k = x.shape
    xg = x.to(torch.float32).reshape(*lead, k // group, group)
    s_g = div_c(xg.abs().amax(dim=-1), fp8_max(fmt))
    return _uniform_model_snr(x, div_c((s_g * s_g).mean(), 12.0))


def model_snr_moss(x: torch.Tensor, micro_group: int = 32,
                   fmt: FP8Format = "e4m3") -> torch.Tensor:
    """Paper Eq. (7): noise mean_g (s · 2^sexp_g)^2 / 12."""
    q = quant_mx(x, micro_group, fmt)
    eff = q.s * e8m0_decode(q.sexp)
    return _uniform_model_snr(x, div_c((eff * eff).mean(), 12.0))
