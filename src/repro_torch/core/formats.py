"""FP8 / microscaling format constants and helpers (PyTorch).

Counterpart of ``repro.core.formats``.  E8M0 level-2 scales are kept as
**int8 exponents** (the unbiased exponent), never as
``torch.float8_e8m0fnu``: the exponent is what the GEMM kernels consume,
and int8 is what the reference stores, so payloads compare bitwise.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch

# Maximum representable magnitudes (OCP OFP8 spec / paper §2.1).
E4M3_MAX = 448.0
E5M2_MAX = 57344.0

# Smallest normal, used to guard log2 of zero scales.
TINY = 1e-30

# E8M0 exponent range (unbiased).
E8M0_MIN_EXP = -127
E8M0_MAX_EXP = 127

# Smallest normal f32.  The reference runs on XLA's CPU backend, which
# computes with denormals flushed to zero (inputs and results); the
# quantizers below flush at the same places explicitly (``ftz``), so
# their payloads stay bitwise equal to the reference's on any device.
MIN_NORMAL = 2.0 ** -126

# 1 / log(2) in f32.  ``jnp.log2(x)`` is a jitted ``log(x) / log(2.0f)``,
# and XLA compiles a division by a constant into a multiplication by
# the constant's f32 reciprocal; the port computes log2 that way.
LN2_F32 = float(np.log(np.float32(2.0)))
INV_LN2_F32 = float(np.float32(1.0) / np.float32(LN2_F32))

FP8Format = Literal["e4m3", "e5m2"]


def fp8_max(fmt: FP8Format) -> float:
    return E4M3_MAX if fmt == "e4m3" else E5M2_MAX


def fp8_dtype(fmt: FP8Format) -> torch.dtype:
    return torch.float8_e4m3fn if fmt == "e4m3" else torch.float8_e5m2


def is_fp8(t: torch.Tensor) -> bool:
    return t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2)


def div_c(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as a true f32 division, as the reference's quantizers
    divide when called op by op.  (PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal instead; dividing by a tensor on
    x's device is a true division on both devices.)"""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def ftz(x: torch.Tensor) -> torch.Tensor:
    """Flush f32 subnormals to a zero of the same sign (see
    ``MIN_NORMAL``; a flushed negative input quantizes to -0, as in the
    reference)."""
    return torch.where(x.abs() < MIN_NORMAL, x * 0.0, x)


def cast_fp8(x: torch.Tensor, fmt: FP8Format) -> torch.Tensor:
    """Saturating cast to FP8.  Torch's float8 cast does not saturate
    (e4m3fn overflows to NaN), so clamp first; the cast itself rounds
    to nearest even, as XLA's does."""
    m = fp8_max(fmt)
    return torch.clamp(x, -m, m).to(fp8_dtype(fmt))


def log2_f32(x: torch.Tensor) -> torch.Tensor:
    """The reference's f32 log2: ``log(x) * f32(1 / log(2))``."""
    return torch.log(x) * torch.tensor(INV_LN2_F32, dtype=torch.float32,
                                       device=x.device)


def e8m0_encode(ratio: torch.Tensor) -> torch.Tensor:
    """ceil(log2(ratio)) as an int8 exponent; ratio expected in (0, 1].
    Same guards as the reference: the 2^-149 floor keeps log2(0)
    finite and the 1e-6 guard keeps ulp noise from bumping an exact
    power of two up one exponent.  A subnormal ratio counts as 0 (the
    reference's flush), which encodes to -127."""
    r = torch.clamp_min(ftz(ratio.to(torch.float32)), 2.0 ** -149)
    e = torch.ceil(log2_f32(r) - 1e-6)
    return torch.clamp(e, E8M0_MIN_EXP, E8M0_MAX_EXP).to(torch.int8)


def e8m0_decode(exp: torch.Tensor) -> torch.Tensor:
    """int8 exponent -> power-of-two f32 scale, exact over the whole
    E8M0 range: the f32 bit pattern is built through an int32 view, so
    2^-127 (the subnormal 0x00400000) survives."""
    e = exp.to(torch.int32)
    normal = (e + 127) << 23
    bits = torch.where(e > -127, normal,
                       torch.full_like(normal, 0x00400000))
    return bits.view(torch.float32)


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Quantization recipe (see ``repro.core.formats.QuantConfig``).

    mode: "bf16" (no quantization), "per_tensor" (TE-style, one f32
    scale per tensor), "per_group" (COAT-style, an f32 scale per
    ``group_size`` along K) or "moss" (level-1 f32 per tensor, level-2
    E8M0 per ``micro_group`` along K).  weight_scaling: "jit" (a max
    reduction every step), "delayed" (the previous step's amax) or
    "auto" (MOSS automatic scaling).  Training takes every mode;
    serving takes moss with automatic scaling, and the other values
    raise where they are consumed."""

    mode: Literal["bf16", "per_tensor", "per_group", "moss"] = "moss"
    fwd_format: FP8Format = "e4m3"
    bwd_format: FP8Format = "e5m2"
    micro_group: int = 32
    group_size: int = 128
    weight_scaling: Literal["jit", "delayed", "auto"] = "auto"
    rescale_interval: int = 500
    grad_comm_fp8: bool = False
    weight_cast_bf16: bool = False

    @property
    def quantized(self) -> bool:
        return self.mode != "bf16"


BF16_CONFIG = QuantConfig(mode="bf16")
MOSS_CONFIG = QuantConfig(mode="moss")
PER_TENSOR_CONFIG = QuantConfig(mode="per_tensor", weight_scaling="jit")
PER_GROUP_CONFIG = QuantConfig(mode="per_group", weight_scaling="jit")
