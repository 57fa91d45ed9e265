"""The standalone two-level quantizer: the wrapper of the Hopper kernel
``csrc/mx_quant.cu`` and its plain PyTorch version.

Given x (M, K) f32/bf16 and the level-1 scale ``s`` (one global amax,
computed by the caller, ``kernels.dispatch.mx_quantize``), returns the
saturating fp8 payload ``q`` (M, K) and the int8 E8M0 exponents
``sexp`` (M, K/32) of every 32-wide group against ``s``.  Replaces the
TPU kernel ``repro.kernels.mx_quant.mx_quant_pallas``; the plain
version is ``repro.core.quant.quant_mx`` with the supplied scale (the
reference's ``ref.mx_quant_ref``).

A CPU tensor takes the plain version.  A CUDA tensor launches the
kernel, or raises: there is no fallback.
"""

from __future__ import annotations

import torch

from repro_torch.core.formats import INV_LN2_F32, fp8_dtype, fp8_max
from repro_torch.core.quant import quant_mx

from ._build import LaunchCounter, check, library

MICRO = 32

counter = LaunchCounter("mx_quant")


def mx_quant_plain(x: torch.Tensor, s: torch.Tensor, fmt: str = "e4m3"):
    xq = quant_mx(x, MICRO, fmt, global_scale=s)
    return xq.q, xq.sexp


def mx_quant(x: torch.Tensor, s: torch.Tensor, fmt: str = "e4m3"):
    """(q fp8 (M, K), sexp int8 (M, K/32))."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"mx_quant: dtype {x.dtype}")
    if x.dim() != 2 or x.shape[1] % MICRO or s.numel() != 1:
        raise ValueError(f"mx_quant: shapes {tuple(x.shape)}, "
                         f"{tuple(s.shape)}")
    if fmt not in ("e4m3", "e5m2"):
        raise ValueError(f"mx_quant: fmt {fmt!r}")
    if x.device.type == "cpu":
        return mx_quant_plain(x, s, fmt)
    dev = x.device
    if dev.type != "cuda" or s.device != dev:
        raise ValueError(f"mx_quant: devices {x.device}, {s.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("mx_quant: x must be contiguous and 16-byte "
                         "aligned")
    m, k = x.shape
    q = torch.empty((m, k), dtype=fp8_dtype(fmt), device=dev)
    sexp = torch.empty((m, k // MICRO), dtype=torch.int8, device=dev)
    launch(x, s, q, sexp, fmt)
    return q, sexp


def launch(x: torch.Tensor, s: torch.Tensor, q: torch.Tensor,
           sexp: torch.Tensor, fmt: str) -> None:
    """The kernel into ``q`` and ``sexp``, on checked CUDA operands (x
    contiguous and 16-byte aligned; also ``mx_fused``'s M > 32
    quantizer)."""
    m, k = x.shape
    if not m:
        return
    dev = x.device
    s32 = s.to(torch.float32).reshape(()).contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = library().mx_quant_launch(
            x.data_ptr(), s32.data_ptr(), q.data_ptr(), sexp.data_ptr(),
            m * (k // MICRO), int(x.dtype == torch.bfloat16),
            int(fmt == "e5m2"), fp8_max(fmt), INV_LN2_F32, stream)
    check(code, "mx_quant")
    counter.hit()
