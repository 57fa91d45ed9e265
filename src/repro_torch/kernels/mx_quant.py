"""The two-level quantizer: the wrappers of the Hopper kernels
``csrc/mx_quant.cu`` (the level-1 scale and the group pass) and their
plain PyTorch versions.

``global_amax(x, fmt)`` is the level-1 scale ``max(amax|x|, TINY) /
FP8_MAX``, as ``repro.kernels.ref.global_scale_ref`` computes it outside
the reference's Pallas quantizer (one fused reduction): one kernel
launch and a 0-d f32 tensor on x's device, bit for bit the plain
version's (a NaN propagates; an inf gives an inf scale).

``mx_quant(x, s, fmt)``, given x (M, K) f32/bf16 and the level-1 scale
``s``, returns the saturating fp8 payload ``q`` (M, K) and the int8
E8M0 exponents ``sexp`` (M, K/32) of every 32-wide group against ``s``.
Replaces the TPU kernel ``repro.kernels.mx_quant.mx_quant_pallas``; the
plain version is ``repro.core.quant.quant_mx`` with the supplied scale
(the reference's ``ref.mx_quant_ref``).

A CPU tensor takes the plain version.  A CUDA tensor launches the
kernel, or raises: there is no fallback.
"""

from __future__ import annotations

import torch

from repro_torch.core.formats import (INV_LN2_F32, TINY, div_c, fp8_dtype,
                                      fp8_max)
from repro_torch.core.quant import quant_mx

from ._build import LaunchCounter, check, library

MICRO = 32
# the most blocks of one global_amax launch (its partials buffer)
AMAX_BLOCKS = 4096

counter = LaunchCounter("mx_quant")
counter_amax = LaunchCounter("global_amax")

# per device: the global_amax kernel's block counter and partial maxima,
# zero before the first launch; every launch leaves the counter at 0.
# The port issues its kernels on the current stream of one thread, so
# no two launches use a buffer at once.
_AMAX_WORKSPACE: dict[torch.device, torch.Tensor] = {}


def _check_fmt(fmt: str, name: str) -> None:
    if fmt not in ("e4m3", "e5m2"):
        raise ValueError(f"{name}: fmt {fmt!r}")


def global_scale_plain(x: torch.Tensor, fmt: str = "e4m3") -> torch.Tensor:
    amax = x.to(torch.float32).abs().amax()
    return div_c(torch.clamp_min(amax, TINY), fp8_max(fmt))


def global_amax(x: torch.Tensor, fmt: str = "e4m3") -> torch.Tensor:
    """The level-1 scale of x (f32 or bf16, contiguous on the card), a
    0-d f32 tensor on x's device."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"global_amax: dtype {x.dtype}")
    if not x.numel():
        raise ValueError("global_amax: empty tensor")
    _check_fmt(fmt, "global_amax")
    if x.device.type == "cpu":
        return global_scale_plain(x, fmt)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"global_amax: device {dev}")
    if not x.is_contiguous():
        raise ValueError("global_amax: x must be contiguous")
    if x.data_ptr() % 16:                 # the kernel reads 16-byte vectors
        x = x.clone()
    ws = _AMAX_WORKSPACE.get(dev)
    if ws is None:
        ws = torch.zeros(1 + AMAX_BLOCKS, dtype=torch.int32, device=dev)
        _AMAX_WORKSPACE[dev] = ws
    s = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = library().global_amax_launch(
            x.data_ptr(), x.numel(), int(x.dtype == torch.bfloat16),
            ws.data_ptr(), AMAX_BLOCKS, s.data_ptr(), fp8_max(fmt), stream)
    check(code, "global_amax")
    counter_amax.hit()
    return s


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
    _check_fmt(fmt, "mx_quant")
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
    contiguous and 16-byte aligned; also ``mx_fused``'s and
    ``moe_gmm``'s quantizer)."""
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
