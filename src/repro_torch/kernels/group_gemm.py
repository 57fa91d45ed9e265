"""The per-group (COAT) fp8 GEMM: the wrapper of the Hopper kernel
``csrc/group_gemm.cu`` and its plain PyTorch version.

Given qx (M, K) fp8 with its f32 group scales sx (M, K/128) and the
fp8 weight payload qw (K, N), returns the (M, N) f32
``Σ_g (Qx_g @ Qw_g) · sx[:, g]``: each 128-wide K group's partial sum
rescaled in f32 inside the K loop, not multiplied by the weight scale
(the caller, ``kernels.dispatch.group_matmul``, applies s_w).  Replaces
the TPU kernel ``repro.kernels.group_gemm.group_gemm_pallas``; the
plain version sums in the kernel's order (each group's f32 partial
times its scales, added to the sum group by group), where the
reference's ``ref.group_gemm_ref`` sums the rescaled partials in XLA's
order.

K is a multiple of 128 (the caller pads).  A CPU tensor takes the plain
version.  A CUDA tensor launches the kernel, or raises: there is no
fallback.  The kernel is the MOSS GEMM's 128 x 128 ``wgmma`` tile
(``csrc/wgmma.cuh``) with the rescale at its K-128 promotion; it takes
the operand formats the recipe multiplies: e4m3 x e4m3 (the forward),
e5m2 x e4m3 (dx) and e4m3 x e5m2 (dW), not e5m2 x e5m2.
"""

from __future__ import annotations

import torch

from repro_torch.core.formats import is_fp8

from ._build import LaunchCounter, check, library

GROUP = 128

counter = LaunchCounter("group_gemm")


def group_gemm_plain(qx: torch.Tensor, sx: torch.Tensor,
                     qw: torch.Tensor) -> torch.Tensor:
    m, k = qx.shape
    xf, wf = qx.to(torch.float32), qw.to(torch.float32)
    acc = torch.zeros((m, qw.shape[1]), dtype=torch.float32,
                      device=qx.device)
    for g in range(k // GROUP):
        ks = slice(g * GROUP, (g + 1) * GROUP)
        acc = acc + torch.matmul(xf[:, ks], wf[ks]) * sx[:, g:g + 1]
    return acc


def _check(qx, sx, qw):
    m, k = qx.shape
    if not (is_fp8(qx) and is_fp8(qw)) or sx.dtype != torch.float32:
        raise TypeError(f"group_gemm: dtypes {qx.dtype}, {sx.dtype}, "
                        f"{qw.dtype}: expected fp8, f32, fp8")
    if k % GROUP or sx.shape != (m, k // GROUP) or qw.dim() != 2 or \
            qw.shape[0] != k:
        raise ValueError(f"group_gemm: shapes {tuple(qx.shape)}, "
                         f"{tuple(sx.shape)}, {tuple(qw.shape)}")


def group_gemm(qx: torch.Tensor, sx: torch.Tensor,
               qw: torch.Tensor) -> torch.Tensor:
    """The f32 (M, N) accumulation, rescaled by the activation group
    scales, not by the weight scale."""
    _check(qx, sx, qw)
    if qx.device.type == "cpu":
        return group_gemm_plain(qx, sx, qw)
    dev = qx.device
    if dev.type != "cuda" or sx.device != dev or qw.device != dev:
        raise ValueError(f"group_gemm: devices {qx.device}, {sx.device}, "
                         f"{qw.device}")
    if not (qx.is_contiguous() and sx.is_contiguous()
            and qw.is_contiguous()) or qx.data_ptr() % 16:
        raise ValueError("group_gemm: operands must be contiguous and qx "
                         "16-byte aligned")
    if qx.dtype == qw.dtype == torch.float8_e5m2:
        raise TypeError("group_gemm: the kernel takes no e5m2 x e5m2 "
                        "product (no recipe multiplies two gradients)")
    m, k = qx.shape
    n = qw.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m and n:
        vec = int(n % 16 == 0 and qw.data_ptr() % 16 == 0)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = library().group_gemm_launch(
                qx.data_ptr(), sx.data_ptr(), qw.data_ptr(), out.data_ptr(),
                m, n, k, int(qx.dtype == torch.float8_e5m2),
                int(qw.dtype == torch.float8_e5m2), vec, stream)
        check(code, "group_gemm")
        counter.hit()
    return out
