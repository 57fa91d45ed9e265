"""The reference's CPU arithmetic for the norms and RoPE.

The reference runs on XLA's CPU backend, whose row sums, reciprocal
square roots and sin/cos differ from PyTorch's CPU kernels in the last
bit now and then.  A flipped f32 bit can flip a bf16 rounding, and a
smoke model's training steps amplify one flipped bf16 element past the
train-step tests' limits.  ``models.layers`` calls these three functions
on CPU tensors only: on the card the norms and RoPE run PyTorch's own
arithmetic, which is held against the CPU by ``chip_smoke.py``'s
card-vs-CPU checks (2e-2 * max|logit|) and by nothing tighter.

What is matched is one XLA CPU backend's choice (the jaxlib the tests
run against): a change there can move these bits again.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np
import torch

from repro_torch.core.formats import div_c

WINDOW = 32          # XLA's CPU reduction: a tree of windows of 32


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim, left to right."""
    total = x[..., 0]
    for i in range(1, x.shape[-1]):
        total = total + x[..., i]
    return total


def mean(x: torch.Tensor) -> torch.Tensor:
    """f32 mean over the last dim, keepdim, in XLA's order: a row summed
    as a tree of windows of 32 (each window left to right, the window
    sums again in windows of 32, the last at most 32 left to right),
    then divided by the length."""
    k = x.shape[-1]
    while x.shape[-1] > WINDOW and x.shape[-1] % WINDOW == 0:
        x = _seq_sum(x.reshape(*x.shape[:-1], -1, WINDOW))
    return div_c(_seq_sum(x), float(k))[..., None]


def rsqrt(v: torch.Tensor) -> torch.Tensor:
    """f32 1/sqrt(v) rounded once from float64: XLA refines the hardware
    estimate with two Newton steps, which lands on the correctly rounded
    value far more often than PyTorch's f32 ``rsqrt``."""
    return torch.rsqrt(v.to(torch.float64)).to(torch.float32)


@functools.lru_cache(maxsize=None)
def _libm_sincos():
    name = ctypes.util.find_library("m")
    if name is None:
        raise RuntimeError("xla_cpu_numerics: no C math library (libm) "
                           "found for sinf/cosf")
    libm = ctypes.CDLL(name)
    fns = []
    for fn in (libm.sinf, libm.cosf):
        fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
        fns.append(np.vectorize(fn, otypes=[np.float32]))
    return fns


def sin_cos(ang: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """sin and cos of CPU f32 angles through the C library's ``sinf`` and
    ``cosf``, element by element, which is what XLA's CPU backend calls
    (PyTorch's vectorized sin/cos differ from them in the last bit of
    ~5% of RoPE angles).  Raises where no C math library is found."""
    a = ang.numpy()
    return tuple(torch.from_numpy(np.asarray(f(a), np.float32))
                 for f in _libm_sincos())
