"""The reference's CPU arithmetic for the norms, RoPE (and musicgen's
sinusoidal positions), the tanh GELU, the logit softcap, the RG-LRU
gates and rwkv6's decay, gates and token-shift mixes.

The reference runs on XLA's CPU backend, whose row sums, reciprocal
square roots, sin/cos, tanh and exp differ from PyTorch's CPU kernels
in the last bits now and then (tanh in 59% of f32 inputs, by up to 5
ulp, and the tanh GELU's ``1 + tanh`` turns that into a flipped bf16
rounding in 3.5% of its outputs).  A flipped f32 bit can flip a bf16
rounding, and a smoke model's training steps amplify one flipped bf16
element past the train-step tests' limits.  ``models.layers``,
``models.rglru`` and ``models.rwkv6`` call these functions on CPU
tensors only (RoPE's rotation too: XLA contracts each of its products
and sums into an FMA, and without that one query element in ~10^5
rounded the other way, which moved phi-3-vision's smoke gradients by
3.6%): on the card
they run PyTorch's own arithmetic, which is held against the CPU by
``chip_smoke.py``'s card-vs-CPU checks (2e-2 * max|logit|) and by
nothing tighter.

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


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 fused multiply-add, rounded once (through float64, whose
    product of two f32 values is exact)."""
    return (a.to(torch.float64) * b + c).to(torch.float32)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c of f32 tensors, rounded once: what XLA's CPU backend
    computes where it contracts a product and a sum in one fused loop."""
    return _fma(a, b.to(torch.float64), c.to(torch.float64))


# XLA's CPU tanh: Eigen's rational approximation, its polynomials
# evaluated with FMA, the input clamped where the quotient reaches +-1
_TANH_CLAMP = 7.99881172180175781
_TANH_NUM = (-2.76076847742355e-16, 2.00018790482477e-13,
             -8.60467152213735e-11, 5.12229709037114e-08,
             1.48572235717979e-05, 6.37261928875436e-04,
             4.89352455891786e-03)
_TANH_DEN = (1.19825839466702e-06, 1.18534705686654e-04,
             2.26843463243900e-03, 4.89352518554385e-03)


def _f32(c: float) -> float:
    return float(np.float32(c))


def _tanh(x: torch.Tensor) -> torch.Tensor:
    xc = x.clamp(-_TANH_CLAMP, _TANH_CLAMP)
    x2 = xc * xc
    num = torch.full_like(x2, _f32(_TANH_NUM[0]))
    for c in _TANH_NUM[1:]:
        num = _fma(num, x2.to(torch.float64), _f32(c))
    num = xc * num
    den = torch.full_like(x2, _f32(_TANH_DEN[0]))
    for c in _TANH_DEN[1:]:
        den = _fma(den, x2.to(torch.float64), _f32(c))
    return torch.where(x.abs() < _f32(0.0004), x, num / den)


class _Tanh(torch.autograd.Function):
    """XLA's tanh, with JAX's derivative (g + g·y)·(1 - y), the first
    product and sum contracted into one FMA as XLA fuses them."""

    @staticmethod
    def forward(ctx, x):
        y = _tanh(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return _fma(g, y.to(torch.float64), g.to(torch.float64)) * (1.0 - y)


def tanh(x: torch.Tensor) -> torch.Tensor:
    """f32 tanh as XLA's CPU backend computes it (inputs below 4e-4 in
    magnitude pass through)."""
    return _Tanh.apply(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh form) of f32 ``x`` as the reference's
    compiled steps compute it: XLA fuses the expression and contracts
    ``x + 0.044715 x^3`` into one FMA."""
    inner = _fma(x * x * x, _f32(0.044715), x.to(torch.float64))
    t = tanh(inner * _f32(np.sqrt(2.0 / np.pi)))
    return x * ((t + 1.0) * 0.5)


# XLA's CPU exp: Cephes' polynomial with FMA, results below the normal
# range flushed to zero, overflow past ln(FLT_MAX) to inf
_EXP_LO, _EXP_HI = -88.3762626647949, 88.3762626647950
_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
          4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def _exp(x: torch.Tensor) -> torch.Tensor:
    xi = x.clamp(_f32(_EXP_LO), _f32(_EXP_HI))
    fx = torch.floor(_fma(xi, _f32(1.44269504088896341), 0.5))
    xr = _fma(fx, -_f32(0.693359375), xi.to(torch.float64))
    xr = _fma(fx, -_f32(-2.12194440e-4), xr.to(torch.float64))
    y = torch.full_like(xr, _f32(_EXP_P[0]))
    for c in _EXP_P[1:]:
        y = _fma(y, xr.to(torch.float64), _f32(c))
    y = _fma(y, (xr * xr).to(torch.float64), xr.to(torch.float64)) + 1.0
    pow2 = ((fx.to(torch.int32) + 127) << 23).view(torch.float32)
    out = y * pow2
    out = torch.where(out.abs() < torch.finfo(torch.float32).tiny,
                      torch.zeros_like(out), out)
    return torch.where(x > _f32(88.72283935546875),
                       torch.full_like(out, float("inf")), out)


class _Exp(torch.autograd.Function):
    """XLA's exp, with JAX's derivative g * exp(x) (the polynomial's own
    derivative is a coarser exp)."""

    @staticmethod
    def forward(ctx, x):
        y = _exp(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * y


def exp(x: torch.Tensor) -> torch.Tensor:
    """f32 exp as XLA's CPU backend computes it."""
    return _Exp.apply(x)


class _Sigmoid(torch.autograd.Function):
    """XLA's logistic, with JAX's derivative g * (y * (1 - y))."""

    @staticmethod
    def forward(ctx, x):
        y = 1.0 / (1.0 + _exp(-x))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (y * (1.0 - y))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` (XLA's logistic, 1 / (1 + exp(-x)))."""
    return _Sigmoid.apply(x)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """f32 sqrt, correctly rounded (through float64)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)
