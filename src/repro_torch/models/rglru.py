"""RecurrentGemma's (Griffin's) recurrent block: a temporal conv and the
RG-LRU (counterpart of ``repro.models.rglru``).

The recurrence is elementwise:
    r_t = sigmoid(W_a u_t + b_a)             (recurrence gate)
    i_t = sigmoid(W_i u_t + b_i)             (input gate)
    log a_t = -c * softplus(Lambda) * r_t    (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)
a linear scan, computed as the reference does: an associative scan
within chunks of 256 positions, the chunks carried in order; one token
of decode is one update.  The five projections are quantized GEMMs
(``qlinear``); the recurrence stays f32 and elementwise, outside the
paper's quantization scope, and no TPU kernel sits behind it.  On the
CPU its gates follow the reference's arithmetic
(``core.xla_cpu_numerics``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import xla_cpu_numerics as xla
from repro_torch.core.formats import QuantConfig
from repro_torch.core.linear import QT, qlinear
from .layers import PDef, exp, gelu, sigmoid

_C = 8.0
_CHUNK = 256


class RGLRUState(NamedTuple):
    """One layer's recurrent state: ``h`` (B, lru) f32, ``conv`` (B, W-1,
    lru) bf16 (the last W-1 conv inputs) and ``idx``, the tokens seen (a
    scalar, or (B,) per serving slot)."""

    h: torch.Tensor
    conv: torch.Tensor
    idx: torch.Tensor


def rglru_defs(cfg):
    d, lru, w = cfg.d_model, cfg.lru_width, cfg.conv_width
    return {
        "w_x": PDef((d, lru), ("fsdp", "lru"), quantized=True),
        "w_gate_branch": PDef((d, lru), ("fsdp", "lru"), quantized=True),
        "w_out": PDef((lru, d), ("lru", "fsdp"), quantized=True),
        "conv_w": PDef((w, lru), ("conv", "lru"), "small"),
        "conv_b": PDef((lru,), ("lru",), "zeros"),
        "w_a": PDef((lru, lru), ("fsdp", "lru"), quantized=True),
        "b_a": PDef((lru,), ("lru",), "zeros"),
        "w_i": PDef((lru, lru), ("fsdp", "lru"), quantized=True),
        "b_i": PDef((lru,), ("lru",), "zeros"),
        "lambda_p": PDef((lru,), ("lru",), "ones"),
    }


def init_rglru_state(cfg, batch: int, max_len: int = 0,
                     device="cuda") -> RGLRUState:
    """A zeroed state with a scalar ``idx`` of 0 (``transformer.
    init_caches`` widens it per slot); ``max_len`` is unused (a
    recurrent state has no length)."""
    return RGLRUState(
        h=torch.zeros((batch, cfg.lru_width), dtype=torch.float32,
                      device=device),
        conv=torch.zeros((batch, cfg.conv_width - 1, cfg.lru_width),
                         dtype=torch.bfloat16, device=device),
        idx=torch.zeros((), dtype=torch.int32, device=device))


def _raw(w):
    return w.w if isinstance(w, QT) else w


def _causal_conv(p, u, prev):
    """Depthwise causal conv of width W over (B, S, lru) ``u``, ``prev``
    (B, W-1, lru) the inputs before it; the f32 sum in the reference's
    order (the newest tap first).  Returns (out in u's dtype, the last
    W-1 inputs)."""
    w, b = _raw(p["conv_w"]), _raw(p["conv_b"])
    width = w.shape[0]
    full = torch.cat([prev.to(u.dtype), u], dim=1)
    s = u.shape[1]
    out = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    for i in range(width):
        sl = full[:, width - 1 - i: width - 1 - i + s]
        out = out + sl.to(torch.float32) * w[width - 1 - i].to(torch.float32)
    new_prev = full[:, -(width - 1):]
    return (out + b.to(torch.float32)).to(u.dtype), new_prev


def _muladd(a, b, c):
    """a * b + c; on the CPU rounded once, as XLA contracts the
    reference's fused product and sum into an FMA."""
    if a.device.type == "cpu":
        return xla.fma(a, b, c)
    return a * b + c


def _combine(x, y):
    """The scan's operator: (a_x, b_x) then (a_y, b_y)."""
    (ax, bx), (ay, by) = x, y
    return ax * ay, _muladd(bx, ay, by)


def _associative_scan(a, b):
    """Inclusive scan of ``_combine`` along dim 1 in the tree of
    ``jax.lax.associative_scan``: combine adjacent pairs, scan the
    pairs' results, then fill the even positions from their left
    neighbours' prefixes (the same combines in the same order, so f32
    results equal the reference's)."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine((a[:, 0:-1:2], b[:, 0:-1:2]),
                      (a[:, 1::2], b[:, 1::2]))
    oa, ob = _associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine((oa[:, :-1], ob[:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        ea, eb = _combine((oa, ob), (a[:, 2::2], b[:, 2::2]))
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    # interleave: even positions from (ea, eb), odd from (oa, ob)
    out_a = torch.empty_like(a)
    out_b = torch.empty_like(b)
    out_a[:, 0::2], out_b[:, 0::2] = ea, eb
    out_a[:, 1::2], out_b[:, 1::2] = oa, ob
    return out_a, out_b


def _lru_scan(a, b, h0):
    """h_t = a_t h_{t-1} + b_t along dim 1; a, b (B, S, L) f32, h0 (B,
    L).  Chunks of 256: an associative scan inside each, the carry from
    one chunk to the next.  Returns (hs (B, S, L), h_last)."""
    bsz, s, lw = a.shape
    chunk = min(_CHUNK, s)
    n = -(-s // chunk)
    pad = n * chunk - s
    if pad:
        a = torch.cat([a, a.new_ones((bsz, pad, lw))], dim=1)
        b = torch.cat([b, b.new_zeros((bsz, pad, lw))], dim=1)
    h = h0
    hs = []
    for c in range(n):
        cum_a, cum_b = _associative_scan(a[:, c * chunk:(c + 1) * chunk],
                                         b[:, c * chunk:(c + 1) * chunk])
        h_t = _muladd(cum_a, h[:, None, :], cum_b)
        h = h_t[:, -1, :]
        hs.append(h_t)
    return torch.cat(hs, dim=1)[:, :s], h


def _softplus(x):
    """``jax.nn.softplus``: max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(exp(-x.abs()))


def _sqrt(x):
    return xla.sqrt(x) if x.device.type == "cpu" else torch.sqrt(x)


def rglru_block(cfg, p, x, qcfg: QuantConfig,
                state: RGLRUState | None = None, mode: str = "train"):
    """x (B, S, d) -> (y, new state).  Without a state (training,
    calibration) the recurrence starts from zeros; ``decode`` with S 1
    is one update, any other length the chunked scan."""
    b, s, _ = x.shape
    gate = qlinear(x, p["w_gate_branch"], qcfg)
    gate = gelu(gate.to(torch.float32)).to(x.dtype)
    u = qlinear(x, p["w_x"], qcfg)

    prev = (state.conv if state is not None else torch.zeros(
        (b, cfg.conv_width - 1, cfg.lru_width), dtype=x.dtype,
        device=x.device))
    u, conv_state = _causal_conv(p, u, prev)

    r = sigmoid(qlinear(u, p["w_a"], qcfg).to(torch.float32)
                 + _raw(p["b_a"]).to(torch.float32))
    i = sigmoid(qlinear(u, p["w_i"], qcfg).to(torch.float32)
                 + _raw(p["b_i"]).to(torch.float32))
    log_a = -_C * _softplus(_raw(p["lambda_p"]).to(torch.float32)) * r
    a = exp(log_a)
    gated_in = _sqrt(torch.clamp_min(_muladd(-a, a, torch.ones_like(a)),
                                     1e-12)) * (i * u.to(torch.float32))

    h0 = (state.h if state is not None else torch.zeros(
        (b, cfg.lru_width), dtype=torch.float32, device=x.device))
    if mode == "decode" and s == 1:
        h_last = _muladd(a[:, 0], h0, gated_in[:, 0])
        hs = h_last[:, None, :]
    else:
        hs, h_last = _lru_scan(a, gated_in, h0)

    y = hs.to(x.dtype) * gate
    y = qlinear(y, p["w_out"], qcfg)
    idx = (state.idx if state is not None
           else torch.zeros((), dtype=torch.int32, device=x.device))
    return y, RGLRUState(h=h_last, conv=conv_state.to(torch.bfloat16),
                         idx=idx + s)
