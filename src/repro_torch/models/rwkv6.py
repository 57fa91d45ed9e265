"""RWKV-6 (Finch): the attention-free time mix with a data-dependent
decay, and the channel mix (counterpart of ``repro.models.rwkv6``).

The recurrence per head (head dim 64):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
In prefill and training it runs chunk-parallel in chunks of 16, as the
reference does: within a chunk the pairwise decay factors as
(r_i e^{C_{i-1}}) . (k_j e^{-C_j}), C the inclusive cumulative log-decay,
clamped to [-5, -1e-4] so that the factored exponentials stay in f32
range.  Everything that does not depend on the carried state is
computed for every chunk at once; only the state's update runs chunk
after chunk.  A decode step of one token is one update (``_wkv_step``).

The projections (r, k, v, g, o, the two LoRAs' first halves and the
channel mix) are quantized GEMMs (``qlinear``); the WKV is f32 plain
PyTorch on both devices: no TPU kernel sits behind it.  On the CPU the
gates and the decay follow the reference's arithmetic
(``core.xla_cpu_numerics``: XLA's tanh, exp and sigmoid, and its FMA
contraction of the token-shift mixes ``x + xx * m``), and the chunks'
cumulative log-decay is summed left to right in f32.  In a serving step
on the card the group norm and the decode update's sums run in
``core.row_order``'s fixed order, so that a row does not depend on its
batch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import row_order
from repro_torch.core import xla_cpu_numerics as xla
from repro_torch.core.formats import QuantConfig
from repro_torch.core.linear import QT, qlinear
from .layers import PDef, _mean, _rsqrt, exp, sigmoid, tanh

_CHUNK = 16
_LW_MIN, _LW_MAX = -5.0, -1e-4
_GN_EPS = 64e-5
_MIX = ("r", "k", "v", "w", "g")


class RWKVState(NamedTuple):
    """One layer's recurrent state: the last inputs of the time mix and
    the channel mix, ``x_tm`` and ``x_cm`` (B, d) bf16, the WKV state
    ``S`` (B, H, dh, dh) f32, and ``idx``, the tokens seen (a scalar, or
    (B,) per serving slot)."""

    x_tm: torch.Tensor
    x_cm: torch.Tensor
    S: torch.Tensor
    idx: torch.Tensor


def timemix_defs(cfg):
    d = cfg.d_model
    rank, dr = cfg.ddlerp_rank, cfg.decay_rank
    return {
        "mu_base": PDef((d,), (None,), "small"),
        "mu": PDef((len(_MIX), d), (None, None), "small"),
        "ddlerp_w1": PDef((d, len(_MIX) * rank), ("fsdp", None),
                          quantized=True),
        "ddlerp_w2": PDef((len(_MIX), rank, d), (None, None, "fsdp"),
                          "small"),
        "w_r": PDef((d, d), ("fsdp", "heads"), quantized=True),
        "w_k": PDef((d, d), ("fsdp", "heads"), quantized=True),
        "w_v": PDef((d, d), ("fsdp", "heads"), quantized=True),
        "w_g": PDef((d, d), ("fsdp", "heads"), quantized=True),
        "w_o": PDef((d, d), ("heads", "fsdp"), quantized=True),
        "decay_base": PDef((d,), (None,), "small"),
        "decay_w1": PDef((d, dr), ("fsdp", None), quantized=True),
        "decay_w2": PDef((dr, d), (None, "fsdp"), "small"),
        "bonus_u": PDef((d,), (None,), "small"),
        "ln_scale": PDef((d,), (None,), "ones"),
        "ln_bias": PDef((d,), (None,), "zeros"),
    }


def chanmix_defs(cfg):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": PDef((d,), (None,), "small"),
        "mu_r": PDef((d,), (None,), "small"),
        "w_k": PDef((d, f), ("fsdp", "mlp"), quantized=True),
        "w_v": PDef((f, d), ("mlp", "fsdp"), quantized=True),
        "w_r": PDef((d, d), ("fsdp", "fsdp"), quantized=True),
    }


def init_rwkv_state(cfg, batch: int, max_len: int = 0,
                    device="cuda") -> RWKVState:
    """A zeroed state with a scalar ``idx`` of 0 (``transformer.
    init_caches`` widens it per slot); ``max_len`` is unused."""
    d, dh = cfg.d_model, cfg.rwkv_head_dim
    return RWKVState(
        x_tm=torch.zeros((batch, d), dtype=torch.bfloat16, device=device),
        x_cm=torch.zeros((batch, d), dtype=torch.bfloat16, device=device),
        S=torch.zeros((batch, d // dh, dh, dh), dtype=torch.float32,
                      device=device),
        idx=torch.zeros((), dtype=torch.int32, device=device))


def _raw(w):
    return w.w if isinstance(w, QT) else w


def _cpu(x: torch.Tensor) -> bool:
    return x.device.type == "cpu"


def _mix(x, xx, m):
    """x + xx * m in f32 (x bf16, converted at each use as the reference
    converts it, so that the bf16 gradients of x add up in its order);
    on the CPU rounded once, as XLA contracts the fused product and
    sum."""
    x32 = x.to(torch.float32)
    if _cpu(x32):
        return xla.fma(xx, m.expand_as(xx), x32)
    return x32 + xx * m


def _token_shift(x, x_prev):
    """Shifted right along the sequence: position t sees x_{t-1}, and
    ``x_prev`` (B, d) fills t = 0."""
    return torch.cat([x_prev[:, None, :].to(x.dtype), x[:, :-1]], dim=1)


def _cumsum(x):
    """Inclusive f32 sum along dim -2.  On the CPU left to right in f32,
    as XLA's reduce-window sums each prefix (``torch.cumsum`` there
    accumulates in float64 and rounds once)."""
    if not _cpu(x):
        return torch.cumsum(x, dim=-2)
    parts = [x[..., 0, :]]
    for i in range(1, x.shape[-2]):
        parts.append(parts[-1] + x[..., i, :])
    return torch.stack(parts, dim=-2)


def _wkv_chunked(r, k, v, lw, u, S0):
    """r, k, v, lw (B, T, H, dh), u (H, dh), S0 (B, H, dh, dh) ->
    (y (B, T, H, dh) f32, the last state).  A partial last chunk is
    padded with zeros (a zero log-decay and a zero key leave the state
    as it is)."""
    b, t, h, dh = r.shape
    chunk = min(_CHUNK, t)
    n = -(-t // chunk)
    pad = n * chunk - t
    if pad:
        r, k, v, lw = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (r, k, v, lw))

    def resh(x):                                  # (n, B, H, L, dh) f32
        return x.to(torch.float32).reshape(b, n, chunk, h, dh).permute(
            1, 0, 3, 2, 4)

    ri, ki, vi, lwi = map(resh, (r, k, v, lw))
    C = _cumsum(lwi)                              # inclusive
    C_prev = C - lwi
    r_dec = ri * exp(C_prev)
    k_dec = ki * exp(-C)
    # intra-chunk: scores[i, j] = sum_d r_dec[i, d] k_dec[j, d] (j < i)
    scores = torch.einsum("nbhld,nbhmd->nbhlm", r_dec, k_dec)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    scores = torch.where(mask, scores, torch.zeros((), device=r.device))
    y_intra = torch.einsum("nbhlm,nbhmv->nbhlv", scores, vi)
    # the current token's bonus: (r_i * u * k_i) v_i
    bonus = torch.einsum("nbhld,nbhld->nbhl", ri * u[None, None, :, None, :],
                         ki)
    # the state's update: S' = diag(e^{C_L}) S + sum_j e^{C_L - C_j} k_j v_j
    c_last = C[..., -1:, :]
    decay_all = exp(c_last).squeeze(-2)[..., None]       # (n,B,H,dh,1)
    kv = torch.einsum("nbhld,nbhlv->nbhdv", ki * exp(c_last - C), vi)
    S = S0.to(torch.float32)
    states = []
    # unbind, not kv[c]: each indexed chunk's backward would build a
    # zero gradient of every chunk (n^2 over a 4096-token sequence)
    for d_c, kv_c in zip(decay_all.unbind(0), kv.unbind(0)):
        states.append(S)
        S = S * d_c + kv_c
    # inter-chunk: y_i += (r_i e^{C_{i-1}}) S_prev
    y_inter = torch.einsum("nbhld,nbhdv->nbhlv", r_dec, torch.stack(states))
    y = y_inter + y_intra + bonus[..., None] * vi
    y = y.permute(1, 0, 3, 2, 4).reshape(b, n * chunk, h, dh)[:, :t]
    return y, S


def _wkv_step(r, k, v, lw, u, S0):
    """One token of the recurrence (decode): r, k, v, lw (B, 1, H, dh).
    In a serving step on the card the sums over dh run in
    ``core.row_order``'s fixed order."""
    ri, ki, vi, lwi = (x[:, 0].to(torch.float32) for x in (r, k, v, lw))
    if row_order.fixed(ri, ri.shape[0]):
        y = (row_order.sum_last(ri[:, :, None, :] * S0.transpose(-1, -2))
             + row_order.sum_last(ri * u[None] * ki)[..., None] * vi)
    else:
        y = (torch.einsum("bhd,bhdv->bhv", ri, S0)
             + torch.einsum("bhd,bhd->bh", ri * u[None], ki)[..., None] * vi)
    S_new = S0 * exp(lwi)[..., None] + ki[..., :, None] * vi[..., None, :]
    return y[:, None], S_new


def _group_norm(y, scale, bias, eps=_GN_EPS):
    """A LayerNorm over each head's dh (rwkv's ``ln_x``): y (B, T, H, dh)
    f32, ``scale`` and ``bias`` (H * dh,).  The means as the norms take
    them (``layers._mean``), a row being one token's H heads."""
    b, t, h, dh = y.shape
    mu = _mean(y, rows=b * t)
    var = _mean(torch.square(y - mu), rows=b * t)
    yn = (y - mu) * _rsqrt(var + eps)
    return (yn.reshape(b, t, -1) * scale + bias).reshape(b, t, h, dh)


def ddlerp(cfg, p, x, x_prev, qcfg: QuantConfig):
    """The data-dependent token shift of x (B, S, d) bf16 after ``x_prev``
    (B, d): the shift's difference ``xx`` (f32) and the five mixes (r, k,
    v, w, g; bf16), each ``x + xx * (mu_i + offs_i)``, ``offs`` a tanh
    LoRA of ``x + xx * mu_base``."""
    b, s, _ = x.shape
    xx = (_token_shift(x, x_prev) - x).to(torch.float32)
    xxx = _mix(x, xx, _raw(p["mu_base"]).to(torch.float32))
    lora = tanh(qlinear(xxx.to(x.dtype), p["ddlerp_w1"], qcfg)
                .to(torch.float32)).reshape(b, s, len(_MIX), cfg.ddlerp_rank)
    w2 = _raw(p["ddlerp_w2"]).to(torch.float32)
    mu = _raw(p["mu"])
    mixed = {}
    for i, name in enumerate(_MIX):
        offs = row_order.matmul(lora[:, :, i], w2[i])
        mixed[name] = _mix(x, xx, mu[i] + offs).to(x.dtype)
    return xx, mixed


def time_mix(cfg, p, x, qcfg: QuantConfig, state: RWKVState, mode: str):
    """x (B, S, d) bf16 -> (out, state with the new ``x_tm`` and ``S``)."""
    b, s, d = x.shape
    dh = cfg.rwkv_head_dim
    h = d // dh
    _, mixed = ddlerp(cfg, p, x, state.x_tm, qcfg)

    r = qlinear(mixed["r"], p["w_r"], qcfg).reshape(b, s, h, dh)
    k = qlinear(mixed["k"], p["w_k"], qcfg).reshape(b, s, h, dh)
    v = qlinear(mixed["v"], p["w_v"], qcfg).reshape(b, s, h, dh)
    g = qlinear(mixed["g"], p["w_g"], qcfg)

    dd = tanh(qlinear(mixed["w"], p["decay_w1"], qcfg).to(torch.float32))
    dd = row_order.matmul(dd, _raw(p["decay_w2"]).to(torch.float32))
    lw = -exp(_raw(p["decay_base"]).to(torch.float32) + dd)
    lw = torch.clamp(lw, _LW_MIN, _LW_MAX).reshape(b, s, h, dh)
    u = _raw(p["bonus_u"]).to(torch.float32).reshape(h, dh)

    S0 = state.S
    if mode == "decode" and s == 1:
        y, S_new = _wkv_step(r, k, v, lw, u, S0)
    else:
        y, S_new = _wkv_chunked(r, k, v, lw, u, S0)

    y = _group_norm(y, _raw(p["ln_scale"]).to(torch.float32),
                    _raw(p["ln_bias"]).to(torch.float32))
    g = g.to(torch.float32)
    y = (y.reshape(b, s, d) * (g * sigmoid(g))).to(x.dtype)     # silu
    out = qlinear(y, p["w_o"], qcfg)
    return out, state._replace(x_tm=x[:, -1].to(torch.bfloat16), S=S_new)


def channel_mix(cfg, p, x, qcfg: QuantConfig, state: RWKVState, mode: str):
    """The squared-ReLU channel mix with its sigmoid gate -> (out, state
    with the new ``x_cm``)."""
    xx = (_token_shift(x, state.x_cm) - x).to(torch.float32)
    xk = _mix(x, xx, _raw(p["mu_k"]).to(torch.float32)).to(x.dtype)
    xr = _mix(x, xx, _raw(p["mu_r"]).to(torch.float32)).to(x.dtype)
    kk = qlinear(xk, p["w_k"], qcfg)
    kk = torch.square(F.relu(kk.to(torch.float32))).to(x.dtype)
    vv = qlinear(kk, p["w_v"], qcfg)
    rr = sigmoid(qlinear(xr, p["w_r"], qcfg).to(torch.float32))
    out = (rr * vv.to(torch.float32)).to(x.dtype)
    return out, state._replace(x_cm=x[:, -1].to(torch.bfloat16))
