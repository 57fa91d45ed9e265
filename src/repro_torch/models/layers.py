"""Shared model components (counterpart of ``repro.models.layers``):
parameter definitions, norms, RoPE and the sinusoidal positions, the
FFN, embedding and LM head.
Every linear layer goes through ``core.linear.qlinear``.

``PDef`` is the single source of truth per parameter (shape, logical
axes, initializer, whether it is a quantized linear weight); params are
plain nested dicts of tensors with the layer dim stacked in front, the
same tree as the reference's, so weights and site tags line up.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import row_order, xla_cpu_numerics
from repro_torch.core.formats import QuantConfig, div_c
from repro_torch.core.linear import QT, qlinear


class PDef(NamedTuple):
    shape: tuple[int, ...]
    logical: tuple[str | None, ...]
    init: str = "normal"              # normal | zeros | ones | embed | small
    quantized: bool = False
    dtype: Any = torch.float32


def is_pdef(x) -> bool:
    return isinstance(x, PDef)


def init_param(d: PDef, gen: torch.Generator,
               device: torch.device | str = "cuda") -> torch.Tensor:
    """Materialize one parameter from ``gen`` (the reference's
    initializers; a torch Generator draws other numbers than a JAX key,
    so weights from the same seed differ between the packages -- tests
    carry the reference's weights across with ``repro_torch.bridge``).
    ``gen`` must live on ``device``."""
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    x = torch.empty(d.shape, dtype=d.dtype, device=device)
    if d.init == "embed":
        return x.normal_(0.0, 0.02, generator=gen)
    if d.init == "small":
        return x.normal_(0.0, 0.006, generator=gen)
    # truncated-normal (+-2 sigma) fan-in init for linear weights, by
    # inverse CDF of a uniform draw
    std = 1.0 / math.sqrt(max(d.shape[0], 1))
    lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0, \
        (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
    x.uniform_(2.0 * lo - 1.0, 2.0 * hi - 1.0, generator=gen)
    return x.erfinv_().mul_(math.sqrt(2.0) * std)


def init_tree(defs, gen: torch.Generator,
              device: torch.device | str = "cuda"):
    """Materialize a (nested dict) tree of PDefs, leaves in sorted-key
    order."""
    if is_pdef(defs):
        return init_param(defs, gen, device)
    return {k: init_tree(defs[k], gen, device) for k in sorted(defs)}


def quant_mask_tree(defs):
    if is_pdef(defs):
        return defs.quantized
    return {k: quant_mask_tree(v) for k, v in defs.items()}


def stack_defs(defs, n: int, axis_name: str = "layers"):
    """Prepend a stacked-layer dim to every PDef."""
    if is_pdef(defs):
        return PDef((n, *defs.shape), (axis_name, *defs.logical),
                    defs.init, defs.quantized, defs.dtype)
    return {k: stack_defs(v, n, axis_name) for k, v in defs.items()}


def wrap_qt(params, scales, mask):
    """Bundle quantized weights with their predicted scales: quantized
    leaves become QT(w, s); others stay raw tensors."""
    if isinstance(params, dict):
        return {k: wrap_qt(params[k], scales[k], mask[k]) for k in params}
    return QT(params, scales) if mask else params


def wrap_qt_nojit(params, mask):
    """QT-wrap without precomputed scales (jit scaling, bf16, eval)."""
    if isinstance(params, dict):
        return {k: wrap_qt_nojit(params[k], mask[k]) for k in params}
    return QT(params, None) if mask else params


class _Broadcast(torch.autograd.Function):
    """``x`` repeated ``n`` times along a new axis ``dim`` (a view).  The
    backward sums the ``n`` gradients one at a time in their own dtype,
    each add rounded (bf16 in training), as XLA transposes the
    reference's ``broadcast_to`` (its CPU order, checked for up to 32
    terms); ``expand``'s backward sums in f32 and rounds once, which
    differs in a third to three quarters of the bf16 elements."""

    @staticmethod
    def forward(ctx, x, n: int, dim: int):
        ctx.dim = dim
        return x.unsqueeze(dim).expand(*x.shape[:dim], n, *x.shape[dim:])

    @staticmethod
    def backward(ctx, g):
        parts = g.unbind(ctx.dim)
        acc = parts[0]
        for part in parts[1:]:
            acc = acc + part
        return acc, None, None


def broadcast(x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """``x`` broadcast to ``n`` copies along a new axis ``dim``, with the
    reference's gradient arithmetic (``_Broadcast``)."""
    return _Broadcast.apply(x, n, dim)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def _mean(xf: torch.Tensor, rows: int | None = None) -> torch.Tensor:
    """f32 mean over the last dim, keepdim; on the CPU in the
    reference's order (``core.xla_cpu_numerics``), on the card in a
    serving step's fixed row order (``core.row_order``; ``rows`` as
    there)."""
    if xf.device.type == "cpu":
        return xla_cpu_numerics.mean(xf)
    return row_order.mean(xf, rows)


def _rsqrt(v: torch.Tensor) -> torch.Tensor:
    if v.device.type == "cpu":
        return xla_cpu_numerics.rsqrt(v)
    return torch.rsqrt(v)


def rmsnorm(x, scale, eps=1e-5):
    xf = x.to(torch.float32)
    y = xf * _rsqrt(_mean(xf * xf) + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(x.dtype)


def layernorm(x, scale, bias, eps=1e-5):
    xf = x.to(torch.float32)
    mu = _mean(xf)
    var = _mean(torch.square(xf - mu))
    y = (xf - mu) * _rsqrt(var + eps)
    return (y * scale.to(torch.float32)
            + bias.to(torch.float32)).to(x.dtype)


def norm_defs(cfg, d: int):
    if cfg.norm == "layernorm":
        return {"scale": PDef((d,), (None,), "ones"),
                "bias": PDef((d,), (None,), "zeros")}
    return {"scale": PDef((d,), (None,), "zeros")}   # rmsnorm (1+scale)


def apply_norm(cfg, p, x):
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rmsnorm(x, p["scale"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(dim: int, theta: float, device=None):
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def _sin_cos(ang: torch.Tensor):
    """sin and cos of the f32 angles; on the CPU as the reference's
    backend computes them (``core.xla_cpu_numerics``)."""
    if ang.device.type == "cpu":
        return xla_cpu_numerics.sin_cos(ang)
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x, positions, theta: float = 1e4, pct: float = 1.0):
    """x: (..., S, H, Dh); positions: (..., S) int.  Rotates the first
    ``pct`` fraction of head dims."""
    dh = x.shape[-1]
    rot = int(dh * pct)
    rot -= rot % 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    freqs = rope_frequencies(rot, theta, x.device)
    ang = positions[..., None].to(torch.float32) * freqs
    sin, cos = _sin_cos(ang)
    cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = xr.to(torch.float32).chunk(2, dim=-1)
    if x.device.type == "cpu":
        # XLA contracts each product and sum into an FMA
        fma = xla_cpu_numerics.fma
        out = torch.cat([fma(x1, cos.expand_as(x1), -(x2 * sin)),
                         fma(x2, cos.expand_as(x2), x1 * sin)], dim=-1)
    else:
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


def sinusoidal_embedding(positions, d: int):
    """MusicGen's sinusoidal position embedding: (..., S) int -> (..., S,
    d) f32, the sines of ``d // 2`` frequencies then their cosines; on the
    CPU with XLA's exp and the C library's sinf and cosf."""
    half = d // 2
    dev = positions.device
    i = torch.arange(half, dtype=torch.float32, device=dev)
    e = div_c(torch.tensor(-math.log(10_000.0), dtype=torch.float32,
                           device=dev) * i, float(half))
    freqs = xla_cpu_numerics.exp(e) if dev.type == "cpu" else torch.exp(e)
    sin, cos = _sin_cos(positions[..., None].to(torch.float32) * freqs)
    return torch.cat([sin, cos], dim=-1)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation, of f32 ``x``;
    on the CPU in the reference's arithmetic."""
    if x.device.type == "cpu":
        return xla_cpu_numerics.gelu_tanh(x)
    return F.gelu(x, approximate="tanh")


def tanh(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return xla_cpu_numerics.tanh(x)
    return torch.tanh(x)


def exp(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return xla_cpu_numerics.exp(x)
    return torch.exp(x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return xla_cpu_numerics.sigmoid(x)
    return torch.sigmoid(x)


# ---------------------------------------------------------------------------
# FFN: SwiGLU, GeGLU, GELU-MLP, squared ReLU
# ---------------------------------------------------------------------------


def ffn_defs(cfg, d_ff: int | None = None):
    """``w_up`` and ``w_down``, and ``w_gate`` for the gated forms."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    defs = {"w_up": PDef((d, f), ("fsdp", "mlp"), quantized=True),
            "w_down": PDef((f, d), ("mlp", "fsdp"), quantized=True)}
    if cfg.act in ("swiglu", "geglu"):
        defs["w_gate"] = PDef((d, f), ("fsdp", "mlp"), quantized=True)
    return defs


def apply_ffn(cfg, p, x, qcfg: QuantConfig):
    up = qlinear(x, p["w_up"], qcfg)
    if cfg.act == "swiglu":
        gate = qlinear(x, p["w_gate"], qcfg)
        h = F.silu(gate.to(torch.float32)).to(x.dtype) * up
    elif cfg.act == "geglu":
        gate = qlinear(x, p["w_gate"], qcfg)
        h = gelu(gate.to(torch.float32)).to(x.dtype) * up
    elif cfg.act == "relu2":
        h = torch.square(F.relu(up.to(torch.float32))).to(x.dtype)
    else:                                               # gelu_mlp
        h = gelu(up.to(torch.float32)).to(x.dtype)
    return qlinear(h, p["w_down"], qcfg)


# ---------------------------------------------------------------------------
# Embedding + LM head
# ---------------------------------------------------------------------------


def embed_defs(cfg):
    """The embedding, and an untied LM head (a tied model's head is the
    embedding transposed)."""
    defs = {"embedding": PDef((cfg.vocab, cfg.d_model), ("vocab", "fsdp"),
                              "embed")}
    if not cfg.tie_embeddings:
        defs["head"] = PDef((cfg.d_model, cfg.vocab), ("fsdp", "vocab"),
                            quantized=True)
    return defs


def embed_tokens(cfg, p, tokens):
    """The rows of the embedding in bf16; with ``embed_scale`` times
    sqrt(d) rounded to bf16 first, as the reference multiplies (sqrt(2560)
    is 50.596..., 50.5 in bf16)."""
    emb = p["embedding"]
    emb = emb.w if isinstance(emb, QT) else emb
    x = emb[tokens.long()].to(torch.bfloat16)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.bfloat16,
                             device=x.device)
    return x


def lm_head(cfg, p, x, qcfg: QuantConfig):
    """f32 logits.  A tied model multiplies by the embedding transposed,
    its weight scale taken just in time; a served one by the
    pre-quantized transposed head ``head_t`` (``train.steps.
    prequantize_params``).  ``logit_softcap`` c: tanh(logits / c) * c in
    f32."""
    if cfg.tie_embeddings:
        if "head_t" in p:
            logits = qlinear(x, p["head_t"], qcfg)
        else:
            emb = p["embedding"]
            w = (emb.w if isinstance(emb, QT) else emb).T
            logits = qlinear(x, QT(w, None), qcfg)
    else:
        logits = qlinear(x, p["head"], qcfg)
    logits = logits.to(torch.float32)
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = tanh(div_c(logits, c)) * c
    return logits
