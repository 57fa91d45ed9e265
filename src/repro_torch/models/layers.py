"""Shared model components (counterpart of ``repro.models.layers``):
parameter definitions, norms, RoPE, the FFN, embedding and LM head.
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

from repro_torch.core import xla_cpu_numerics
from repro_torch.core.formats import QuantConfig
from repro_torch.core.linear import QT, qlinear


class PDef(NamedTuple):
    shape: tuple[int, ...]
    logical: tuple[str | None, ...]
    init: str = "normal"              # normal | zeros | ones | embed
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


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def _mean(xf: torch.Tensor) -> torch.Tensor:
    """f32 mean over the last dim, keepdim; on the CPU in the
    reference's order (``core.xla_cpu_numerics``)."""
    if xf.device.type == "cpu":
        return xla_cpu_numerics.mean(xf)
    return xf.mean(dim=-1, keepdim=True)


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
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------


def ffn_defs(cfg, d_ff: int | None = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {"w_up": PDef((d, f), ("fsdp", "mlp"), quantized=True),
            "w_gate": PDef((d, f), ("fsdp", "mlp"), quantized=True),
            "w_down": PDef((f, d), ("mlp", "fsdp"), quantized=True)}


def apply_ffn(cfg, p, x, qcfg: QuantConfig):
    """SwiGLU (the other activations are not ported yet)."""
    up = qlinear(x, p["w_up"], qcfg)
    gate = qlinear(x, p["w_gate"], qcfg)
    h = F.silu(gate.to(torch.float32)).to(x.dtype) * up
    return qlinear(h, p["w_down"], qcfg)


# ---------------------------------------------------------------------------
# Embedding + LM head
# ---------------------------------------------------------------------------


def embed_defs(cfg):
    """Untied embedding and LM head (tied heads are not ported yet)."""
    return {"embedding": PDef((cfg.vocab, cfg.d_model), ("vocab", "fsdp"),
                              "embed"),
            "head": PDef((cfg.d_model, cfg.vocab), ("fsdp", "vocab"),
                         quantized=True)}


def embed_tokens(cfg, p, tokens):
    emb = p["embedding"]
    emb = emb.w if isinstance(emb, QT) else emb
    return emb[tokens.long()].to(torch.bfloat16)


def lm_head(cfg, p, x, qcfg: QuantConfig):
    return qlinear(x, p["head"], qcfg).to(torch.float32)
