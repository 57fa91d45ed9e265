"""Multi-head Latent Attention (DeepSeek-V2): the counterpart of
``repro.models.mla``.

The cache holds the latent ``c_kv`` (kv_lora values a token) and the
shared RoPE key ``k_rope`` (q_rope values a token), bf16, one of each
for all heads.  Train and prefill materialise per-head K and V from the
latent through ``w_uk`` / ``w_uv`` (quantized ``dense_general``) and run
the chunked causal attention; decode uses the absorbed form: the query
is taken into the latent space through ``w_uk``, attends over every
cache slot, and the latent context leaves through ``w_uv``.  The
absorbed einsums are bf16-operand, f32-accumulation products
(``runtime_flags.einsum``); the reference computes them outside any
Pallas kernel, so they are plain torch here too.

The absorbed decode multiplies by the raw weights rounded to bf16, as
the reference's in-graph path does.  Served with pre-quantized weights
the tree carries those bf16 values beside the fp8 payloads
(``ABSORBED``, added by ``train.steps.prequantize_params``), so that
the decode does not multiply by an unscaled fp8 payload.

The cache is written IN PLACE, as ``attention._cache_write`` writes
its own: the returned cache shares the tensors it was given and has
``idx`` advanced by S.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.formats import QuantConfig
from repro_torch.core.linear import QT, dense_general, qlinear
from repro_torch.core.runtime_flags import einsum
from ._attn_core import NEG_INF, chunked_attention
from .layers import PDef, apply_rope, broadcast, rmsnorm

# the quantized weights the absorbed decode multiplies by -> the key of
# their bf16 copies in a pre-quantized serving tree
ABSORBED = {"w_uk": "w_uk_bf16", "w_uv": "w_uv_bf16"}


class MLACache(NamedTuple):
    """One layer's latent cache (the engine stacks the payloads over
    layers: (L, B, T, ...)).

      c_kv    (B, T, kv_lora)  bf16 latent, position p in slot p % T
      k_rope  (B, T, q_rope)   bf16 RoPE'd shared key
      idx     () | (B,)        int32 absolute position of the next write;
                               slot s is live iff s < min(idx, T).  A
                               scalar is one depth for every row (the
                               prefill); (B,) per-slot depths (the
                               engine, the Server)"""

    c_kv: torch.Tensor
    k_rope: torch.Tensor
    idx: torch.Tensor


def mla_defs(cfg):
    d, h = cfg.d_model, cfg.n_heads
    dq = cfg.q_nope + cfg.q_rope
    return {
        "wq": PDef((d, h, dq), ("fsdp", "heads", None), quantized=True),
        "w_dkv": PDef((d, cfg.kv_lora), ("fsdp", "latent"), quantized=True),
        "w_kr": PDef((d, cfg.q_rope), ("fsdp", None), quantized=True),
        "kv_norm": PDef((cfg.kv_lora,), (None,), "zeros"),
        "w_uk": PDef((cfg.kv_lora, h, cfg.q_nope), ("latent", "heads", None),
                     quantized=True),
        "w_uv": PDef((cfg.kv_lora, h, cfg.v_head), ("latent", "heads", None),
                     quantized=True),
        "wo": PDef((h, cfg.v_head, d), ("heads", None, "fsdp"),
                   quantized=True),
    }


def init_mla_cache(cfg, batch: int, max_len: int, device) -> MLACache:
    """A zeroed bf16 latent cache of ``max_len`` slots with a scalar
    ``idx`` of 0 (``transformer.init_caches`` widens it per slot)."""
    z = lambda n: torch.zeros((batch, max_len, n), dtype=torch.bfloat16,
                              device=device)
    return MLACache(z(cfg.kv_lora), z(cfg.q_rope),
                    torch.zeros((), dtype=torch.int32, device=device))


def _latent(cfg, p, x, positions, qcfg):
    c_kv = qlinear(x, p["w_dkv"], qcfg)                       # (B,S,L)
    c_kv = rmsnorm(c_kv, p["kv_norm"], cfg.norm_eps)
    k_r = qlinear(x, p["w_kr"], qcfg)[..., None, :]           # (B,S,1,R)
    k_r = apply_rope(k_r, positions, cfg.rope_theta)[..., 0, :]
    return c_kv, k_r


def _queries(cfg, p, x, positions, qcfg):
    q = dense_general(x, p["wq"], qcfg)                       # (B,S,H,N+R)
    q_n, q_r = q[..., :cfg.q_nope], q[..., cfg.q_nope:]
    return q_n, apply_rope(q_r, positions, cfg.rope_theta)


def _absorbed(p, name: str) -> torch.Tensor:
    """The weight the absorbed decode multiplies by: the bf16 copy a
    pre-quantized tree carries, else the raw weight (rounded to bf16 by
    the einsum).  An fp8 payload alone would be off by its scale."""
    if ABSORBED[name] in p:
        return p[ABSORBED[name]]
    w = p[name].w if isinstance(p[name], QT) else p[name]
    if w.element_size() == 1:
        raise ValueError(f"MLA decode: {name} is an fp8 payload without its "
                         f"bf16 copy {ABSORBED[name]!r} "
                         "(train.steps.prequantize_params adds it)")
    return w


def _write(cache: MLACache, c_kv, k_r) -> MLACache:
    """Append S positions per row in place, at ``idx % T`` (a scalar, or
    each row's own with a (B,) idx), the start clamped to T - S as the
    reference's update slice does."""
    t = cache.c_kv.shape[1]
    s = c_kv.shape[1]
    idx = cache.idx.long()
    if idx.dim() == 0:
        start = min(int(idx) % t, t - s)
        cache.c_kv[:, start:start + s] = c_kv.to(cache.c_kv.dtype)
        cache.k_rope[:, start:start + s] = k_r.to(cache.k_rope.dtype)
    else:
        start = torch.clamp_max(idx % t, t - s)
        rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
        slots = start[:, None] + torch.arange(s, device=idx.device)
        cache.c_kv[rows, slots] = c_kv.to(cache.c_kv.dtype)
        cache.k_rope[rows, slots] = k_r.to(cache.k_rope.dtype)
    return cache._replace(idx=cache.idx + s)


def _absorbed_attention(cfg, p, q_n, q_r, cache: MLACache, out_dtype):
    """The decode's attention over every slot of the (post-write) cache,
    in the latent space: (B, S, H, v_head)."""
    b = q_n.shape[0]
    t = cache.c_kv.shape[1]
    q_lat = einsum("bshn,lhn->bshl", q_n, _absorbed(p, "w_uk"))
    scores = (einsum("bshl,btl->bsht", q_lat, cache.c_kv)
              + einsum("bshr,btr->bsht", q_r, cache.k_rope))
    scores = scores * (cfg.q_nope + cfg.q_rope) ** -0.5
    nv = cache.idx.reshape(-1).expand(b)
    valid = torch.arange(t, device=nv.device)[None, :] < \
        torch.clamp_max(nv, t)[:, None]
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.tensor(NEG_INF, dtype=torch.float32,
                                      device=scores.device))
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    w = e / e.sum(dim=-1, keepdim=True)
    ctx_lat = einsum("bsht,btl->bshl", w, cache.c_kv)
    return einsum("bshl,lhv->bshv", ctx_lat,
                  _absorbed(p, "w_uv")).to(out_dtype)


def mla_attention(cfg, p, x, positions, qcfg: QuantConfig,
                  cache: MLACache | None = None, mode: str = "train"):
    """Returns (out, new_cache).  ``train`` runs without a cache;
    ``prefill`` writes the prompt's latents into ``cache`` (a fresh one,
    ``transformer.init_caches``) from position 0; ``decode`` appends
    at each row's depth and attends through the absorbed form."""
    b, s, _ = x.shape
    h = cfg.n_heads
    q_n, q_r = _queries(cfg, p, x, positions, qcfg)
    c_kv, k_r = _latent(cfg, p, x, positions, qcfg)
    if mode == "decode":
        new_cache = _write(cache, c_kv, k_r)
        out = _absorbed_attention(cfg, p, q_n, q_r, new_cache, x.dtype)
    elif mode in ("train", "prefill"):
        k_n = dense_general(c_kv, p["w_uk"], qcfg)            # (B,S,H,N)
        v = dense_general(c_kv, p["w_uv"], qcfg)              # (B,S,H,V)
        # the shared RoPE key to every head (its backward sums the heads
        # as the reference's does: layers.broadcast)
        k = torch.cat([k_n, broadcast(k_r, h, 2)], dim=-1)
        q = torch.cat([q_n, q_r], dim=-1)
        out = chunked_attention(cfg, q, k, v)
        new_cache = None
        if mode == "prefill":
            new_cache = _write(cache._replace(idx=torch.zeros_like(
                cache.idx)), c_kv, k_r)
    else:
        raise ValueError(f"MLA attention mode {mode!r}")
    # wo keeps its weight scale and drops the activation-scale field, as
    # the reference's QT(wo.w.reshape(-1, d), wo.s) does: it quantizes
    # just in time, also under delayed scales
    wo = p["wo"]
    w = wo.w if isinstance(wo, QT) else wo
    s_w = wo.s if isinstance(wo, QT) else None
    y = qlinear(out.reshape(b, s, -1), QT(w.reshape(-1, cfg.d_model), s_w),
                qcfg)
    return y, new_cache
