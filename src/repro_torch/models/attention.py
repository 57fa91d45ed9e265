"""Attention with RoPE and the fp8 KV cache (counterpart of
``repro.models.attention``, the paths the serving slices run).

Modes:
  train    chunked causal attention, no cache (the calibration forward)
  prefill  chunked causal attention, then the prompt's K/V written into
           a fresh contiguous cache (the whole-prompt prefill)
  decode   S == 1: one new token per slot against the cache through
           the decode kernel (paged or contiguous); S > 1: a
           chunked-prefill step -- S prompt tokens written at the
           slot's depth, attending the resident history plus an
           in-chunk causal mask.
  verify   the speculative verify step: S = k tokens per slot (the last
           committed token and k - 1 drafts) written at the slot's depth,
           then attended through the decode kernel's batched-query form
           (draft j sees its own position and the earlier drafts', as
           the j-th of k sequential decode steps would).  S == 1 is
           decode.  Unwrapped caches only (the engine's gate).

The cache is updated IN PLACE: where the reference donates the caches
to its jitted step and gets new arrays back, ``_cache_write`` writes
the new positions into the tensors it was given and returns a cache
whose ``idx`` has advanced.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.formats import E4M3_MAX, TINY, QuantConfig, cast_fp8
from repro_torch.core.formats import div_c
from repro_torch.core.linear import QT, dense_general
from repro_torch.core.runtime_flags import (decode_attn_path, einsum,
                                            kv_cache_override)
from repro_torch.kernels import dispatch
from ._attn_core import NEG_INF, _window, chunked_attention
from .layers import PDef, _mean, _rsqrt, apply_rope


class KVCache(NamedTuple):
    """One layer's KV cache, in one of two layouts.

    Contiguous (``block_table`` None: identity placement, the legacy
    Server, the whole-prompt prefill); C = ``cache_len`` =
    min(max_len, window):
      k, v          (B, KV, C, Dh)  e4m3 (fp8 cache) or bf16 payloads;
                                    position p lives in slot p % C (a
                                    ring for a windowed arch)
      k/v_scale     (B, KV, C)      f32 per-(token, kv-head) scales, or
                                    None for a bf16 cache
      idx           () | (B,)       int32 absolute position of the next
                                    write (not mod C); slot s is live
                                    iff s < min(idx, C).  A scalar is
                                    one depth for every row (the
                                    prefill); (B,) is per-slot depths
                                    (the engine, the Server)

    Floating page pool (``block_table`` set):
      k, v          (P, KV, T, Dh)  payloads, P physical pages of T
                                    tokens shared by every slot (the
                                    last one is the trash page)
      k/v_scale     (P, KV, T)      scales, or None for a bf16 pool
      idx           (B,)            int32 per-slot logical depth
      block_table   (B, NP)         int32: logical page j of slot b is
                                    physical page block_table[b, j]

    The engine stacks the payloads over layers ((L, ...)) and shares
    one idx / block_table between layers."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None
    v_scale: torch.Tensor | None
    idx: torch.Tensor
    block_table: torch.Tensor | None = None


def _quant_kv(x: torch.Tensor):
    """(B, KV, S, Dh) -> (e4m3 payload, per-(B, KV, S) f32 scale): one
    amax over each position's head vector, TINY-clamped."""
    xf = x.to(torch.float32)
    s = div_c(torch.clamp_min(xf.abs().amax(dim=-1), TINY), E4M3_MAX)
    return cast_fp8(xf / s[..., None], "e4m3"), s


def _dequant_kv(q, s, dtype=torch.bfloat16):
    return (q.to(torch.float32) * s[..., None]).to(dtype)


def attn_defs(cfg):
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    defs = {
        "wq": PDef((d, h, dh), ("fsdp", "heads", None), quantized=True),
        "wk": PDef((d, kv, dh), ("fsdp", "kv_heads", None), quantized=True),
        "wv": PDef((d, kv, dh), ("fsdp", "kv_heads", None), quantized=True),
        "wo": PDef((h, dh, d), ("heads", None, "fsdp"), quantized=True),
    }
    if cfg.qk_norm:
        defs["q_norm"] = PDef((dh,), (None,), "ones")
        defs["k_norm"] = PDef((dh,), (None,), "ones")
    return defs


def cache_len(cfg, max_len: int) -> int:
    """Slots per row of a contiguous cache: the window for a windowed
    arch, else max_len."""
    w = _window(cfg)
    return min(max_len, w) if w else max_len


def resolve_kv_cache_dtype(cfg) -> str:
    """The KV-cache storage dtype: ``REPRO_KV_CACHE`` when set, else
    the config's (``"fp8"`` by default).  Read only where a cache or a
    pool is made: an existing cache keeps its layout.  MLA's latent
    cache and the recurrent states do not read it."""
    return kv_cache_override() or cfg.kv_cache_dtype


def init_cache(cfg, batch: int, max_len: int, device) -> KVCache:
    """A zeroed contiguous cache of ``cache_len`` slots with a scalar
    ``idx`` of 0 (``transformer.init_caches`` widens it per slot)."""
    shape = (batch, cfg.n_kv, cache_len(cfg, max_len), cfg.head_dim)
    idx = torch.zeros((), dtype=torch.int32, device=device)
    if resolve_kv_cache_dtype(cfg) == "fp8":
        z = lambda shp, dt: torch.zeros(shp, dtype=dt, device=device)
        return KVCache(z(shape, torch.float8_e4m3fn),
                       z(shape, torch.float8_e4m3fn),
                       z(shape[:-1], torch.float32),
                       z(shape[:-1], torch.float32), idx)
    z = torch.zeros(shape, dtype=torch.bfloat16, device=device)
    return KVCache(z, z.clone(), None, None, idx)


def init_page_pool(cfg, num_pages: int, page_size: int, n_layers: int,
                   device) -> tuple:
    """Zeroed (L, P, KV, T, Dh) payloads and (L, P, KV, T) scales (or
    None) for one segment's floating-page pool."""
    shape = (n_layers, num_pages, cfg.n_kv, page_size, cfg.head_dim)
    if resolve_kv_cache_dtype(cfg) == "fp8":
        z = lambda shp, dt: torch.zeros(shp, dtype=dt, device=device)
        return (z(shape, torch.float8_e4m3fn), z(shape, torch.float8_e4m3fn),
                z(shape[:-1], torch.float32), z(shape[:-1], torch.float32))
    z = torch.zeros(shape, dtype=torch.bfloat16, device=device)
    return z, z.clone(), None, None


def _qk_norm(x, scale, eps):
    """Per-head RMS over Dh in f32 times the per-head-dim ``scale`` (no
    1 + scale, unlike ``layers.rmsnorm``); the f32 result, which the
    caller rounds."""
    xf = x.to(torch.float32)
    return xf * _rsqrt(_mean(xf * xf) + eps) * scale.to(torch.float32)


def _project_qkv(cfg, p, x, positions, qcfg: QuantConfig):
    q = dense_general(x, p["wq"], qcfg)                  # (B,S,H,Dh)
    k = dense_general(x, p["wk"], qcfg)                  # (B,S,KV,Dh)
    v = dense_general(x, p["wv"], qcfg)
    if cfg.qk_norm:
        # after the projections, before RoPE
        q = _qk_norm(q, p["q_norm"], cfg.norm_eps).to(x.dtype)
        k = _qk_norm(k, p["k_norm"], cfg.norm_eps).to(x.dtype)
    if cfg.pos_embedding == "rope":
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_pct)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_pct)
    return q, k, v


def _attend(qg, cache: KVCache, n_valid):
    """The grouped queries against the cache through the paged or the
    contiguous decode kernel; ``REPRO_DECODE_ATTN=einsum`` takes their
    plain versions, on the card too (the reference's A/B switch)."""
    sm = qg.shape[-1] ** -0.5
    args = (qg, cache.k, cache.v, cache.k_scale, cache.v_scale, n_valid)
    if decode_attn_path() == "einsum":
        return dispatch.decode_attention_plain(*args, cache.block_table,
                                               sm_scale=sm)
    if cache.block_table is not None:
        return dispatch.decode_attention_paged(*args, cache.block_table,
                                               sm_scale=sm)
    return dispatch.decode_attention(*args, sm_scale=sm)


def _decode_attention(cfg, q, cache: KVCache, n_valid):
    """q: (B, 1, H, Dh) against the cache, through the paged or the
    contiguous decode kernel (head h belongs to kv head h // G)."""
    b, _, h, dh = q.shape
    kvh = cache.k.shape[1]
    qg = q.reshape(b, kvh, h // kvh, dh)
    return _attend(qg, cache, n_valid).reshape(b, 1, h, dh).to(q.dtype)


def _verify_attention(cfg, q, cache: KVCache, n_valid):
    """q: (B, S, H, Dh), S draft queries per slot, against the cache the
    drafts were just written into; ``n_valid`` is the depth after that
    write.  The (B, KV, S, G, Dh) regroup (head h of draft j is kv head
    h // G, row h % G) takes the 5-D form of the decode dispatch, so the
    history is read in place, never dequantized."""
    b, s, h, dh = q.shape
    kvh = cache.k.shape[1]
    qg = q.reshape(b, s, kvh, h // kvh, dh).transpose(1, 2)
    out = _attend(qg, cache, n_valid)
    return out.transpose(1, 2).reshape(b, s, h, dh).to(q.dtype)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """fp8 tensors are indexed through a uint8 view (bit for bit; not
    every PyTorch build has float8 index kernels)."""
    return t.view(torch.uint8) if t.element_size() == 1 and \
        t.is_floating_point() else t


def _gather(pool, block_table):
    """(P, KV, T, ...) pool -> (B, KV, NP·T, ...) through the table."""
    b = block_table.shape[0]
    x = _bytes(pool)[block_table.long()].view(pool.dtype)
    x = x.movedim(2, 1)                       # (B, KV, NP, T, ...)
    return x.reshape(b, x.shape[1], -1, *x.shape[4:])


def _chunk_attention(cfg, q, k_new, v_new, cache: KVCache, pos0):
    """Chunked-prefill attention: S new prompt tokens at each slot's
    depth against the resident history (positions < pos0, read back
    dequantized from the post-write pool) plus an in-chunk causal mask
    over the chunk's own bf16 K/V; one f32 softmax over both.  History
    positions are absolute, never ring-wrapped (non-windowed caches
    only: ``transformer.chunk_prefill_supported``)."""
    b, s, h, dh = q.shape
    kvh = k_new.shape[2]
    g = h // kvh
    scale = dh ** -0.5
    fp8 = cache.k_scale is not None
    dev = q.device
    pos0 = pos0.reshape(-1).expand(b)

    if cache.block_table is not None:
        kh, vh = _gather(cache.k, cache.block_table), \
            _gather(cache.v, cache.block_table)
        if fp8:
            kh = _dequant_kv(kh, _gather(cache.k_scale, cache.block_table))
            vh = _dequant_kv(vh, _gather(cache.v_scale, cache.block_table))
    else:
        kh, vh = cache.k, cache.v
        if fp8:
            kh = _dequant_kv(kh, cache.k_scale)
            vh = _dequant_kv(vh, cache.v_scale)
    c = kh.shape[2]

    qg = q.reshape(b, s, kvh, g, dh).permute(0, 2, 3, 1, 4)
    kf = k_new.transpose(1, 2)                # (B,KV,S,Dh)
    vf = v_new.transpose(1, 2)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)

    s_hist = einsum("bkgsd,bkcd->bkgsc", qg, kh) * scale
    s_self = einsum("bkgsd,bktd->bkgst", qg, kf) * scale
    hist_ok = torch.arange(c, device=dev)[None, :] < pos0[:, None]
    s_hist = torch.where(hist_ok[:, None, None, None, :], s_hist, neg)
    causal = torch.arange(s, device=dev)[:, None] >= \
        torch.arange(s, device=dev)[None, :]
    s_self = torch.where(causal[None, None, None], s_self, neg)
    scores = torch.cat([s_hist, s_self], dim=-1)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    p = p / p.sum(dim=-1, keepdim=True)
    out = (einsum("bkgsc,bkcd->bkgsd", p[..., :c], vh)
           + einsum("bkgst,bktd->bkgsd", p[..., c:], vf))
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, h, dh)
    return out.to(q.dtype)


def _cache_write(cfg, cache: KVCache, k_new, v_new) -> KVCache:
    """Append S positions per slot IN PLACE; fp8 caches quantize on
    write.  Returns the cache with ``idx`` advanced by S (a new tensor:
    the layers share the old one).

    Floating page pool: position p of slot b lands in physical page
    ``block_table[b, p // T]`` at offset ``p % T``; for S > 1 the
    positions past the block-table width (a chunk's padded tail) go to
    the trash page (the pool's last row).  The engine has made every
    target page private beforehand.

    Contiguous cache, position p in slot p % C:
      (B,) idx, S > 1   each row writes its chunk at its own depth;
                        positions >= C are dropped, not clamped (a
                        chunk's padded tail; non-windowed caches only)
      S >= C            the last C positions, rolled so that p sits in
                        slot p % C (the prefill of a ring; scalar idx)
      (B,) idx, S == 1  each row writes at idx[b] % C (ring decode)
      scalar idx        [idx % C, idx % C + S), the start clamped to
                        C - S as the reference's update slice does"""
    fp8 = cache.k_scale is not None
    k_new = k_new.transpose(1, 2)                         # (B,KV,S,Dh)
    v_new = v_new.transpose(1, 2)
    ks_new = vs_new = None
    if fp8:
        k_new, ks_new = _quant_kv(k_new)
        v_new, vs_new = _quant_kv(v_new)
    s_new = k_new.shape[2]
    idx = cache.idx.long()
    dev = idx.device
    if cache.block_table is not None:
        t = cache.k.shape[2]
        bt = cache.block_table.long()
        if s_new == 1:
            page = bt.gather(1, (idx // t)[:, None])[:, 0]    # (B,)
            off = idx % t

            def put(buf, upd):                           # upd (B,KV,1,...)
                _bytes(buf)[page, :, off] = _bytes(upd[:, :, 0].to(buf.dtype))
        else:
            n_pages = bt.shape[1]
            trash = cache.k.shape[0] - 1
            pos = idx[:, None] + torch.arange(s_new, device=dev)
            lp = pos // t
            page = torch.where(lp < n_pages,
                               bt.gather(1, lp.clamp(0, n_pages - 1)),
                               torch.full_like(lp, trash))  # (B,S)
            off = pos % t

            def put(buf, upd):                           # upd (B,KV,S,...)
                _bytes(buf)[page, :, off] = _bytes(
                    upd.movedim(2, 1).to(buf.dtype))
    else:
        c = cache.k.shape[2]
        if idx.dim() == 1 and s_new > 1:
            pos = idx[:, None] + torch.arange(s_new, device=dev)
            keep = pos < c
            rows = torch.arange(pos.shape[0], device=dev)[:, None] \
                .expand_as(pos)[keep]
            slots = pos[keep]

            def put(buf, upd):
                _bytes(buf)[rows, :, slots] = _bytes(
                    upd.movedim(2, 1)[keep].to(buf.dtype))
        elif s_new >= c:
            if idx.dim() != 0:
                raise ValueError("a multi-token ring append needs a shared "
                                 "scalar idx (the engine prefills one "
                                 "request at a time)")
            start = (int(idx) + s_new - c) % c

            def put(buf, upd):
                _bytes(buf).copy_(torch.roll(
                    _bytes(upd[:, :, -c:].to(buf.dtype)), start, dims=2))
        elif idx.dim() == 1:
            if s_new != 1:
                raise ValueError("a per-slot cache appends one token")
            rows = torch.arange(idx.shape[0], device=dev)
            slot = idx % c

            def put(buf, upd):
                _bytes(buf)[rows, :, slot] = _bytes(upd[:, :, 0].to(
                    buf.dtype))
        else:
            start = min(int(idx) % c, c - s_new)

            def put(buf, upd):
                _bytes(buf)[:, :, start:start + s_new] = _bytes(
                    upd.to(buf.dtype))

    put(cache.k, k_new)
    put(cache.v, v_new)
    if fp8:
        put(cache.k_scale, ks_new)
        put(cache.v_scale, vs_new)
    return cache._replace(idx=cache.idx + s_new)


def attention(cfg, p, x, positions, qcfg: QuantConfig,
              cache: KVCache | None = None, mode: str = "train"):
    """Returns (out, new_cache); see the module docstring for modes.
    ``prefill`` writes into ``cache``, a fresh contiguous cache
    (``transformer.init_caches``), from position 0."""
    if mode in ("decode", "verify"):
        q, k_new, v_new = _project_qkv(cfg, p, x, positions, qcfg)
        if x.shape[1] == 1:
            new_cache = _cache_write(cfg, cache, k_new, v_new)
            out = _decode_attention(cfg, q, new_cache, new_cache.idx)
        elif mode == "verify":
            new_cache = _cache_write(cfg, cache, k_new, v_new)
            out = _verify_attention(cfg, q, new_cache, new_cache.idx)
        else:
            pos0 = cache.idx
            new_cache = _cache_write(cfg, cache, k_new, v_new)
            out = _chunk_attention(cfg, q, k_new, v_new, new_cache, pos0)
    elif mode in ("train", "prefill"):
        q, k, v = _project_qkv(cfg, p, x, positions, qcfg)
        out = chunked_attention(cfg, q, k, v)
        new_cache = (_cache_write(cfg, cache, k, v) if mode == "prefill"
                     else None)
    else:
        raise ValueError(f"attention mode {mode!r}")
    y = dense_general(out.reshape(*out.shape[:-2], -1), QTflat(p["wo"]),
                      qcfg)
    return y, new_cache


def QTflat(wt):
    """wo is stored (H, Dh, d); flatten to (H·Dh, d) for the GEMM,
    keeping the scale and the activation-scale field."""
    w = wt.w if isinstance(wt, QT) else wt
    s = wt.s if isinstance(wt, QT) else None
    a = wt.a if isinstance(wt, QT) else None
    return QT(w.reshape(-1, w.shape[-1]), s, a)
