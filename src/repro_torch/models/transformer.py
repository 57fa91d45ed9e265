"""Model assembly (counterpart of ``repro.models.transformer``, the dense
and MoE families): embed -> repeated blocks -> final norm -> LM head,
and the token cross-entropy.  Params are stacked over layers like the
reference's; the layer scan is a Python loop over them.  In ``train``
mode the forward runs under autograd, each layer under
``torch.utils.checkpoint`` when ``cfg.remat`` is set (the reference's
``jax.checkpoint`` of the scan body); serving callers hold
``torch.inference_mode`` themselves."""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.formats import QuantConfig
from . import attention as attn_mod
from . import moe as moe_mod
from .attention import KVCache
from .layers import (
    apply_ffn,
    apply_norm,
    embed_defs,
    embed_tokens,
    ffn_defs,
    lm_head,
    norm_defs,
    stack_defs,
)


class Segment(NamedTuple):
    name: str
    n: int                       # repeats
    defs: dict                   # one unit's param defs (unstacked)
    apply: Callable              # (cfg,qcfg,p,x,pos,cache,mode)
    #                              -> (x, cache, aux loss or None)


def _dense_unit(cfg, d_ff=None):
    return {
        "ln1": norm_defs(cfg, cfg.d_model),
        "attn": attn_mod.attn_defs(cfg),
        "ln2": norm_defs(cfg, cfg.d_model),
        "ffn": ffn_defs(cfg, d_ff),
    }


def _dense_apply(cfg, qcfg, p, x, pos, cache, mode):
    h, cache = attn_mod.attention(cfg, p["attn"],
                                  apply_norm(cfg, p["ln1"], x), pos, qcfg,
                                  cache, mode)
    x = x + h
    h = apply_ffn(cfg, p["ffn"], apply_norm(cfg, p["ln2"], x), qcfg)
    return x + h, cache, None         # no aux loss (no per-layer launch)


def _moe_unit(cfg):
    return {
        "ln1": norm_defs(cfg, cfg.d_model),
        "attn": attn_mod.attn_defs(cfg),
        "ln2": norm_defs(cfg, cfg.d_model),
        "moe": moe_mod.moe_defs(cfg),
    }


def _moe_apply(cfg, qcfg, p, x, pos, cache, mode):
    h, cache = attn_mod.attention(cfg, p["attn"],
                                  apply_norm(cfg, p["ln1"], x), pos, qcfg,
                                  cache, mode)
    x = x + h
    h, aux = moe_mod.moe_block(cfg, p["moe"], apply_norm(cfg, p["ln2"], x),
                               qcfg, mode)
    return x + h, cache, aux


def _unsupported(cfg) -> list[str]:
    """What of ``cfg`` the port cannot run yet."""
    checks = {
        f"family {cfg.family!r}": cfg.family not in ("dense", "moe"),
        "shared experts (n_shared)": cfg.n_shared > 0,
        "leading dense layers (first_dense)": cfg.first_dense > 0,
        f"input_mode {cfg.input_mode!r}": cfg.input_mode != "tokens",
        f"pos_embedding {cfg.pos_embedding!r}":
            cfg.pos_embedding not in ("rope", "none"),
        f"attn_type {cfg.attn_type!r}": cfg.attn_type not in ("full",
                                                              "swa"),
        f"act {cfg.act!r}": cfg.act != "swiglu",
        f"norm {cfg.norm!r}": cfg.norm not in ("rmsnorm", "layernorm"),
        "qk_norm": cfg.qk_norm,
        "logit_softcap": cfg.logit_softcap > 0,
        "tie_embeddings": cfg.tie_embeddings,
        "embed_scale": cfg.embed_scale,
    }
    return [name for name, bad in checks.items() if bad]


def build_segments(cfg) -> list[Segment]:
    bad = _unsupported(cfg)
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(bad)} not ported yet: ROADMAP queue 1 "
            "items 10-11")
    if cfg.family == "moe":
        return [Segment("blocks", cfg.n_layers, _moe_unit(cfg), _moe_apply)]
    return [Segment("blocks", cfg.n_layers, _dense_unit(cfg), _dense_apply)]


def model_defs(cfg) -> dict:
    defs: dict[str, Any] = {
        "embed": embed_defs(cfg),
        "final_norm": norm_defs(cfg, cfg.d_model),
    }
    for seg in build_segments(cfg):
        defs[seg.name] = stack_defs(seg.defs, seg.n)
    return defs


def init_caches(cfg, batch: int, max_len: int, per_slot: bool = False,
                device="cuda") -> dict:
    """Contiguous caches for every segment, payloads stacked over the
    segment's layers: (L, B, KV, C, Dh).  One ``idx`` is shared by the
    layers: a scalar 0, or with ``per_slot`` a (B,) vector of zeros so
    that serving slots track their own depths."""
    caches = {}
    for seg in build_segments(cfg):
        one = attn_mod.init_cache(cfg, batch, max_len, device)
        stack = lambda t: None if t is None else \
            t[None].expand(seg.n, *t.shape).contiguous()
        idx = (torch.zeros((batch,), dtype=torch.int32, device=device)
               if per_slot else one.idx)
        caches[seg.name] = KVCache(stack(one.k), stack(one.v),
                                   stack(one.k_scale), stack(one.v_scale),
                                   idx)
    return caches


def paged_decode_supported(cfg, max_len: int, page_size: int) -> bool:
    """Floating page pools need an unwrapped cache (no window ring: the
    pool append writes ``idx // T`` directly) of a whole number of
    pages.  Dense and MoE models alike: a MoE block's attention and its
    caches are the dense ones."""
    c = attn_mod.cache_len(cfg, max_len)
    return c == max_len and c % page_size == 0


def chunk_prefill_supported(cfg, max_len: int) -> bool:
    """Chunked prefill writes prompt chunks at absolute positions, so it
    needs an unwrapped cache (C == max_len)."""
    return attn_mod.cache_len(cfg, max_len) == max_len


def spec_verify_supported(cfg, max_len: int) -> bool:
    """The speculative verify step writes k positions at absolute depths
    and a rejection truncates the depth: the same gate as chunked
    prefill (an unwrapped cache, C == max_len)."""
    return chunk_prefill_supported(cfg, max_len)


def init_paged_pools(cfg, max_len: int, num_pages: int, page_size: int,
                     device) -> dict:
    """Floating-page pools for every segment: payloads stacked over the
    segment's layers with ``num_pages + 1`` physical pages -- the extra
    last page is the TRASH page that chunk padding and unassigned
    block-table entries point at (its bytes are never read).  ``idx``
    and ``block_table`` start empty; the engine stamps them before every
    step."""
    if not paged_decode_supported(cfg, max_len, page_size):
        raise ValueError(f"{cfg.name}: max_len={max_len} page_size="
                         f"{page_size} cannot use floating pages")
    pps = max_len // page_size
    pools = {}
    for seg in build_segments(cfg):
        k, v, ks, vs = attn_mod.init_page_pool(cfg, num_pages + 1,
                                               page_size, seg.n, device)
        pools[seg.name] = KVCache(
            k=k, v=v, k_scale=ks, v_scale=vs,
            idx=torch.zeros((0,), dtype=torch.int32, device=device),
            block_table=torch.zeros((0, pps), dtype=torch.int32,
                                    device=device))
    return pools


def _layer_cache(c: KVCache, l: int) -> KVCache:
    # views: the layer's in-place writes land in the stacked tensors
    return c._replace(k=c.k[l], v=c.v[l],
                      k_scale=None if c.k_scale is None else c.k_scale[l],
                      v_scale=None if c.v_scale is None else c.v_scale[l])


def _unbind(t, n: int) -> list:
    return [None] * n if t is None else list(t.unbind(0))


def _layers(tree, n: int) -> list:
    """A stacked segment subtree -> one subtree per layer.  Each stacked
    tensor is split once with ``unbind`` (whose backward stacks the
    per-layer gradients once; indexing ``w[l]`` per layer would build a
    stacked-size zero gradient for every layer)."""
    from repro_torch.core.linear import QT

    if isinstance(tree, QT):
        a = tree.a
        aa = [None] * n if a is None else [
            a._replace(s=s, sub=sub)
            for s, sub in zip(_unbind(a.s, n), _unbind(a.sub, n))]
        return [QT(w, s, al) for w, s, al in
                zip(_unbind(tree.w, n), _unbind(tree.s, n), aa)]
    if isinstance(tree, dict):
        per = {k: _layers(v, n) for k, v in tree.items()}
        return [{k: per[k][l] for k in tree} for l in range(n)]
    return _unbind(tree, n)


def forward(cfg, qcfg: QuantConfig, params, tokens: torch.Tensor,
            caches: dict | None = None, mode: str = "train"):
    """Returns (logits f32, new_caches, aux_loss): ``aux_loss`` is the
    f32 sum of the MoE blocks' load-balance losses (0 for dense models).

    tokens (B, S).  ``train`` runs without a cache, under autograd;
    ``prefill`` writes the prompt's K/V into fresh contiguous caches
    (``init_caches``) from position 0; ``decode`` and ``verify`` (S
    draft tokens per slot, attended through the decode kernel) read the
    depths from the caches' ``idx`` (a scalar or one per slot) for
    positions.  The caches are written in place and come back with
    ``idx`` advanced by S."""
    b, s = tokens.shape
    x = embed_tokens(cfg, params["embed"], tokens)
    dev = x.device
    if mode in ("decode", "verify"):
        pos0 = _first_idx(caches)
        positions = torch.arange(s, dtype=torch.int32, device=dev)
        positions = (pos0[:, None] + positions if pos0.dim()
                     else pos0 + positions)
    elif mode in ("train", "prefill"):
        positions = torch.arange(s, dtype=torch.int32, device=dev)
    else:
        raise ValueError(f"forward mode {mode!r}")
    remat = cfg.remat and mode == "train" and torch.is_grad_enabled()

    aux_total = torch.zeros((), dtype=torch.float32, device=dev)
    new_caches = {}
    for seg in build_segments(cfg):
        c_seg = caches.get(seg.name) if caches is not None else None
        new_c = None
        for l, p_l in enumerate(_layers(params[seg.name], seg.n)):
            c_l = None if c_seg is None else _layer_cache(c_seg, l)
            if remat:
                x, new_c, aux = checkpoint(seg.apply, cfg, qcfg, p_l, x,
                                           positions, c_l, mode,
                                           use_reentrant=False)
            else:
                x, new_c, aux = seg.apply(cfg, qcfg, p_l, x, positions,
                                          c_l, mode)
            if aux is not None:
                aux_total = aux_total + aux
        new_caches[seg.name] = (None if c_seg is None
                                else c_seg._replace(idx=new_c.idx))
    x = apply_norm(cfg, params["final_norm"], x)
    logits = lm_head(cfg, params["embed"], x, qcfg)
    return logits, (new_caches if caches is not None else None), aux_total


def ce_loss(cfg, logits: torch.Tensor, labels: torch.Tensor,
            mask: torch.Tensor | None = None) -> torch.Tensor:
    """Token cross-entropy in f32 (``repro.models.transformer.ce_loss``:
    max-shifted log-sum-exp, the max held out of the gradient)."""
    logits = logits.to(torch.float32)
    m = logits.detach().amax(dim=-1, keepdim=True)
    shifted = logits - m
    lse = torch.log(torch.exp(shifted).sum(dim=-1))
    picked = shifted.gather(-1, labels.long()[..., None])[..., 0]
    ll = picked - lse
    if mask is None:
        return -ll.mean()
    mask = mask.to(torch.float32)
    return -(ll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def _first_idx(caches) -> torch.Tensor:
    for c in caches.values():
        if c is not None:
            return c.idx
    raise ValueError("decode mode needs caches")
