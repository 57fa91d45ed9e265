"""Model assembly (counterpart of ``repro.models.transformer``): embed
(or take the embeddings of the audio and vision models) -> segments of
repeated blocks -> final norm -> LM head, and the token cross-entropy.
The dense, audio and vision families are ``blocks`` of attention and an
FFN (musicgen adds sinusoidal positions to its input); deepseek's
leading dense layers are a segment of their own (``dense0``) before the
MoE ``blocks``; recurrentgemma's are ``griffin`` units of (recurrent,
recurrent, local attention) and a ``tail_rec`` segment of the
``n_layers % 3`` recurrent blocks left over; rwkv6's ``blocks`` are a
time mix and a channel mix.  A segment's cache is one node
(``KVCache``, ``MLACache``, ``RGLRUState``, ``RWKVState``) or a griffin
unit's tuple of three; every node of a segment shares one ``idx``.
Params are stacked over layers like the reference's; the layer scan is
a Python loop over them.  In ``train`` mode the forward runs under
autograd, each layer under ``torch.utils.checkpoint`` when
``cfg.remat`` is set (the reference's ``jax.checkpoint`` of the scan
body); serving callers hold ``torch.inference_mode`` themselves."""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.actscale import split_act
from repro_torch.core.formats import QuantConfig
from repro_torch.obs.quant_health import QH
from . import attention as attn_mod
from . import mla as mla_mod
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import rwkv6 as rwkv_mod
from .attention import KVCache
from .layers import (
    apply_ffn,
    apply_norm,
    embed_defs,
    embed_tokens,
    ffn_defs,
    lm_head,
    norm_defs,
    sinusoidal_embedding,
    stack_defs,
)


class Segment(NamedTuple):
    name: str
    n: int                       # repeats
    defs: dict                   # one unit's param defs (unstacked)
    apply: Callable              # (cfg,qcfg,p,x,pos,cache,mode)
    #                              -> (x, cache, aux loss or None)
    init_cache: Callable         # (cfg,batch,max_len,device)->one cache


def _attention(cfg):
    """(param defs, apply, init_cache) of the family's attention: MLA's
    latent attention for mla_moe, else the per-head one."""
    if cfg.family == "mla_moe":
        return mla_mod.mla_defs, mla_mod.mla_attention, \
            mla_mod.init_mla_cache
    return attn_mod.attn_defs, attn_mod.attention, attn_mod.init_cache


def _dense_unit(cfg, d_ff=None):
    return {
        "ln1": norm_defs(cfg, cfg.d_model),
        "attn": _attention(cfg)[0](cfg),
        "ln2": norm_defs(cfg, cfg.d_model),
        "ffn": ffn_defs(cfg, d_ff),
    }


def _dense_apply(cfg, qcfg, p, x, pos, cache, mode):
    h, cache = _attention(cfg)[1](cfg, p["attn"],
                                  apply_norm(cfg, p["ln1"], x), pos, qcfg,
                                  cache, mode)
    x = x + h
    h = apply_ffn(cfg, p["ffn"], apply_norm(cfg, p["ln2"], x), qcfg)
    return x + h, cache, None         # no aux loss (no per-layer launch)


def _moe_unit(cfg):
    unit = {
        "ln1": norm_defs(cfg, cfg.d_model),
        "attn": _attention(cfg)[0](cfg),
        "ln2": norm_defs(cfg, cfg.d_model),
        "moe": moe_mod.moe_defs(cfg),
    }
    if cfg.n_shared > 0:
        unit["shared"] = ffn_defs(cfg, cfg.n_shared * cfg.d_ff)
    return unit


def _moe_apply(cfg, qcfg, p, x, pos, cache, mode):
    """The MoE block: attention, the routed experts, then the shared
    experts' FFN on the same normed input, added after the routed output
    (the reference's order)."""
    h, cache = _attention(cfg)[1](cfg, p["attn"],
                                  apply_norm(cfg, p["ln1"], x), pos, qcfg,
                                  cache, mode)
    x = x + h
    hn = apply_norm(cfg, p["ln2"], x)
    h, aux = moe_mod.moe_block(cfg, p["moe"], hn, qcfg, mode)
    if cfg.n_shared > 0:
        h = h + apply_ffn(cfg, p["shared"], hn, qcfg)
    return x + h, cache, aux


def _rec_unit(cfg):
    return {
        "ln1": norm_defs(cfg, cfg.d_model),
        "rec": rglru_mod.rglru_defs(cfg),
        "ln2": norm_defs(cfg, cfg.d_model),
        "ffn": ffn_defs(cfg),
    }


def _rec_apply(cfg, qcfg, p, x, pos, cache, mode):
    h, cache = rglru_mod.rglru_block(cfg, p["rec"],
                                     apply_norm(cfg, p["ln1"], x), qcfg,
                                     cache, mode)
    x = x + h
    h = apply_ffn(cfg, p["ffn"], apply_norm(cfg, p["ln2"], x), qcfg)
    return x + h, cache, None


def _griffin_unit(cfg):
    """RecurrentGemma's repeating unit: (rec, rec, local attention),
    each with its own FFN."""
    return {"rec0": _rec_unit(cfg), "rec1": _rec_unit(cfg),
            "attn0": _dense_unit(cfg)}


def _griffin_apply(cfg, qcfg, p, x, pos, cache, mode):
    cache = cache if cache is not None else (None, None, None)
    x, c0, _ = _rec_apply(cfg, qcfg, p["rec0"], x, pos, cache[0], mode)
    x, c1, _ = _rec_apply(cfg, qcfg, p["rec1"], x, pos, cache[1], mode)
    x, c2, _ = _dense_apply(cfg, qcfg, p["attn0"], x, pos, cache[2], mode)
    return x, (c0, c1, c2), None


def _griffin_cache(cfg, batch, max_len, device):
    return (rglru_mod.init_rglru_state(cfg, batch, device=device),
            rglru_mod.init_rglru_state(cfg, batch, device=device),
            attn_mod.init_cache(cfg, batch, max_len, device))


def _rwkv_unit(cfg):
    return {
        "ln1": norm_defs(cfg, cfg.d_model),
        "tm": rwkv_mod.timemix_defs(cfg),
        "ln2": norm_defs(cfg, cfg.d_model),
        "cm": rwkv_mod.chanmix_defs(cfg),
    }


def _rwkv_apply(cfg, qcfg, p, x, pos, cache, mode):
    """rwkv6's block: the time mix, then the channel mix, each on its
    normed input; without a cache (training, calibration) from a zeroed
    state."""
    st = cache if cache is not None else rwkv_mod.init_rwkv_state(
        cfg, x.shape[0], device=x.device)
    h, st = rwkv_mod.time_mix(cfg, p["tm"], apply_norm(cfg, p["ln1"], x),
                              qcfg, st, mode)
    x = x + h
    h, st = rwkv_mod.channel_mix(cfg, p["cm"], apply_norm(cfg, p["ln2"], x),
                                 qcfg, st, mode)
    return x + h, st._replace(idx=st.idx + x.shape[1]), None


def build_segments(cfg) -> list[Segment]:
    if cfg.family == "ssm":
        return [Segment("blocks", cfg.n_layers, _rwkv_unit(cfg),
                        _rwkv_apply, rwkv_mod.init_rwkv_state)]
    if cfg.family not in ("dense", "audio", "vlm", "moe", "mla_moe",
                          "hybrid"):
        raise ValueError(f"{cfg.name}: family {cfg.family!r}")
    init = _attention(cfg)[2]
    if cfg.family == "mla_moe":
        # deepseek: the leading dense layers, then the MoE blocks
        segs = []
        if cfg.first_dense:
            segs.append(Segment("dense0", cfg.first_dense,
                                _dense_unit(cfg, cfg.dense_ff or cfg.d_ff),
                                _dense_apply, init))
        segs.append(Segment("blocks", cfg.n_layers - cfg.first_dense,
                            _moe_unit(cfg), _moe_apply, init))
        return segs
    if cfg.family == "moe":
        return [Segment("blocks", cfg.n_layers, _moe_unit(cfg), _moe_apply,
                        init)]
    if cfg.family == "hybrid":
        n_units, rem = divmod(cfg.n_layers, 3)
        segs = [Segment("griffin", n_units, _griffin_unit(cfg),
                        _griffin_apply, _griffin_cache)]
        if rem:
            segs.append(Segment("tail_rec", rem, _rec_unit(cfg), _rec_apply,
                                rglru_mod.init_rglru_state))
        return segs
    return [Segment("blocks", cfg.n_layers, _dense_unit(cfg), _dense_apply,
                    init)]


def model_defs(cfg) -> dict:
    defs: dict[str, Any] = {
        "embed": embed_defs(cfg),
        "final_norm": norm_defs(cfg, cfg.d_model),
    }
    for seg in build_segments(cfg):
        defs[seg.name] = stack_defs(seg.defs, seg.n)
    return defs


def cache_nodes(c) -> list:
    """The nodes of one segment's cache: the node, or a griffin unit's
    three."""
    if hasattr(c, "_fields"):
        return [c]
    return [n for x in c for n in cache_nodes(x)]


def map_nodes(c, fn):
    """``c`` with ``fn`` applied to each of its nodes (tuples kept)."""
    if hasattr(c, "_fields"):
        return fn(c)
    return tuple(map_nodes(x, fn) for x in c)


def cache_payloads(c) -> list[str]:
    """The payload fields of a cache node (``KVCache``, ``MLACache``,
    ``RGLRUState``, ``RWKVState``): every field but the ``idx`` and
    ``block_table`` the layers share."""
    return [f for f in c._fields if f not in ("idx", "block_table")]


def map_payloads(c, fn):
    """``c`` with ``fn`` applied to each payload tensor of each node
    (None stays)."""
    return map_nodes(c, lambda n: n._replace(**{
        f: None if getattr(n, f) is None else fn(getattr(n, f))
        for f in cache_payloads(n)}))


def cache_idx(c) -> torch.Tensor:
    """The depth ``idx`` that a segment's nodes share."""
    return cache_nodes(c)[0].idx


def with_idx(c, idx):
    """``c`` with every node's ``idx`` replaced by ``idx``."""
    return map_nodes(c, lambda n: n._replace(idx=idx))


def init_caches(cfg, batch: int, max_len: int, per_slot: bool = False,
                device="cuda") -> dict:
    """Contiguous caches for every segment (``KVCache``, the MLA latent
    ``MLACache``, the RG-LRU's ``RGLRUState``, rwkv6's ``RWKVState``, or
    a griffin unit's tuple of them), payloads stacked over the segment's
    layers: (L, B, ...).  One ``idx`` is shared by the layers and the
    nodes of a segment: a scalar 0, or with ``per_slot`` a (B,) vector of
    zeros so that serving slots track their own depths."""
    caches = {}
    for seg in build_segments(cfg):
        one = seg.init_cache(cfg, batch, max_len, device)
        one = map_payloads(
            one, lambda t: t[None].expand(seg.n, *t.shape).contiguous())
        idx = (torch.zeros((batch,), dtype=torch.int32, device=device)
               if per_slot else cache_idx(one))
        caches[seg.name] = with_idx(one, idx)
    return caches


def _per_head_cache(cfg) -> bool:
    """Page pools, chunked prefill and verify steps take per-head
    ``KVCache`` families; MLA's latent cache and the recurrent states
    have no page structure and take the whole-prompt prefill on identity
    rows (the reference's gates)."""
    return cfg.family in ("dense", "audio", "vlm", "moe")


def paged_decode_supported(cfg, max_len: int, page_size: int) -> bool:
    """Floating page pools need a per-head cache, unwrapped (no window
    ring: the pool append writes ``idx // T`` directly), of a whole
    number of pages.  Dense and MoE models alike: a MoE block's
    attention and its caches are the dense ones."""
    c = attn_mod.cache_len(cfg, max_len)
    return _per_head_cache(cfg) and c == max_len and c % page_size == 0


def chunk_prefill_supported(cfg, max_len: int) -> bool:
    """Chunked prefill writes prompt chunks at absolute positions, so it
    needs a per-head, unwrapped cache (C == max_len)."""
    return _per_head_cache(cfg) and \
        attn_mod.cache_len(cfg, max_len) == max_len


def spec_verify_supported(cfg, max_len: int) -> bool:
    """The speculative verify step writes k positions at absolute depths
    and a rejection truncates the depth: the same gate as chunked
    prefill (a per-head, unwrapped cache, C == max_len)."""
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


def _layer_cache(c, l: int):
    # views: the layer's in-place writes land in the stacked tensors
    return map_payloads(c, lambda t: t[l])


def _store_layer(view, new) -> None:
    """Copy a layer's new state into its views of the stacked cache
    where the layer returned new tensors (the RG-LRU's ``h`` and
    ``conv``, rwkv6's ``x_tm``, ``x_cm`` and ``S``); attention writes its
    cache in place."""
    for vn, nn in zip(cache_nodes(view), cache_nodes(new)):
        for f in cache_payloads(vn):
            a, b = getattr(vn, f), getattr(nn, f)
            if a is not None and b is not a:
                a.copy_(b)


def _unbind(t, n: int) -> list:
    return [None] * n if t is None else list(t.unbind(0))


def _layers(tree, n: int) -> list:
    """A stacked segment subtree -> one subtree per layer.  Each stacked
    tensor is split once with ``unbind`` (whose backward stacks the
    per-layer gradients once; indexing ``w[l]`` per layer would build a
    stacked-size zero gradient for every layer)."""
    from repro_torch.core.linear import QT

    if isinstance(tree, QT):
        return [QT(w, s, al) for w, s, al in
                zip(_unbind(tree.w, n), _unbind(tree.s, n),
                    split_act(tree.a, n))]
    if isinstance(tree, dict):
        per = {k: _layers(v, n) for k, v in tree.items()}
        return [{k: per[k][l] for k in tree} for l in range(n)]
    return _unbind(tree, n)


def forward(cfg, qcfg: QuantConfig, params, tokens: torch.Tensor,
            caches: dict | None = None, mode: str = "train"):
    """Returns (logits f32, new_caches, aux_loss): ``aux_loss`` is the
    f32 sum of the MoE blocks' load-balance losses (0 for dense models).

    tokens (B, S) int, or for an embeddings-input model (musicgen,
    phi-3-vision) also its embeddings (B, S, d), taken in bf16 in place
    of the embedding's rows (the reference's ``{"embeds": ...}`` batch).
    ``train`` runs without a cache, under autograd;
    ``prefill`` writes the prompt's K/V into fresh contiguous caches
    (``init_caches``) from position 0; ``decode`` and ``verify`` (S
    draft tokens per slot, attended through the decode kernel) read the
    depths from the caches' ``idx`` (a scalar or one per slot) for
    positions.  The caches are written in place and come back with
    ``idx`` advanced by S."""
    if tokens.dim() == 3:
        if cfg.input_mode != "embeddings":
            raise ValueError(f"{cfg.name} takes tokens, not embeddings")
        x = tokens.to(torch.bfloat16)
    else:
        x = embed_tokens(cfg, params["embed"], tokens)
    b, s = x.shape[:2]
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
    if cfg.pos_embedding == "sinusoidal":
        pe = sinusoidal_embedding(positions, cfg.d_model)
        x = x + (pe if positions.dim() > 1 else pe[None]).to(x.dtype)
    remat = cfg.remat and mode == "train" and torch.is_grad_enabled()

    aux_total = torch.zeros((), dtype=torch.float32, device=dev)
    new_caches = {}
    for seg in build_segments(cfg):
        c_seg = caches.get(seg.name) if caches is not None else None
        new_c = None
        health = []              # quant-health: each layer's site stats
        for l, p_l in enumerate(_layers(params[seg.name], seg.n)):
            c_l = None if c_seg is None else _layer_cache(c_seg, l)
            if remat:
                x, new_c, aux = checkpoint(seg.apply, cfg, qcfg, p_l, x,
                                           positions, c_l, mode,
                                           use_reentrant=False)
            else:
                x, new_c, aux = seg.apply(cfg, qcfg, p_l, x, positions,
                                          c_l, mode)
            if c_l is not None:
                _store_layer(c_l, new_c)
            if aux is not None:
                aux_total = aux_total + aux
            if QH.tracing:
                health.append(QH.drain_layer())
        if health:
            QH.stash_layers(health)
        new_caches[seg.name] = (None if c_seg is None
                                else with_idx(c_seg, cache_idx(new_c)))
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
            return cache_idx(c)
    raise ValueError("decode mode needs caches")
