"""The serving half of ``repro.train.steps``: build-time weight
pre-quantization, the serving QT wrap, and the decode step (which is
also the chunked-prefill step).  The training step is ROADMAP queue 1
items 2-5."""

from __future__ import annotations

import torch

from repro_torch.core.formats import TINY, div_c, fp8_max
from repro_torch.core.linear import QT
from repro_torch.core.quant import PrequantParams, prequant_weight
from repro_torch.models.layers import PDef, quant_mask_tree
from repro_torch.models.transformer import forward, model_defs


def _tree_map(fn, *trees):
    """Map ``fn`` over the leaves of nested dicts of the same shape."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *[t[k] for t in trees]) for k in first}
    return fn(*trees)


def _scale_dims(defs):
    """Leading dims that get independent fp8 scales (the stacked layer
    dim), from the PDef logical names."""
    def dims(d: PDef):
        n = 0
        for name in d.logical:
            if name not in ("layers", "experts"):
                break
            n += 1
        return n

    if isinstance(defs, PDef):
        return dims(defs)
    return {k: _scale_dims(v) for k, v in defs.items()}


def init_scales(defs, params, qcfg):
    """Per-(layer) slice scale: max(amax, TINY) / FP8_MAX over the
    non-stacked dims."""
    def init(w, nd):
        axes = tuple(range(nd, w.dim()))
        amax = w.to(torch.float32).abs().amax(dim=axes)
        return div_c(torch.clamp_min(amax, TINY), fp8_max(qcfg.fwd_format))

    return _tree_map(init, params, _scale_dims(defs))


def serve_weight_scales(cfg, params):
    """Build-time per-tensor weight scales (None unless the recipe is
    quantized with automatic scaling)."""
    if not (cfg.quant.quantized and cfg.quant.weight_scaling == "auto"):
        return None
    return init_scales(model_defs(cfg), params, cfg.quant)


def prequantize_params(cfg, params) -> PrequantParams | None:
    """Quantize every quantized linear weight to its fp8 payload once,
    per-(layer) slice scales, bitwise what the reference builds; never-
    quantized leaves keep their arrays (scale 1).  (The reference's
    transposed tied head ``embed/head_t`` comes with tied-embedding
    models.)"""
    qcfg = cfg.quant
    if not qcfg.quantized:
        return None
    if qcfg.weight_scaling != "auto":
        raise NotImplementedError(
            f"weight_scaling={qcfg.weight_scaling!r} for serving: ROADMAP "
            "queue 1 item 6")
    defs = model_defs(cfg)
    sdims = _scale_dims(defs)
    mask = quant_mask_tree(defs)
    pred = init_scales(defs, params, qcfg)

    def leaf(w, nd, m, s):
        if not m:
            return w, torch.ones((), dtype=torch.float32, device=w.device)
        return prequant_weight(w, nd, qcfg.fwd_format, scale=s,
                               cast_bf16=qcfg.weight_cast_bf16)

    out = _tree_map(leaf, params, sdims, mask, pred)
    return PrequantParams(qweights=_unzip(out, 0), scales=_unzip(out, 1))


def _unzip(tree, i):
    if isinstance(tree, dict):
        return {k: _unzip(v, i) for k, v in tree.items()}
    return tree[i]


def serve_quant_mask(cfg, tree=None):
    """The serving quantization mask (``quant_mask_tree``; ``tree`` is
    the reference's hook for the tied head, which waits with tied
    models)."""
    return quant_mask_tree(model_defs(cfg))


def _wrap_serve(params, mask, scales, act=None, path=()):
    """QT-wrap quantized leaves with their build-time scales and, from
    ``act`` (the flat ``{site tag: ActScale}``), their calibrated
    activation scales."""
    from repro_torch.core.actscale import path_tag

    out = {}
    for key, w in params.items():
        p = path + (key,)
        s = None if scales is None else scales[key]
        if isinstance(w, dict):
            out[key] = _wrap_serve(w, mask[key], s, act, p)
        elif mask[key]:
            out[key] = QT(w, s, act.get(path_tag(p)) if act else None)
        else:
            out[key] = w
    return out


def make_decode_step(cfg, scales=None, act_scales=None):
    """The serving step: tokens (B, 1) decode one position per slot;
    tokens (1, C) chunk-prefill C prompt tokens of one slot.  The same
    callable serves both shapes, as in the reference.  The caches' pool
    tensors are updated in place; the returned caches carry the advanced
    ``idx``."""
    mask = serve_quant_mask(cfg, scales)
    qcfg = cfg.quant

    def decode_step(params, caches, tokens):
        qp = _wrap_serve(params, mask, scales, act_scales)
        return forward(cfg, qcfg, qp, tokens, caches, mode="decode")

    return decode_step
