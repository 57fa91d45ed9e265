"""Step functions: the MOSS training step (forward + backward + AdamW +
automatic scaling) and the serving step, with their state plumbing.
Counterpart of ``repro.train.steps``.

The MOSS integration points of ``make_train_step``:
  1. before the forward, the per-tensor weight scales are predicted from
     the scale states (no max-reductions, paper Eq. 10); under ``jit``
     scaling (the per_group and per_tensor baselines) every GEMM
     measures its weight instead;
  2. every linear GEMM runs through ``core.linear.qmm`` (fp8 residuals,
     the fused dx and dW kernels);
  3. after the AdamW update the scale states advance one step, with a
     real max-reduction only when a refresh is due (a host branch).

Master weights, gradients and moments are f32.  The mesh, the fp8
gradient all-reduce and its ``comm_residual`` are ROADMAP queue 1
item 13: the state carries ``None`` and the step refuses a mesh.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core import row_order
from repro_torch.core.autoscale import advance, measured_scale, predict
from repro_torch.core.formats import QuantConfig
from repro_torch.core.linear import QT
from repro_torch.core.quant import PrequantParams, prequant_weight
from repro_torch.core.tree import (
    tree_leaves,
    tree_map,
    tree_unflatten,
    tree_unzip,
)
from repro_torch.models.mla import ABSORBED
from repro_torch.models.layers import (
    PDef,
    init_tree,
    quant_mask_tree,
    wrap_qt,
    wrap_qt_nojit,
)
from repro_torch.models.transformer import (
    ce_loss,
    forward,
    init_caches,
    model_defs,
)
from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_update,
    clip_by_global_norm,
    init_opt_state,
)
from repro_torch.optim.schedule import cosine_with_warmup


class TrainState(NamedTuple):
    params: Any               # f32 master weights (nested dict)
    opt: Any                  # OptState tree
    scale_s0: Any             # per-leaf predicted-scale base (f32)
    scale_t: Any              # per-leaf steps since refresh (int)
    comm_residual: Any        # fp8-allreduce error feedback: None here
    step: int


class TrainHParams(NamedTuple):
    peak_lr: float = 3e-4
    warmup_steps: int = 2000
    total_steps: int = 100_000
    grad_clip: float = 1.0
    aux_coef: float = 0.01    # weight of the MoE load-balance loss
    microbatches: int = 1     # gradient accumulation (activation memory)
    adamw: AdamWConfig = AdamWConfig()


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
    return tree_map(lambda w, nd: measured_scale(w, qcfg, nd), params,
                    _scale_dims(defs))


def predicted_scales(s0, t, lr, qcfg: QuantConfig):
    """Eq. (10) for every leaf: ``s0 + lr · t / FP8_MAX``."""
    return tree_map(lambda s, ts: predict(s, ts, lr, qcfg), s0, t)


def advance_scales(defs, s0, t, params, qcfg: QuantConfig):
    """One step forward for every leaf (``core.autoscale.advance``)."""
    out = tree_map(lambda s, ts, w, nd: advance(s, ts, w, qcfg, nd), s0, t,
                   params, _scale_dims(defs))
    return tree_unzip(out, 0), tree_unzip(out, 1)


def init_train_state(cfg, hp: TrainHParams, seed: int = 0, params=None,
                     device="cuda") -> TrainState:
    """Weights from ``seed`` (a torch Generator on ``device``) unless
    given, zero moments, measured scales."""
    defs = model_defs(cfg)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = init_tree(defs, gen, device)
    if cfg.quant.grad_comm_fp8:
        raise NotImplementedError(
            "fp8 gradient all-reduce: ROADMAP queue 1 item 13")
    return TrainState(params=params, opt=init_opt_state(params),
                      scale_s0=init_scales(defs, params, cfg.quant),
                      scale_t=tree_map(lambda w: 0, params),
                      comm_residual=None, step=0)


def _split(batch: dict, n: int, i: int) -> dict:
    return {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
            for k, v in batch.items()}


def model_input(cfg, batch: dict) -> torch.Tensor:
    """What ``forward`` takes from a batch: its ``embeds`` for an
    embeddings-input model that has them, else its ``tokens``."""
    if cfg.input_mode == "embeddings" and "embeds" in batch:
        return batch["embeds"]
    return batch["tokens"]


def make_train_step(cfg, hp: TrainHParams, mesh=None):
    """The train step ``(state, batch) -> (state, metrics)``: microbatch
    accumulation, global-norm clip, AdamW on the cosine schedule, and
    the scale states advanced.  ``batch`` holds ``tokens`` and
    ``labels`` (B, S) (and optionally ``mask``) on any device; an
    embeddings-input model's batch may hold ``embeds`` (B, S, d), which
    it takes in place of the tokens' embedding rows (the reference's
    frontend stub, ``launch.train.stub_embeds``)."""
    if mesh is not None:
        raise NotImplementedError("mesh training: ROADMAP queue 1 item 13")
    defs = model_defs(cfg)
    mask = quant_mask_tree(defs)
    qcfg = cfg.quant
    auto = qcfg.quantized and qcfg.weight_scaling == "auto"

    def train_step(state: TrainState, batch: dict):
        lr = cosine_with_warmup(state.step, peak_lr=hp.peak_lr,
                                warmup_steps=hp.warmup_steps,
                                total_steps=hp.total_steps)
        dev = state.params["embed"]["embedding"].device
        lr_dev = lr.to(dev)
        scales = (predicted_scales(state.scale_s0, state.scale_t, lr_dev,
                                   qcfg) if auto else None)
        params = tree_map(lambda w: w.detach().requires_grad_(True),
                          state.params)
        flat = tree_leaves(params)
        batch = {k: v.to(dev) for k, v in batch.items()}

        n_mb = max(hp.microbatches, 1)
        grads = None
        loss = torch.zeros((), device=dev)
        aux = torch.zeros((), device=dev)
        for i in range(n_mb):
            mb = _split(batch, n_mb, i) if n_mb > 1 else batch
            qp = (wrap_qt(params, scales, mask) if auto
                  else wrap_qt_nojit(params, mask))
            logits, _, a = forward(cfg, qcfg, qp, model_input(cfg, mb),
                                   mode="train")
            l = ce_loss(cfg, logits, mb["labels"], mb.get("mask"))
            del logits
            # an embeddings-input step leaves the embedding unused: its
            # gradient is zero, as the reference's
            g = torch.autograd.grad(l + hp.aux_coef * a, flat,
                                    materialize_grads=True)
            grads = list(g) if grads is None else \
                [a + b for a, b in zip(grads, g)]
            del g
            loss = loss + l.detach()
            aux = aux + a.detach()
        if n_mb > 1:
            grads = [g / n_mb for g in grads]
            loss, aux = loss / n_mb, aux / n_mb
        grads = tree_unflatten(state.params, grads)

        with torch.no_grad():
            # the step owns its gradients: clipped in place, each freed
            # once its leaf is updated
            del flat, params
            grads, gnorm = clip_by_global_norm(grads, hp.grad_clip)
            new_params, new_opt = adamw_update(hp.adamw, state.params,
                                               grads, state.opt,
                                               state.step, lr_dev)
            del grads
            if qcfg.quantized:
                new_s0, new_t = advance_scales(defs, state.scale_s0,
                                               state.scale_t, new_params,
                                               qcfg)
            else:
                new_s0, new_t = state.scale_s0, state.scale_t
        metrics = {"loss": loss, "aux": aux, "lr": lr, "grad_norm": gnorm}
        return TrainState(params=new_params, opt=new_opt, scale_s0=new_s0,
                          scale_t=new_t, comm_residual=None,
                          step=state.step + 1), metrics

    return train_step


def make_eval_step(cfg):
    defs = model_defs(cfg)
    mask = quant_mask_tree(defs)
    qcfg = cfg.quant

    @torch.no_grad()
    def eval_step(params, batch):
        dev = params["embed"]["embedding"].device
        qp = wrap_qt_nojit(params, mask)
        logits, _, _ = forward(cfg, qcfg, qp,
                               model_input(cfg, batch).to(dev), mode="train")
        m = batch.get("mask")
        return ce_loss(cfg, logits, batch["labels"].to(dev),
                       None if m is None else m.to(dev))

    return eval_step


def serve_weight_scales(cfg, params):
    """Build-time per-tensor weight scales (None unless the recipe is
    quantized with automatic scaling)."""
    if not (cfg.quant.quantized and cfg.quant.weight_scaling == "auto"):
        return None
    return init_scales(model_defs(cfg), params, cfg.quant)


def prequantize_params(cfg, params) -> PrequantParams | None:
    """Quantize every quantized linear weight to its fp8 payload once,
    per-(layer) slice scales, bitwise what the reference builds; never-
    quantized leaves keep their arrays (scale 1).  ``auto`` recipes
    (moss) quantize against the predicted scale; ``jit`` and
    ``delayed`` ones (the per_group and per_tensor baselines) against
    each slice's own amax, taken after any bf16 cast, as their in-step
    quantizer would.  An MLA attention node also gets the bf16 copies of
    ``w_uk`` and ``w_uv`` that its absorbed decode multiplies by
    (``models.mla.ABSORBED``; the reference multiplies by the fp8
    payloads there and drops their scales).  (The reference's transposed
    tied head ``embed/head_t`` comes with tied-embedding models.)"""
    qcfg = cfg.quant
    if not qcfg.quantized:
        return None
    defs = model_defs(cfg)
    sdims = _scale_dims(defs)
    mask = quant_mask_tree(defs)
    auto = qcfg.weight_scaling == "auto"
    pred = init_scales(defs, params, qcfg) if auto else None

    def leaf(w, nd, m, s):
        if not m:
            return w, torch.ones((), dtype=torch.float32, device=w.device)
        return prequant_weight(w, nd, qcfg.fwd_format,
                               scale=s if auto else None,
                               cast_bf16=qcfg.weight_cast_bf16)

    out = tree_map(leaf, params, sdims, mask, pred if auto else sdims)
    qweights, scales = tree_unzip(out, 0), tree_unzip(out, 1)
    for name, att in _mla_attention(params):
        # the MLA absorbed decode's operands: the raw weights in bf16,
        # what the in-graph path multiplies by (mla.ABSORBED)
        for src, dst in ABSORBED.items():
            qweights[name]["attn"][dst] = att[src].to(torch.bfloat16)
            scales[name]["attn"][dst] = torch.ones(
                (), dtype=torch.float32, device=att[src].device)
    if cfg.tie_embeddings:
        q, s = prequant_weight(params["embed"]["embedding"].T, 0,
                               qcfg.fwd_format, scale=None,
                               cast_bf16=qcfg.weight_cast_bf16)
        qweights["embed"]["head_t"] = q.contiguous()    # (d, vocab)
        scales["embed"]["head_t"] = s
    return PrequantParams(qweights=qweights, scales=scales)


def _mla_attention(tree):
    """(segment name, attention node) of every MLA segment of a
    params-shaped tree (its attention has ``w_uk``)."""
    for name, seg in tree.items():
        att = seg.get("attn") if isinstance(seg, dict) else None
        if att is not None and "w_uk" in att:
            yield name, att


def serve_quant_mask(cfg, tree=None):
    """The serving quantization mask: ``quant_mask_tree``, for an MLA
    model the bf16 copies that a pre-quantized tree carries for the
    absorbed decode (never quantized), and the transposed tied head
    ``embed/head_t`` (quantized) when ``tree`` (a serving params or
    scales tree) carries one."""
    mask = quant_mask_tree(model_defs(cfg))
    for _, att in _mla_attention(mask):
        att.update({dst: False for dst in ABSORBED.values()})
    if (isinstance(tree, dict) and isinstance(tree.get("embed"), dict)
            and "head_t" in tree["embed"]):
        mask["embed"]["head_t"] = True
    return mask


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


def _health_act(act_scales, quant_health: bool):
    """The quant-health tap, resolved at build: with the flag on and
    delayed activation scales present, each site's ``ActScale`` wrapped
    in a ``TaggedScale`` (``repro_torch.obs.quant_health``) and True;
    else ``act_scales`` untouched and False."""
    if quant_health and act_scales:
        from repro_torch.obs.quant_health import tag_act_scales

        return tag_act_scales(act_scales), True
    return act_scales, False


def _forward_health(health: bool, cfg, qcfg, qp, tokens, caches, mode):
    """``forward``, and with ``health`` in a quant-health capture
    window: (logits, caches, the per-site statistics tree or None)."""
    if not health:
        logits, caches, _ = forward(cfg, qcfg, qp, tokens, caches,
                                    mode=mode)
        return logits, caches, None
    from repro_torch.obs.quant_health import QH

    with QH.capture() as cap:
        logits, caches, _ = forward(cfg, qcfg, qp, tokens, caches,
                                    mode=mode)
    return logits, caches, cap.tree


def make_decode_step(cfg, scales=None, act_scales=None, rows: int = 0,
                     quant_health: bool = False):
    """The serving step: tokens (B, 1) decode one position per slot (an
    embeddings-input model also takes embeddings (B, 1, d));
    tokens (1, C) chunk-prefill C prompt tokens of one slot.  The same
    callable serves both shapes, as in the reference.  The caches' pool
    tensors are updated in place; the returned caches carry the advanced
    ``idx``.  On the card a step of at most ``rows`` rows computes each
    row in an order that its batch does not change
    (``core.row_order``).  ``quant_health=True`` (with delayed
    activation scales) returns the per-site quantization-health tree as
    a third output (``repro_torch.obs.quant_health``)."""
    mask = serve_quant_mask(cfg, scales)
    qcfg = cfg.quant
    act, health = _health_act(act_scales, quant_health)

    @torch.inference_mode()
    def decode_step(params, caches, tokens):
        qp = _wrap_serve(params, mask, scales, act)
        with row_order.rows(rows):
            logits, caches, tree = _forward_health(health, cfg, qcfg, qp,
                                                   tokens, caches, "decode")
        return (logits, caches, tree) if health else (logits, caches)

    return decode_step


def make_verify_step(cfg, scales=None, act_scales=None, rows: int = 0,
                     quant_health: bool = False):
    """The speculative verify step: tokens (B, k) = [last committed
    token, draft_1 .. draft_{k-1}] per slot.  All k positions are written
    to the cache and attended in one forward through the decode kernel's
    batched-query form; logits (B, k, V) come back for every position,
    position j's being what the j-th of k sequential decode steps would
    give (with the same weights and delayed activation scales).  The
    caches' ``idx`` advances by k; the caller truncates the depths of
    rejected drafts.  ``rows`` as in ``make_decode_step``, counting
    each slot's k positions; ``quant_health`` too."""
    mask = serve_quant_mask(cfg, scales)
    qcfg = cfg.quant
    act, health = _health_act(act_scales, quant_health)

    @torch.inference_mode()
    def verify_step(params, caches, tokens):
        qp = _wrap_serve(params, mask, scales, act)
        with row_order.rows(rows):
            logits, caches, tree = _forward_health(health, cfg, qcfg, qp,
                                                   tokens, caches, "verify")
        return (logits, caches, tree) if health else (logits, caches)

    return verify_step


def make_prefill_step(cfg, max_len: int, scales=None, act_scales=None,
                      quant_health: bool = False):
    """The whole-prompt prefill: tokens (B, S) from position 0 into fresh
    contiguous caches of ``cache_len(cfg, max_len)`` slots with a
    scalar ``idx`` (a prompt of S >= C keeps its last C positions, p in
    slot p % C).  Returns (logits (B, 1, V), caches), and with
    ``quant_health`` (as in ``make_decode_step``) the health tree third.

    The step's optional third argument ``last`` is the position whose
    logits come back (default the last): the engine right-pads prompts
    to a length bucket, and the causal last-token logits then sit at the
    true prompt length - 1."""
    mask = serve_quant_mask(cfg, scales)
    qcfg = cfg.quant
    act, health = _health_act(act_scales, quant_health)

    @torch.inference_mode()
    def prefill_step(params, tokens, last: int | None = None):
        qp = _wrap_serve(params, mask, scales, act)
        caches = init_caches(cfg, tokens.shape[0], max_len,
                             device=tokens.device)
        logits, caches, tree = _forward_health(health, cfg, qcfg, qp,
                                               tokens, caches, "prefill")
        pos = logits.shape[1] - 1 if last is None else last
        logits = logits[:, pos:pos + 1]
        return (logits, caches, tree) if health else (logits, caches)

    return prefill_step
