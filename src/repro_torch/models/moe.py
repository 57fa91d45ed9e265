"""Token-choice top-k Mixture of Experts: the counterpart of
``repro.models.moe`` on one device.

Train path: sort-based dispatch (a stable argsort by expert id and the
capacity cut; never a (T, E, C) one-hot) into the flat ``(E·C, d)``
buffer, the experts, and the f32 combine.  moss and bf16 run the
experts through the grouped kernels (``core.linear.qlinear_grouped``:
3 launches and 3 amax reductions per block, where one GEMM per expert
would take 3·E and 3·E); the per_group and per_tensor baselines run
them one by one through ``qlinear``.  Small T (at most 4096 tokens with
``cfg.moe_decode_dense``) takes the masked dense-experts combine: every
expert on every token.

The router is f32 and unquantized.  Expert GEMMs are MOSS-quantized
with per-expert weight scales (the ``experts`` dim of the stacked
weights gets its own scale state).

Serving (the reference's contract): the decode and verify modes and
the calibration forward (``REC.recording``) always take the masked
dense combine, so that a token's routing and arithmetic do not depend
on the batch it rides in, and every expert is calibrated on every
calibration token.  There each expert's sites run with their own
weight scales and their own calibrated activation scales (``_experts``
slices the stacked ``ActScale``), and each expert's calibration
records under its (layer, expert) index (``REC.sub_index``).

Not ported yet, and refused with ``NotImplementedError``: expert
parallelism over a mesh (the reference's shard_map with two
``all_to_all``).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.core.formats import QuantConfig
from repro_torch.core.linear import QT, qlinear, qlinear_grouped
from .layers import PDef

DENSE_MAX_TOKENS = 4096     # the dense combine's limit under moe_decode_dense


def moe_defs(cfg):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": PDef((d, e), (None, None)),          # f32, not quantized
        "w_up": PDef((e, d, f), ("experts", "fsdp", "mlp"), quantized=True),
        "w_gate": PDef((e, d, f), ("experts", "fsdp", "mlp"),
                       quantized=True),
        "w_down": PDef((e, f, d), ("experts", "mlp", "fsdp"),
                       quantized=True),
    }


def _expert_ffn(cfg, w_up: QT, w_gate: QT, w_down: QT, x, qcfg):
    """One expert's gated FFN on its (C, d) token buffer."""
    up = qlinear(x, w_up, qcfg)
    gate = qlinear(x, w_gate, qcfg)
    h = F.silu(gate.to(torch.float32)).to(x.dtype) * up
    return qlinear(h, w_down, qcfg)


def _expert_act(a, e: int) -> list:
    """A site's activation-scale state for each of ``e`` experts: a
    calibrated ``ActScale`` stacked over the experts (``s`` (E,),
    ``sub`` (E, K/micro)) split per expert; a calibration tag or None
    as it is."""
    from repro_torch.core.actscale import ActScale

    if not isinstance(a, ActScale):
        return [a] * e
    subs = [None] * e if a.sub is None else list(a.sub.unbind(0))
    return [ActScale(s, sub) for s, sub in zip(a.s.unbind(0), subs)]


def _experts(wt: QT) -> list[QT]:
    """A stacked (E, ...) weight -> one QT per expert, each with its own
    weight scale and activation scales (split once with ``unbind``, so
    the backward stacks the expert gradients once)."""
    e = wt.w.shape[0]
    ss = [None] * e if wt.s is None else list(wt.s.unbind(0))
    return [QT(w, s, a) for w, s, a in zip(wt.w.unbind(0), ss,
                                           _expert_act(wt.a, e))]


def _experts_vmapped(cfg, p, xs, qcfg):
    """xs: (E, C, d) (or a list of E (C, d) buffers) -> (E, C, d), one
    expert at a time with its own scales (the reference's ``jax.vmap``
    over ``_expert_ffn``).  Under calibration each expert records under
    its (layer, expert) index."""
    from repro_torch.core.actscale import REC

    ups, gates, downs = (_experts(p[n]) for n in ("w_up", "w_gate",
                                                    "w_down"))
    ys = []
    for i, (u, g, dn, x) in enumerate(zip(ups, gates, downs, xs)):
        with REC.sub_index(i) if REC.recording else contextlib.nullcontext():
            ys.append(_expert_ffn(cfg, u, g, dn, x, qcfg))
    return torch.stack(ys)


def _experts_grouped(cfg, p, xs, sizes, qcfg):
    """All expert FFNs through the grouped kernels: xs (E, C, d)
    flattened to the sorted token buffer, one launch per GEMM."""
    e, c, d = xs.shape
    flat = xs.reshape(e * c, d)
    up = qlinear_grouped(flat, p["w_up"], sizes, c, qcfg)
    gate = qlinear_grouped(flat, p["w_gate"], sizes, c, qcfg)
    h = F.silu(gate.to(torch.float32)).to(flat.dtype) * up
    y = qlinear_grouped(h, p["w_down"], sizes, c, qcfg)
    return y.reshape(e, c, d)


def _expert_runner(cfg, p, qcfg):
    """fn(xs, sizes) -> ys: moss and bf16 through the grouped kernels
    (bf16 grouped computes the same dots over the same rows as one by
    one), the per-tensor and per-group baselines one expert at a time."""
    if qcfg.mode in ("moss", "bf16"):
        return lambda xs, sizes: _experts_grouped(cfg, p, xs, sizes, qcfg)
    return lambda xs, sizes: _experts_vmapped(cfg, p, xs, qcfg)


def router_probs(cfg, p, x_flat):
    """The f32 router: (logits, softmax probs)."""
    w = p["router"]
    w = w.w if isinstance(w, QT) else w
    logits = x_flat.to(torch.float32) @ w.to(torch.float32)
    return logits, torch.softmax(logits, dim=-1)


def top_k(probs, k: int):
    """(weights, ids) of the k largest probabilities per row, largest
    first and the lower expert id first among equals, as
    ``jax.lax.top_k`` (``torch.topk`` does not promise its tie order)."""
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[:, :k], ids[:, :k]


def route(cfg, p, x_flat):
    """Router -> (probs, normalized top-k weights, top-k ids)."""
    _, probs = router_probs(cfg, p, x_flat)
    top_w, top_ids = top_k(probs, cfg.top_k)
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    return probs, top_w, top_ids


def load_balance_loss(probs, ids, n_experts: int, top_k: int):
    """Switch-style aux loss: E · Σ_e f_e · P_e."""
    one_hot = F.one_hot(ids.long(), n_experts).to(torch.float32)  # (T,k,E)
    f = one_hot.sum(dim=(0, 1)) / (ids.shape[0] * top_k)
    pmean = probs.mean(dim=0)
    return n_experts * torch.sum(f * pmean)


def _capacity(cfg, t_local: int) -> int:
    c = int(t_local * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    return -(-c // 8) * 8                                # round up to 8


def dispatch_plan(ids, n_experts: int, capacity: int):
    """The sort-based dispatch of the (T, k) expert ids: ``order`` (the
    stable sort of the flat ids), ``dest`` (each sorted slot's row in
    the (E·C + 1)-row buffer, the last row the trash row of the tokens
    past their expert's capacity) and ``sizes`` (E,) int32, the
    per-expert row counts after the capacity cut."""
    flat_ids = ids.reshape(-1)                           # (T·k,)
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    experts = torch.arange(n_experts, device=ids.device,
                           dtype=sorted_ids.dtype)
    group_start = torch.searchsorted(sorted_ids, experts)
    group_end = torch.searchsorted(sorted_ids, experts, right=True)
    sizes = torch.clamp_max(group_end - group_start, capacity).to(
        torch.int32)
    pos = torch.arange(flat_ids.numel(), device=ids.device) - \
        group_start[sorted_ids]
    dest = torch.where(pos < capacity, sorted_ids * capacity + pos,
                       n_experts * capacity)
    return order, dest, sizes


def _dispatch_combine_local(cfg, x_loc, ids_loc, w_loc, expert_fn,
                            capacity: int):
    """Dispatch -> experts -> combine on one device."""
    t_loc, d = x_loc.shape
    k = ids_loc.shape[-1]
    e = cfg.n_experts
    order, dest, sizes = dispatch_plan(ids_loc, e, capacity)
    token_of = order // k
    # scatter tokens into (E, C, d); the dropped ones all land on the
    # trash row (duplicate indices), which nothing reads
    buf = torch.zeros((e * capacity + 1, d), dtype=x_loc.dtype,
                      device=x_loc.device)
    buf = buf.index_put((dest,), x_loc[token_of])
    xs = buf[:-1].reshape(e, capacity, d)
    ys = expert_fn(xs, sizes)                            # (E, C, d)
    ybuf = torch.cat([ys.reshape(e * capacity, d),
                      ys.new_zeros((1, d))], dim=0)
    gathered = ybuf[dest]                                # (T·k, d) sorted
    unsort = torch.argsort(order, stable=True)
    per_slot = gathered[unsort].reshape(t_loc, k, d)
    y = torch.einsum("tkd,tk->td", per_slot.to(torch.float32),
                     w_loc.to(torch.float32))
    return y.to(x_loc.dtype)


def _dense_moe(cfg, p, x_flat, top_w, top_ids, qcfg):
    """Masked dense-experts combine for small T: every expert on every
    token, each weighted by its routing weight (0 where unrouted)."""
    t, _ = x_flat.shape
    combine = torch.zeros((t, cfg.n_experts), dtype=torch.float32,
                          device=x_flat.device).scatter(
        1, top_ids.long(), top_w.to(torch.float32))
    ys = _experts_vmapped(cfg, p, [x_flat] * cfg.n_experts, qcfg)  # (E,T,d)
    y = torch.einsum("etd,te->td", ys.to(torch.float32), combine)
    return y.to(x_flat.dtype)


def _unsupported() -> str | None:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and \
            dist.get_world_size() > 1:
        return "MoE expert parallelism over a mesh: ROADMAP queue 1 item 13"
    return None


def moe_block(cfg, p, x, qcfg: QuantConfig, mode: str = "train"):
    """x: (B, S, d) -> (y, aux_loss)."""
    from repro_torch.core.actscale import REC

    bad = _unsupported()
    if bad:
        raise NotImplementedError(bad)
    b, s, d = x.shape
    x_flat = x.reshape(-1, d)
    t = x_flat.shape[0]
    probs, top_w, top_ids = route(cfg, p, x_flat)
    aux = load_balance_loss(probs, top_ids, cfg.n_experts, cfg.top_k)
    # decode, verify and calibration always take the dense combine
    # (the reference's moe_block): per-token routing independent of the
    # batch, and no expert left with an empty calibration buffer
    if mode in ("decode", "verify") or REC.recording or (
            cfg.moe_decode_dense and t <= DENSE_MAX_TOKENS):
        y = _dense_moe(cfg, p, x_flat, top_w, top_ids, qcfg)
        return y.reshape(b, s, d), aux
    cap = _capacity(cfg, t)
    fn = _expert_runner(cfg, p, qcfg)
    y = _dispatch_combine_local(cfg, x_flat, top_ids, top_w, fn, cap)
    return y.reshape(b, s, d), aux
