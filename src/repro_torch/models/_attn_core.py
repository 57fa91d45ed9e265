"""Chunked causal attention for train and prefill modes (counterpart of
``repro.models._attn_core``): the calibration forward's and the
whole-prompt prefill's attention, with the sliding-window term.
No TPU kernel sits behind it, so it is plain torch ops: query chunks
outside, KV chunks inside with an online softmax, so scores never
exceed (B, H, Cq, Ck)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.runtime_flags import einsum

NEG_INF = -1e30


def _window(cfg):
    """The number of keys a query sees ("swa", "local"), else None."""
    if cfg.attn_type in ("swa", "local"):
        return cfg.window
    return None


def chunked_attention(cfg, q, k, v, q_pos0: int = 0):
    """q: (B, S, H, Dh); k, v: (B, T, KV, Dh) -> (B, S, H, Dh)."""
    b, s, h, dh = q.shape
    dv = v.shape[-1]
    t = k.shape[1]
    kvh = k.shape[2]
    g = h // kvh
    window = _window(cfg)
    scale = dh ** -0.5
    dev = q.device

    cq = min(cfg.attn_chunk, s)
    ck = min(cfg.attn_chunk, t)
    nq, nk = -(-s // cq), -(-t // ck)
    q = F.pad(q, (0, 0, 0, 0, 0, nq * cq - s))
    k = F.pad(k, (0, 0, 0, 0, 0, nk * ck - t))
    v = F.pad(v, (0, 0, 0, 0, 0, nk * ck - t))
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    outs = []
    for i in range(nq):
        qi = q[:, i * cq:(i + 1) * cq]
        qpos = q_pos0 + torch.arange(i * cq, (i + 1) * cq, device=dev)
        m = torch.full((b, h, cq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, cq, dv), dtype=torch.float32, device=dev)
        for j in range(nk):
            kj = k[:, j * ck:(j + 1) * ck].repeat_interleave(g, dim=2)
            vj = v[:, j * ck:(j + 1) * ck].repeat_interleave(g, dim=2)
            kpos = torch.arange(j * ck, (j + 1) * ck, device=dev)
            scores = einsum("bqhd,bkhd->bhqk", qi, kj) * scale
            mask = qpos[:, None] >= kpos[None, :]
            if window is not None:
                mask &= (qpos[:, None] - kpos[None, :]) < window
            mask &= (kpos < t)[None, :]
            scores = torch.where(mask[None, None], scores, neg)
            m_new = torch.maximum(m, scores.amax(dim=-1))
            p = torch.exp(scores - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + einsum("bhqk,bkhd->bhqd", p, vj)
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.transpose(1, 2))                 # (B, Cq, H, Dv)
    out = torch.cat(outs, dim=1)
    return out[:, :s].to(q.dtype)
