"""AdamW (paper Eq. 1): the counterpart of ``repro.optim.adamw``.

Plain tensor code over nested dicts of f32 master weights; the
reference has no kernel here.  The update has the reference's formula
and order; the moments and the new weights are new tensors (the caller
drops the old ones).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.tree import tree_leaves, tree_map, tree_unzip


class OptState(NamedTuple):
    mu: torch.Tensor
    nu: torch.Tensor


class AdamWConfig(NamedTuple):
    b1: float = 0.9
    b2: float = 0.95          # paper: LLM-typical beta2
    eps: float = 1e-8
    weight_decay: float = 0.1


def init_opt_state(params):
    return tree_map(lambda w: OptState(
        mu=torch.zeros_like(w, dtype=torch.float32),
        nu=torch.zeros_like(w, dtype=torch.float32)), params)


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def adamw_update(cfg: AdamWConfig, params, grads, state, step: int, lr):
    """Returns (new_params, new_state).  ``step`` is 0-based (the
    bias corrections use step + 1)."""
    t = float(step + 1)
    # 1 - b^t in f32, as the reference computes it from an f32 step
    c1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32),
                         torch.tensor(t, dtype=torch.float32))
    c2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32),
                         torch.tensor(t, dtype=torch.float32))

    def upd(w, g, st):
        dev = w.device
        b1, b2 = _f32(cfg.b1, dev), _f32(cfg.b2, dev)
        g = g.to(torch.float32)
        mu = b1 * st.mu + (1.0 - b1) * g
        nu = b2 * st.nu + (1.0 - b2) * torch.square(g)
        mhat = mu / c1.to(dev)
        vhat = nu / c2.to(dev)
        delta = mhat / (torch.sqrt(vhat) + _f32(cfg.eps, dev))
        w32 = w.to(torch.float32)
        lr_t = _f32(lr, dev)
        w_new = w32 - lr_t * (delta + _f32(cfg.weight_decay, dev) * w32)
        return w_new.to(w.dtype), OptState(mu=mu, nu=nu)

    out = tree_map(upd, params, grads, state)
    return tree_unzip(out, 0), tree_unzip(out, 1)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    factor = torch.clamp_max(
        _f32(max_norm, norm.device) / torch.clamp_min(norm, 1e-9), 1.0)
    return tree_map(lambda g: (g.to(torch.float32) * factor).to(g.dtype),
                grads), norm
