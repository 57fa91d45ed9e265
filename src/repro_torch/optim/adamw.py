"""AdamW (paper Eq. 1): the counterpart of ``repro.optim.adamw``.

Plain tensor code over nested dicts of f32 master weights; the
reference has no kernel here.  The update has the reference's formula
and order; the moments and the new weights are new tensors (the caller
drops the old ones), and the gradients are the caller's to consume: the
clip scales them in place and the update frees each once it is used.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.tree import tree_leaves, tree_map


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
    bias corrections use step + 1).  The caller hands its gradients
    over: each leaf of the (dict) ``grads`` tree is set to None once its
    update is made, so that none is held longer than needed (a 256,000 x
    4096 f32 leaf is 4.2 GB)."""
    t = float(step + 1)
    # 1 - b^t in f32, as the reference computes it from an f32 step
    c1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32),
                         torch.tensor(t, dtype=torch.float32))
    c2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32),
                         torch.tensor(t, dtype=torch.float32))

    def upd(w, g, st):
        # mu = b1 mu + (1 - b1) g, nu = b2 nu + (1 - b2) g^2, delta =
        # (mu / c1) / (sqrt(nu / c2) + eps), w - lr (delta + wd w): the
        # same operations in the same order, with at most three
        # temporaries of the leaf's size alive at once
        dev = w.device
        b1, b2 = _f32(cfg.b1, dev), _f32(cfg.b2, dev)
        g = g.to(torch.float32)
        mu = b1 * st.mu
        t = (1.0 - b1) * g
        mu.add_(t)
        nu = b2 * st.nu
        t = torch.square(g)
        t.mul_(1.0 - b2)
        nu.add_(t)
        del t
        den = nu / c2.to(dev)
        den.sqrt_()
        den.add_(_f32(cfg.eps, dev))
        delta = mu / c1.to(dev)
        delta.div_(den)
        del den
        w32 = w.to(torch.float32)
        delta.add_(_f32(cfg.weight_decay, dev) * w32)
        delta.mul_(_f32(lr, dev))
        w_new = w32 - delta
        return w_new.to(w.dtype), OptState(mu=mu, nu=nu)

    def walk(p, g, st):
        new_p, new_st = {}, {}
        for k in p:
            if isinstance(p[k], dict):
                new_p[k], new_st[k] = walk(p[k], g[k], st[k])
            else:
                new_p[k], new_st[k] = upd(p[k], g[k], st[k])
                g[k] = None
        return new_p, new_st

    return walk(params, grads, state)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to at most ``max_norm`` in global L2 norm, the norm).
    The f32 leaves are scaled where they are (the reference's product)
    and the same tree comes back."""
    norm = global_norm(grads)
    factor = torch.clamp_max(
        _f32(max_norm, norm.device) / torch.clamp_min(norm, 1e-9), 1.0)
    for g in tree_leaves(grads):
        g.mul_(factor)
    return grads, norm
