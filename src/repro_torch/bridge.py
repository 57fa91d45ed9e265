"""Carry the reference's weights and calibrated scales into the port.

Everything crosses as numpy arrays, so this module needs neither JAX
nor ``repro``: a caller turns the reference's tree into numpy first
(``jax.tree.map(np.asarray, tree)``) and hands it over.  bf16 crosses
as a ``uint16`` view and fp8 as a ``uint8`` view, so every bit
survives."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.actscale import ActScale

_VIEWS = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}


def to_torch(x, device="cpu") -> torch.Tensor:
    """One numpy array (any of f32, int, bf16, fp8) -> a torch tensor
    with the same bits."""
    a = np.array(x, copy=True, order="C")      # writable, owned
    view = _VIEWS.get(a.dtype.name)
    if view is None:
        return torch.from_numpy(a).to(device)
    raw, dtype = view
    t = torch.from_numpy(a.view(raw))
    if raw is np.uint16:
        t = t.view(torch.int16)
    return t.view(dtype).to(device)


def tree_to_torch(tree, device="cpu"):
    """Nested dicts of numpy arrays -> the same tree of tensors."""
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device) for k, v in tree.items()}
    return to_torch(tree, device)


def act_scales_to_torch(act: dict, device="cpu") -> dict:
    """{site tag: (s, sub)} numpy pairs (the reference's ActScales,
    turned to numpy) -> {site tag: ActScale}."""
    return {tag: ActScale(s=to_torch(s, device),
                          sub=None if sub is None else to_torch(sub, device))
            for tag, (s, sub) in act.items()}


def bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's raw bits as a numpy integer array (for bitwise
    comparison with ``np.asarray(ref).view(np.uint8|np.uint16|...)``)."""
    t = t.detach().cpu().contiguous()
    width = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()]
    return t.view(width).numpy()
