"""Carry the reference's weights, calibrated scales and train state into
the port, and the port's train state back out.

Everything crosses as numpy arrays, so this module needs neither JAX
nor ``repro``: a caller turns the reference's tree into numpy first
(``jax.tree.map(np.asarray, tree)``) and hands it over.  bf16 crosses
as a ``uint16`` view and fp8 as a ``uint8`` view, so every bit
survives.  Tensors land on the card unless the caller names another
device, like the port's other entry points."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.actscale import ActScale
from repro_torch.core.tree import tree_map

_VIEWS = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}


def to_torch(x, device="cuda") -> torch.Tensor:
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


def tree_to_torch(tree, device="cuda"):
    """Nested dicts of numpy arrays -> the same tree of tensors."""
    return tree_map(lambda x: to_torch(x, device), tree)


def act_scales_to_torch(act: dict, device="cuda") -> dict:
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


def train_state_to_torch(ref, device="cuda"):
    """The reference's ``TrainState`` with numpy leaves (params, the
    ``OptState(mu, nu)`` tree, ``scale_s0``, ``scale_t``, ``step``) ->
    the port's ``TrainState`` on ``device``."""
    from repro_torch.optim.adamw import OptState
    from repro_torch.train.steps import TrainState

    if ref.comm_residual is not None:
        raise NotImplementedError(
            "fp8 all-reduce residuals: ROADMAP queue 1 item 13")
    return TrainState(
        params=tree_to_torch(ref.params, device),
        opt=tree_map(lambda st: OptState(to_torch(st[0], device),
                                         to_torch(st[1], device)),
                     ref.opt),
        scale_s0=tree_to_torch(ref.scale_s0, device),
        scale_t=tree_map(int, ref.scale_t),
        comm_residual=None, step=int(ref.step))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """An f32 or integer tensor -> numpy (same values, on the host)."""
    return t.detach().cpu().numpy()


def train_state_to_numpy(state):
    """The port's ``TrainState`` with numpy leaves (``scale_t`` as
    int32, ``step`` as an int), for comparison with the reference's."""
    from repro_torch.optim.adamw import OptState

    return state._replace(
        params=tree_map(to_numpy, state.params),
        opt=tree_map(lambda st: OptState(to_numpy(st.mu), to_numpy(st.nu)),
                     state.opt),
        scale_s0=tree_map(to_numpy, state.scale_s0),
        scale_t=tree_map(np.int32, state.scale_t))
