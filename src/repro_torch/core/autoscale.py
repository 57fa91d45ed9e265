"""MOSS automatic scaling for weight tensors (paper §3.2): the
counterpart of ``repro.core.autoscale``.

AdamW moves a weight by at most the step size per step (paper Thm 2),
so ``max|W_t| <= max|W_0| + η·t`` and the per-tensor fp8 scale can be
predicted instead of measured:

    s_t = s_0 + η · (t - t_refresh) / FP8_MAX            (paper Eq. 10)

A real max-reduction runs only every ``rescale_interval`` steps.  The
reference's ``lax.cond`` refresh is a host branch on the step count
here: ``steps_since`` is a Python int, so the untaken branch reads no
weight bytes.  ``jit`` and ``delayed`` scaling refresh every step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .formats import TINY, QuantConfig, div_c, fp8_max


class ScaleState(NamedTuple):
    """Automatic-scaling state for one weight tensor."""

    s0: torch.Tensor         # f32 scale measured at the last refresh
    steps_since: int         # steps since the last refresh


def measured_scale(w: torch.Tensor, cfg: QuantConfig,
                   n_stacked: int = 0) -> torch.Tensor:
    """``max(amax, TINY) / FP8_MAX`` over the dims after the first
    ``n_stacked`` (one scale per stacked slice)."""
    axes = tuple(range(n_stacked, w.dim()))
    wf = w.detach().to(torch.float32).abs()
    amax = wf.amax(dim=axes) if axes else wf
    return div_c(torch.clamp_min(amax, TINY), fp8_max(cfg.fwd_format))


def init_scale_state(w: torch.Tensor, cfg: QuantConfig) -> ScaleState:
    """s_0 from a real max-reduction at initialization."""
    return ScaleState(s0=measured_scale(w, cfg), steps_since=0)


def predict(s0: torch.Tensor, steps_since: int, lr,
            cfg: QuantConfig) -> torch.Tensor:
    """Paper Eq. (10): s_t = s_0 + η·t / FP8_MAX (t counted since the
    refresh), in the reference's f32 order: ``s0 + lr·t / FP8_MAX``."""
    lr = torch.as_tensor(lr, dtype=torch.float32, device=s0.device)
    t = torch.tensor(float(steps_since), dtype=torch.float32,
                     device=s0.device)
    return s0 + div_c(lr * t, fp8_max(cfg.fwd_format))


def advance(s0: torch.Tensor, steps_since: int, w: torch.Tensor,
            cfg: QuantConfig, n_stacked: int = 0
            ) -> tuple[torch.Tensor, int]:
    """One step forward: every ``rescale_interval`` steps (every step
    under jit and delayed scaling) measure, else count the step.  The
    train step's ``advance_scales`` maps this over its leaves."""
    if (cfg.weight_scaling in ("jit", "delayed")
            or steps_since + 1 >= cfg.rescale_interval):
        return measured_scale(w, cfg, n_stacked), 0
    return s0, steps_since + 1


def predicted_scale(state: ScaleState, lr, cfg: QuantConfig
                    ) -> torch.Tensor:
    return predict(state.s0, state.steps_since, lr, cfg)


def update_scale_state(state: ScaleState, w: torch.Tensor,
                       cfg: QuantConfig) -> ScaleState:
    return ScaleState(*advance(state.s0, state.steps_since, w, cfg))
