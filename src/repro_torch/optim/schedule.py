"""LR schedules (paper §4.1: cosine decay to 10% of peak after a linear
warmup): the counterpart of ``repro.optim.schedule``.  The value is an
f32 tensor on the CPU, computed in the reference's order so the two
agree bit for bit."""

from __future__ import annotations

import math

import torch


def cosine_with_warmup(step, *, peak_lr: float, warmup_steps: int,
                       total_steps: int, final_frac: float = 0.1
                       ) -> torch.Tensor:
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = peak_lr * step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    floor = peak_lr * final_frac
    cos = floor + 0.5 * (peak_lr - floor) * (1.0 + torch.cos(math.pi * prog))
    return torch.where(step < warmup_steps, warm, cos)


def constant_lr(step, *, peak_lr: float, **_) -> torch.Tensor:
    return torch.full_like(torch.as_tensor(step, dtype=torch.float32),
                           peak_lr)
