"""Learning-rate schedules: pure functions of the step, in fp32 as the
reference computes them (counterpart of ``repro/optim/schedule.py``).
``step`` is a host int or a 0-d tensor; the result is a 0-d fp32 tensor
on the step's device (the CPU for a host int), so a training loop that
keeps its step counter on the card never reads it back."""

from __future__ import annotations

import math

import torch


def _as_f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def linear_warmup_cosine(step, *, peak_lr: float, warmup: int = 100,
                         total: int = 10_000,
                         floor: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    decay to ``floor * peak_lr`` at ``total``."""
    stepf = _as_f32(step)
    warm = stepf / max(warmup, 1)
    frac = torch.clamp((stepf - warmup) / max(total - warmup, 1), 0, 1)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
    return peak_lr * torch.where(stepf < warmup, warm, cos)


def constant(step, *, peak_lr: float, **_) -> torch.Tensor:
    return torch.full((), peak_lr, dtype=torch.float32,
                      device=_as_f32(step).device)
