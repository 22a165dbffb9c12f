"""Learning-rate schedules (paper Appendix C: cosine + 10% linear warmup).

As in ``repro.core.schedules``, in f32: each schedule maps a 0-d int32
step tensor to a 0-d f32 tensor on the step's device, with device ops
only (no host synchronisation inside a training step).
"""
from __future__ import annotations

import math

import torch

from .types import Schedule


def constant(lr: float) -> Schedule:
    def f(step):
        step = torch.as_tensor(step)
        return torch.full((), lr, dtype=torch.float32, device=step.device)
    return f


def linear_warmup_cosine(
    peak_lr: float,
    total_steps: int,
    warmup_frac: float = 0.1,
    final_frac: float = 0.1,
) -> Schedule:
    warmup_steps = max(1, int(total_steps * warmup_frac))
    decay_steps = max(1, total_steps - warmup_steps)

    def f(step):
        step = torch.as_tensor(step).to(torch.float32)
        # divisors as tensors: torch divides by a Python number as a
        # multiplication by its reciprocal on the card; JAX divides
        warm = peak_lr * step / torch.full_like(step, warmup_steps)
        progress = torch.clamp((step - warmup_steps)
                               / torch.full_like(step, decay_steps), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5
                         * (1 + torch.cos(math.pi * progress)))
        return torch.where(step < warmup_steps, warm, cos)

    return f
