"""LR schedules, in float32 as the JAX package's."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then a cosine decay to
    ``min_ratio * peak_lr`` at ``total_steps``; a float32 scalar."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = peak_lr * step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio)
                     * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup_steps, warm, cos)


def constant(step, *, peak_lr: float, **_) -> torch.Tensor:
    return torch.full_like(torch.as_tensor(step, dtype=torch.float32),
                           peak_lr)
