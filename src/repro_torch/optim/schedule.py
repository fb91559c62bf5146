"""LR schedules (pure functions of the step counter), in f32 as the
reference computes them."""
from __future__ import annotations

import math

import torch


def cosine_warmup(step, *, warmup: int, total: int, floor: float = 0.1) -> torch.Tensor:
    """Linear warm-up over ``warmup`` steps, then a cosine from 1 down to
    ``floor`` at ``total``. ``step`` is an int or a tensor (kept on its
    device); the result is an f32 scalar tensor."""
    s = (step if isinstance(step, torch.Tensor) else torch.tensor(step)).to(torch.float32)
    warm = torch.clamp(s / max(warmup, 1), max=1.0)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
