"""Learning-rate schedules (step -> lr), port of ``repro/optim/
schedule.py``. ``step`` is a 0-dim tensor or a number; the result is a
0-dim f32 tensor on ``step``'s device (the CPU for a number)."""
from __future__ import annotations

import math

import torch


def _f32(step):
    return torch.as_tensor(step, dtype=torch.float32)


def constant(lr: float):
    return lambda step: torch.full_like(_f32(step), lr)


def linear_warmup(base_lr: float, warmup_steps: int):
    def fn(step):
        s = _f32(step)
        return base_lr * torch.clamp((s + 1) / max(warmup_steps, 1), max=1.0)
    return fn


def cosine_schedule(base_lr: float, total_steps: int, *,
                    warmup_steps: int = 0, final_frac: float = 0.1):
    def fn(step):
        s = _f32(step)
        warm = (torch.clamp((s + 1) / max(warmup_steps, 1), max=1.0)
                if warmup_steps else torch.ones_like(s))
        t = torch.clamp((s - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi
                                                                   * t))
        return base_lr * warm * cos
    return fn
