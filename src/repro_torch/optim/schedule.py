"""Learning-rate schedules (pure functions of the step counter) — port of
``repro/optim/schedule.py``: the step is an int tensor, the result a 0-d
f32 tensor on its device, computed in f32 as the JAX functions compute
it."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    def fn(step):
        return torch.tensor(lr, dtype=torch.float32,
                            device=torch.as_tensor(step).device)
    return fn


def linear_warmup(lr: float, warmup_steps: int):
    def fn(step):
        frac = torch.clamp(_f32(step) / max(1, warmup_steps), max=1.0)
        return torch.tensor(lr, dtype=torch.float32,
                            device=frac.device) * frac
    return fn


def cosine_with_warmup(lr: float, warmup_steps: int, total_steps: int,
                       min_ratio: float = 0.1):
    def fn(step):
        s = _f32(step)
        warm = torch.clamp(s / max(1, warmup_steps), max=1.0)
        prog = torch.clamp((s - warmup_steps)
                           / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (
            1 + torch.cos(torch.tensor(math.pi, dtype=torch.float32,
                                       device=s.device) * prog))
        return torch.tensor(lr, dtype=torch.float32,
                            device=s.device) * warm * cos
    return fn
