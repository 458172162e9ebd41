"""Learning-rate schedules (functions of the step).

Counterpart of ``repro/optim/schedules.py``.  The step is the optimizer
state's 0-d int32 tensor and each schedule returns a 0-d float32 tensor on
its device, computed with float32 tensor ops in the reference's order, so a
train step never reads the step on the host.
"""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def linear_warmup_cosine(lr: float, warmup: int, total: int,
                         final_frac: float = 0.1):
    def fn(step):
        step = step.to(torch.float32)
        warm = lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = lr * (final_frac + (1 - final_frac)
                    * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return fn


def inverse_sqrt(lr: float, warmup: int):
    def fn(step):
        step = torch.clamp(step.to(torch.float32), min=1.0)
        return lr * torch.minimum(step / max(warmup, 1),
                                  torch.sqrt(warmup / step))
    return fn
