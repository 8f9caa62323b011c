"""LR schedules: linear warmup → cosine decay (the usual pretraining shape).

Each schedule maps a step (a tensor, as the optimizer's count is, or a
number) to a float32 0-d tensor on the step's device, computed in float32
as the reference computes it.
"""
from __future__ import annotations

import math

import torch


def warmup_cosine(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    def sched(step):
        step = torch.as_tensor(step).float()
        warm = peak_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)

    return sched


def constant(lr: float):
    def sched(step):
        return torch.full((), lr, dtype=torch.float32, device=torch.as_tensor(step).device)

    return sched
