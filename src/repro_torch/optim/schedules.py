"""LR schedules: cosine (default) and WSD (warmup-stable-decay — MiniCPM,
arXiv:2404.06395 §4), both as count->lr callables for AdamW, as in
``repro/optim/schedules.py``. ``count`` is an int32 tensor; the schedule
is computed in fp32 from it in the reference's order of operations, so
each step's lr is the reference's."""
from __future__ import annotations

import math

import torch


def cosine(peak_lr: float, warmup_steps: int, total_steps: int,
           min_ratio: float = 0.1):
    def fn(count):
        c = count.float()
        warm = peak_lr * c / max(warmup_steps, 1)
        frac = torch.clamp((c - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(c < warmup_steps, warm, cos)
    return fn


def wsd(peak_lr: float, warmup_steps: int, stable_steps: int, decay_steps: int,
        min_ratio: float = 0.01):
    """Warmup-Stable-Decay: linear warmup, long flat stable phase, short
    exponential-ish (linear here) decay tail."""
    def fn(count):
        c = count.float()
        warm = peak_lr * c / max(warmup_steps, 1)
        stable = torch.tensor(peak_lr, dtype=torch.float32, device=c.device)
        dfrac = torch.clamp((c - warmup_steps - stable_steps)
                            / max(decay_steps, 1), 0.0, 1.0)
        decay = peak_lr * (1.0 - (1.0 - min_ratio) * dfrac)
        return torch.where(c < warmup_steps, warm,
                           torch.where(c < warmup_steps + stable_steps,
                                       stable, decay))
    return fn


def constant(lr: float):
    return lambda count: torch.tensor(lr, dtype=torch.float32,
                                      device=count.device)
