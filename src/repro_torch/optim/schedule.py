"""Learning-rate schedules (warmup + cosine/linear decay) — port of
`repro/optim/schedule.py`. The step count lives on the host, so these are
plain Python functions of an int."""
from __future__ import annotations

import math


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    final_frac: float = 0.1):
    def lr(step: int) -> float:
        if step < warmup:
            return peak_lr * step / max(warmup, 1)
        t = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return peak_lr * (final_frac + (1 - final_frac) * 0.5
                          * (1 + math.cos(math.pi * t)))

    return lr


def linear_schedule(peak_lr: float, warmup: int, total: int,
                    final_frac: float = 0.0):
    def lr(step: int) -> float:
        if step < warmup:
            return peak_lr * step / max(warmup, 1)
        t = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return peak_lr * (1 - (1 - final_frac) * t)

    return lr


def make_schedule(name: str, peak_lr: float, warmup: int, total: int):
    if name == "cosine":
        return cosine_schedule(peak_lr, warmup, total)
    if name == "linear":
        return linear_schedule(peak_lr, warmup, total)
    if name == "constant":
        return lambda step: float(peak_lr)
    raise ValueError(f"unknown schedule {name}")
