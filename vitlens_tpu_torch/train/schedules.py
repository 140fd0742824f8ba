"""LR schedules (port of vitlens_tpu/train/schedules.py; reference
training/scheduler.py:13-64): step-wise cosine, const and const with
cooldown, each with the linear warmup base_lr * (step + 1) / warmup. Each
schedule is a plain function of the step index returning a Python float.
"""

from __future__ import annotations

import math


def warmup_lr(base_lr: float, step, warmup: int) -> float:
    return base_lr * (step + 1) / max(warmup, 1)


def cosine_lr(base_lr: float, warmup: int, total_steps: int):
    def schedule(step) -> float:
        if step < warmup:
            return warmup_lr(base_lr, step, warmup)
        e = step - warmup
        es = max(total_steps - warmup, 1)
        return 0.5 * (1 + math.cos(math.pi * e / es)) * base_lr

    return schedule


def const_lr(base_lr: float, warmup: int):
    def schedule(step) -> float:
        return warmup_lr(base_lr, step, warmup) if step < warmup else base_lr

    return schedule


def const_lr_cooldown(base_lr: float, warmup: int, total_steps: int,
                      cooldown_steps: int, cooldown_power: float = 1.0,
                      cooldown_end_lr: float = 0.0):
    def schedule(step) -> float:
        if step < warmup:
            return warmup_lr(base_lr, step, warmup)
        start_cooldown = total_steps - cooldown_steps
        if step < start_cooldown:
            return base_lr
        decay = (1 - (step - start_cooldown) / cooldown_steps) ** cooldown_power
        return decay * (base_lr - cooldown_end_lr) + cooldown_end_lr

    return schedule


def get_schedule(name: str, base_lr: float, warmup: int, total_steps: int,
                 cooldown_steps: int = 0, cooldown_power: float = 1.0,
                 cooldown_end_lr: float = 0.0):
    if name in ("cosine", "cosine_lr"):
        return cosine_lr(base_lr, warmup, total_steps)
    if name in ("const", "const_lr"):
        return const_lr(base_lr, warmup)
    if name in ("const-cooldown", "const_lr_cooldown"):
        return const_lr_cooldown(base_lr, warmup, total_steps, cooldown_steps,
                                 cooldown_power, cooldown_end_lr)
    raise ValueError(name)
