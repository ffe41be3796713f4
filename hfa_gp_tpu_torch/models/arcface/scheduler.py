"""PolyScheduler: poly(2) decay with linear warmup (port of
hfa_gp_tpu/models/arcface/scheduler.py), a plain function of the step:
  warmup:  lr * step / warmup_steps        (linear)
  decay:   lr * (1 - (step-warmup)/(total-warmup)) ** 2
"""

from __future__ import annotations

from typing import Callable


def poly_scheduler(base_lr: float, total_steps: int, warmup_steps: int,
                   power: float = 2.0) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        step = float(step)
        if step < warmup_steps:
            return base_lr * step / max(warmup_steps, 1)
        frac = 1.0 - (step - warmup_steps) / max(
            total_steps - warmup_steps, 1)
        return base_lr * min(max(frac, 0.0), 1.0) ** power

    return schedule
