"""Learning-rate schedule.

Counterpart of gpt2_vision_language_tpu/train/schedule.py: cosine decay with
linear warmup, the reference's get_lr (train_gpt2.py:277-285), computed on
the host as the reference does. Warmup is (step + 1) / warmup * max_lr;
past max_steps the schedule floors at min_lr.
"""

from __future__ import annotations

import math

from ..core.config import ScheduleConfig


def cosine_warmup_lr(step: int, cfg: ScheduleConfig) -> float:
    step = float(step)
    if step < cfg.warmup_steps:
        return cfg.max_lr * (step + 1.0) / cfg.warmup_steps
    if step > cfg.max_steps:
        return cfg.min_lr
    ratio = (step - cfg.warmup_steps) / (cfg.max_steps - cfg.warmup_steps)
    ratio = min(max(ratio, 0.0), 1.0)
    coeff = 0.5 * (1.0 + math.cos(math.pi * ratio))
    return cfg.min_lr + coeff * (cfg.max_lr - cfg.min_lr)
