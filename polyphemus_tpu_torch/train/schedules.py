"""LR and KL-beta schedules, functions of the count of completed optimizer
updates.

Counterpart of `polyphemus_tpu/train/schedules.py`, in plain Python floats.
The reference's documented bugs are fixed by default and reproduced by the
config flags: `ramp_warmup=False` holds the LR at its peak during warmup
(the reference never ramps), and `ref_parity=True` makes beta 0 (the
reference trainer never applies its beta schedule).
"""
from __future__ import annotations

import math

from ..config import BetaSchedulerConfig, LRSchedulerConfig


def lr_schedule(cfg: LRSchedulerConfig, step: int) -> float:
    """LR after `step` completed updates: the peak through warmup (or a
    linear ramp to it), then exponential decay to final_lr_scale * peak
    over decay_steps."""
    decay_factor = -math.log(cfg.final_lr_scale) / cfg.decay_steps
    if step <= cfg.warmup_steps:
        if cfg.ramp_warmup:
            return cfg.peak_lr * step / max(cfg.warmup_steps, 1)
        return cfg.peak_lr
    return cfg.peak_lr * math.exp(-decay_factor * (step - cfg.warmup_steps))


def beta_schedule(cfg: BetaSchedulerConfig, step: int, *,
                  ref_parity: bool = False) -> float:
    """KL weight after `step` completed updates: 0 before anneal_start,
    then step_size per increment up to beta_max."""
    if ref_parity or step < cfg.anneal_start:
        return 0.0
    n_steps = max(int(cfg.beta_max // cfg.step_size), 1)
    inc_every = max((cfg.anneal_end - cfg.anneal_start) // n_steps, 1)
    cur = (step - cfg.anneal_start) // inc_every
    return min(max(cfg.step_size * (cur + 1), 0.0), cfg.beta_max)
