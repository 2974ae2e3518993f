"""LR schedules as step -> lr functions (counterpart of
medical_tri_modal_pilot_tpu/train/schedule.py, which computes in jnp
float32; this one computes in numpy float32 with the same formulas).

``cosine_annealing_warmup_restarts`` mirrors the reference scheduler
(the reference's cosine_annealing_with_warmup_v2.py:56-92, called with
epoch=iteration so the closed-form branch of step() applies): linear warmup
from min_lr to max_lr*gamma^cycle, then cosine to min_lr, cycles growing by
cycle_mult.

``cosine_warmup_single`` is the OneCycle-style single-cycle variant
(cosine_annealing_with_warmupSingle.py): linear ramp for warmup then a
single cosine decay over the remaining steps.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np

f32 = np.float32


def cosine_annealing_warmup_restarts(first_cycle_steps: int,
                                     max_lr: float,
                                     min_lr: float = 1e-6,
                                     warmup_steps: int = 0,
                                     gamma: float = 1.0,
                                     cycle_mult: float = 1.0
                                     ) -> Callable[[int], float]:
    """Returns f(step) -> lr (the reference steps the scheduler with the
    1-based iteration count, 2_train.py:190)."""
    if warmup_steps >= first_cycle_steps:
        raise ValueError("warmup_steps must be below first_cycle_steps")

    def schedule(step) -> float:
        step = f32(step)
        if cycle_mult == 1.0:
            cycle = np.floor(step / f32(first_cycle_steps))
            step_in_cycle = step - cycle * f32(first_cycle_steps)
            cur_cycle_steps = f32(first_cycle_steps)
        else:
            ratio = (step / f32(first_cycle_steps) * f32(cycle_mult - 1.0)
                     + f32(1.0))
            cycle = np.floor(np.log(np.maximum(ratio, f32(1.0)))
                             / f32(math.log(cycle_mult)))
            start = (f32(first_cycle_steps)
                     * (f32(cycle_mult) ** cycle - f32(1.0))
                     / f32(cycle_mult - 1.0))
            step_in_cycle = step - np.floor(start)
            cur_cycle_steps = f32(first_cycle_steps) * f32(cycle_mult) ** cycle
        cur_max_lr = f32(max_lr) * f32(gamma) ** cycle
        if warmup_steps > 0:
            warm = ((cur_max_lr - f32(min_lr)) * step_in_cycle
                    / f32(warmup_steps) + f32(min_lr))
        else:
            warm = cur_max_lr
        denom = np.maximum(cur_cycle_steps - f32(warmup_steps), f32(1.0))
        cos = f32(min_lr) + (cur_max_lr - f32(min_lr)) * (
            f32(1.0) + np.cos(f32(np.pi) * (step_in_cycle - f32(warmup_steps))
                              / denom)) / f32(2.0)
        return float(warm if step_in_cycle < warmup_steps else cos)

    return schedule


def cosine_warmup_single(total_steps: int, max_lr: float,
                         min_lr: float = 1e-6, warmup_steps: int = 0
                         ) -> Callable[[int], float]:
    def schedule(step) -> float:
        step = f32(step)
        warm = f32(max_lr) * step / f32(max(warmup_steps, 1))
        denom = f32(max(total_steps - warmup_steps, 1))
        cos = f32(min_lr) + (f32(max_lr) - f32(min_lr)) * (
            f32(1.0) + np.cos(f32(np.pi) * (step - f32(warmup_steps))
                              / denom)) / f32(2.0)
        return float(warm if step < warmup_steps else cos)

    return schedule
