"""LR schedules (counterpart of ``deepspeed_tpu/runtime/lr_schedules.py``).

The same five schedules under the reference's config names, as functions
from step to lr. A schedule computes in fp32 with torch ops, as the JAX
one does with jnp ops: called with a Python int it gives a 0-d CPU tensor
(``float()`` it for the host); called with the engine's step counter, a
0-d tensor on the card, it gives the lr there without a host sync. The
engine exposes a ``.lr_scheduler`` shim with ``step()``/``get_last_lr()``
for API parity.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch

Schedule = Callable[[Any], torch.Tensor]

WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
WARMUP_COSINE_LR = "WarmupCosineLR"
ONE_CYCLE = "OneCycle"
LR_RANGE_TEST = "LRRangeTest"


def _steps(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 0.001,
              warmup_num_steps: int = 1000, warmup_type: str = "log",
              **_ignored) -> Schedule:
    """reference: lr_schedules.py WarmupLR (log or linear warmup, then flat)."""

    def sched(step):
        s = torch.clamp(_steps(step) + 1, max=warmup_num_steps)
        if warmup_type == "log":
            # lr scales with log(step)/log(warmup_steps), as the reference
            frac = torch.log(s) / math.log(max(warmup_num_steps, 2))
        else:
            frac = s / warmup_num_steps
        frac = torch.clamp(frac, 0.0, 1.0)
        return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * frac

    return sched


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 0.001, warmup_num_steps: int = 1000,
                    warmup_type: str = "log", **_ignored) -> Schedule:
    """Warmup then linear decay to zero (reference WarmupDecayLR)."""
    warm = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps,
                     warmup_type)

    def sched(step):
        step = _steps(step)
        decay = torch.clamp((total_num_steps - step)
                            / max(total_num_steps - warmup_num_steps, 1),
                            0.0, 1.0)
        return torch.where(step < warmup_num_steps, warm(step),
                           warmup_max_lr * decay)

    return sched


def warmup_cosine_lr(total_num_steps: int, warmup_min_ratio: float = 0.0,
                     warmup_num_steps: int = 1000,
                     cos_min_ratio: float = 0.0001,
                     warmup_max_lr: float = 0.001, **_ignored) -> Schedule:
    """reference WarmupCosineLR: ratios are relative to the optimizer lr;
    here warmup_max_lr is the peak."""

    def sched(step):
        step = _steps(step)
        warm_frac = warmup_min_ratio + (1 - warmup_min_ratio) * torch.clamp(
            (step + 1) / max(warmup_num_steps, 1), 0.0, 1.0)
        progress = torch.clamp((step - warmup_num_steps)
                               / max(total_num_steps - warmup_num_steps, 1),
                               0.0, 1.0)
        cos_frac = cos_min_ratio + (1 - cos_min_ratio) * 0.5 * (
            1 + torch.cos(math.pi * progress))
        frac = torch.where(step < warmup_num_steps, warm_frac, cos_frac)
        return warmup_max_lr * frac

    return sched


def one_cycle(cycle_min_lr: float, cycle_max_lr: float,
              cycle_first_step_size: int = 2000,
              cycle_second_step_size: int | None = None,
              decay_step_size: int = 0, decay_lr_rate: float = 0.0,
              **_ignored) -> Schedule:
    """reference OneCycle (lr triangle then optional decay); momentum
    cycling is owned by the optimizer, not modeled here."""
    second = cycle_second_step_size or cycle_first_step_size
    total = cycle_first_step_size + second

    def sched(step):
        step = _steps(step)
        up = step / max(cycle_first_step_size, 1)
        down = 1.0 - (step - cycle_first_step_size) / max(second, 1)
        in_cycle = torch.where(step < cycle_first_step_size, up,
                               torch.clamp(down, 0.0, 1.0))
        lr = cycle_min_lr + (cycle_max_lr - cycle_min_lr) * torch.clamp(
            in_cycle, 0.0, 1.0)
        if decay_step_size > 0:
            decay_steps = torch.clamp(step - total, min=0) / decay_step_size
            lr = torch.where(step > total,
                             cycle_min_lr / (1.0 + decay_steps
                                             * decay_lr_rate), lr)
        return lr

    return sched


def lr_range_test(lr_range_test_min_lr: float = 1e-3,
                  lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0,
                  lr_range_test_staircase: bool = False,
                  **_ignored) -> Schedule:

    def sched(step):
        interval = _steps(step) / lr_range_test_step_size
        if lr_range_test_staircase:
            interval = torch.floor(interval)
        return lr_range_test_min_lr * (1.0 + interval
                                       * lr_range_test_step_rate)

    return sched


SCHEDULES = {
    WARMUP_LR: warmup_lr,
    WARMUP_DECAY_LR: warmup_decay_lr,
    WARMUP_COSINE_LR: warmup_cosine_lr,
    ONE_CYCLE: one_cycle,
    LR_RANGE_TEST: lr_range_test,
}


def build_schedule(name: str | None, params: dict, base_lr: float) -> Schedule:
    if name is None:
        return lambda step: torch.full_like(_steps(step), base_lr)
    if name not in SCHEDULES:
        raise ValueError(f"unknown scheduler {name!r}; known: "
                         f"{sorted(SCHEDULES)}")
    params = dict(params)
    params.setdefault("warmup_max_lr", base_lr)
    return SCHEDULES[name](**params)


class LRSchedulerShim:
    """Object-style scheduler for API parity with torch schedulers."""

    def __init__(self, schedule: Schedule, engine):
        self._schedule = schedule
        self._engine = engine

    def step(self, *a, **k):
        pass  # the engine's train step evaluates the schedule itself

    def get_last_lr(self):
        return [float(self._schedule(self._engine.global_steps))]

    def state_dict(self):
        return {}

    def load_state_dict(self, sd):
        pass
