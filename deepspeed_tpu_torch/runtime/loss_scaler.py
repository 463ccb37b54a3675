"""Dynamic loss scaling for fp16 (counterpart of
``deepspeed_tpu/runtime/loss_scaler.py``; reference:
runtime/fp16/loss_scaler.py).

The state is three 0-d tensors on the engine's device, updated with tensor
ops, so the step never reads them on the host. Semantics match the
reference: on overflow, consume hysteresis, then halve the scale and skip
the step; after ``scale_window`` consecutive good steps, double it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LossScaleState(NamedTuple):
    scale: torch.Tensor        # f32 scalar
    good_steps: torch.Tensor   # i32 scalar
    hysteresis: torch.Tensor   # i32 scalar


def init_loss_scale(config, device=None) -> LossScaleState:
    """config: runtime.config.FP16Config. Static scale (loss_scale>0) is
    modeled as dynamic with an infinite window and no growth/backoff."""
    if not config.enabled:
        scale = 1.0
    elif config.loss_scale > 0:
        scale = config.loss_scale
    else:
        scale = 2.0 ** config.initial_scale_power
    return LossScaleState(
        scale=torch.tensor(scale, dtype=torch.float32, device=device),
        good_steps=torch.tensor(0, dtype=torch.int32, device=device),
        hysteresis=torch.tensor(config.hysteresis, dtype=torch.int32,
                                device=device))


def grads_finite(grads) -> torch.Tensor:
    """The overflow bit: all gradients finite (reference:
    stage_1_and_2.py:1997 CheckOverflow), a 0-d bool tensor."""
    flags = [torch.isfinite(g).all() for g in grads]
    return torch.stack(flags).all()


def update_loss_scale(state: LossScaleState, overflow: torch.Tensor, *,
                      dynamic: bool, scale_window: int, min_scale: float,
                      hysteresis: int) -> LossScaleState:
    if not dynamic:
        return state
    # overflow path: consume hysteresis; halve once it is exhausted
    hyst_left = torch.where(overflow, state.hysteresis - 1, state.hysteresis)
    backoff = overflow & (hyst_left <= 0)
    new_scale = torch.where(
        backoff, torch.clamp(state.scale / 2.0, min=min_scale), state.scale)
    new_hyst = torch.where(backoff, torch.full_like(hyst_left, hysteresis),
                           torch.clamp(hyst_left, min=1))
    # growth path
    good = torch.where(overflow, torch.zeros_like(state.good_steps),
                       state.good_steps + 1)
    grow = good >= scale_window
    new_scale = torch.where(grow, new_scale * 2.0, new_scale)
    good = torch.where(grow, torch.zeros_like(good), good)
    return LossScaleState(scale=new_scale, good_steps=good.int(),
                          hysteresis=new_hyst.int())
