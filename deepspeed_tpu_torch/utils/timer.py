"""Throughput timer and the timer names (counterpart of
``deepspeed_tpu/utils/timer.py``; reference: deepspeed/utils/timer.py).

The timer measures host-visible step boundaries. It waits for the card
to finish the work behind a given tensor only where a caller passes one (the engine does so every ``steps_per_print``
steps, as the JAX engine blocks on the loss there); otherwise the host
clock measures the enqueue.
"""

from __future__ import annotations

import time
from typing import Any

import torch

FORWARD_MICRO_TIMER = "fwd_microstep"
FORWARD_GLOBAL_TIMER = "fwd"
BACKWARD_MICRO_TIMER = "bwd_microstep"
BACKWARD_GLOBAL_TIMER = "bwd"
STEP_MICRO_TIMER = "step_microstep"
STEP_GLOBAL_TIMER = "step"
TRAIN_BATCH_TIMER = "train_batch"


def _wait_for(value: Any) -> None:
    """Block until the card has produced ``value`` (a tensor)."""
    if isinstance(value, torch.Tensor) and value.device.type == "cuda":
        torch.cuda.current_stream(value.device).synchronize()


class ThroughputTimer:
    """samples/sec + TFLOPS estimation (reference: utils/timer.py:228)."""

    def __init__(self, batch_size: int, steps_per_output: int = 100,
                 flops_per_sample: float | None = None):
        self.batch_size = batch_size
        self.steps_per_output = steps_per_output
        self.flops_per_sample = flops_per_sample
        self.epoch_count = 0
        self.global_step_count = 0
        self.total_elapsed_time = 0.0
        self._start = 0.0
        self.started = False

    def start(self):
        self.started = True
        self._start = time.perf_counter()

    def stop(self, sync: Any = None, report_speed: bool = True):
        if not self.started:
            return
        if sync is not None:
            _wait_for(sync)
        self.total_elapsed_time += time.perf_counter() - self._start
        self.global_step_count += 1
        self.started = False
        if (report_speed
                and self.global_step_count % self.steps_per_output == 0):
            from .logging import log_dist
            log_dist(
                f"step={self.global_step_count}, "
                f"throughput={self.avg_samples_per_sec():.2f} samples/s"
                + (f", tflops={self.tflops():.1f}"
                   if self.flops_per_sample else ""))

    def avg_samples_per_sec(self) -> float:
        if self.total_elapsed_time == 0:
            return 0.0
        return (self.global_step_count * self.batch_size
                / self.total_elapsed_time)

    def tflops(self) -> float | None:
        """TFLOP/s from the model's count; None where the model gives no
        count (an adapter's)."""
        if not self.flops_per_sample:
            return None
        return self.avg_samples_per_sec() * self.flops_per_sample / 1e12
