"""The fused decode loop on the card: its operands at fixed addresses and
the CUDA graphs that replay it (the port's counterpart of the JAX engine's
jitted ``fused_decode_loop``, ``deepspeed_tpu/inference/v2/engine_v2.py``
``_fused_fn``).

* :class:`FusedState` holds one dispatch's operands and results (tokens,
  positions, active mask, budgets, block table, row keys, the output
  tokens, the steps run and the last tick's logits) for one batch bucket
  and table-width bucket. A fresh dispatch loads host-built operands into
  it; a chained one replays on the carry the last dispatch left there, so
  the host reads nothing between them.
* :class:`CapturedLoop` is one captured graph of ``k`` ticks over a state
  for one sampling setting: a warm-up tick first, eagerly on a side stream
  over copies of the operands with every row inactive (it builds each
  kernel's library and changes neither the pools nor the state), then the
  capture. Replays count their kernel launches on the wrappers' counters
  (a wrapper counts in Python, so only at capture; see
  :func:`launch_snapshot`).

On the card the loop replays a graph or raises: there is no eager
fallback. On the CPU :class:`FusedState` holds plain tensors and the
engine runs the loop eagerly over them.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ...ops import norms
from . import paged

# the operands a dispatch loads, with their dtypes
OPERANDS = {"tokens": torch.int64, "pos": torch.int32, "active": torch.bool,
            "remaining": torch.int32, "tables": torch.int32,
            "row_keys": torch.int64}


def counted_wrappers() -> tuple:
    """The kernel wrappers a serving forward calls, each counting its
    launches in ``.launches`` and by variant in ``.variant_launches``."""
    return (paged.paged_attention_kernel, norms.rms_norm_kernel,
            norms.layer_norm_kernel)


def launch_snapshot() -> list:
    """Every counted wrapper's launches, by variant, and last variant."""
    return [(w.launches, dict(w.variant_launches), w.variant)
            for w in counted_wrappers()]


def launch_delta(before: list, after: list) -> list:
    """What the wrappers counted between two snapshots."""
    return [(a[0] - b[0], {v: n - b[1].get(v, 0) for v, n in a[1].items()
                           if n != b[1].get(v, 0)}, a[2])
            for b, a in zip(before, after)]


def restore_launches(snapshot: list) -> None:
    """Set every counted wrapper back to ``snapshot``."""
    for w, (n, by_variant, variant) in zip(counted_wrappers(), snapshot):
        w.launches = n
        w.variant_launches = dict(by_variant)
        w.variant = variant


def add_launches(delta: list) -> None:
    """Count one replay of a graph whose capture counted ``delta``."""
    for w, (n, by_variant, variant) in zip(counted_wrappers(), delta):
        if not n:
            continue
        w.launches += n
        for v, m in by_variant.items():
            w.variant_launches[v] = w.variant_launches.get(v, 0) + m
        w.variant = variant


class FusedResult:
    """One dispatch's output tokens [B, k] and steps run, on their way to
    the host: on the card copied into a pinned buffer after the dispatch,
    in stream order, and read once its event has passed."""

    def __init__(self, out, steps, num_steps: int, event=None):
        self._out, self._steps = out, steps
        self._k = num_steps
        self._event = event

    def read(self) -> tuple[np.ndarray, int]:
        """(tokens [B, k] int64, -1 beyond each row's emits; steps run)."""
        if self._event is not None:
            self._event.synchronize()
        return (self._out[:, :self._k].numpy().copy(),
                int(self._steps.item()))


class FusedState:
    """The fused loop's operands and results for one (batch bucket
    ``bb``, table-width bucket ``kb``) at fixed addresses, up to
    ``max_steps`` ticks a dispatch. On the card, host-built operands go
    through pinned staging buffers (a new load waits until the last one's
    copies have run), and each dispatch's results come back through a
    ring of ``ring`` pinned buffers, one for each dispatch that may be in
    flight plus one."""

    def __init__(self, bb: int, kb: int, max_steps: int, vocab: int,
                 device, ring: int):
        self.bb, self.kb, self.max_steps = bb, kb, max_steps
        self.device = torch.device(device)
        shapes = {"tokens": (bb,), "pos": (bb,), "active": (bb,),
                  "remaining": (bb,), "tables": (bb, kb),
                  "row_keys": (bb, 2)}
        for name, dtype in OPERANDS.items():
            setattr(self, name, torch.zeros(shapes[name], dtype=dtype,
                                            device=self.device))
        self.out = torch.full((bb, max_steps), -1, dtype=torch.int64,
                              device=self.device)
        self.steps = torch.zeros((), dtype=torch.int32, device=self.device)
        self.logits = torch.zeros((bb, vocab), dtype=torch.float32,
                                  device=self.device)
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self._stage = {n: torch.zeros(shapes[n], dtype=dt,
                                          pin_memory=True)
                           for n, dt in OPERANDS.items()}
            self._staged = None
            self._ring = [(torch.empty((bb, max_steps), dtype=torch.int64,
                                       pin_memory=True),
                           torch.empty((), dtype=torch.int32,
                                       pin_memory=True))
                          for _ in range(ring)]
            self._next = 0

    def operands(self) -> dict:
        return {n: getattr(self, n) for n in OPERANDS}

    def load(self, **host) -> None:
        """Fill the operands from host arrays (numpy or CPU tensors, one
        per name of ``OPERANDS``)."""
        srcs = {name: torch.as_tensor(np.asarray(arr)).to(OPERANDS[name])
                for name, arr in host.items()}
        if not self._cuda:
            for name, src in srcs.items():
                getattr(self, name).copy_(src)
            return
        if self._staged is not None:
            # the last load's copies may still read the staging buffers
            self._staged.synchronize()
        for name, src in srcs.items():
            self._stage[name].copy_(src)
            getattr(self, name).copy_(self._stage[name], non_blocking=True)
        self._staged = torch.cuda.Event()
        self._staged.record()

    def result(self, num_steps: int) -> FusedResult:
        """The last dispatch's results, taken in stream order (before the
        next dispatch on this state overwrites them)."""
        if not self._cuda:
            return FusedResult(self.out.clone(), self.steps.clone(),
                               num_steps)
        out, steps = self._ring[self._next]
        self._next = (self._next + 1) % len(self._ring)
        out.copy_(self.out, non_blocking=True)
        steps.copy_(self.steps, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return FusedResult(out, steps, num_steps, event)


class CapturedLoop:
    """``num_steps`` ticks of ``paged.fused_decode_loop`` over ``state``,
    captured as one CUDA graph. ``stats`` holds its capture time in ms
    (warm-up and instantiation included), the device memory its private
    pool took (MiB, from the allocator's reserved bytes) and the launches
    a replay makes by wrapper."""

    def __init__(self, model, pools: dict, state: FusedState,
                 num_steps: int, **loop_kw):
        if state.device.type != "cuda":
            raise ValueError("CapturedLoop needs CUDA operands")
        if num_steps > state.max_steps:
            raise ValueError(f"{num_steps} ticks over a state of "
                             f"{state.max_steps}")
        self.num_steps = num_steps

        def run(st: FusedState, out, steps, logits_out):
            return paged.fused_decode_loop(
                model, pools, st.tokens, st.pos, st.tables, st.active,
                st.remaining, st.row_keys, num_steps=num_steps, out=out,
                steps=steps, logits_out=logits_out, **loop_kw)

        torch.cuda.synchronize(state.device)
        torch.cuda.empty_cache()     # as the capture's entry does
        reserved = torch.cuda.memory_reserved(state.device)
        t = time.perf_counter()
        # warm-up: one eager tick over copies with every row inactive
        side = torch.cuda.Stream(state.device)
        side.wait_stream(torch.cuda.current_stream(state.device))
        with torch.cuda.stream(side):
            idle = {n: t_.clone() for n, t_ in state.operands().items()}
            idle["active"].zero_()
            paged.fused_decode_loop(
                model, pools, idle["tokens"], idle["pos"], idle["tables"],
                idle["active"], idle["remaining"], idle["row_keys"],
                num_steps=1, **loop_kw)
        torch.cuda.current_stream(state.device).wait_stream(side)
        before = launch_snapshot()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            run(state, state.out[:, :num_steps], state.steps, state.logits)
        after = launch_snapshot()
        # a capture launches nothing: its counts belong to each replay
        self.launches = launch_delta(before, after)
        restore_launches(before)
        torch.cuda.synchronize(state.device)
        self.stats = {
            "capture_ms": 1e3 * (time.perf_counter() - t),
            "pool_mib": (torch.cuda.memory_reserved(state.device)
                         - reserved) / 2**20,
            "launches_per_replay": {
                w.__name__: n for w, (n, _, _) in zip(counted_wrappers(),
                                                      self.launches) if n}}

    def replay(self) -> None:
        self.graph.replay()
        add_launches(self.launches)
