"""Megatron-compatible activation checkpointing (counterpart of
``deepspeed_tpu/runtime/activation_checkpointing/checkpointing.py``;
reference: runtime/activation_checkpointing/checkpointing.py —
``checkpoint()`` :946, ``CheckpointFunction`` :486, activation
partitioning :375/:266, CPU checkpointing, ``CudaRNGStatesTracker`` :124).

The JAX module maps each feature onto ``jax.checkpoint``; the port maps
it onto ``torch.utils.checkpoint`` (non-reentrant):

- ``checkpoint(fn, *args)``: recompute ``fn``'s activations in backward,
  under the configured policy (:func:`remat`). The ``jax.checkpoint_policies``
  names keep their meaning: ``nothing_saveable`` saves only the inputs;
  ``everything_saveable`` saves every intermediate, so ``fn`` runs
  unwrapped; ``dots_saveable`` (alias ``checkpoint_dots``) saves the
  outputs of every matmul (``aten.mm``/``addmm``/``bmm``/``baddbmm``) and
  ``dots_with_no_batch_dims_saveable`` (alias
  ``checkpoint_dots_with_no_batch_dims``) those of the unbatched ones
  (``mm``/``addmm``, the projections), through a selective-checkpoint
  policy; the recompute then returns the saved outputs and reruns the
  rest. A hand-written kernel launched through ``ctypes`` is no dispatcher
  op: the policy sees only the ``aten.empty`` it writes into, which it
  recomputes, so the recompute launches the kernel again.
- ``partition_activations``: JAX shards the saved stash over the ``tp``
  axis; the port has no tensor parallelism yet (ROADMAP Slice D), so at
  tp <= 1, as in JAX, it changes nothing.
- ``cpu_checkpointing``: as JAX's ``offload_dot_with_no_batch_dims``, the
  outputs of the unbatched matmuls go to pinned host memory in forward and
  come back in the recompute in place of running the matmul; everything
  else is recomputed.
- :class:`RNGStatesTracker`: named streams whose ``fork()`` returns a
  ``torch.Generator`` seeded by a pure function of (seed, counter), so a
  dropout inside a checkpointed block draws the same bits in the recompute
  (``torch.utils.checkpoint`` also restores the global RNG state). The bits
  differ from JAX's threefry keys; the contract is the same.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint as
                                    _checkpoint,
                                    create_selective_checkpoint_contexts)

_aten = torch.ops.aten
UNBATCHED_DOTS = (_aten.mm.default, _aten.addmm.default)
BATCHED_DOTS = (_aten.bmm.default, _aten.baddbmm.default)
# the jax.checkpoint_policies names that are policies (not factories) ->
# the matmul ops whose outputs they save (None: none; "all": every op)
STOCK_POLICIES = {
    "nothing_saveable": None,
    "everything_saveable": "all",
    "dots_saveable": UNBATCHED_DOTS + BATCHED_DOTS,
    "checkpoint_dots": UNBATCHED_DOTS + BATCHED_DOTS,
    "dots_with_no_batch_dims_saveable": UNBATCHED_DOTS,
    "checkpoint_dots_with_no_batch_dims": UNBATCHED_DOTS,
}
# the names the JAX module's config accepts (_POLICIES); others fall back
# to nothing_saveable there too
_POLICIES = ("nothing_saveable", "dots_saveable", "everything_saveable",
             "dots_with_no_batch_dims_saveable")

_CONFIG = None  # ActivationCheckpointingConfig set by configure()


def _saving(ops: tuple):
    """A ``context_fn`` whose policy saves the outputs of ``ops``."""
    def policy(ctx, func, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if func in ops
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy)


def remat(function: Callable, *args, policy: str = "nothing_saveable",
          **kwargs):
    """``function(*args, **kwargs)`` with its activations rematerialised
    in backward under the stock policy named ``policy``."""
    if policy not in STOCK_POLICIES:
        raise ValueError(f"unknown checkpoint policy {policy!r}; one of "
                         f"{sorted(STOCK_POLICIES)}")
    ops = STOCK_POLICIES[policy]
    if ops == "all":
        return function(*args, **kwargs)
    if ops is None:
        return _checkpoint(function, *args, use_reentrant=False, **kwargs)
    return _checkpoint(function, *args, use_reentrant=False,
                       context_fn=_saving(ops), **kwargs)


class _OffloadDots(TorchDispatchMode):
    """Forward: each unbatched matmul's output, in order, to host memory
    (pinned when it comes from a card)."""

    def __init__(self, store: list):
        super().__init__()
        self.store = store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in UNBATCHED_DOTS:
            if out.device.type == "cpu":
                host = out.detach()
            else:
                host = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=True)
                host.copy_(out, non_blocking=True)
            self.store.append((host, out.device))
        return out


class _ReloadDots(TorchDispatchMode):
    """Recompute: each unbatched matmul, in the forward's order, returns
    its host copy on its device instead of running."""

    def __init__(self, store: list):
        super().__init__()
        self.store = store
        self.next = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in UNBATCHED_DOTS and self.next < len(self.store):
            host, device = self.store[self.next]
            self.next += 1
            return host.to(device, non_blocking=True)
        return func(*args, **(kwargs or {}))


def _offload_contexts():
    store: list = []
    return _OffloadDots(store), _ReloadDots(store)


def configure(mpu_=None, deepspeed_config=None, partition_activations=None,
              contiguous_checkpointing=None, num_checkpoints=None,
              checkpoint_in_cpu=None, synchronize=None, profile=None):
    """reference: checkpointing.py:926 configure(). ``deepspeed_config``
    is a DeepSpeed config (dict, JSON path or ``DeepSpeedConfig``); the
    keyword arguments override its ``activation_checkpointing`` block."""
    global _CONFIG
    from ..config import ActivationCheckpointingConfig, DeepSpeedConfig
    if deepspeed_config is not None:
        _CONFIG = DeepSpeedConfig.from_any(
            deepspeed_config).activation_checkpointing
    elif _CONFIG is None:
        _CONFIG = ActivationCheckpointingConfig()
    if partition_activations is not None:
        _CONFIG.partition_activations = partition_activations
    if checkpoint_in_cpu is not None:
        _CONFIG.cpu_checkpointing = checkpoint_in_cpu
    if num_checkpoints is not None:
        _CONFIG.number_checkpoints = num_checkpoints
    if profile is not None:
        _CONFIG.profile = profile


def is_configured() -> bool:
    return _CONFIG is not None


def checkpoint(function: Callable, *args, **kwargs):
    """Checkpoint a forward block (reference: checkpoint():946 — call in
    place of ``function(*args)``; activations are recomputed in backward)
    under the configured policy; ``cpu_checkpointing`` offloads the
    unbatched matmul outputs to host memory instead."""
    from ..config import ActivationCheckpointingConfig
    cfg = _CONFIG or ActivationCheckpointingConfig()
    if cfg.cpu_checkpointing:
        return _checkpoint(function, *args, use_reentrant=False,
                           context_fn=_offload_contexts, **kwargs)
    policy = cfg.policy if cfg.policy in _POLICIES else "nothing_saveable"
    return remat(function, *args, policy=policy, **kwargs)


def checkpoint_wrapper(function: Callable) -> Callable:
    """Decorator form: ``layer = checkpoint_wrapper(layer)``."""

    @functools.wraps(function)
    def wrapped(*args, **kwargs):
        return checkpoint(function, *args, **kwargs)

    return wrapped


# --- RNG tracker (reference: CudaRNGStatesTracker :124) -----------------

class RNGStatesTracker:
    """Named deterministic random streams for dropout inside checkpointed
    blocks (reference: CudaRNGStatesTracker + model_parallel_cuda_manual_
    seed :245). A fork's generator is seeded by a pure function of (the
    stream's seed, its fork counter), so forward and recompute agree by
    construction."""

    def __init__(self):
        self._seeds: dict[str, int] = {}
        self._counters: dict[str, int] = {}

    def reset(self):
        self._seeds.clear()
        self._counters.clear()

    def add(self, name: str, seed: int):
        if name in self._seeds:
            raise ValueError(f"rng state {name!r} already exists")
        self._seeds[name] = seed
        self._counters[name] = 0

    def get_states(self):
        return dict(self._seeds), dict(self._counters)

    def set_states(self, states):
        self._seeds, self._counters = dict(states[0]), dict(states[1])

    def fork(self, name: str = "model-parallel-rng",
             device=None) -> torch.Generator:
        """A fresh deterministically seeded generator for this stream (on
        ``device``, the CPU by default)."""
        if name not in self._seeds:
            raise ValueError(f"unknown rng state {name!r}")
        self._counters[name] += 1
        seed = np.random.SeedSequence(
            [self._seeds[name], self._counters[name]]).generate_state(
                1, np.uint64)[0]
        gen = torch.Generator(device=device or "cpu")
        return gen.manual_seed(int(seed))


_RNG_TRACKER = RNGStatesTracker()


def get_cuda_rng_tracker() -> RNGStatesTracker:  # reference name parity
    return _RNG_TRACKER


get_rng_tracker = get_cuda_rng_tracker


def model_parallel_cuda_manual_seed(seed: int):
    """reference: checkpointing.py:245 — seed the model-parallel stream
    (offset from the data-parallel one) and the data-parallel stream."""
    _RNG_TRACKER.reset()
    _RNG_TRACKER.add("model-parallel-rng", seed + 2718)
    _RNG_TRACKER.add("data-parallel-rng", seed)


def reset():
    global _CONFIG
    _CONFIG = None
    _RNG_TRACKER.reset()
