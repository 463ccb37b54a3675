"""The fused serving loops on the card: their operands at fixed addresses
and the CUDA graphs that replay them (the port's counterpart of the JAX
engine's jitted ``fused_decode_loop``, ``fused_spec_decode_loop``,
``fused_serve_loop`` and ``fused_spec_serve_loop``,
``deepspeed_tpu/inference/v2/engine_v2.py`` ``_fused_fn``, ``_spec_fn``,
``_serve_fn`` and ``_spec_serve_fn``).

* :class:`FusedState` holds one chain-mode dispatch's operands and results
  (tokens, positions, active mask, budgets, block table, row keys, the
  output tokens, the steps run and the last tick's logits; with
  speculation also the history window, the per-row output pointers and
  the spec counters) for one batch bucket and table-width bucket. A fresh
  dispatch loads host-built operands into it; a chained one replays on the
  carry the last dispatch left there, so the host reads nothing between
  them.
* :class:`RingState` holds a ring-mode chain: the carry (with the epoch
  and stage-valid masks), the staged requests' operands, the output ring,
  its epochs and pointer, and the steps and spec counters of the chain.
  The host loads it once before the chain's first dispatch and reads the
  ring back once after its last.
* ``inference/graphs.py`` :class:`CapturedLoop` (shared with the v1
  engine's ``generate``) is one captured graph of a loop function over a
  state: a warm-up tick first, eagerly on a side stream over a copy of the
  state with every row inactive (:meth:`_DeviceState.idle_copy`: it
  builds each kernel's library and changes neither the pools nor the
  state), then the capture.

On the card a loop replays a graph or raises: there is no eager fallback.
On the CPU the states hold plain tensors and the engine runs the loops
eagerly over them.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

# the operands a chain-mode dispatch loads, with their dtypes
OPERANDS = {"tokens": torch.int64, "pos": torch.int32, "active": torch.bool,
            "remaining": torch.int32, "tables": torch.int32,
            "row_keys": torch.int64}
# what ring mode adds: each row's swap count and its staged request
STAGE_OPERANDS = {"epoch": torch.int32, "stage_valid": torch.bool,
                  "stage_tokens": torch.int64, "stage_pos": torch.int32,
                  "stage_rem": torch.int32, "stage_keys": torch.int64,
                  "stage_tables": torch.int32}


class _DeviceState:
    """Tensors at fixed addresses: ``operands`` (name -> (shape, dtype))
    that the host loads, through pinned staging buffers on the card (a
    new load waits until the last one's copies have run), and device-only
    ``buffers`` (name -> (shape, dtype, fill)). ``graphs`` caches the
    dispatch functions captured over this state, so they go with it."""

    def __init__(self, device, operands: dict, buffers: dict):
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._operands = {n: dt for n, (_, dt) in operands.items()}
        for name, (shape, dtype) in operands.items():
            setattr(self, name, torch.zeros(shape, dtype=dtype,
                                            device=self.device))
        for name, (shape, dtype, fill) in buffers.items():
            setattr(self, name, torch.full(shape, fill, dtype=dtype,
                                           device=self.device))
        self._names = list(operands) + list(buffers)
        self.graphs: dict = {}
        if self._cuda:
            self._stage = {n: torch.zeros(shape, dtype=dt, pin_memory=True)
                           for n, (shape, dt) in operands.items()}
            self._staged = None

    def operands(self) -> dict:
        return {n: getattr(self, n) for n in self._operands}

    def tensors(self) -> dict:
        """Every tensor of the state, operands and buffers."""
        return {n: getattr(self, n) for n in self._names}

    def load(self, **host) -> None:
        """Fill operands from host arrays (numpy or CPU tensors, by
        name)."""
        srcs = {name: torch.as_tensor(np.asarray(arr)).to(
            self._operands[name]) for name, arr in host.items()}
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

    def release(self) -> None:
        """Drop the dispatch functions (and their graphs) at once: each
        refers back to this state, a cycle only the garbage collector
        would otherwise break."""
        self.graphs.clear()

    def idle_copy(self):
        """A copy of the state over cloned tensors with every row inactive
        and no stage attached: a loop run over it changes neither the
        pools nor this state (a capture's warm-up)."""
        idle = copy.copy(self)
        for name, t in self.tensors().items():
            setattr(idle, name, t.clone())
        idle.active.zero_()
        if hasattr(idle, "stage_valid"):
            idle.stage_valid.zero_()
        idle.graphs = {}
        return idle


class FusedResult:
    """One chain-mode dispatch's results on their way to the host: on the
    card copied into pinned buffers after the dispatch, in stream order,
    and read once its event has passed."""

    def __init__(self, host: dict, width: int, event=None):
        self._host, self._width = host, width
        self._event = event

    def _wait(self) -> None:
        if self._event is not None:
            self._event.synchronize()

    def read(self) -> tuple[np.ndarray, int]:
        """(tokens [B, width] int64, -1 beyond each row's emits; steps
        run)."""
        self._wait()
        return (self._host["out"][:, :self._width].numpy().copy(),
                int(self._host["steps"].item()))

    def spec(self) -> tuple[np.ndarray, np.ndarray]:
        """A speculative dispatch's per-row output pointers [B] and spec
        counters [4] (proposed, accepted, hit slots, live slots)."""
        self._wait()
        return (self._host["out_ptr"].numpy().copy(),
                self._host["spec_stats"].numpy().copy())


class FusedState(_DeviceState):
    """The chain-mode loops' operands and results for one (batch bucket
    ``bb``, table-width bucket ``kb``) at fixed addresses, up to
    ``max_steps`` ticks a dispatch. ``draft_len`` > 0 adds the
    speculative carry: ``hist`` [bb, ``hist_width``] (the drafter's
    window), ``out_ptr`` [bb] and ``spec_stats`` [4], with ``out`` [bb,
    max_steps * (1 + draft_len) + 1] (the last column the trash column
    of the per-row scatter). Each dispatch's results come back through a
    ring of ``ring`` pinned buffers, one for each dispatch that may be in
    flight plus one."""

    def __init__(self, bb: int, kb: int, max_steps: int, vocab: int,
                 device, ring: int, draft_len: int = 0, hist_width: int = 0):
        self.bb, self.kb, self.max_steps = bb, kb, max_steps
        self.draft_len, self.hist_width = draft_len, hist_width
        shapes = {"tokens": (bb,), "pos": (bb,), "active": (bb,),
                  "remaining": (bb,), "tables": (bb, kb),
                  "row_keys": (bb, 2)}
        operands = {n: (shapes[n], dt) for n, dt in OPERANDS.items()}
        results = {"out": ((bb, max_steps * (1 + draft_len) + 1),
                           torch.int64, -1),
                   "steps": ((), torch.int32, 0),
                   "logits": ((bb, vocab), torch.float32, 0)}
        if draft_len:
            operands["hist"] = ((bb, hist_width), torch.int64)
            results.update(out_ptr=((bb,), torch.int32, 0),
                           spec_stats=((4,), torch.int32, 0))
        super().__init__(device, operands, results)
        self._copied = ["out", "steps"] + (["out_ptr", "spec_stats"]
                                           if draft_len else [])
        if self._cuda:
            self._ring = [{n: torch.empty(getattr(self, n).shape,
                                          dtype=getattr(self, n).dtype,
                                          pin_memory=True)
                           for n in self._copied} for _ in range(ring)]
            self._next = 0

    def fits(self, k: int, draft_len: int, hist_width: int) -> bool:
        """Whether this state serves ``k`` ticks a dispatch, and with
        ``draft_len`` > 0 the speculative loop of that draft length over
        a window of ``hist_width``."""
        return self.max_steps >= k and (not draft_len or (
            self.draft_len == draft_len and self.hist_width == hist_width))

    def result(self, width: int) -> FusedResult:
        """The last dispatch's results, the first ``width`` output
        columns, taken in stream order (before the next dispatch on this
        state overwrites them)."""
        if not self._cuda:
            return FusedResult({n: getattr(self, n).clone()
                                for n in self._copied}, width)
        host = self._ring[self._next]
        self._next = (self._next + 1) % len(self._ring)
        for n in self._copied:
            host[n].copy_(getattr(self, n), non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return FusedResult(host, width, event)


class RingState(_DeviceState):
    """A ring-mode chain's operands at fixed addresses for one (batch
    bucket ``bb``, table-width bucket ``kb``): the carry (``OPERANDS``
    with ``epoch`` and ``stage_valid``), the staged requests' operands,
    the output ``ring`` [bb, cap + 1] and ``ring_epochs`` (the last
    column the trash column of the speculative scatter), ``ring_ptr``
    ([] plain, [bb] speculative), the dispatch's ``steps`` and the
    chain's ``chain_steps``; ``draft_len`` > 0 adds ``hist``,
    ``stage_hist`` [bb, ``hist_width``] and ``spec_stats`` [4]. The host
    loads it once before a chain (:meth:`load` also resets the ring, its
    pointer and the counters) and reads it once after (:meth:`read`,
    through one set of pinned buffers and an event; ``reads`` counts
    them)."""

    def __init__(self, bb: int, kb: int, cap: int, device,
                 draft_len: int = 0, hist_width: int = 0):
        self.bb, self.kb, self.cap = bb, kb, cap
        self.draft_len, self.hist_width = draft_len, hist_width
        shapes = {"tokens": (bb,), "pos": (bb,), "active": (bb,),
                  "remaining": (bb,), "tables": (bb, kb),
                  "row_keys": (bb, 2), "epoch": (bb,), "stage_valid": (bb,),
                  "stage_tokens": (bb,), "stage_pos": (bb,),
                  "stage_rem": (bb,), "stage_keys": (bb, 2),
                  "stage_tables": (bb, kb)}
        dtypes = dict(OPERANDS, **STAGE_OPERANDS)
        operands = {n: (shapes[n], dt) for n, dt in dtypes.items()}
        buffers = {"ring": ((bb, cap + 1), torch.int64, -1),
                   "ring_epochs": ((bb, cap + 1), torch.int32, -1),
                   "ring_ptr": ((bb,) if draft_len else (), torch.int32, 0),
                   "steps": ((), torch.int32, 0),
                   "chain_steps": ((), torch.int32, 0)}
        if draft_len:
            operands.update(hist=((bb, hist_width), torch.int64),
                            stage_hist=((bb, hist_width), torch.int64))
            buffers["spec_stats"] = ((4,), torch.int32, 0)
        super().__init__(device, operands, buffers)
        self._read_names = ["ring", "ring_epochs", "ring_ptr", "epoch",
                            "chain_steps"] + (["spec_stats"] if draft_len
                                              else [])
        self._host = ({n: torch.empty(getattr(self, n).shape,
                                      dtype=getattr(self, n).dtype,
                                      pin_memory=True)
                       for n in self._read_names} if self._cuda else None)
        self.reads = 0

    def fits(self, cap: int, draft_len: int, hist_width: int) -> bool:
        return (self.cap, self.draft_len, self.hist_width) == (
            cap, draft_len, hist_width)

    def load(self, **host) -> None:
        """Fill the chain's operands from host arrays, then reset the
        ring, its epochs and pointer, and the chain's counters."""
        super().load(**host)
        self.ring.fill_(-1)
        self.ring_epochs.fill_(-1)
        for name in ("ring_ptr", "chain_steps", "spec_stats"):
            if hasattr(self, name):
                getattr(self, name).zero_()

    def read(self) -> dict:
        """The chain's one device-to-host read: the ring [bb, cap] and its
        epochs, ``ring_ptr``, each row's final ``epoch``, ``chain_steps``
        and (speculative) ``spec_stats``, as numpy arrays."""
        self.reads += 1
        if self._cuda:
            for n in self._read_names:
                self._host[n].copy_(getattr(self, n), non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            event.synchronize()
            src = self._host
        else:
            src = {n: getattr(self, n) for n in self._read_names}
        out = {n: src[n].numpy().copy() for n in self._read_names}
        out["ring"] = out["ring"][:, :self.cap]
        out["ring_epochs"] = out["ring_epochs"][:, :self.cap]
        return out
