"""CUDA graphs of the serving loops: one capture discipline for the v2
engine's fused dispatches (``v2/fused_graph.py``, ``engine_v2.py``) and
the v1 engine's decode step (``engine.py`` ``InferenceEngine.generate``).

:class:`CapturedLoop` captures ``run(state)`` over a state whose tensors
sit at fixed addresses (``state.device``, ``state.idle_copy()``): a
warm-up first, eagerly on a side stream over an idle copy of the state
(it builds each kernel's library and cuBLAS's workspace and changes
neither the state nor what it points at), then the capture. Replays count
their kernel launches on the wrappers' counters (a wrapper counts in
Python, so only at capture, into the capturing thread's tally; see
``ops/launches.py``).

On the card a loop replays its graph or raises: no caller retries a
failed capture eagerly.
"""

from __future__ import annotations

import collections
import gc
import threading
import time

import torch

from ..ops import launches

# one warm-up stream a device: every stream cuBLAS runs on keeps a
# workspace of its own for the process's life
_WARM_STREAMS: dict = {}
# one capture at a time in the process: engines serving on threads of
# their own (the async server's worker, a prefill engine's) may each
# capture, and two captures would share the warm-up stream
_CAPTURE_LOCK = threading.Lock()


class CapturedLoop:
    """``run(state)`` (a loop function over the state's tensors: a v2
    decode, spec, serve or spec-serve dispatch, or the v1 decode step)
    captured as one CUDA graph; ``warm(idle)`` runs one eager tick of the
    same loop over ``state.idle_copy()`` first. ``stats`` holds its
    capture time in ms (warm-up and instantiation included), the device
    memory its private pool took (MiB, from the allocator's reserved
    bytes) and the launches a replay makes by wrapper.

    The garbage collector is run before the capture and held off during
    it: a dead reference cycle that holds another graph, collected in the
    middle of a capture, would destroy that graph there, and a graph's
    destruction is an operation the capture forbids (it invalidates the
    capture).

    Captures are serialized across threads (``_CAPTURE_LOCK``), and each
    forbids unsafe CUDA calls on its own thread only
    (``capture_error_mode="thread_local"``): another thread's engine may
    go on allocating, launching and reading results meanwhile, on its own
    pools and streams."""

    def __init__(self, state, run, warm):
        if state.device.type != "cuda":
            raise ValueError("CapturedLoop needs CUDA operands")
        with _CAPTURE_LOCK:
            self._capture(state, run, warm)

    def _capture(self, state, run, warm) -> None:
        dev = state.device
        torch.cuda.synchronize(dev)
        gc.collect()
        torch.cuda.empty_cache()     # as the capture's entry does
        reserved = torch.cuda.memory_reserved(dev)
        t = time.perf_counter()
        side = _WARM_STREAMS.get(dev)
        if side is None:
            side = _WARM_STREAMS[dev] = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            warm(state.idle_copy())
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            # a capture launches nothing: its counts belong to each replay
            with launches.tally() as recorded, \
                    torch.cuda.graph(self.graph,
                                     capture_error_mode="thread_local"):
                run(state)
        finally:
            if collecting:
                gc.enable()
        torch.cuda.synchronize(dev)
        self.launches = dict(collections.Counter(recorded))
        per, by = {}, {}
        for (w, variant), n in self.launches.items():
            per[w.__name__] = per.get(w.__name__, 0) + n
            by.setdefault(w.__name__, {})[variant] = n
        self.stats = {
            "capture_ms": 1e3 * (time.perf_counter() - t),
            "pool_mib": (torch.cuda.memory_reserved(dev) - reserved)
            / 2**20,
            "launches_per_replay": per, "launches_by_variant": by}

    def replay(self) -> None:
        self.graph.replay()
        launches.add(self.launches)
