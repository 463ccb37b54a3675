"""Disaggregated, multi-replica serving (counterpart of
``deepspeed_tpu/serving/router.py``): a prefix-affinity router in front of
N decode ``AsyncInferenceServer`` replicas, and a dedicated prefill engine
whose finished prompts migrate to a decode replica as KV block sets, the
MII/FastGen deployment layer over inference v2.

- :class:`PrefillEngine` wraps an ``InferenceEngineV2`` kept for chunked
  prefill, so long prompts stop stealing decode ticks. One worker thread
  owns every call into its engine; ``prefill()`` runs the chunked prefill
  and the first token as a co-located serve loop would, and returns the
  sequence as a ``KVExportState`` (quantized blocks and scales as
  stored).
- :class:`InferenceRouter` places each request on the replica whose
  prefix cache holds the longest chain of its prompt, else on the least
  loaded, skipping replicas over ``max_open_per_replica`` and draining
  those under the free-block watermark; a request that fails on its
  replica is resubmitted, prompt plus the tokens already streamed under
  the same uid, so a position-keyed stream continues exactly.
- :class:`RoutedHandle` is the client's stream: one async iterator a
  request, however many engines served it.

Host-only orchestration: the device work happens inside the engines, on
their owning threads. The JAX router's health gating and its blocksan
transit bookkeeping wait for the telemetry port (ROADMAP port item 15).
"""

from __future__ import annotations

import asyncio
import itertools
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

from ..utils.logging import log_dist
from .config import RouterConfig
from .server import AsyncInferenceServer, RequestCancelled, RequestFailed

_DONE = object()

# the router's decision and outcome counters (metrics() schema, the JAX
# router's; health_skips stays 0 until health gating is ported)
ROUTER_COUNTER_KEYS = (
    "routed_affinity", "routed_least_loaded", "backpressure_skips",
    "drain_skips", "health_skips", "reroutes", "prefill_handoffs",
    "migrated_bytes", "completed", "failed", "cancelled")


class PrefillEngine:
    """See the module docstring. Built over a dedicated
    ``InferenceEngineV2``; the sampling parameters default to that
    engine's config (they must match the decode replicas' for a hand-off
    to be bit-identical; greedy always is)."""

    def __init__(self, engine, *, name: str = "prefill0",
                 temperature: Optional[float] = None,
                 top_k: Optional[int] = None,
                 top_p: Optional[float] = None, seed: int = 0):
        self.engine = engine
        self.name = str(name)
        self._sampling = (temperature, top_k, top_p)
        self.seed = int(seed)
        # one worker thread owns every engine call: its stream orders the
        # prefill, the export's gather and its host copy
        self._ex = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"ds-prefill-{name}")
        self.stats = {"prefills": 0, "exported_bytes": 0,
                      "exported_blocks": 0, "prefill_tokens": 0}
        self._lock = threading.Lock()

    def _work(self, uid: int, prompt: list[int]):
        """The worker's body: chunked prefill, first token, export. The
        engine is left empty (export flushes): the prefill pool only ever
        holds prompts in flight."""
        t, k, p = self._sampling
        tok = self.engine.prefill_request(uid, prompt, temperature=t,
                                          top_k=k, top_p=p,
                                          seed=self.seed)
        state = self.engine.export_request(uid, n_generated=1,
                                           source=self.name)
        with self._lock:
            self.stats["prefills"] += 1
            self.stats["exported_bytes"] += state.payload_bytes
            self.stats["exported_blocks"] += state.payload_blocks
            self.stats["prefill_tokens"] += len(prompt)
        return tok, state

    async def prefill(self, uid: int, prompt: Sequence[int]):
        """Run one prompt through the prefill engine; returns
        ``(first_token, KVExportState)`` without blocking the event
        loop."""
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._ex, self._work, int(uid), [int(t) for t in prompt])

    def metrics(self) -> dict:
        with self._lock:
            return dict(self.stats, name=self.name)

    def close(self) -> None:
        self._ex.shutdown(wait=True)


class RoutedHandle:
    """A request's stream across replicas: ``async for tok in handle``
    yields int token ids exactly once each, whichever engine made them.
    ``replica`` names the decode replica serving the request now."""

    def __init__(self, uid: int):
        self.uid = uid
        self.replica: Optional[str] = None
        self.error: Optional[str] = None
        self._q: asyncio.Queue = asyncio.Queue()
        self._finished = False
        self._inner = None            # the live replica RequestHandle
        self._cancelled = False

    def _push(self, tokens: list[int]) -> None:
        # one queue item a token: a multi-token delivery must not
        # interleave with a later push
        for t in tokens:
            self._q.put_nowait(int(t))

    def _finish(self, error: Optional[str] = None) -> None:
        self.error = error
        self._q.put_nowait(_DONE)

    def __aiter__(self):
        return self

    async def __anext__(self) -> int:
        if self._finished:
            raise StopAsyncIteration
        item = await self._q.get()
        if item is _DONE:
            self._finished = True
            if self.error == "cancelled":
                raise RequestCancelled(f"request {self.uid}")
            if self.error:
                raise RequestFailed(self.error)
            raise StopAsyncIteration
        return item

    async def tokens(self) -> list[int]:
        return [t async for t in self]

    def cancel(self) -> None:
        """Drop the request on whichever replica runs it now."""
        self._cancelled = True
        if self._inner is not None:
            self._inner.cancel()


class InferenceRouter:
    """See the module docstring. Typical use::

        replicas = [AsyncInferenceServer(e) for e in engines]
        router = InferenceRouter(replicas, RouterConfig(
            disaggregation={"enabled": True}),
            prefill=PrefillEngine(prefill_engine))
        async with router:
            h = await router.submit(prompt_ids, max_new_tokens=256)
            async for tok in h:
                ...

    The router owns the replicas' lifecycle (started on entry, drained
    and stopped on exit). Every request gets a router-wide uid, kept
    through the prefill hand-off, the migration and any reroute."""

    def __init__(self, replicas: Sequence[AsyncInferenceServer],
                 config=None, *,
                 prefill: Optional[PrefillEngine] = None):
        if not replicas:
            raise ValueError("InferenceRouter needs >= 1 replica")
        if config is None:
            config = RouterConfig()
        elif isinstance(config, dict):
            config = RouterConfig.from_dict(config)
        self.config = config
        self.prefill = prefill
        if config.disaggregation.enabled and prefill is None:
            raise ValueError(
                "disaggregation.enabled requires a PrefillEngine "
                "(router(..., prefill=PrefillEngine(engine)))")
        self.replicas: list[tuple[str, AsyncInferenceServer]] = []
        for i, srv in enumerate(replicas):
            if not srv.config.replica:
                srv.config.replica = f"replica{i}"
            self.replicas.append((srv.config.replica, srv))
        self._uid = itertools.count()
        self._tasks: set = set()
        self.stats = dict.fromkeys(ROUTER_COUNTER_KEYS, 0)
        self.placed: dict[str, int] = {n: 0 for n, _ in self.replicas}
        # replicas whose worker died before or at stop(): {name: error}
        self.replica_errors: dict[str, str] = {}

    # -- lifecycle -----------------------------------------------------
    async def __aenter__(self):
        await self.start()
        return self

    async def __aexit__(self, *exc):
        await self.stop(drain=exc[0] is None)

    async def start(self) -> None:
        for _, srv in self.replicas:
            await srv.start()
        log_dist(f"InferenceRouter: {len(self.replicas)} replica(s) "
                 f"[{', '.join(n for n, _ in self.replicas)}]"
                 + (f" + prefill engine '{self.prefill.name}'"
                    if self.prefill is not None else ""))

    async def stop(self, drain: bool = True) -> None:
        if self._tasks:
            if not drain:
                for t in self._tasks:
                    t.cancel()
            await asyncio.gather(*self._tasks, return_exceptions=True)
        # stop every replica even when one died mid-run (stopping at the
        # first error would leak the others' worker threads). A death the
        # router routed around is recorded in replica_errors; losing
        # every replica raises.
        errors: dict[str, Exception] = {}
        for name, srv in self.replicas:
            try:
                await srv.stop(drain=drain)
            except Exception as err:   # noqa: BLE001 — per replica
                errors[name] = err
                log_dist(f"InferenceRouter: replica {name} died: {err}")
        if self.prefill is not None:
            self.prefill.close()
        self.replica_errors = {n: str(e) for n, e in errors.items()}
        if errors and len(errors) == len(self.replicas):
            raise next(iter(errors.values()))

    # -- placement -----------------------------------------------------
    def _place(self, tokens: list[int], record: bool = True):
        """The candidate replicas for one request, best first. Affinity
        first: the replica with the longest cached prefix chain (at least
        ``min_affinity_blocks``) wins; ties and traffic with no affinity
        go least loaded. Replicas over the open-request cap are skipped,
        and those under the drain watermark are kept as a last resort.
        ``record=False`` on backoff re-polls keeps the skip counters
        counting placement decisions, not polls. (The JAX router also
        skips replicas its health detector suspects; that waits for the
        telemetry port.)"""
        cfg = self.config
        rows, drained = [], []
        for name, srv in self.replicas:
            if not srv.accepting:
                continue
            open_ = srv.open_requests
            if cfg.max_open_per_replica \
                    and open_ >= cfg.max_open_per_replica:
                if record:
                    self.stats["backpressure_skips"] += 1
                continue
            row = (name, srv, srv.prefix_affinity(tokens), open_)
            if cfg.drain_free_block_watermark \
                    and srv.free_blocks < cfg.drain_free_block_watermark:
                # the pool is nearly exhausted: let it drain
                if record:
                    self.stats["drain_skips"] += 1
                drained.append(row)
                continue
            rows.append(row)
        if not rows:
            rows = drained
        if not rows:
            return [], "none"
        if max(r[2] for r in rows) >= cfg.min_affinity_blocks:
            rows.sort(key=lambda r: (-r[2], r[3], r[0]))
            rule = "affinity"
        else:
            rows.sort(key=lambda r: (r[3], r[0]))
            rule = "least_loaded"
        return [(n, s) for n, s, _, _ in rows], rule

    # -- request intake ------------------------------------------------
    async def submit(self, prompt: Sequence[int], *,
                     max_new_tokens: Optional[int] = None,
                     priority: Optional[int] = None) -> RoutedHandle:
        """Route one generation request; returns its streaming handle at
        once (placement, the prefill hand-off and any reroutes run in a
        background task)."""
        toks = [int(t) for t in prompt]
        if not toks:
            raise ValueError("submit() needs at least one prompt token")
        uid = next(self._uid)
        handle = RoutedHandle(uid)
        max_new = int(max_new_tokens if max_new_tokens is not None
                      else self.replicas[0][1]
                      .config.default_max_new_tokens)
        task = asyncio.ensure_future(
            self._drive(handle, toks, max_new, priority))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return handle

    async def generate(self, prompt: Sequence[int], **kw) -> list[int]:
        h = await self.submit(prompt, **kw)
        return await h.tokens()

    async def _drive(self, handle: RoutedHandle, prompt: list[int],
                     max_new: int, priority) -> None:
        """One request's whole journey: the optional disaggregated
        prefill, placement, streaming, drain-and-reroute."""
        cfg = self.config
        uid = handle.uid
        got: list[int] = []
        state = None
        try:
            dis = cfg.disaggregation
            if (self.prefill is not None and dis.enabled
                    and len(prompt) >= dis.prefill_threshold_tokens):
                tok0, state = await self.prefill.prefill(uid, prompt)
                self.stats["prefill_handoffs"] += 1
                self.stats["migrated_bytes"] += state.payload_bytes
                got.append(tok0)
                handle._push([tok0])
                eos = self.replicas[0][1].config.eos_token_id
                if max_new <= 1 or (eos is not None and tok0 == eos):
                    # done at prefill: no decode hand-off
                    self.stats["completed"] += 1
                    handle._finish()
                    return
            reroutes = 0
            polls = 0
            failed_on: set[str] = set()
            while True:
                if handle._cancelled:
                    raise _Cancelled()
                cands, rule = self._place(prompt, record=polls == 0)
                polls += 1
                # a replica that just failed this request does not get it
                # straight back; once every one has failed, any may retry
                cands = [(n, s) for n, s in cands
                         if n not in failed_on] or cands
                if not cands:
                    if not any(s.accepting for _, s in self.replicas):
                        raise RequestFailed(
                            "no replica is accepting requests")
                    await asyncio.sleep(cfg.retry_backoff_s)
                    continue
                placed = False
                for name, srv in cands:
                    try:
                        if state is not None:
                            h = await srv.submit_imported(
                                state, max_new_tokens=max_new,
                                priority=priority, uid=uid)
                            state = None
                        elif got:
                            # reroute: the streamed tokens join the
                            # prompt under the same uid, so the stream
                            # resumes where the failed replica left off
                            h = await srv.submit(
                                prompt + got,
                                max_new_tokens=max_new - len(got),
                                priority=priority, uid=uid)
                        else:
                            h = await srv.submit(
                                prompt, max_new_tokens=max_new,
                                priority=priority, uid=uid)
                    except RuntimeError:
                        # the replica refused (queue full, stopping): try
                        # the next candidate
                        self.stats["backpressure_skips"] += 1
                        continue
                    placed = True
                    key = ("routed_affinity" if rule == "affinity"
                           else "routed_least_loaded")
                    self.stats[key] += 1
                    self.placed[name] = self.placed.get(name, 0) + 1
                    handle.replica = name
                    handle._inner = h
                    break
                if not placed:
                    await asyncio.sleep(cfg.retry_backoff_s)
                    continue
                try:
                    async for t in h:
                        got.append(t)
                        handle._push([t])
                    self.stats["completed"] += 1
                    handle._finish()
                    return
                except RequestFailed as err:
                    # drain-and-reroute: the replica rejected or dropped
                    # the request mid-stream; move it on
                    handle._inner = None
                    failed_on.add(name)
                    reroutes += 1
                    self.stats["reroutes"] += 1
                    if reroutes > cfg.reroute_retries:
                        raise RequestFailed(
                            f"request {uid} failed after {reroutes - 1} "
                            f"reroute(s): {err}") from err
        except (_Cancelled, RequestCancelled):
            self.stats["cancelled"] += 1
            handle._finish(error="cancelled")
        except asyncio.CancelledError:
            self.stats["cancelled"] += 1
            handle._finish(error="cancelled")
            raise
        except BaseException as err:   # noqa: BLE001 — on the stream
            self.stats["failed"] += 1
            handle._finish(error=str(err))

    # -- observability -------------------------------------------------
    def metrics(self) -> dict:
        """The router's counters, one row a replica (open requests,
        placements, free blocks, a subset of its serving metrics) and the
        prefill engine's stats."""
        out = dict(self.stats)
        out["replicas"] = {}
        for name, srv in self.replicas:
            m = srv.metrics()
            out["replicas"][name] = {
                "open_requests": srv.open_requests,
                "placed": self.placed.get(name, 0),
                "free_blocks": srv.free_blocks,
                "decoded_tokens": m.get("decoded_tokens", 0),
                "imports": m.get("imports", 0),
                "prefix_hit_rate": m.get("prefix_hit_rate", 0.0),
                "prefill_tokens_saved": m.get("prefill_tokens_saved", 0),
            }
        if self.prefill is not None:
            out["prefill"] = self.prefill.metrics()
        return out


class _Cancelled(Exception):
    """The routed request was cancelled before placement."""
