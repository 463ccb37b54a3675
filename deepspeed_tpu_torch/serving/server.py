"""Async continuous-batching serving front end (counterpart of
``deepspeed_tpu/serving/server.py``; the FastGen/MII serving layer over
``InferenceEngineV2``).

``AsyncInferenceServer`` runs the shared scheduler
(:class:`~..inference.v2.serve_loop.FusedServeLoop`, the driver behind
``generate_fused``) on a worker thread of its own and exposes an asyncio
surface:

- ``await server.submit(prompt, ...)`` returns a :class:`RequestHandle`
  that async-iterates the request's tokens as the worker lands them;
- priority tiers (lower runs first) with optional preemption: a
  high-priority prompt that cannot be admitted parks strictly
  lower-priority running requests (KV blocks swapped out, prefix-cached
  full blocks kept warm, the history kept on the host); they resume
  position-exactly;
- ``handle.cancel()`` releases the request's KV blocks at the next
  dispatch boundary;
- ``submit_imported`` takes a migrated sequence (the decode half of
  disaggregated serving, see ``router.py``);
- an admission bound (``shed_queue_depth``) that the optional
  :class:`~.controller.ServingController` moves at run time.

The worker thread owns every engine call (on the card: every kernel
launch, graph replay and pool write of this engine happens on that
thread's current stream, in order); the asyncio side only exchanges
messages with it through a mailbox, so the event loop never waits on the
device. The JAX server's per-step telemetry (the flight-recorder
heartbeat, the health monitor's beat, the request traces) waits for the
telemetry port (ROADMAP port item 15).
"""

from __future__ import annotations

import asyncio
import itertools
import threading
import time
from collections import deque
from typing import Optional, Sequence

from ..inference.v2.serve_loop import FusedServeLoop, TokenEvent
from ..utils.logging import log_dist
from .config import ServingConfig

_DONE = object()


class RequestCancelled(Exception):
    """Raised by the stream iterator of a cancelled request."""


class RequestFailed(Exception):
    """Raised by the stream iterator when the scheduler rejected the
    request (a prompt that can never fit the KV pool, a shed submit, a
    failed import) or the serving loop died."""


class RequestHandle:
    """Per-request streaming handle: ``async for tok in handle`` yields int
    token ids as they decode; ``await handle.tokens()`` collects the whole
    generation. Made by :meth:`AsyncInferenceServer.submit`."""

    def __init__(self, uid: int, server: "AsyncInferenceServer"):
        self.uid = uid
        self._server = server
        self._q: asyncio.Queue = asyncio.Queue()
        self._buf: deque = deque()
        self._finished = False
        self.error: Optional[str] = None
        self.submitted_at = time.perf_counter()

    # worker -> event loop (always through call_soon_threadsafe)
    def _push(self, evt: TokenEvent) -> None:
        if evt.tokens:
            self._q.put_nowait(list(evt.tokens))
        if evt.finished:
            self.error = evt.error
            self._q.put_nowait(_DONE)

    def __aiter__(self):
        return self

    async def __anext__(self) -> int:
        while not self._buf:
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
            self._buf.extend(item)
        return self._buf.popleft()

    async def tokens(self) -> list[int]:
        """Collect the rest of the stream into one list."""
        return [t async for t in self]

    def cancel(self) -> None:
        """Drop the request; its KV blocks are released at the next
        dispatch boundary and the stream raises :class:`RequestCancelled`."""
        self._server._post(("cancel", self.uid))


class AsyncInferenceServer:
    """See the module docstring. Typical use::

        engine = build_engine("llama", "3-8b", {"dtype": "bf16", ...})
        async with AsyncInferenceServer(engine) as server:
            h = await server.submit(prompt_ids, max_new_tokens=256)
            async for tok in h:
                ...
    """

    def __init__(self, engine, config=None):
        if config is None:
            config = ServingConfig()
        elif isinstance(config, dict):
            config = ServingConfig.from_dict(config)
        self.engine = engine
        self.config = config
        self._uid = itertools.count()
        self._handles: dict[int, RequestHandle] = {}
        self._mailbox: list[tuple] = []
        self._mail_lock = threading.Lock()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._aloop: Optional[asyncio.AbstractEventLoop] = None
        self._accepting = False
        self._stopping = False
        self._open = 0          # queued + running requests
        # the live admission bound: written by the config at start and by
        # the controller on the worker thread, read by submit() on the
        # event loop (an int: a stale read costs one admit/shed decision)
        self._shed_depth = int(config.shed_queue_depth)
        self._shed_count = 0    # owned by the event-loop thread
        self._controller = None
        self._worker_error: Optional[BaseException] = None
        self.session: Optional[FusedServeLoop] = None

    # ------------------------------------------------------------------
    async def __aenter__(self):
        await self.start()
        return self

    async def __aexit__(self, *exc):
        await self.stop(drain=exc[0] is None)

    async def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("server already started")
        cfg = self.config
        self._aloop = asyncio.get_running_loop()
        self.session = FusedServeLoop(
            self.engine, k_steps=cfg.k_steps,
            temperature=cfg.temperature, top_k=cfg.top_k,
            top_p=cfg.top_p, eos_id=cfg.eos_token_id, seed=cfg.seed,
            strict=False, preemption=cfg.preemption,
            replica=cfg.replica)
        if cfg.controller.enabled:
            # stepped from the worker loop: every knob it turns mutates
            # state the worker owns
            from .controller import ServingController
            self._controller = ServingController(
                cfg.controller,
                chain_depth=self.session.max_depth,
                draft_len=self.session._draft_cfg,
                shed_depth=cfg.shed_queue_depth,
                set_shed_depth=self._set_shed_depth,
                set_chain_depth=self.session.set_chain_depth,
                set_draft_len=self.session.set_draft_len)
        # _accepting is turned off by a dying worker (the losing race
        # costs one submit, which then meets the _worker_error check);
        # _stopping is set by the worker after it reads a stop message
        self._accepting = True
        self._stopping = False
        self._thread = threading.Thread(target=self._work, daemon=True,
                                        name="ds-serving-loop")
        self._thread.start()
        log_dist("AsyncInferenceServer: serving loop started "
                 f"(k={self.session.k}, chain depth "
                 f"{self.session.depth}, "
                 f"{'ring' if self.session.ring_mode else 'chain'} mode)")

    async def stop(self, drain: bool = True) -> None:
        """Shut the serving loop down. ``drain=True`` finishes the
        requests already submitted first; ``drain=False`` cancels them.
        An error that killed the worker is raised here."""
        if self._thread is None:
            return
        self._accepting = False
        if not drain:
            for h in list(self._handles.values()):
                h.cancel()
        self._post(("stop",))
        await self._aloop.run_in_executor(None, self._thread.join)
        self._thread = None
        if self._worker_error is not None:
            raise self._worker_error

    def _admit_handle(self, max_new_tokens, priority, uid):
        """Submit-side bookkeeping shared by both submits: the accept and
        backpressure checks, the shed decision, the handle. Returns
        (handle, max_new, priority, shed); a shed handle is already
        finished (its stream raises ``RequestFailed`` naming the shed) and
        is not posted to the worker."""
        if not self._accepting:
            raise RuntimeError("server is not accepting requests")
        if self._worker_error is not None:
            raise RuntimeError(
                "serving loop died") from self._worker_error
        cfg = self.config
        if cfg.max_queue and self._open >= cfg.max_queue:
            raise RuntimeError(
                f"serving queue full ({self._open} open requests >= "
                f"max_queue {cfg.max_queue})")
        shed_at = self._shed_depth
        if shed_at and self._open >= shed_at:
            # past the bound the request fails fast instead of aging in
            # the mailbox; counted, never silently dropped
            uid = next(self._uid) if uid is None else int(uid)
            handle = RequestHandle(uid, self)
            self._shed_count += 1
            handle._push(TokenEvent(
                uid, [], finished=True,
                error=f"request {uid} shed: {self._open} open requests "
                      f">= admission bound {shed_at}"))
            return handle, None, None, True
        # a caller spanning several replicas (the router) passes its own
        # uid, so one request keeps one uid across hand-off and reroute
        uid = next(self._uid) if uid is None else int(uid)
        if uid in self._handles:
            raise RuntimeError(f"request uid {uid} already open")
        handle = RequestHandle(uid, self)
        self._handles[uid] = handle
        self._open += 1
        max_new = int(max_new_tokens if max_new_tokens is not None
                      else cfg.default_max_new_tokens)
        prio = int(priority if priority is not None
                   else cfg.default_priority)
        return handle, max_new, prio, False

    async def submit(self, prompt: Sequence[int], *,
                     max_new_tokens: Optional[int] = None,
                     priority: Optional[int] = None,
                     uid: Optional[int] = None) -> RequestHandle:
        """Queue one generation request; returns its streaming handle.
        Raises when the server is stopped or ``max_queue`` is reached."""
        toks = [int(t) for t in prompt]
        handle, max_new, prio, shed = self._admit_handle(
            max_new_tokens, priority, uid)
        if not shed:
            self._post(("submit", handle.uid, toks, max_new, prio))
        return handle

    async def submit_imported(self, state, *,
                              max_new_tokens: Optional[int] = None,
                              priority: Optional[int] = None,
                              uid: Optional[int] = None,
                              emit_carried: bool = False
                              ) -> RequestHandle:
        """Queue a migrated sequence (a ``KVExportState`` from another
        engine's ``export_request``), the decode half of a disaggregated
        hand-off: its KV lands in this replica's pools at admission,
        position-exactly. With ``emit_carried`` the already generated
        tokens are emitted again at the head of the stream (the router
        leaves it off: it streamed them during the hand-off)."""
        n_gen = int(state.n_generated)
        if len(state.tokens) - n_gen <= 0:
            raise ValueError(
                "submit_imported() needs at least one prompt token")
        max_new_chk = int(max_new_tokens if max_new_tokens is not None
                          else self.config.default_max_new_tokens)
        if max_new_chk <= n_gen:
            raise ValueError(
                f"imported request already generated {n_gen} of "
                f"{max_new_chk} tokens — finish it without a hand-off")
        handle, max_new, prio, shed = self._admit_handle(
            max_new_tokens, priority, uid)
        if not shed:
            self._post(("submit_imported", handle.uid, state, max_new,
                        prio, bool(emit_carried)))
        return handle

    async def generate(self, prompt: Sequence[int], **kw) -> list[int]:
        """submit() and collect the whole stream."""
        h = await self.submit(prompt, **kw)
        return await h.tokens()

    def kill(self) -> None:
        """Fault injection: the worker dies at its next mailbox read, as
        on an engine fault. Every open handle fails with
        ``RequestFailed`` ("serving loop died"), ``accepting`` turns off
        and ``stop()`` raises the error, so the router's reroute is
        exercised for real."""
        self._post(("die",))

    def metrics(self) -> dict:
        """The engine's serving counters merged with the scheduler's
        (preemptions, restores, cancellations, admitted, chain_drains,
        imports), the open and shed request counts, the replica label and
        the controller's knobs."""
        m = dict(self.engine.serving_metrics())
        if self.session is not None:
            m.update(self.session.counters)
        m["open_requests"] = self._open
        m["shed_requests"] = self._shed_count
        m["replica"] = self.config.replica
        if self._controller is not None:
            m["controller_actions"] = self._controller.action_counts()
            m["controller_chain_depth"] = self._controller.chain_depth
            m["controller_draft_len"] = self._controller.draft_len
            m["controller_shed_depth"] = self._controller.shed_depth
        return m

    def _set_shed_depth(self, depth: int) -> None:
        """The controller's admission knob (written on the worker thread,
        read by submit())."""
        self._shed_depth = int(depth)

    # -- the router's placement probes (host-only reads) ---------------
    @property
    def accepting(self) -> bool:
        """True while submits are admitted (started, not stopping, the
        worker alive)."""
        return bool(self._accepting) and self._worker_error is None

    @property
    def open_requests(self) -> int:
        """Queued + running requests (the router's load signal)."""
        return self._open

    @property
    def free_blocks(self) -> int:
        """This replica's schedulable KV headroom (a read of the worker's
        accounting: a placement hint, not a reservation)."""
        return self.engine.free_blocks

    def prefix_affinity(self, tokens) -> int:
        """Leading full blocks of ``tokens`` this replica's prefix cache
        holds, the router's placement key. The match is walked again by
        the worker at admission, so a stale answer costs placement
        quality, never correctness."""
        return len(self.engine.state_manager.prefix_match(
            [int(t) for t in tokens]))

    # ------------------------------------------------------------------
    def _post(self, msg: tuple) -> None:
        # an append under the mailbox lock; the worker holds it only to
        # swap the list, never around engine work
        with self._mail_lock:
            self._mailbox.append(msg)
        self._wake.set()

    def _emit(self, events: list[TokenEvent]) -> None:
        """Worker -> event loop hand-off (one call a step). Every handle
        and ``_open`` change happens on the event-loop thread, as
        submit() does, so neither needs a lock."""

        def deliver(evts=list(events)):
            for e in evts:
                h = self._handles.get(e.uid)
                if h is not None:
                    h._push(e)
                if e.finished:
                    self._handles.pop(e.uid, None)
                    self._open -= 1

        self._aloop.call_soon_threadsafe(deliver)

    def _work(self) -> None:
        """The worker thread: owns the session and every engine call."""
        s = self.session
        cfg = self.config
        try:
            while True:
                stop = self._drain_mailbox(s)
                if stop and not s.has_work():
                    break
                if not s.has_work():
                    self._control()
                    self._wake.wait(timeout=0.1)
                    self._wake.clear()
                    continue
                events = s.step()
                self._control()
                if events:
                    self._emit(events)
                elif s.has_work():
                    # waiting on admission headroom: back off, no spin
                    time.sleep(cfg.idle_poll_s)
        except BaseException as e:   # noqa: BLE001 — surfaced on stop()
            self._worker_error = e
            self._accepting = False
            fail = [TokenEvent(uid, [], finished=True,
                               error=f"serving loop died: {e}")
                    for uid in list(self._handles)]
            if fail:
                self._emit(fail)
        finally:
            try:
                s.close()
            except Exception:   # noqa: BLE001 — shutdown best-effort
                pass

    def _drain_mailbox(self, s: FusedServeLoop) -> bool:
        with self._mail_lock:
            msgs, self._mailbox = self._mailbox, []
        stop = self._stopping
        for m in msgs:
            if m[0] == "submit":
                _, uid, prompt, max_new, prio = m
                s.submit(prompt, max_new, priority=prio, uid=uid)
            elif m[0] == "submit_imported":
                _, uid, state, max_new, prio, emit = m
                s.submit_imported(state, max_new, priority=prio,
                                  uid=uid, emit_carried=emit)
            elif m[0] == "cancel":
                s.cancel(m[1])
            elif m[0] == "stop":
                stop = self._stopping = True
            elif m[0] == "die":
                raise RuntimeError("fault injection: replica killed")
        return stop

    def _control(self) -> None:
        """One controller interval (rate-limited), on the worker thread:
        the depth and draft knobs change session state the worker owns;
        the shed bound goes back to submit() as an int."""
        c = self._controller
        if c is None:
            return
        from .controller import read_server_signals
        c.maybe_step(lambda: read_server_signals(self))
