"""Continuous-batching scheduler over the fused decode loop (counterpart of
``deepspeed_tpu/inference/v2/serve_loop.py``, chain mode).

``FusedServeLoop`` is the admission / enqueue / drain scheduler behind
``InferenceEngineV2.generate_fused``: a prompt list is submitted up front
and ``step()`` is called until ``has_work()`` is False. Requests carry a
priority; a higher-priority arrival may preempt a lower-priority one (its
KV blocks are parked, its token history kept on the host and re-admitted
later), and ``cancel`` drops a request at the next dispatch boundary.

Chain mode: up to ``max_inflight_dispatches`` fused dispatches are in
flight; the host drains the oldest one's output while newer ones run,
since the loop's carry stays in the device operands
(``fused_graph.FusedState``) and a chained dispatch reads nothing from
the host. Ring mode (``fused_admission``: admission inside the device
loop) and speculative decoding are not ported yet; the engine refuses
both by config.

The loop is single-threaded: callers run ``submit``/``cancel`` on the
thread that runs ``step()``.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

# scheduler-level counters, the JAX loop's schema ("imports" counts
# migrated sequences, which this port does not take yet: it stays 0)
LOOP_COUNTER_KEYS = ("preemptions", "restores", "cancellations",
                     "admitted", "chain_drains", "imports")


@dataclass
class ServeRequest:
    """One in-flight generation request. ``generated`` accumulates across
    preemptions: a restore re-admits ``prompt + generated``, so the
    continuation is position-exact (greedy and position-keyed stochastic
    decode both resume bit-identically)."""
    uid: int
    prompt: list[int]
    max_new_tokens: int
    priority: int = 1
    order: int = 0
    generated: list[int] = field(default_factory=list)
    preemptions: int = 0

    @property
    def budget(self) -> int:
        return self.max_new_tokens - len(self.generated)

    @property
    def admission_tokens(self) -> list[int]:
        return self.prompt + self.generated


@dataclass
class TokenEvent:
    """One emission of :meth:`FusedServeLoop.step`: ``tokens`` newly
    decoded for ``uid`` (may be empty on a pure state change), with
    ``finished`` set on the request's last event; ``error`` says why a
    request ended without running (non-strict mode) or was cancelled."""
    uid: int
    tokens: list[int]
    finished: bool = False
    error: Optional[str] = None


class FusedServeLoop:
    """See the module docstring. Built over a live
    :class:`~.engine_v2.InferenceEngineV2`; the sampling parameters
    default to the engine config and hold for the loop's lifetime."""

    def __init__(self, engine, *, k_steps: Optional[int] = None,
                 temperature: Optional[float] = None,
                 top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 eos_id: Optional[int] = None, seed: int = 0,
                 strict: bool = False, preemption: bool = True):
        cfg = engine._config
        self.e = engine
        self.k = max(1, int(k_steps if k_steps is not None
                            else (cfg.fused_decode_steps or 8)))
        (self.temperature, self.top_k, self.top_p,
         self.eos) = engine._sampling_args(temperature, top_k, top_p,
                                           eos_id)
        self.seed = int(seed)
        self.strict = bool(strict)
        self.preemption = bool(preemption)
        self.depth = max(1, int(cfg.max_inflight_dispatches))
        self.waiting: list[ServeRequest] = []
        self.live: dict[int, ServeRequest] = {}
        self.infl: deque = deque()
        self.to_flush: list[int] = []
        self.counters = dict.fromkeys(LOOP_COUNTER_KEYS, 0)
        # (seconds since the previous drain, decode steps drained): wall a
        # decode step with the chain's host syncs amortized in
        self.drain_stats: list[tuple[float, int]] = []
        self._cancelled: set[int] = set()
        self._order = itertools.count()
        self._uid = itertools.count()
        self._last_drain_t = time.perf_counter()
        # chain state: the loaded operands (the carry between chained
        # dispatches), their rows and budgets, dispatches enqueued on them
        self._carry = None
        self._rowset: list[int] = []
        self._budgets: dict[int, int] = {}
        self._n_enq = 0

    # ------------------------------------------------------------------
    # request intake (single-threaded with step())
    def submit(self, prompt, max_new_tokens: int = 32, *,
               priority: int = 1, uid: Optional[int] = None) -> int:
        """Queue one prompt; returns its uid. Lower ``priority`` values
        run first; ties admit in submission order."""
        toks = [int(t) for t in prompt]
        if not toks:
            raise ValueError("submit() needs at least one prompt token")
        if uid is None:
            uid = next(self._uid)
        self.waiting.append(ServeRequest(
            uid=int(uid), prompt=toks,
            max_new_tokens=max(1, int(max_new_tokens)),
            priority=int(priority), order=next(self._order)))
        return int(uid)

    def cancel(self, uid: int) -> None:
        """Drop a request mid-stream; its KV blocks are released at the
        next dispatch boundary."""
        self._cancelled.add(int(uid))

    def has_work(self) -> bool:
        return bool(self.waiting or self.live or self.infl
                    or self.to_flush or self._cancelled)

    # ------------------------------------------------------------------
    def step(self) -> list[TokenEvent]:
        """One scheduler iteration: boundary housekeeping (flush, cancel,
        preempt, admit, prefill), then enqueue up to the chain depth and
        drain the oldest dispatch. Returns the tokens decoded this
        iteration; an empty list means the loop is idle or waiting for
        admission headroom."""
        ev: list[TokenEvent] = []
        if not self.has_work():
            return ev
        try:
            self._step_chain(ev)
        except BaseException:
            self._emergency_flush()
            raise
        return ev

    def close(self) -> None:
        """Release every request's KV state (server shutdown)."""
        self._emergency_flush()
        self.waiting.clear()
        self._cancelled.clear()

    def _emergency_flush(self) -> None:
        """Block-leak guard: wait for what is in flight (its commits are
        lost, but the device must stop writing through the tables before
        the blocks recycle), then release every scheduled but unfinished
        sequence's KV blocks."""
        for _, result in self.infl:
            try:
                result.read()
            except Exception:   # noqa: BLE001 — best-effort drain
                pass
        self.infl.clear()
        self._carry = None
        for u in set(self.live) | set(self.to_flush):
            self.e.flush(u)
        self.live.clear()
        self.to_flush.clear()

    # ------------------------------------------------------------------
    # boundary housekeeping: runs only with nothing in flight
    def _boundary(self, ev: list[TokenEvent]) -> list[int]:
        assert not self.infl
        for u in self.to_flush:
            self.e.flush(u)
        self.to_flush.clear()
        self._apply_cancels(ev)
        ids = self._admit(ev)
        if ids:
            self._carry = None
            self._prefill(ids, ev)
        return ids

    def _apply_cancels(self, ev: list[TokenEvent]) -> None:
        if not self._cancelled:
            return
        for uid in sorted(self._cancelled):
            req = self.live.pop(uid, None)
            if req is None:
                before = len(self.waiting)
                self.waiting = [r for r in self.waiting if r.uid != uid]
                if len(self.waiting) == before:
                    continue        # unknown or already finished uid
            else:
                self.e.flush(uid)
                self._carry = None  # membership changed mid-rowset
            self.counters["cancellations"] += 1
            ev.append(TokenEvent(uid, [], finished=True,
                                 error="cancelled"))
        self._cancelled.clear()

    def _finish(self, uid: int, ev: list[TokenEvent]) -> None:
        self.live.pop(uid, None)
        self.to_flush.append(uid)
        if uid in self._cancelled:
            self._cancelled.discard(uid)
            self.counters["cancellations"] += 1
            ev.append(TokenEvent(uid, [], finished=True,
                                 error="cancelled"))
        else:
            ev.append(TokenEvent(uid, [], finished=True))

    # ------------------------------------------------------------------
    # admission (+ preemption): the full worst-case block budget (history
    # + remaining new tokens) is allocated up front, because fused
    # dispatches write KV on the device through tables fixed beforehand
    def _admit(self, ev: list[TokenEvent]) -> list[int]:
        e, mgr = self.e, self.e.state_manager
        bs = mgr.block_size
        max_live = e._config.max_ragged_sequence_count
        self.waiting.sort(key=lambda r: (r.priority, r.order))
        batch: list[ServeRequest] = []

        def headroom() -> int:
            return mgr.available_blocks - sum(
                self._admission_cost(mgr, r, self._need(r, bs))
                for r in batch)

        free = mgr.available_blocks
        while self.waiting:
            req = self.waiting[0]
            if len(self.live) + len(batch) >= max_live:
                # decode rows, not blocks, bind: a high-priority arrival
                # may still park a lower-priority occupant for its row
                if self._try_preempt(req, 0, ev, free_rows=True):
                    free = headroom()
                    continue
                break
            need = self._need(req, bs)
            if need > mgr.max_blocks_per_seq or \
                    need > mgr.allocator.num_blocks:
                msg = (f"prompt {req.uid}: {len(req.admission_tokens)} "
                       f"tokens + {req.budget} new can never fit the KV "
                       f"pool (needs {need} blocks)")
                if self.strict:
                    raise ValueError(msg)
                self.waiting.pop(0)
                ev.append(TokenEvent(req.uid, [], finished=True,
                                     error=msg))
                continue
            cost = self._admission_cost(mgr, req, need)
            if cost > free:
                if self._try_preempt(req, cost - free, ev):
                    free = headroom()
                    continue        # re-check the same request
                break
            self.waiting.pop(0)
            free -= cost
            batch.append(req)
        if not batch:
            return []
        e.schedule([r.uid for r in batch],
                   [r.admission_tokens for r in batch])
        for r in batch:
            self.live[r.uid] = r
        for r in batch:
            mgr.reserve(r.uid, r.budget)
        self.counters["admitted"] += len(batch)
        self.counters["restores"] += sum(1 for r in batch
                                         if r.preemptions > 0
                                         and r.generated)
        return [r.uid for r in batch]

    @staticmethod
    def _need(req: ServeRequest, block_size: int) -> int:
        """Blocks a request's history plus its remaining budget fill."""
        return -(-(len(req.admission_tokens) + req.budget) // block_size)

    @staticmethod
    def _admission_cost(mgr, req: ServeRequest, need: int) -> int:
        """Blocks one admission takes from the headroom (prefix-cache
        hits credited)."""
        return mgr.admission_cost(req.admission_tokens, need)

    def _try_preempt(self, req: ServeRequest, short_blocks: int,
                     ev: list[TokenEvent],
                     free_rows: bool = False) -> bool:
        """Park strictly lower-priority requests (KV swap-out: blocks
        released, prefix-cached full blocks kept in the LRU for a warm
        restore, the token history kept here) until ``req`` fits.
        ``free_rows`` parks one victim to free a decode row. Called only
        at a dispatch boundary, so no victim is in flight."""
        if not self.preemption or (short_blocks <= 0 and not free_rows):
            return False
        victims = sorted((r for r in self.live.values()
                          if r.priority > req.priority),
                         key=lambda r: (-r.priority, -r.order))
        if not victims:
            return False
        mgr = self.e.state_manager
        for v in victims:
            freed_before = mgr.available_blocks
            mgr.park(v.uid)
            self.live.pop(v.uid, None)
            v.preemptions += 1
            self.waiting.append(v)
            self.counters["preemptions"] += 1
            self._carry = None
            short_blocks -= mgr.available_blocks - freed_before
            if free_rows or short_blocks <= 0:
                break
        # keep the pass priority-ordered: a parked victim outranks lower
        # waiters for the blocks it freed (FIFO within its tier)
        self.waiting.sort(key=lambda r: (r.priority, r.order))
        return True

    # ------------------------------------------------------------------
    def _prefill(self, uids_new: list[int], ev: list[TokenEvent]) -> None:
        """Chunked prefill of newly admitted prompts, then each one's first
        generated token, sampled with the same op and position keying as
        the device loop, so it belongs to the same stochastic stream."""
        e, mgr = self.e, self.e.state_manager
        filling = [u for u in uids_new if u in self.live]
        firsts: dict = {}
        while filling:
            run = [u for u in filling if mgr.seqs[u].pending]
            logits = e._run(run)
            for i, u in enumerate(run):
                if not mgr.seqs[u].pending:
                    firsts[u] = logits[i]
                    filling.remove(u)
        toks = e.sample_first_tokens(firsts, self.temperature, self.top_k,
                                     self.top_p, self.seed)
        for u, tok in toks.items():
            req = self.live[u]
            req.generated.append(tok)
            e.serving_stats["decoded_tokens"] += 1
            ev.append(TokenEvent(u, [tok]))
            if req.budget <= 0 or (self.eos is not None
                                   and tok == self.eos):
                self._finish(u, ev)
            else:
                # the first token is the first dispatch's pending input
                # (blocks reserved at admission)
                mgr.extend(u, [tok])

    # ------------------------------------------------------------------
    def _step_chain(self, ev: list[TokenEvent]) -> None:
        e, mgr = self.e, self.e.state_manager
        stats = e.serving_stats
        if not self.live and not self.infl:
            self._carry = None
            ids = self._boundary(ev)
            if not self.live and self.waiting and not ids:
                self._handle_stuck(ev)
            return

        while self.live and len(self.infl) < self.depth:
            if self._carry is None and self.infl:
                # a rebuild needs the in-flight dispatch's commits first:
                # stale host state would replay its decode steps
                break
            if self._carry is None:
                self._rowset = sorted(self.live)
                self._budgets = {u: self.live[u].budget
                                 for u in self._rowset}
                self._carry = e._fused_operands(
                    self._rowset, self.k, self._budgets, self.seed)
                self._n_enq = 0
            # the first dispatch after a rebuild always goes; a chained
            # one only when no admission waits and some row's budget
            # outlasts the chain so far
            left = max(self._budgets.values()) - self.k * self._n_enq
            if self._n_enq > 0 and (self.waiting or left <= 0):
                break
            # no row can use more ticks than its budget left
            run = e._fused_fn(self._carry, min(self.k, left),
                              self.temperature, self.top_k, self.top_p,
                              self.eos)
            result = run()
            self._n_enq += 1
            if not self.infl:
                # chain start: clock drain intervals from here, not from
                # the admission/prefill that preceded it
                self._last_drain_t = time.perf_counter()
            self.infl.append((list(self._rowset), result))
            stats["host_dispatches"] += 1
            stats["fused_dispatches"] += 1

        if not self.infl:       # chain declined to enqueue: rebuild
            self._carry = None
            return
        # drain the oldest dispatch (a newer chained one may still run)
        rows, result = self.infl.popleft()
        toks, n_exec = result.read()
        stats["fused_steps"] += n_exec
        stats["fused_slots"] += n_exec * len(rows)
        now = time.perf_counter()
        self.drain_stats.append((now - self._last_drain_t, n_exec))
        self._last_drain_t = now
        self.counters["chain_drains"] += 1
        membership_changed = False
        for i, u in enumerate(rows):
            req = self.live.get(u)
            if req is None:       # finished in an earlier dispatch
                continue
            row = [int(t) for t in toks[i] if t >= 0]
            if not row:
                continue
            mgr.commit_device_tokens(u, row)
            req.generated.extend(row)
            stats["decoded_tokens"] += len(row)
            stats["fused_slot_tokens"] += len(row)
            stats["fused_live_slots"] += len(row)   # one token a slot
            if u not in self._cancelled:
                ev.append(TokenEvent(u, row))
            if (req.budget <= 0
                    or (self.eos is not None and row[-1] == self.eos)
                    or u in self._cancelled):
                self._finish(u, ev)
                membership_changed = True
        if membership_changed or self.waiting:
            # a finished row's slot should go to a waiting prompt:
            # rebuild the operands once the in-flight chain drains
            self._carry = None
        if not self.infl:
            # nothing in flight writes through the old tables: blocks may
            # recycle and prompts admit
            self._boundary(ev)

    def _handle_stuck(self, ev: list[TokenEvent]) -> None:
        """Nothing live or in flight, and the head request did not
        admit."""
        if self.strict:
            raise RuntimeError(
                "continuous-batching deadlock: pending prompts but "
                "nothing admissible")
        mgr = self.e.state_manager
        if not mgr.seqs and self.waiting:
            # the engine is empty and the head request still does not
            # fit: it never will, so fail it instead of spinning
            req = self.waiting.pop(0)
            ev.append(TokenEvent(
                req.uid, [], finished=True,
                error=f"request {req.uid} cannot fit the KV pool even "
                      "with the engine idle"))
