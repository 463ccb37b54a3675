"""Continuous-batching scheduler over the fused decode loops (counterpart
of ``deepspeed_tpu/inference/v2/serve_loop.py``).

``FusedServeLoop`` is the admission / enqueue / drain scheduler behind
``InferenceEngineV2.generate_fused``: a prompt list is submitted up front
and ``step()`` is called until ``has_work()`` is False. Requests carry a
priority; a higher-priority arrival may preempt a lower-priority one (its
KV blocks are parked, its token history kept on the host and re-admitted
later), and ``cancel`` drops a request at the next dispatch boundary.

Two dispatch disciplines, chosen by the engine's config:

- **chain mode** (default): up to ``max_inflight_dispatches`` fused
  dispatches are in flight; the host drains the oldest one's output while
  newer ones run, since the loop's carry stays in the device operands
  (``fused_graph.FusedState``) and a chained dispatch reads nothing from
  the host.
- **ring mode** (``fused_admission``): dispatches chain through
  ``paged.fused_serve_loop``: waiting prompts are pre-staged (prefilled,
  blocks reserved, one stage a row) and swapped into a finished row
  inside the loop, and sampled tokens gather in a device ring
  (``fused_graph.RingState``) that the host reads once a chain.

With ``speculative.enabled`` either discipline runs the speculative loops
(``paged.fused_spec_decode_loop`` / ``fused_spec_serve_loop``), and every
scheduling decision sizes a dispatch's advance as ``k * (1 +
draft_len)``. ``set_chain_depth`` and ``set_draft_len`` adjust the chain
depth and toggle drafting between chains.

``submit_imported`` queues a migrated sequence (a ``KVExportState`` from
another engine's ``export_request``): its KV lands in this engine's pools
when it is admitted, and it joins the fused loop with no prefill pass,
the decode half of disaggregated serving.

The loop is single-threaded: callers run ``submit``/``cancel`` on the
thread that runs ``step()`` (``serving.AsyncInferenceServer`` does this
through a mailbox).
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ...ops import threefry

# scheduler-level counters, the JAX loop's schema ("imports" counts the
# migrated sequences admitted through submit_imported)
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
    # a KVExportState awaiting admission, imported the first time the
    # request is admitted; a later preemption restores by re-prefill from
    # the host-side history, like any parked request
    kv_import: Optional[object] = None
    # re-emit the already generated suffix at admission (closed-loop
    # callers; the router streams it itself before the hand-off)
    emit_carried: bool = False
    # admitted by import this round: the prefill pass skips it (its one
    # pending token is the next fused dispatch's input)
    was_imported: bool = False

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
    default to the engine config and hold for the loop's lifetime.
    ``host_reads`` counts the blocking device-to-host reads of decoded
    tokens: one a dispatch in chain mode, one a chain in ring mode."""

    def __init__(self, engine, *, k_steps: Optional[int] = None,
                 temperature: Optional[float] = None,
                 top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 eos_id: Optional[int] = None, seed: int = 0,
                 strict: bool = False, preemption: bool = True,
                 replica: str = ""):
        cfg = engine._config
        self.e = engine
        # the serving replica's label (the JAX loop stamps it on the
        # request traces it admits; the port keeps it for the metrics)
        self.replica = str(replica)
        self.k = max(1, int(k_steps if k_steps is not None
                            else (cfg.fused_decode_steps or 8)))
        (self.temperature, self.top_k, self.top_p,
         self.eos) = engine._sampling_args(temperature, top_k, top_p,
                                           eos_id)
        self.seed = int(seed)
        self.strict = bool(strict)
        self.preemption = bool(preemption)
        self.depth = max(1, int(cfg.max_inflight_dispatches))
        # the configured depth is the ceiling set_chain_depth may not pass,
        # so the ring sized from it always suffices
        self.max_depth = self.depth
        self.ring_mode = bool(cfg.fused_admission)
        # the configured draft length is the only nonzero value:
        # set_draft_len toggles between it and 0
        self._draft_cfg = (int(cfg.speculative.draft_len)
                           if cfg.speculative.enabled else 0)
        self._pending_draft: Optional[int] = None
        if self.ring_mode:
            # sized for the largest family's advance, so depth and draft
            # changes never change a state's shapes
            self.ring_cap = self.k * self.max_depth * (1 + self._draft_cfg)
        self._bind_fn(self._draft_cfg)
        self.waiting: list[ServeRequest] = []
        self.live: dict[int, ServeRequest] = {}
        self.staged: dict[int, ServeRequest] = {}   # ring mode only
        self.infl: deque = deque()
        self.to_flush: list[int] = []
        self.counters = dict.fromkeys(LOOP_COUNTER_KEYS, 0)
        self.host_reads = 0
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

    def _bind_fn(self, draft_len: int) -> None:
        """Bind the dispatch functions of ``draft_len``'s family (0 =
        plain decode): the engine's ``_fused_fn``/``_spec_fn`` in chain
        mode, ``_serve_fn``/``_spec_serve_fn`` in ring mode."""
        e = self.e
        self.draft_len = int(draft_len)
        self.spec = self.draft_len > 0
        if self.ring_mode:
            self.fn = e._spec_serve_fn if self.spec else e._serve_fn
        else:
            self.fn = e._spec_fn if self.spec else e._fused_fn

    # ------------------------------------------------------------------
    # runtime knobs, applied between chains; neither changes a shape
    def set_chain_depth(self, depth: int) -> int:
        """Set the live chain depth, clamped to [1, the configured
        ``max_inflight_dispatches``]; effective at once (depth bounds
        only the host's enqueue loops)."""
        self.depth = max(1, min(int(depth), self.max_depth))
        return self.depth

    def set_draft_len(self, draft_len: int) -> int:
        """Ask for drafting off (0) or on (any nonzero value: the
        configured draft length, the only other family). Applied at the
        next chain boundary, since in-flight dispatches and the carry
        belong to the current family. Returns the value in effect once
        it applies."""
        want = self._draft_cfg if int(draft_len) > 0 else 0
        self._pending_draft = None if want == self.draft_len else want
        return want

    def _apply_pending_draft(self) -> None:
        """Apply :meth:`set_draft_len` once nothing is in flight: every
        device commit has landed, so dropping the carry and rebuilding
        the operands under the other family replays nothing."""
        if self._pending_draft is None or self.infl:
            return
        self._carry = None
        self._bind_fn(self._pending_draft)
        self._pending_draft = None

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

    def submit_imported(self, state, max_new_tokens: int = 32, *,
                        priority: int = 1, uid: Optional[int] = None,
                        emit_carried: bool = False) -> int:
        """Queue a migrated sequence (a :class:`~.ragged.KVExportState`
        from another engine's ``export_request``): the external-prefill
        admission path. Its KV payload is imported at admission, not
        here, so a queued hand-off holds no pool blocks while it waits;
        once admitted it joins the fused loop position-exactly with no
        prefill pass (greedy continuation is bit-identical to a
        co-located run). ``emit_carried`` re-emits the already generated
        suffix as the request's first TokenEvent. ``max_new_tokens`` is
        the request's whole generation budget, carried tokens
        included."""
        toks = [int(t) for t in state.tokens]
        n_gen = int(state.n_generated)
        prompt = toks[:len(toks) - n_gen]
        generated = toks[len(toks) - n_gen:]
        if not prompt:
            raise ValueError(
                "submit_imported() needs at least one prompt token")
        max_new = max(1, int(max_new_tokens))
        if max_new <= n_gen:
            raise ValueError(
                f"imported request already generated {n_gen} of "
                f"{max_new} tokens — nothing left to decode (finish "
                "such requests without a hand-off)")
        if uid is None:
            uid = next(self._uid)
        self.waiting.append(ServeRequest(
            uid=int(uid), prompt=prompt, max_new_tokens=max_new,
            priority=int(priority), order=next(self._order),
            generated=generated, kv_import=state,
            emit_carried=bool(emit_carried)))
        return int(uid)

    def cancel(self, uid: int) -> None:
        """Drop a request mid-stream; its KV blocks are released at the
        next dispatch boundary."""
        self._cancelled.add(int(uid))

    def has_work(self) -> bool:
        return bool(self.waiting or self.live or self.staged or self.infl
                    or self.to_flush or self._cancelled)

    # ------------------------------------------------------------------
    def step(self) -> list[TokenEvent]:
        """One scheduler iteration: boundary housekeeping (flush, cancel,
        preempt, admit, prefill), then enqueue up to the chain depth and
        drain. Returns the tokens decoded this iteration; an empty list
        means the loop is idle or waiting for admission headroom."""
        ev: list[TokenEvent] = []
        self._apply_pending_draft()
        if not self.has_work():
            return ev
        try:
            if self.ring_mode:
                self._step_ring(ev)
            else:
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
        for _, result, _ in self.infl:
            try:
                result.read()
            except Exception:   # noqa: BLE001 — best-effort drain
                pass
        self.infl.clear()
        self._carry = None
        if self.e.device.type == "cuda":
            # a ring chain in flight writes through the stage tables too
            try:
                torch.cuda.synchronize(self.e.device)
            except Exception:   # noqa: BLE001 — best-effort drain
                pass
        for u in set(self.live) | set(self.staged) | set(self.to_flush):
            self.e.flush(u)
        self.live.clear()
        self.staged.clear()
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
            req = self.live.pop(uid, None) or self.staged.pop(uid, None)
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

    def _finish(self, uid: int, ev: list[TokenEvent],
                staged: bool = False) -> None:
        (self.staged if staged else self.live).pop(uid, None)
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
            # ring mode also admits pre-staged requests past max_live, at
            # most one a decode row: prefilled and reserved now, swapped
            # into a finished row's slot on the device. Recomputed each
            # pass: preemption frees rows mid-pass.
            stage_from = max_live - len(self.live)
            n_to_live = min(len(batch), stage_from)
            n_to_stage = len(batch) - n_to_live
            n_rows_after = len(self.live) + n_to_live
            req = self.waiting[0]
            if n_to_live >= stage_from and not (
                    self.ring_mode
                    and len(self.staged) + n_to_stage < n_rows_after):
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
        stage_from = max_live - len(self.live)
        fresh = [r for r in batch if r.kv_import is None]
        if fresh:
            e.schedule([r.uid for r in fresh],
                       [r.admission_tokens for r in fresh])
        # the whole batch joins the tracked sets before importing and
        # reserving: a failure mid-batch leaves every scheduled uid in
        # sight of the block-leak guard
        for i, r in enumerate(batch):
            if self.ring_mode and i >= stage_from:
                self.staged[r.uid] = r
            else:
                self.live[r.uid] = r
        for r in [r for r in batch if r.kv_import is not None]:
            # external-prefill admission: the migrated KV lands now,
            # position-exact, with no prefill pass
            state, r.kv_import = r.kv_import, None
            try:
                e.import_request(r.uid, state)
            except (RuntimeError, ValueError) as err:
                # a layout mismatch fails the request, not the loop
                self.live.pop(r.uid, None)
                self.staged.pop(r.uid, None)
                batch.remove(r)
                ev.append(TokenEvent(r.uid, [], finished=True,
                                     error=str(err)))
                continue
            r.was_imported = True
            self.counters["imports"] += 1
            if r.emit_carried and r.generated:
                ev.append(TokenEvent(r.uid, list(r.generated)))
        if not batch:
            return []
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
        """Blocks one admission takes from the headroom: a migrated
        request allocates its full history fresh at import, with no
        prefix-cache credit; any other gets the cache-credited cost."""
        if req.kv_import is not None:
            return need
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
        victims = sorted(
            (r for r in (*self.staged.values(), *self.live.values())
             if r.priority > req.priority),
            key=lambda r: (-r.priority, -r.order))
        if not victims:
            return False
        mgr = self.e.state_manager
        for v in victims:
            freed_before = mgr.available_blocks
            mgr.park(v.uid)
            self.staged.pop(v.uid, None)
            self.live.pop(v.uid, None)
            v.preemptions += 1
            # a once-imported victim restores by the normal re-prefill
            # (its KV left the pool with the park)
            v.was_imported = False
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
        # imported admissions arrive at the dispatch-boundary state (one
        # pending token, the first token made on the exporting side):
        # prefilling them would consume their dispatch input
        filling = []
        for u in uids_new:
            req = self.live.get(u) or self.staged.get(u)
            if req is not None and not req.was_imported:
                filling.append(u)
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
            req = self.live.get(u) or self.staged.get(u)
            req.generated.append(tok)
            e.serving_stats["decoded_tokens"] += 1
            ev.append(TokenEvent(u, [tok]))
            if req.budget <= 0 or (self.eos is not None
                                   and tok == self.eos):
                self._finish(u, ev, staged=u in self.staged)
            else:
                # the first token is the first dispatch's pending input
                # (blocks reserved at admission)
                mgr.extend(u, [tok])

    def _commit(self, uid: int, req: ServeRequest, seg: list[int],
                ev: list[TokenEvent]) -> None:
        """Commit ``seg``, tokens the device decoded for ``uid``, and
        stream them."""
        stats = self.e.serving_stats
        self.e.state_manager.commit_device_tokens(uid, seg)
        req.generated.extend(seg)
        stats["decoded_tokens"] += len(seg)
        stats["fused_slot_tokens"] += len(seg)
        if not self.spec:
            # one token a live slot; the spec loops count their live
            # slots on the device
            stats["fused_live_slots"] += len(seg)
        if uid not in self._cancelled:
            ev.append(TokenEvent(uid, seg))

    def _ends(self, uid: int, req: ServeRequest, seg: list[int]) -> bool:
        return (req.budget <= 0 or (self.eos is not None
                                    and seg[-1] == self.eos)
                or uid in self._cancelled)

    def _drained(self, n_exec: int, rows: int) -> None:
        stats = self.e.serving_stats
        stats["fused_steps"] += n_exec
        stats["fused_slots"] += n_exec * rows
        now = time.perf_counter()
        self.drain_stats.append((now - self._last_drain_t, n_exec))
        self._last_drain_t = now
        self.counters["chain_drains"] += 1
        self.host_reads += 1

    # ------------------------------------------------------------------
    # chain mode
    def _step_chain(self, ev: list[TokenEvent]) -> None:
        e = self.e
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
                build = e._spec_operands if self.spec else e._fused_operands
                self._carry = build(self._rowset, self.k, self._budgets,
                                    self.seed)
                self._n_enq = 0
            # the first dispatch after a rebuild always goes; a chained
            # one only when no admission waits and some row's budget can
            # outlast the chain so far (a spec dispatch may advance a row
            # k * (1 + draft_len) tokens)
            most = max(self._budgets.values())
            if self._n_enq > 0 and (
                    self.waiting
                    or most <= self.k * (1 + self.draft_len) * self._n_enq):
                break
            run = self.fn(self._carry, self.k, self.temperature,
                          self.top_k, self.top_p, self.eos)
            result = run()
            self._n_enq += 1
            if not self.infl:
                # chain start: clock drain intervals from here, not from
                # the admission/prefill that preceded it
                self._last_drain_t = time.perf_counter()
            self.infl.append((list(self._rowset), result, self.spec))
            stats["host_dispatches"] += 1
            stats["fused_dispatches"] += 1

        if not self.infl:       # chain declined to enqueue: rebuild
            self._carry = None
            return
        # drain the oldest dispatch (a newer chained one may still run)
        rows, result, spec = self.infl.popleft()
        toks, n_exec = result.read()
        ptrs = None
        if spec:
            ptrs, spec_stats = result.spec()
            e._absorb_spec_stats(spec_stats)
        self._drained(n_exec, len(rows))
        membership_changed = False
        for i, u in enumerate(rows):
            req = self.live.get(u)
            if req is None:       # finished in an earlier dispatch
                continue
            row = [int(t) for t in (toks[i, :ptrs[i]] if spec else toks[i])
                   if t >= 0]
            if not row:
                continue
            self._commit(u, req, row, ev)
            if self._ends(u, req, row):
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

    # ------------------------------------------------------------------
    # ring mode: admission inside the loop, one host read a chain
    def _step_ring(self, ev: list[TokenEvent]) -> None:
        stats = self.e.serving_stats
        ids = self._boundary(ev)
        if not self.live and self.staged:
            # every decode row finished while stages survived: promote
            # them (prefilled and reserved, they are valid decode rows)
            for uid in sorted(self.staged):
                self.live[uid] = self.staged.pop(uid)
        if not self.live:
            if self.waiting and not ids:
                self._handle_stuck(ev)
            return
        rowset = sorted(self.live)
        budgets = {u: self.live[u].budget for u in rowset}
        # one stage a row, bound to the rows likeliest to free first
        # (smallest budget left)
        stage_map: dict[int, int] = {}
        if self.staged:
            by_budget = sorted(range(len(rowset)),
                               key=lambda i: budgets[rowset[i]])
            for i, su in zip(by_budget, sorted(self.staged)):
                stage_map[i] = su
        state = self._serve_operands(rowset, budgets, stage_map)
        # the chain's length from the largest budget a row may still use,
        # its staged occupant's included. With eos_id set, rows may end
        # early and a chain's tail dispatches run no live tick: checking
        # before each would cost the host read this mode removes.
        eff = max(budgets[u] + (self.staged[stage_map[i]].budget
                                if i in stage_map else 0)
                  for i, u in enumerate(rowset))
        adv = self.k * (1 + self.draft_len)
        chain_len = max(1, min(self.depth, -(-eff // adv)))
        if self.waiting:
            # prompts wait for a host-side admission: keep the chain short
            chain_len = 1
        self._last_drain_t = time.perf_counter()
        for _ in range(chain_len):
            run = self.fn(state, self.k, self.temperature, self.top_k,
                          self.top_p, self.eos)
            run()
            stats["host_dispatches"] += 1
            stats["fused_dispatches"] += 1
        self._drain_ring(ev, rowset, stage_map, state)

    def _drain_ring(self, ev: list[TokenEvent], rowset: list[int],
                    stage_map: dict[int, int], state) -> None:
        """The chain's one host read: ring tokens and epochs, the pointers
        and each row's final epoch, attributed to the row's occupants
        (epoch 0 the row's uid, epoch 1 its staged request, swapped in on
        the device). In spec mode ``ring_ptr`` is per row and the chain's
        spec counters come along."""
        e = self.e
        rd = state.read()
        spec = state.draft_len > 0
        if spec:
            e._absorb_spec_stats(rd["spec_stats"])
        self._drained(int(rd["chain_steps"]), len(rowset))
        toks, eps, ep_fin = rd["ring"], rd["ring_epochs"], rd["epoch"]
        for i, u0 in enumerate(rowset):
            owners = [u0] + ([stage_map[i]] if i in stage_map else [])
            cols = int(rd["ring_ptr"][i] if spec else rd["ring_ptr"])
            for e_idx, uid in enumerate(owners):
                seg = [int(t) for t, ep in zip(toks[i, :cols], eps[i, :cols])
                       if ep == e_idx and t >= 0]
                staged = e_idx > 0
                req = (self.staged if staged else self.live).get(uid)
                if req is None or not seg:
                    continue
                self._commit(uid, req, seg, ev)
                if staged and int(ep_fin[i]) >= 1:
                    # the stage was taken on the device: the request now
                    # owns the row
                    self.live[uid] = self.staged.pop(uid)
                if self._ends(uid, req, seg):
                    self._finish(uid, ev)

    def _serve_operands(self, rowset: list[int], budgets: dict[int, int],
                        stage_map: dict[int, int]):
        """Host-side build of a ring-mode chain's operands, loaded into
        the bucket's :class:`~.fused_graph.RingState`: the rows as a
        chain-mode dispatch builds them (pending checks, reservation,
        buckets, key rows), each row's staged token, position, budget, key
        row and table row, and (spec) both history windows. The tables
        take one power-of-two width covering live and staged rows (a
        staged table cut below its own blocks would clamp its writes)."""
        e, mgr, k = self.e, self.e.state_manager, self.k
        if self.spec:
            e._reserve_spec(rowset, k, budgets)
        bb, host, max_blocks = e._dispatch_rows(rowset, k, budgets,
                                                self.seed)
        s_tok = np.zeros((bb,), np.int64)
        s_pos = np.zeros((bb,), np.int32)
        s_rem = np.zeros((bb,), np.int32)
        s_valid = np.zeros((bb,), bool)
        stage_tables: dict[int, np.ndarray] = {}
        for i, su in stage_map.items():
            sq = mgr.seqs[su]
            if sq.pending != 1:
                raise RuntimeError(
                    f"fused serve: staged sequence {su} must have exactly "
                    f"one pending token, got {sq.pending}")
            s_tok[i] = sq.tokens[-1]
            s_pos[i] = sq.seen
            s_rem[i] = self.staged[su].budget
            s_valid[i] = s_rem[i] > 0
            stage_tables[i] = mgr.block_table(sq)
            max_blocks = max(max_blocks, len(sq.blocks))
        kb = e._table_width(max_blocks)
        fallback = np.full((mgr.max_blocks_per_seq,),
                           mgr.allocator.num_blocks, np.int32)
        s_tab = np.stack([stage_tables.get(i, fallback)
                          for i in range(bb)])[:, :kb]
        s_ids = [stage_map.get(i, (1 << 30) + bb + i) for i in range(bb)]
        s_keys = threefry.fold_in(e._base_key(self.seed),
                                  torch.tensor(s_ids, dtype=torch.int64))
        host.update(tables=host["tables"][:, :kb],
                    epoch=np.zeros((bb,), np.int32), stage_tokens=s_tok,
                    stage_pos=s_pos, stage_rem=s_rem, stage_keys=s_keys,
                    stage_tables=s_tab, stage_valid=s_valid)
        if self.spec:
            hw = int(e._config.speculative.history_window)
            s_hist = np.full((bb, hw), -1, np.int64)
            for i, su in stage_map.items():
                s_hist[i] = mgr.history_tail(su, hw)
            host.update(hist=e._history_rows(rowset, bb), stage_hist=s_hist)
        state = e._ring_state(bb, kb, self.ring_cap, self.draft_len)
        state.load(**host)
        return state
