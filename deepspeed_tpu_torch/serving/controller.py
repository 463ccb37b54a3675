"""Online serving feedback controller (counterpart of
``deepspeed_tpu/serving/controller.py``).

A small state machine on the server's worker thread, stepped every
``ControllerConfig.interval_s`` (so every knob it turns is single-threaded
with the serve loop's ``step()``). It reads SLO burn rates, the queue-wait
and ITL p99s, and the server's open-request count (the signal that needs
no telemetry), and moves three knobs in a fixed order:

1. **admission**: tighten the live shed depth (fast-fail at the queue,
   counted, never a silent drop);
2. **chain depth**: step ``max_inflight_dispatches`` down (deep chains
   amortize host round trips at low load, but only admit at their
   boundary);
3. **draft length**: toggle speculative drafting off (drafts pay verify
   compute and KV reserve exactly when capacity binds).

Recovery relaxes in reverse order, and only after ``step_up_after``
consecutive healthy intervals (hysteresis: jittered load cannot flap the
knobs). The controller never raises a knob above its configured value.
Pure host-side logic. The burn-rate and percentile signals and the
decision counters of the JAX controller live in telemetry, which the port
does not have yet (ROADMAP port item 15): :func:`read_server_signals`
reads the open-request signal only."""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

from .config import ControllerConfig

# knob identifiers in step-down priority order
_KNOB_SHED = "shed"
_KNOB_DEPTH = "depth"
_KNOB_DRAFT = "draft"


@dataclasses.dataclass
class Signals:
    """One interval's controller inputs. ``None`` means the signal is
    unavailable (telemetry off / no samples yet) — the controller
    treats missing signals as healthy rather than guessing."""

    burn_rate: Optional[float] = None       # SLO breaches per request
    queue_wait_p99_ms: Optional[float] = None
    itl_p99_ms: Optional[float] = None
    open_requests: int = 0
    shed_depth: int = 0                     # live admission bound (0=off)
    slo_ttft_ms: float = 0.0
    slo_itl_ms: float = 0.0


@dataclasses.dataclass
class Action:
    """One controller decision, kept in a bounded in-memory log (the
    bench reads it for the adaptation-events table)."""

    t: float
    action: str                  # e.g. "shed_tighten", "depth_down"
    knob: str
    value: int
    reason: str


class ServingController:
    """See module docstring. Drive with :meth:`update` (pure, fake-
    clock testable) or :meth:`maybe_step` (production cadence gate).
    The host object wires the knobs via callables so the controller
    stays importable without a server/engine."""

    def __init__(self, cfg: ControllerConfig, *,
                 chain_depth: int = 1, draft_len: int = 0,
                 shed_depth: int = 0,
                 set_shed_depth: Optional[Callable[[int], Any]] = None,
                 set_chain_depth: Optional[Callable[[int], Any]] = None,
                 set_draft_len: Optional[Callable[[int], Any]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg
        self.clock = clock
        # configured ceilings — the controller retreats from these and
        # returns to them, never past them
        self.max_chain_depth = max(1, int(chain_depth))
        self.max_draft_len = max(0, int(draft_len))
        self.base_shed_depth = int(shed_depth)  # 0 = shedding off at rest
        # live knob values
        self.chain_depth = self.max_chain_depth
        self.draft_len = self.max_draft_len
        self.shed_depth = self.base_shed_depth
        self._set_shed = set_shed_depth
        self._set_depth = set_chain_depth
        self._set_draft = set_draft_len
        self._healthy_streak = 0
        self._next_t = 0.0
        self.actions: list[Action] = []
        self._counts: dict[str, int] = {}

    # -- metrics -------------------------------------------------------
    def _record(self, action: str, knob: str, value: int,
                reason: str) -> Action:
        act = Action(self.clock(), action, knob, int(value), reason)
        self.actions.append(act)
        if len(self.actions) > 512:
            del self.actions[:256]
        self._counts[action] = self._counts.get(action, 0) + 1
        return act

    def action_counts(self) -> dict[str, int]:
        return dict(self._counts)

    # -- knob plumbing -------------------------------------------------
    def _apply(self, knob: str, value: int) -> None:
        if knob == _KNOB_SHED:
            self.shed_depth = int(value)
            if self._set_shed is not None:
                self._set_shed(self.shed_depth)
        elif knob == _KNOB_DEPTH:
            self.chain_depth = int(value)
            if self._set_depth is not None:
                self._set_depth(self.chain_depth)
        elif knob == _KNOB_DRAFT:
            self.draft_len = int(value)
            if self._set_draft is not None:
                self._set_draft(self.draft_len)

    # -- signal classification -----------------------------------------
    def _queue_pressure(self, sig: Signals) -> Optional[str]:
        """Reason string when admission is the bottleneck."""
        c = self.cfg
        if sig.queue_wait_p99_ms is not None and sig.slo_ttft_ms > 0:
            lim = sig.slo_ttft_ms * c.queue_wait_frac
            if sig.queue_wait_p99_ms > lim:
                return (f"queue_wait p99 {sig.queue_wait_p99_ms:.0f}ms"
                        f" > {lim:.0f}ms")
        # telemetry-free fallback: open requests far beyond the live
        # admission bound means the mailbox is aging work
        bound = sig.shed_depth or self.shed_depth \
            or self.base_shed_depth or c.max_shed_depth
        if sig.open_requests > 2 * bound:
            return (f"{sig.open_requests} open > 2x admission bound "
                    f"{bound}")
        return None

    def _saturated(self, sig: Signals) -> Optional[str]:
        """Reason string when decode itself is past the SLO."""
        c = self.cfg
        if (sig.itl_p99_ms is not None and sig.slo_itl_ms > 0
                and sig.itl_p99_ms > sig.slo_itl_ms * c.saturation_ratio):
            return (f"ITL p99 {sig.itl_p99_ms:.1f}ms > "
                    f"{sig.slo_itl_ms * c.saturation_ratio:.1f}ms")
        return None

    def _burning(self, sig: Signals) -> bool:
        return (sig.burn_rate is not None
                and sig.burn_rate > self.cfg.burn_high)

    def _healthy(self, sig: Signals) -> bool:
        if sig.burn_rate is not None and sig.burn_rate > self.cfg.burn_low:
            return False
        return (self._queue_pressure(sig) is None
                and self._saturated(sig) is None)

    # -- the state machine ---------------------------------------------
    def update(self, sig: Signals) -> Optional[Action]:
        """One controller interval over explicit signals. At most ONE
        knob moves per interval (small steps + hysteresis beat a fast
        multi-knob grab — the classic AIMD discipline). Returns the
        action taken, if any."""
        c = self.cfg
        pressure = self._queue_pressure(sig)
        saturated = self._saturated(sig)
        burning = self._burning(sig)

        if pressure is not None or (burning and saturated is None):
            # admission first: shed at the queue before touching the
            # decode path (fast-fail > silent aging)
            self._healthy_streak = 0
            cur = self.shed_depth or c.max_shed_depth
            nxt = max(c.min_shed_depth, cur // 2)
            if self.shed_depth == 0 or nxt < self.shed_depth:
                self._apply(_KNOB_SHED, nxt)
                a = self._record("shed_tighten", _KNOB_SHED, nxt,
                                 pressure or "SLO burn high")
                return a
            # admission already at the floor: fall through to the
            # decode-path knobs only if decode is actually saturated
            if saturated is None:
                return None

        if saturated is not None and (burning or pressure is not None
                                      or sig.burn_rate is None):
            self._healthy_streak = 0
            if self.chain_depth > c.min_chain_depth:
                nxt = max(c.min_chain_depth, self.chain_depth - 1)
                self._apply(_KNOB_DEPTH, nxt)
                return self._record("depth_down", _KNOB_DEPTH, nxt,
                                    saturated)
            if self.draft_len > c.min_draft_len:
                self._apply(_KNOB_DRAFT, c.min_draft_len)
                return self._record("draft_off", _KNOB_DRAFT,
                                    c.min_draft_len, saturated)
            return None

        if not self._healthy(sig):
            # neither tripping nor healthy: the hysteresis band — hold
            # every knob and reset nothing gently (streak keeps
            # building only on genuinely healthy intervals)
            self._healthy_streak = 0
            return None

        self._healthy_streak += 1
        if self._healthy_streak < c.step_up_after:
            return None
        # one relax step, REVERSE priority: drafts back on, depth back
        # up, admission loosened last (the knob most likely to re-trip)
        self._healthy_streak = 0
        if self.draft_len < self.max_draft_len:
            self._apply(_KNOB_DRAFT, self.max_draft_len)
            return self._record("draft_on", _KNOB_DRAFT,
                                self.max_draft_len, "recovered")
        if self.chain_depth < self.max_chain_depth:
            nxt = min(self.max_chain_depth, self.chain_depth + 1)
            self._apply(_KNOB_DEPTH, nxt)
            return self._record("depth_up", _KNOB_DEPTH, nxt,
                                "recovered")
        if self.shed_depth != self.base_shed_depth:
            cur = self.shed_depth
            nxt = min(cur * 2, self.base_shed_depth or c.max_shed_depth)
            if self.base_shed_depth == 0 and nxt >= c.max_shed_depth:
                nxt = 0         # fully recovered: shedding back off
            self._apply(_KNOB_SHED, nxt)
            return self._record("shed_relax", _KNOB_SHED, nxt,
                                "recovered")
        return None

    def maybe_step(self, read_signals: Callable[[], Signals]) -> \
            Optional[Action]:
        """Production entry: rate-limit to ``interval_s``, read the
        signals, run one :meth:`update`. Called from the server's
        worker-thread beat."""
        now = self.clock()
        if now < self._next_t:
            return None
        self._next_t = now + self.cfg.interval_s
        return self.update(read_signals())


def read_server_signals(server, tel=None) -> Signals:
    """Assemble :class:`Signals` from a live
    :class:`~.server.AsyncInferenceServer`: the open-request count, the
    live admission bound and the SLO targets. The burn-rate and
    percentile signals come from telemetry (``tel``), which the port does
    not have yet, so they stay ``None`` and the controller treats them as
    healthy. Runs on the worker thread."""
    cfg = server.config
    sig = Signals(open_requests=int(getattr(server, "_open", 0)),
                  shed_depth=int(getattr(server, "_shed_depth", 0)),
                  slo_ttft_ms=float(cfg.slo_ttft_ms),
                  slo_itl_ms=float(cfg.slo_itl_ms))
    if tel is not None:
        raise NotImplementedError(
            "read_server_signals: the telemetry signals (burn rate, "
            "queue-wait and ITL p99) are not ported to deepspeed_tpu_torch "
            "yet (ROADMAP.md, port Queue 1: item 15, Slice G)")
    return sig
