"""Serving front-end configuration (counterpart of
``deepspeed_tpu/serving/config.py``; the analogue of DeepSpeed-MII's
deployment config).

The JAX blocks are pydantic models; here they are dataclasses on the
port's ``DeepSpeedConfigModel`` with the JAX fields, defaults and bounds:
an unknown key raises, and so does a value outside a JAX ``Field(ge=...,
gt=..., le=...)`` bound (``BOUNDS``)."""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional

from ..runtime.config_utils import DeepSpeedConfigModel

_WORDS = {"ge": "greater than or equal to", "gt": "greater than",
          "le": "less than or equal to"}
_TESTS = {"ge": lambda v, b: v >= b, "gt": lambda v, b: v > b,
          "le": lambda v, b: v <= b}


@dataclasses.dataclass
class _Bounded(DeepSpeedConfigModel):
    """A config block whose ``BOUNDS`` (field -> {"ge" | "gt" | "le":
    bound}) are checked at construction."""

    BOUNDS: ClassVar[dict[str, dict]] = {}

    def __post_init__(self):
        super().__post_init__()
        for name, bounds in self.BOUNDS.items():
            value = getattr(self, name)
            for op, bound in bounds.items():
                if not _TESTS[op](value, bound):
                    raise ValueError(
                        f"{type(self).__name__}.{name} {value!r}: must be "
                        f"{_WORDS[op]} {bound}")


@dataclasses.dataclass
class ControllerConfig(_Bounded):
    """The online serving feedback controller (``controller.py``): a
    state machine stepped every ``interval_s`` on the server's worker
    thread. It reads SLO burn rates, the queue-wait and ITL p99s and the
    open-request count, and moves three knobs: the admission bound (shed
    depth), the dispatch-chain depth and the speculative draft length.
    Queue pressure throttles admission first; sustained ITL saturation
    then steps the chain depth down, then drafting off. Recovery relaxes
    in reverse order after ``step_up_after`` consecutive healthy
    intervals. The burn-rate and percentile signals come from telemetry,
    which the port does not have yet: without it the controller acts on
    the open-request count alone."""
    enabled: bool = False
    interval_s: float = 1.0
    # SLO burn-rate trip / clear thresholds (breaches a request)
    burn_high: float = 0.1
    burn_low: float = 0.02
    # queue-wait p99 above this share of the TTFT SLO is admission
    # pressure
    queue_wait_frac: float = 0.5
    # ITL p99 above slo_itl_ms times this is decode saturation
    saturation_ratio: float = 1.5
    step_up_after: int = 5
    # the shed-depth range the throttle moves within (min_shed_depth also
    # arms shedding when ServingConfig.shed_queue_depth is 0)
    min_shed_depth: int = 4
    max_shed_depth: int = 256
    # floors of the step-downs
    min_chain_depth: int = 1
    min_draft_len: int = 0

    BOUNDS: ClassVar[dict[str, dict]] = {
        "interval_s": {"gt": 0.0}, "burn_high": {"ge": 0.0},
        "burn_low": {"ge": 0.0}, "queue_wait_frac": {"gt": 0.0},
        "saturation_ratio": {"gt": 0.0}, "step_up_after": {"ge": 1},
        "min_shed_depth": {"ge": 1}, "max_shed_depth": {"ge": 1},
        "min_chain_depth": {"ge": 1}, "min_draft_len": {"ge": 0}}


@dataclasses.dataclass
class ServingConfig(_Bounded):
    """The async continuous-batching server over ``InferenceEngineV2``
    (``AsyncInferenceServer``). The engine's scheduling knobs (fused K,
    chain depth, ring mode, pool sizing, prefix cache) live on
    ``RaggedInferenceEngineConfig``; this block configures the request
    front end above it."""
    # a request's default when submit() gives none
    default_max_new_tokens: int = 128
    # submit()'s default priority tier; lower values run first
    default_priority: int = 1
    # requests open at once (queued + running) past which submit()
    # raises; 0 = unbounded
    max_queue: int = 0
    # admission bound: a submit() arriving with this many requests open
    # is shed, failing fast with RequestFailed("... shed ..."), counted;
    # 0 = off. The controller moves the live bound at run time.
    shed_queue_depth: int = 0
    # a higher-priority prompt that cannot be admitted may park strictly
    # lower-priority running requests (KV swapped out, history kept)
    preemption: bool = True
    # fused decode steps a dispatch; None = the engine's
    # fused_decode_steps
    k_steps: Optional[int] = None
    # sampling overrides for the whole server; None = the engine's
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    eos_token_id: Optional[int] = None
    # base PRNG seed (position-keyed, so preemptions resume the stream)
    seed: int = 0
    # replica label; the router names replicas replica0..N-1 when empty
    replica: str = ""
    # the worker's sleep while waiting on admission headroom
    idle_poll_s: float = 0.002
    # SLO targets (ms; 0 = none): read by the controller, and by the
    # request traces once telemetry is ported
    slo_ttft_ms: float = 0.0
    slo_itl_ms: float = 0.0
    controller: ControllerConfig = dataclasses.field(
        default_factory=ControllerConfig)

    BOUNDS: ClassVar[dict[str, dict]] = {
        "default_max_new_tokens": {"ge": 1}, "max_queue": {"ge": 0},
        "shed_queue_depth": {"ge": 0}, "idle_poll_s": {"gt": 0.0},
        "slo_ttft_ms": {"ge": 0.0}, "slo_itl_ms": {"ge": 0.0}}


@dataclasses.dataclass
class DisaggregationConfig(_Bounded):
    """Prefill/decode disaggregation: with a ``PrefillEngine`` on the
    router, prompts of at least ``prefill_threshold_tokens`` tokens (0 =
    all) run chunked prefill on the prefill engine and migrate to a
    decode replica as a KV block set (``export_request`` /
    ``import_request``); quantized blocks travel as stored, and greedy
    continuation is bit-identical to a co-located run."""
    enabled: bool = False
    prefill_threshold_tokens: int = 0

    BOUNDS: ClassVar[dict[str, dict]] = {
        "prefill_threshold_tokens": {"ge": 0}}


@dataclasses.dataclass
class HealthConfig(_Bounded):
    """Replica health gating of the router (the JAX phi-accrual failure
    detector over serving-loop heartbeats). Kept so that JAX configs
    load; it acts only once telemetry, where the detector lives, is
    ported (ROADMAP port item 15). Until then the router places on every
    accepting replica."""
    enabled: bool = True
    phi_suspect: float = 4.0
    phi_dead: float = 10.0
    heartbeat_window: int = 64
    min_heartbeats: int = 3
    recovery_ratio: float = 0.5
    degraded_score: float = 0.35
    min_interval_s: float = 0.05

    BOUNDS: ClassVar[dict[str, dict]] = {
        "phi_suspect": {"gt": 0.0}, "phi_dead": {"gt": 0.0},
        "heartbeat_window": {"ge": 2}, "min_heartbeats": {"ge": 1},
        "recovery_ratio": {"gt": 0.0, "le": 1.0},
        "degraded_score": {"ge": 0.0, "le": 1.0},
        "min_interval_s": {"gt": 0.0}}


@dataclasses.dataclass
class RouterConfig(_Bounded):
    """The prefix-affinity router (``InferenceRouter``) over N decode
    replicas: a request goes to the replica whose prefix cache holds the
    longest chain of its prompt, else to the least loaded; replicas over
    ``max_open_per_replica`` are skipped, and a replica under
    ``drain_free_block_watermark`` free blocks drains (last resort only).
    A request that fails on its replica is resubmitted with its history
    under the same uid, up to ``reroute_retries`` times."""
    min_affinity_blocks: int = 1
    max_open_per_replica: int = 0
    drain_free_block_watermark: int = 0
    reroute_retries: int = 2
    retry_backoff_s: float = 0.005
    disaggregation: DisaggregationConfig = dataclasses.field(
        default_factory=DisaggregationConfig)
    health: HealthConfig = dataclasses.field(default_factory=HealthConfig)

    BOUNDS: ClassVar[dict[str, dict]] = {
        "min_affinity_blocks": {"ge": 1}, "max_open_per_replica": {"ge": 0},
        "drain_free_block_watermark": {"ge": 0},
        "reroute_retries": {"ge": 0}, "retry_backoff_s": {"gt": 0.0}}
