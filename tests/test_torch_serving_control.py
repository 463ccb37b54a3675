"""The port's serving control plane against the JAX package
(tests/test_serving_control.py:56-212, :400 and :418 rerun on
``deepspeed_tpu_torch.serving``): the feedback controller on a fake clock,
each scenario's decisions held equal to JAX's ``ServingController`` fed
the same ``Signals`` sequence; admission shedding counted and never
silent; the serve loop's runtime knobs clamping; the armed controller
shedding under a burst end to end; and the config blocks' defaults and
bounds against JAX's pydantic blocks. ~10 s.
"""

import asyncio
import dataclasses

import pytest

from deepspeed_tpu.serving import (
    ControllerConfig as JControllerConfig, ServingController as JController,
    Signals as JSignals)
from deepspeed_tpu.serving import config as jconfig
from deepspeed_tpu_torch.inference.v2 import build_engine
from deepspeed_tpu_torch.inference.v2.serve_loop import FusedServeLoop
from deepspeed_tpu_torch.serving import (Action, AsyncInferenceServer,
                                         ControllerConfig, RequestFailed,
                                         ServingConfig, ServingController,
                                         Signals, read_server_signals)
from deepspeed_tpu_torch.serving import config as tconfig


class FakeClock:
    """Deterministic monotonic clock for the cadence tests."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


CTL = dict(enabled=True, min_shed_depth=4, max_shed_depth=64,
           step_up_after=3)


def _ctl(cfg=None, **kw):
    kw.setdefault("chain_depth", 2)
    kw.setdefault("draft_len", 4)
    kw.setdefault("shed_depth", 0)
    kw.setdefault("clock", FakeClock())
    return ServingController(cfg or ControllerConfig(**CTL), **kw)


def _jctl(cfg=None, **kw):
    kw.setdefault("chain_depth", 2)
    kw.setdefault("draft_len", 4)
    kw.setdefault("shed_depth", 0)
    kw.setdefault("clock", FakeClock())
    return JController(cfg or JControllerConfig(**CTL), **kw)


HEALTHY = dict(burn_rate=0.0, slo_ttft_ms=1000.0, slo_itl_ms=50.0)
BURNING = dict(burn_rate=0.5, slo_ttft_ms=1000.0, slo_itl_ms=50.0)
SAT = dict(itl_p99_ms=200.0, slo_itl_ms=50.0)
BAND = dict(burn_rate=0.05, slo_ttft_ms=1000.0, slo_itl_ms=50.0)


def _decisions(ctl, signals, sig_cls):
    """Feed ``signals`` (dicts) and record every decision and the knobs
    after it."""
    out = []
    for s in signals:
        a = ctl.update(sig_cls(**s))
        out.append((None if a is None else
                    (a.action, a.knob, a.value, a.reason),
                    ctl.shed_depth, ctl.chain_depth, ctl.draft_len))
    return out


# scenario -> (controller kwargs, the Signals sequence)
SCENARIOS = {
    "burn_sheds_to_floor": ({}, [BURNING] * 6),
    "queue_pressure": ({}, [dict(queue_wait_p99_ms=600.0,
                                 slo_ttft_ms=1000.0),
                            dict(open_requests=100, shed_depth=8),
                            dict(burn_rate=0.9, queue_wait_p99_ms=900.0,
                                 itl_p99_ms=400.0, slo_ttft_ms=1000.0,
                                 slo_itl_ms=50.0)]),
    "saturation": ({}, [SAT, SAT, SAT, dict(itl_p99_ms=60.0,
                                            slo_itl_ms=50.0)]),
    "recovery": ({}, [BURNING, SAT, SAT, HEALTHY, HEALTHY, BAND]
                 + [HEALTHY] * 50),
    "base_bound": ({"shed_depth": 16}, [BURNING] + [HEALTHY] * 12),
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_controller_decisions_equal_jax(scenario):
    """Every scenario's decisions (action, knob, value, reason) and the
    knobs after each step equal JAX's controller on the same signals."""
    kw, signals = SCENARIOS[scenario]
    got = _decisions(_ctl(**kw), signals, Signals)
    want = _decisions(_jctl(**kw), signals, JSignals)
    assert got == want
    assert any(d[0] is not None for d in got)


def test_controller_burn_tightens_admission_first():
    """JAX :56: high burn without decode saturation sheds at the queue,
    halving to the floor, never touching the decode knobs."""
    calls = []
    c = _ctl(set_shed_depth=calls.append)
    for want in (32, 16, 8, 4):
        a = c.update(Signals(**BURNING))
        assert isinstance(a, Action)
        assert (a.action, a.value) == ("shed_tighten", want)
    assert calls == [32, 16, 8, 4]
    assert c.update(Signals(**BURNING)) is None
    assert (c.chain_depth, c.draft_len) == (2, 4)
    assert c.action_counts() == {"shed_tighten": 4}


def test_controller_saturation_steps_depth_then_draft():
    """JAX :93: decode saturation steps chain depth down to its floor,
    then drafts off; ITL above the SLO but inside the ratio band holds."""
    depth, draft = [], []
    c = _ctl(set_chain_depth=depth.append, set_draft_len=draft.append)
    assert c.update(Signals(**SAT)).action == "depth_down"
    assert c.update(Signals(**SAT)).action == "draft_off"
    assert c.update(Signals(**SAT)) is None
    assert (depth, draft) == ([1], [0])
    c2 = _ctl()
    assert c2.update(Signals(itl_p99_ms=60.0, slo_itl_ms=50.0)) is None
    assert (c2.chain_depth, c2.draft_len) == (2, 4)


def test_controller_maybe_step_rate_limits_on_fake_clock():
    """JAX :175: maybe_step reads the signals only once an interval has
    passed."""
    clock = FakeClock()
    c = _ctl(ControllerConfig(enabled=True, interval_s=1.0,
                              min_shed_depth=4, max_shed_depth=64),
             clock=clock)
    reads = []

    def read():
        reads.append(clock.t)
        return Signals(**BURNING)

    assert c.maybe_step(read).action == "shed_tighten"
    clock.t = 0.5
    assert c.maybe_step(read) is None
    clock.t = 1.0
    assert c.maybe_step(read).action == "shed_tighten"
    assert reads == [0.0, 1.0]
    assert [a.t for a in c.actions] == [0.0, 1.0]


def _bare_server(loop, **cfg):
    """An engine-less server exercising only the event-loop admission
    path (the worker thread never starts)."""
    s = AsyncInferenceServer.__new__(AsyncInferenceServer)
    s.__init__(None, ServingConfig(**cfg))
    s._accepting = True
    s._aloop = loop
    return s


def test_shed_fast_fails_counted_never_silent():
    """JAX :196: past the admission bound a submit fails fast with a
    RequestFailed naming the shed, counted, with nothing left open; under
    the bound it is admitted; read_server_signals reads the bound and the
    open count."""
    async def run():
        s = _bare_server(asyncio.get_running_loop(), shed_queue_depth=2,
                         slo_itl_ms=40.0)
        s._open = 2
        h = await s.submit([1, 2, 3])
        with pytest.raises(RequestFailed, match="shed"):
            await h.tokens()
        assert s._shed_count == 1 and s._open == 2
        assert h.uid not in s._handles
        sig = read_server_signals(s)
        assert (sig.open_requests, sig.shed_depth, sig.slo_itl_ms) == \
            (2, 2, 40.0)
        assert sig.burn_rate is None and sig.itl_p99_ms is None
        s._open = 1
        h2 = await s.submit([1, 2, 3])
        assert s._open == 2 and h2.uid in s._handles

    asyncio.run(run())


def test_shed_default_off_admits_unbounded():
    """JAX :212: shedding is off by default; every submit is admitted."""
    assert ServingConfig().shed_queue_depth == 0

    async def run():
        s = _bare_server(asyncio.get_running_loop())
        s._open = 500
        h = await s.submit([1, 2, 3])
        assert s._open == 501 and h.uid in s._handles
        assert s._shed_count == 0

    asyncio.run(run())


def test_serve_loop_runtime_knobs_clamp():
    """JAX :400: chain depth clamps to [1, the configured max]; draft
    toggling without speculation stays at 0."""
    e = build_engine("llama", "tiny", dict(
        dtype="float32", kv_block_size=8, num_kv_blocks=128,
        max_chunk_size=16, max_inflight_dispatches=3), device="cpu")
    loop = FusedServeLoop(e, k_steps=2)
    assert loop.depth == 3 and loop.max_depth == 3
    assert loop.set_chain_depth(5) == 3
    assert loop.set_chain_depth(0) == 1
    assert loop.set_chain_depth(2) == 2
    assert loop.set_draft_len(8) == 0
    assert loop.set_draft_len(0) == 0


def test_controller_load_step_e2e_sheds_under_burst():
    """JAX :418: shedding off at rest; the armed controller sees the
    overload from the open-request count, arms a bound mid-run, and late
    submits fail fast; completed + shed == submitted, and the engine
    leaks nothing."""
    e = build_engine("llama", "tiny", dict(
        dtype="float32", kv_block_size=8, num_kv_blocks=128,
        max_chunk_size=16, max_ragged_sequence_count=2,
        fused_decode_steps=2), device="cpu")
    cfg = ServingConfig(
        k_steps=2, shed_queue_depth=0,
        controller=ControllerConfig(enabled=True, interval_s=0.01,
                                    min_shed_depth=2, max_shed_depth=2,
                                    step_up_after=50))

    async def run():
        prompts = [[1 + i, 2, 3] for i in range(14)]
        async with AsyncInferenceServer(e, cfg) as s:
            first = [await s.submit(p, max_new_tokens=8)
                     for p in prompts[:10]]
            for _ in range(1500):
                if s._shed_depth:
                    break
                await asyncio.sleep(0.01)
            assert s._shed_depth == 2, "controller never armed the bound"
            late = [await s.submit(p, max_new_tokens=8)
                    for p in prompts[10:]]
            done = shed = 0
            for h in first + late:
                try:
                    assert len(await h.tokens()) == 8
                    done += 1
                except RequestFailed as err:
                    assert "shed" in str(err)
                    shed += 1
            m = s.metrics()
            assert shed == s._shed_count == m["shed_requests"] >= 1
            assert done + shed == len(prompts)
            assert m["controller_actions"].get("shed_tighten", 0) >= 1
            assert m["controller_shed_depth"] == 2
        assert e.free_blocks == 128 and not e.state_manager.seqs

    asyncio.run(run())


BLOCKS = ["ControllerConfig", "ServingConfig", "DisaggregationConfig",
          "HealthConfig", "RouterConfig"]


@pytest.mark.parametrize("name", BLOCKS)
def test_config_blocks_match_jax_defaults_and_bounds(name):
    """Each serving config block has JAX's fields and defaults; every
    JAX bound (``Field(ge=, gt=, le=)``) raises on the port, just past
    it; unknown keys raise."""
    jcls, tcls = getattr(jconfig, name), getattr(tconfig, name)
    assert tcls().model_dump() == jcls().model_dump()
    for field, info in jcls.model_fields.items():
        for m in info.metadata:
            for op, step in (("ge", -1), ("gt", 0), ("le", 1)):
                bound = getattr(m, op, None)
                if bound is None:
                    continue
                bad = bound + step if isinstance(bound, int) and \
                    not isinstance(bound, bool) else bound + step * 0.5
                if op == "gt":
                    bad = bound
                with pytest.raises(Exception):
                    jcls(**{field: bad})
                with pytest.raises(ValueError, match=field):
                    tcls(**{field: bad})
    with pytest.raises(ValueError, match="unknown config key"):
        tcls.from_dict({"no_such_knob": 1})
    assert dataclasses.is_dataclass(tcls)
