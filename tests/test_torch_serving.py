"""The port's async serving front end (``deepspeed_tpu_torch.serving.
AsyncInferenceServer``) against the JAX package, fp32 on the CPU
(tests/test_serving.py:34-224 rerun on the port): the chain-depth knob,
the server's greedy stream against generate_fused and the JAX server's,
priority under a constrained pool, preemption with park and restore, a
cancel releasing its blocks, ring mode through the server (parity, the
EOS swap under a small pool, the in-graph swap), and a worker error
surfacing on ``stop()``.

The JAX params are carried across (``models/convert.py``); tokens are
held equal, and every test leaves its engine empty. ~20 s.
"""

import asyncio

import jax
import numpy as np
import pytest

from deepspeed_tpu.inference.v2 import (
    InferenceEngineV2 as JEngine,
    RaggedInferenceEngineConfig as JConfig)
from deepspeed_tpu.inference.v2.serve_loop import (
    FusedServeLoop as JServeLoop)
from deepspeed_tpu.models import Llama as JLlama
from deepspeed_tpu.serving import (
    AsyncInferenceServer as JServer, ServingConfig as JServingConfig)
from deepspeed_tpu_torch.inference.v2 import (RaggedInferenceEngineConfig,
                                              build_engine)
from deepspeed_tpu_torch.inference.v2.serve_loop import FusedServeLoop
from deepspeed_tpu_torch.serving import (AsyncInferenceServer,
                                         RequestCancelled, RequestFailed,
                                         ServingConfig)

PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7], [6, 7, 8, 9, 10, 11]]
ENGINE_KW = dict(dtype="float32", kv_block_size=8, num_kv_blocks=128,
                 max_chunk_size=16)
_SHARED: dict = {}


def _jax(**over):
    """A JAX engine on the module's params (the first one draws them)."""
    kw = dict(ENGINE_KW, **over)
    if "params" not in _SHARED:
        je = JEngine(JLlama(size="tiny"), JConfig(**kw))
        _SHARED["params"] = (je.params, jax.tree.map(np.asarray, je.params))
        return je
    return JEngine(JLlama(size="tiny"), JConfig(**kw),
                   params=_SHARED["params"][0])


def _engine(**over):
    """A fresh port engine on the JAX params."""
    if "params" not in _SHARED:
        _jax()
    return build_engine("llama", "tiny", dict(ENGINE_KW, **over),
                        params=_SHARED["params"][1], device="cpu")


def _clean(e, nb=128):
    assert e.free_blocks == nb and not e.state_manager.seqs, \
        (e.free_blocks, e.state_manager.seqs)


def _serve(server_cls, config, engine, prompts, max_new, **kw):
    async def main():
        async with server_cls(engine, config) as s:
            handles = [await s.submit(p, max_new_tokens=max_new, **kw)
                       for p in prompts]
            return [await h.tokens() for h in handles], s.metrics()

    return asyncio.run(main())


def test_max_inflight_knob_validation_and_metric():
    """JAX :34: the chain-depth knob refuses 0 and shows in
    serving_metrics()."""
    with pytest.raises(ValueError, match="greater than or equal"):
        RaggedInferenceEngineConfig(max_inflight_dispatches=0)
    e = _engine(max_inflight_dispatches=3)
    assert e.serving_metrics()["max_inflight_dispatches"] == 3


def test_server_greedy_stream_matches_generate_fused_and_jax_server():
    """JAX :44: the tokens the server streams equal generate_fused's on
    the same engine and the JAX server's; the engine ends empty."""
    e = _engine()
    ref = e.generate_fused(PROMPTS, max_new_tokens=10, k_steps=3)
    outs, m = _serve(AsyncInferenceServer, ServingConfig(k_steps=3), e,
                     PROMPTS, 10)
    je = _jax()
    jouts, _ = _serve(JServer, JServingConfig(k_steps=3), je, PROMPTS, 10)
    assert outs == ref == jouts
    assert m["admitted"] == 3 and m["open_requests"] == 0
    _clean(e)


def test_priority_ordering_under_constrained_pool():
    """JAX :60: a later priority-0 request admits before earlier
    priority-2 ones when the pool cannot hold everyone, in the JAX loop's
    order."""
    def order(loop_cls, e):
        loop = loop_cls(e, k_steps=4, preemption=False)
        loop.submit([1, 2, 3, 4, 5], 24, priority=2, uid=100)
        loop.submit([2, 3, 4], 24, priority=2, uid=101)
        loop.submit([9, 8, 7], 24, priority=0, uid=102)
        first_seen: list[int] = []
        while loop.has_work():
            for evt in loop.step():
                if evt.tokens and evt.uid not in first_seen:
                    first_seen.append(evt.uid)
        return first_seen

    e = _engine(num_kv_blocks=10)
    got = order(FusedServeLoop, e)
    assert got[0] == 102 and set(got) == {100, 101, 102}
    assert got == order(JServeLoop, _jax(num_kv_blocks=10))
    _clean(e, 10)


def test_preemption_park_restore_roundtrip():
    """JAX :78: a high-priority arrival preempts the running low-priority
    request; the victim restores later, and both streams equal their
    unpreempted runs."""
    e = _engine(num_kv_blocks=16)
    ref_lo = e.generate_fused([[1, 2, 3, 4, 5]], max_new_tokens=60,
                              k_steps=4)[0]
    ref_hi = e.generate_fused([[9, 8, 7]], max_new_tokens=60,
                              k_steps=4)[0]

    async def main():
        async with AsyncInferenceServer(e, ServingConfig(k_steps=4)) as s:
            lo = await s.submit([1, 2, 3, 4, 5], max_new_tokens=60,
                                priority=2)
            first_lo = await lo.__anext__()
            hi = await s.submit([9, 8, 7], max_new_tokens=60, priority=0)
            out_hi = await hi.tokens()
            out_lo = [first_lo] + await lo.tokens()
            return out_lo, out_hi, s.metrics()

    out_lo, out_hi, m = asyncio.run(main())
    assert m["preemptions"] >= 1 and m["restores"] >= 1, m
    assert out_hi == ref_hi and out_lo == ref_lo
    _clean(e, 16)


def test_preemption_frees_decode_row_when_rows_bound():
    """JAX :105: with one decode row and ample blocks, a high-priority
    arrival parks the low-priority occupant and finishes first."""
    e = _engine(max_ragged_sequence_count=1)
    loop = FusedServeLoop(e, k_steps=4)
    lo = loop.submit([1, 2, 3, 4, 5], 40, priority=2)
    for _ in range(3):
        loop.step()
    hi = loop.submit([9, 8, 7], 10, priority=0)
    finish_order: list[int] = []
    while loop.has_work():
        for evt in loop.step():
            if evt.finished:
                assert evt.error is None, evt
                finish_order.append(evt.uid)
    assert loop.counters["preemptions"] >= 1, loop.counters
    assert finish_order == [hi, lo]
    _clean(e)


def test_cancel_mid_stream_releases_blocks():
    """JAX :127: a cancel mid-stream ends the iterator with
    RequestCancelled, and every block returns to the pool at the next
    dispatch boundary."""
    e = _engine()

    async def main():
        async with AsyncInferenceServer(e, ServingConfig(k_steps=2)) as s:
            h = await s.submit([1, 2, 3, 4, 5], max_new_tokens=100)
            got = []
            with pytest.raises(RequestCancelled):
                async for t in h:
                    got.append(t)
                    if len(got) >= 3:
                        h.cancel()
            for _ in range(200):
                if e.free_blocks == 128:
                    break
                await asyncio.sleep(0.02)
            return got, s.metrics()

    got, m = asyncio.run(main())
    assert 3 <= len(got) < 100 and m["cancellations"] == 1
    _clean(e)


def test_ring_mode_server_greedy_parity():
    """JAX :154 through the server: ring mode (in-graph admission, one
    host read a chain) streams chain mode's generate_fused tokens."""
    ref = _engine().generate_fused(PROMPTS, max_new_tokens=10, k_steps=3)
    e = _engine(fused_admission=True, max_inflight_dispatches=3)
    outs, m = _serve(AsyncInferenceServer, ServingConfig(k_steps=3), e,
                     PROMPTS, 10)
    assert outs == ref
    assert m["dispatches_per_token"] <= 0.25, m
    _clean(e)


def test_ring_mode_eos_swap_and_in_graph_swap_through_the_server():
    """JAX :167 and :197 through the server: ring mode with EOS equals
    the per-tick generate(); under a pool too small for both prompts the
    second is staged and swapped in on the device; with more prompts than
    decode rows the staged requests take finished rows in the graph; each
    equals the chain driver."""
    free = _engine().generate([[1, 2, 3, 4, 5]], max_new_tokens=10)[0]
    eos = free[4]
    p = [[1, 2, 3, 4, 5], [9, 8, 7]]
    ref = _engine().generate(p, max_new_tokens=10, eos_id=eos)
    e = _engine(fused_admission=True)
    outs, _ = _serve(AsyncInferenceServer,
                     ServingConfig(k_steps=4, eos_token_id=eos), e, p, 10)
    assert outs == ref and outs[0][-1] == eos
    _clean(e)
    p2 = [list(range(10)), list(range(12))]
    ref2 = _engine(num_kv_blocks=6).generate(p2, max_new_tokens=12)
    e2 = _engine(num_kv_blocks=6, fused_admission=True)
    outs2, _ = _serve(AsyncInferenceServer, ServingConfig(k_steps=3), e2,
                      p2, 12)
    assert outs2 == ref2
    _clean(e2, 6)
    p3 = [[1, 2, 3], [4, 5], [6, 7, 8], [9, 10]]
    ref3 = _engine(max_ragged_sequence_count=2).generate_fused(
        p3, max_new_tokens=6, k_steps=3)
    e3 = _engine(max_ragged_sequence_count=2, fused_admission=True,
                 max_inflight_dispatches=4)
    outs3, _ = _serve(AsyncInferenceServer, ServingConfig(k_steps=3), e3,
                      p3, 6)
    assert outs3 == ref3
    _clean(e3)


@pytest.mark.parametrize("fault", ["kill", "engine"])
def test_worker_error_surfaces_on_stop(fault):
    """A worker that dies (kill() or an engine fault) fails every open
    handle with RequestFailed, stops accepting, raises its error from
    stop(), and leaves no blocks behind."""
    e = _engine()
    if fault == "engine":
        def broken(*a, **kw):
            raise ValueError("engine fault")
        e._fused_fn = broken

    async def main():
        s = AsyncInferenceServer(e, ServingConfig(k_steps=2))
        await s.start()
        h = await s.submit([1, 2, 3], max_new_tokens=50)
        if fault == "kill":
            await h.__anext__()
            s.kill()
        with pytest.raises(RequestFailed, match="serving loop died"):
            await h.tokens()
        for _ in range(100):
            if not s.accepting:
                break
            await asyncio.sleep(0.01)
        assert not s.accepting
        with pytest.raises(RuntimeError):
            await s.submit([4, 5])
        with pytest.raises((RuntimeError, ValueError),
                           match="fault"):
            await s.stop()

    asyncio.run(main())
    _clean(e)
