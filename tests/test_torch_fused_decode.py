"""The port's fused decode path (deepspeed_tpu_torch/inference/v2:
``paged.fused_decode_loop``, ``decode_fused``, ``serve_loop.FusedServeLoop``
and ``generate_fused``) against the JAX engine's on the CPU, fp32, with the
JAX params carried across (``models/convert.py``): the JAX fused tests
(tests/test_inference_v2.py:271-355, tests/test_serving.py:61-154) rerun on
the port and held to the JAX engine.

Tokens are held equal (greedy and stochastic: the sampling is bit-exact,
tests/test_torch_sampling.py, and the logits agree at 2e-4, the JAX v2
tests' tolerance); the serving counters equal JAX's; pools after a fused
dispatch at 2e-4. On the CPU the loop runs eagerly on the kernels' plain
versions; the graph capture is checked on the card
(tests/test_torch_cuda.py). ~40 s.
"""

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import (
    InferenceEngineV2 as JEngine,
    RaggedInferenceEngineConfig as JConfig)
from deepspeed_tpu.inference.v2.serve_loop import (
    FusedServeLoop as JServeLoop)
from deepspeed_tpu.models import GPT2 as JGPT2, Llama as JLlama
from deepspeed_tpu_torch.inference.v2 import (DSStateManager,
                                              RaggedInferenceEngineConfig,
                                              build_engine, paged)
from deepspeed_tpu_torch.inference.v2.serve_loop import FusedServeLoop


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side runs tiny models: one intra-op thread a worker
    keeps it from spinning against the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = dict(rtol=2e-4, atol=2e-4)
ENGINE_KW = dict(dtype="float32", kv_block_size=8, num_kv_blocks=128,
                 max_chunk_size=16)
JAX_MODELS = {"llama": JLlama, "gpt2": JGPT2}
PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7], [6, 7, 8, 9, 10, 11]]
# the fused counters serving_metrics() reports
FUSED_KEYS = ("host_dispatches", "fused_dispatches", "fused_steps",
              "fused_slots", "fused_slot_tokens", "fused_live_slots",
              "decoded_tokens", "dispatches_per_token", "fused_occupancy",
              "tokens_per_dispatch", "max_inflight_dispatches")
_PARAMS: dict = {}


def _pair(family="llama", **over):
    """(fresh JAX engine, fresh port engine) on one set of JAX params."""
    kw = dict(ENGINE_KW, **over)
    if family not in _PARAMS:
        je = JEngine(JAX_MODELS[family](size="tiny"), JConfig(**ENGINE_KW))
        _PARAMS[family] = (je.params, jax.tree.map(np.asarray, je.params))
    jparams, params = _PARAMS[family]
    je = JEngine(JAX_MODELS[family](size="tiny"), JConfig(**kw),
                 params=jparams)
    te = build_engine(family, "tiny", kw, params=params, device="cpu")
    return je, te


def _port(family="llama", **over):
    return _pair(family, **over)[1]


def _fused_metrics(e):
    m = e.serving_metrics()
    return {k: m[k] for k in FUSED_KEYS}


@pytest.mark.parametrize("family", list(JAX_MODELS))
def test_fused_greedy_matches_per_tick_and_jax_engine(family):
    """JAX's acceptance gate (test_fused_greedy_matches_per_tick, :271):
    K = 3 fused ticks emit the per-tick generate()'s greedy tokens with a K
    that does not divide max_new_tokens, at <= 0.25 dispatches a token;
    and the tokens and fused counters equal the JAX engine's."""
    je, te = _pair(family)
    ref = _port(family).generate(PROMPTS, max_new_tokens=10)
    got = te.generate_fused(PROMPTS, max_new_tokens=10, k_steps=3)
    assert got == ref
    assert je.generate_fused(PROMPTS, max_new_tokens=10, k_steps=3) == got
    m = te.serving_metrics()
    assert m["dispatches_per_token"] <= 0.25, m
    assert m["fused_occupancy"] > 0.9, m
    assert _fused_metrics(te) == _fused_metrics(je)
    assert te.free_blocks == ENGINE_KW["num_kv_blocks"]
    assert not te.state_manager.seqs


def test_fused_mid_loop_eos_and_inter_dispatch_admission():
    """JAX :288: EOS ends a sequence inside the loop, and a pool too
    small for both prompts admits the second between dispatches, both
    token-identical to the per-tick generate() and to the JAX engine."""
    je, te = _pair()
    free = _port().generate([[1, 2, 3, 4, 5]], max_new_tokens=10)[0]
    eos = free[4]            # the 5th greedy token: a stop inside k = 4
    p = [[1, 2, 3, 4, 5], [9, 8, 7]]
    ref = _port().generate(p, max_new_tokens=10, eos_id=eos)
    got = te.generate_fused(p, max_new_tokens=10, k_steps=4, eos_id=eos)
    assert got == ref
    assert len(got[0]) == 5 and got[0][-1] == eos
    assert je.generate_fused(p, max_new_tokens=10, k_steps=4,
                             eos_id=eos) == got
    assert _fused_metrics(te) == _fused_metrics(je)
    # 6 blocks x 8 tokens cannot hold both: the second prompt admits
    # after the first finishes, between fused dispatches
    p2 = [list(range(10)), list(range(12))]
    je2, te2 = _pair(num_kv_blocks=6)
    ref2 = _port(num_kv_blocks=6).generate(p2, max_new_tokens=12)
    got2 = te2.generate_fused(p2, max_new_tokens=12, k_steps=3)
    assert got2 == ref2
    assert je2.generate_fused(p2, max_new_tokens=12, k_steps=3) == got2
    assert _fused_metrics(te2) == _fused_metrics(je2)
    assert te2.free_blocks == 6


@pytest.mark.parametrize("sampling", [dict(top_k=50),
                                      dict(top_k=50, top_p=0.9)])
def test_fused_sampled_decode_matches_jax_and_is_schedule_invariant(
        sampling):
    """JAX :313: stochastic decode keys its randomness by (uid, position),
    so k = 2 and k = 4 give the same tokens; and with the threefry bits
    and the compiled rounding carried over, they are the JAX engine's."""
    kw = dict(max_new_tokens=8, temperature=0.9, seed=13, **sampling)
    prompts = [[1, 2, 3], [7, 6, 5, 4]]
    je, te = _pair()
    a = te.generate_fused(prompts, k_steps=2, **kw)
    b = _port().generate_fused(prompts, k_steps=4, **kw)
    assert a == b
    assert je.generate_fused(prompts, k_steps=2, **kw) == a
    assert _fused_metrics(te) == _fused_metrics(je)
    greedy = _port().generate(prompts, max_new_tokens=8)
    assert a != greedy           # the draw did sample


def test_sampling_config_defaults_drive_generate_fused():
    """The config's sampling keys (refused before this slice) are the
    loop's defaults, as in JAX; per-call arguments override them."""
    cfg = dict(sampling_temperature=0.9, sampling_top_k=50,
               fused_decode_steps=2, max_inflight_dispatches=3)
    je, te = _pair(**cfg)
    got = te.generate_fused(PROMPTS, max_new_tokens=6, seed=13)
    assert got == je.generate_fused(PROMPTS, max_new_tokens=6, seed=13)
    assert got == _port().generate_fused(PROMPTS, max_new_tokens=6, seed=13,
                                         temperature=0.9, top_k=50,
                                         k_steps=2)
    assert te.serving_metrics()["max_inflight_dispatches"] == 3
    with pytest.raises(ValueError, match="greater than or equal"):
        RaggedInferenceEngineConfig(max_inflight_dispatches=0)


def test_decode_fused_single_dispatch_api_and_budget_cap():
    """JAX :324: one dispatch advances a put() sequence up to K tokens and
    commits them (the last left pending); a budget caps the emits. Tokens,
    steps and the pools after it as the JAX engine's."""
    je, te = _pair()
    ref = _port().generate([[1, 2, 3, 4, 5]], max_new_tokens=6)[0]
    t0 = None
    for e in (je, te):
        logits = e.put([0], [[1, 2, 3, 4, 5]])
        t0 = int(np.argmax(np.asarray(logits[0])))
        e.state_manager.extend(0, [t0])
    out = te.decode_fused([0], k_steps=5)
    assert [t0] + out[0] == ref
    assert out == je.decode_fused([0], k_steps=5)
    assert te.query(0)[0] == je.query(0)[0] == 5 + 5
    for n in ("k", "v"):
        np.testing.assert_allclose(te.pools[n].numpy(),
                                   np.asarray(je.pools[n]), **TOL)
    out2 = te.decode_fused([0], k_steps=5, budgets={0: 2})
    assert len(out2[0]) == 2
    assert out2 == je.decode_fused([0], k_steps=5, budgets={0: 2})
    # a budget of 0: nothing emitted, no step counted
    steps = te.serving_stats["fused_steps"]
    for e in (te, je):
        assert e.decode_fused([0], k_steps=5, budgets={0: 0}) == {0: []}
    assert te.serving_stats["fused_steps"] == steps
    assert _fused_metrics(te) == _fused_metrics(je)


def test_fused_reserve_and_commit_bookkeeping():
    """JAX :342 on the port's state manager."""
    m = DSStateManager(block_size=4, num_blocks=8, max_blocks_per_seq=4)
    m.extend(0, [1, 2, 3, 4, 5])       # 2 blocks
    assert m.reserve(0, 6) == 1        # 11 tokens -> 3 blocks
    assert m.reserve(0, 6) == 0        # idempotent
    with pytest.raises(RuntimeError, match="max length"):
        m.reserve(0, 100)
    m.seqs[0].seen = 4                 # pending=1, fused entry invariant
    m.commit_device_tokens(0, [7, 8, 9])
    assert m.seqs[0].seen == 7 and m.seqs[0].pending == 1
    with pytest.raises(RuntimeError, match="pending"):
        m.seqs[0].seen = 5
        m.commit_device_tokens(0, [1])
    m.seqs[0].seen = 7
    with pytest.raises(RuntimeError, match="reserved blocks"):
        m.commit_device_tokens(0, [1, 2, 3, 4, 5, 6])
    # park: the history comes back and every block is released
    assert m.park(0) == [1, 2, 3, 4, 5, 7, 8, 9]
    assert m.allocator.free_blocks == 8 and m.park(0) == []


@pytest.mark.parametrize("over", [
    dict(kv_cache={"enabled": True, "dtype": "int8"}),
    dict(kv_cache={"enabled": True, "dtype": "fp8", "granularity": "token"}),
    dict(prefix_cache={"enabled": True})])
def test_fused_on_quantized_and_prefix_cache_engines(over):
    """generate_fused on int8/fp8 pools and with the prefix cache (a
    shared 16-token prefix: 2 full blocks) gives the per-tick generate()'s
    tokens and the JAX engine's, with JAX's counters."""
    prefix = np.random.default_rng(30).integers(0, 512, 16).tolist()
    prompts = [prefix + [3, 1, 4], prefix + [1, 5], [9, 2, 6]]
    je, te = _pair(**over)
    for e in (je, te):                 # publish the prefix first
        e.generate_fused([prefix + [7]], max_new_tokens=4, k_steps=3)
    ref_engine = _port(**over)
    ref_engine.generate([prefix + [7]], max_new_tokens=4)
    ref = ref_engine.generate(prompts, max_new_tokens=9)
    got = te.generate_fused(prompts, max_new_tokens=9, k_steps=3)
    assert got == ref
    assert je.generate_fused(prompts, max_new_tokens=9, k_steps=3) == got
    tm, jm = te.serving_metrics(), je.serving_metrics()
    for key in FUSED_KEYS + ("prefix_hits", "prefix_misses",
                             "prefill_tokens_saved"):
        assert tm[key] == jm[key], key
    if "prefix_cache" in over:
        assert tm["prefix_hits"] > 0


def _drive(loop, submits, steps_before=0):
    """Submit ``submits[0]``, step ``steps_before`` times, submit the rest,
    run to the end. Returns ({uid: tokens}, finish order, errors, the
    order of first tokens)."""
    out, order, errors, first = {}, [], {}, []

    def run(events):
        for evt in events:
            if evt.tokens and evt.uid not in out:
                first.append(evt.uid)
            out.setdefault(evt.uid, []).extend(evt.tokens)
            if evt.finished:
                order.append(evt.uid)
                if evt.error:
                    errors[evt.uid] = evt.error

    loop.submit(*submits[0][0], **submits[0][1])
    for _ in range(steps_before):
        run(loop.step())
    for args, kw in submits[1:]:
        loop.submit(*args, **kw)
    while loop.has_work():
        run(loop.step())
    return out, order, errors, first


def test_preemption_park_restore_matches_jax_loop():
    """JAX test_serving.py:79/107 on the serve loops: a priority-0
    arrival preempts the running priority-2 request, first for KV blocks
    (a 16-block pool), then for the one decode row; the victim restores
    and finishes with its unpreempted tokens. Events, order and counters
    as the JAX loop's."""
    for over, new in ((dict(num_kv_blocks=16), 60),
                      (dict(max_ragged_sequence_count=1), 30)):
        je, te = _pair(**over)
        ref = {0: _port().generate([[1, 2, 3, 4, 5]], new)[0],
               1: _port().generate([[9, 8, 7]], new)[0]}
        submits = [(([1, 2, 3, 4, 5], new), dict(priority=2, uid=0)),
                   (([9, 8, 7], new), dict(priority=0, uid=1))]
        got = _drive(FusedServeLoop(te, k_steps=4), submits, 3)
        want = _drive(JServeLoop(je, k_steps=4), submits, 3)
        assert got == want
        assert got[0] == ref and got[1][0] == 1
        assert te.serving_metrics()["fused_steps"] \
            == je.serving_metrics()["fused_steps"]
        assert not te.state_manager.seqs


def test_cancel_and_priority_order_match_jax_loop():
    """JAX test_serving.py:61/129: a later priority-0 request admits
    first in a pool too small for all (no preemption); a cancelled
    request ends with error "cancelled" and returns its blocks."""
    je, te = _pair(num_kv_blocks=10)
    submits = [(([1, 2, 3, 4, 5], 24), dict(priority=2, uid=100)),
               (([2, 3, 4], 24), dict(priority=2, uid=101)),
               (([9, 8, 7], 24), dict(priority=0, uid=102))]
    got = _drive(FusedServeLoop(te, k_steps=4, preemption=False), submits)
    want = _drive(JServeLoop(je, k_steps=4, preemption=False), submits)
    assert got == want and got[3][0] == 102
    assert te.free_blocks == 10
    loops = []
    je, te = _pair(num_kv_blocks=16)       # 14 blocks for 5 + 100 tokens
    for e, cls in ((te, FusedServeLoop), (je, JServeLoop)):
        loop = cls(e, k_steps=2)
        loop.submit([1, 2, 3, 4, 5], 100, uid=7)
        for _ in range(3):
            loop.step()
        loop.cancel(7)
        events = []
        while loop.has_work():
            events += loop.step()
        loops.append([(v.uid, v.tokens, v.finished, v.error)
                      for v in events])
        assert loop.counters["cancellations"] == 1
        assert e.free_blocks == 16 and not e.state_manager.seqs
    assert loops[0] == loops[1]
    assert loops[0][-1][2:] == (True, "cancelled")


def test_fused_loop_matches_jax_fused_decode_loop():
    """paged.fused_decode_loop against the JAX loop on the same operands
    (two live rows at EOS/budget ends, an inactive row and a pad row):
    output tokens, steps run and the carry equal, the pools at 2e-4."""
    je, te = _pair()
    prompts = [[1, 2, 3, 4, 5], [9, 8, 7], [6, 7, 8, 9, 10, 11]]
    for e in (je, te):
        logits = e.put([0, 1, 2], prompts)
        for u, lg in enumerate(np.asarray(logits)):
            e.state_manager.extend(u, [int(np.argmax(lg))])
    budgets = {0: 6, 1: 2, 2: 0}
    ops = je._fused_operands([0, 1, 2], 6, budgets, 5)
    state = te._fused_operands([0, 1, 2], 6, budgets, 5)
    np.testing.assert_array_equal(state.tables.numpy(), np.asarray(ops[2]))
    np.testing.assert_array_equal(state.row_keys.numpy().astype(np.uint32),
                                  np.asarray(ops[5]))
    # the JAX engine's jitted loop (the compiled rounding of temperature)
    want = je._fused_fn(6, 0.9, 50, 0.0, None)(je.params, je.pools, *ops)
    got = paged.fused_decode_loop(
        te.model, te.pools, state.tokens, state.pos, state.tables,
        state.active, state.remaining, state.row_keys, num_steps=6,
        eos_id=None, temperature=0.9, top_k=50, top_p=0.0)
    for g, w in zip(got[:6], want[:6]):
        np.testing.assert_array_equal(np.asarray(g).astype(np.int64),
                                      np.asarray(w).astype(np.int64))
    assert int(got[1]) == 6 and (got[0][1, 2:] == -1).all()
    for n in ("k", "v"):
        np.testing.assert_allclose(te.pools[n].numpy(),
                                   np.asarray(want[6][n]), **TOL)


def _bits(t):
    return t.view(torch.uint8).clone()


@pytest.mark.parametrize("kv", [None, "int8", "fp8"])
def test_masked_pool_write_leaves_dead_slots_untouched(kv):
    """The static-shape pool write: every pool byte (payload and scales)
    is poisoned with 0x3C (finite in every format, so the context row 0
    attends to stays readable); a chunk with a row cut short by true_len,
    an inactive row with its own table and a pad row carrying row 0's
    table at position 0 writes exactly the valid slots; a chunk with no
    valid slot changes nothing."""
    over = {"kv_cache": {"enabled": True, "dtype": kv}} if kv else {}
    te = build_engine("llama", "tiny", dict(ENGINE_KW, num_kv_blocks=16,
                                            **over), device="cpu")
    for t in te.pools.values():
        t.view(torch.uint8).fill_(0x3C)
    before = {n: _bits(t) for n, t in te.pools.items()}
    tables = torch.tensor([[3, 5, 16], [7, 9, 16], [3, 5, 16]],
                          dtype=torch.int32)
    tokens = torch.tensor([[11, 12, 13], [14, 15, 16], [17, 18, 19]])
    pos0 = torch.tensor([6, 2, 0], dtype=torch.int32)
    true_len = torch.tensor([2, 0, 0], dtype=torch.int32)
    paged.paged_forward(te.model, te.pools, tokens, pos0, tables, true_len)
    # row 0 writes positions 6 and 7: block 3, offsets 6 and 7
    for n, t in te.pools.items():
        changed = (_bits(t) != before[n]).reshape(
            t.shape[0], t.shape[1] * t.shape[2], -1).any(-1)
        want = torch.zeros_like(changed)
        want[:, 3 * 8 + 6] = want[:, 3 * 8 + 7] = True
        assert torch.equal(changed, want), n
        assert torch.isfinite(t[:, 3, 6:8].float()).all(), n
    after = {n: _bits(t) for n, t in te.pools.items()}
    paged.paged_forward(te.model, te.pools, tokens, pos0, tables,
                        torch.zeros(3, dtype=torch.int32))
    for n, t in te.pools.items():
        assert torch.equal(_bits(t), after[n]), n
