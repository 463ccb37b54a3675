"""The port's speculative decoding (deepspeed_tpu_torch/inference/v2:
``paged.draft_prompt_lookup``, ``append_history``, ``_spec_tick``,
``fused_spec_decode_loop``, the engine's spec path and the serve loop's)
against the JAX package's on the CPU, fp32, with the JAX params carried
across (``models/convert.py``): the JAX spec tests (tests/test_spec_decode.py)
rerun on the port and held to the JAX engine.

The drafter and the history shift are held bit-equal to JAX's on seeded
histories; the loop's tokens, pointers, history, steps and spec counters
equal to JAX's on the same operands, the pools at 2e-4 (the JAX v2 tests'
tolerance); greedy and sampled tokens equal to the JAX spec engine's and
to the port's spec-off ones. Prompts that repeat make the tiny models'
greedy continuations loop, so drafts are proposed and accepted. On the
CPU the loops run eagerly on the kernels' plain versions; their graphs
are checked on the card (tests/test_torch_cuda.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import (
    InferenceEngineV2 as JEngine,
    RaggedInferenceEngineConfig as JConfig)
from deepspeed_tpu.inference.v2 import paged as jpaged
from deepspeed_tpu.models import GPT2 as JGPT2, Llama as JLlama
from deepspeed_tpu_torch.inference.v2 import (RaggedInferenceEngineConfig,
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
SPEC = {"enabled": True, "draft_len": 3, "min_ngram": 2,
        "history_window": 64}
JAX_MODELS = {"llama": JLlama, "gpt2": JGPT2}
# repeating prompts: the tiny models' greedy continuations loop on them
# (see _prompts), so the drafter proposes and the verify accepts
SEEDS = [[1, 2, 3] * 6, [3, 1, 4, 1, 5, 9, 2, 6] * 3, [9, 8, 7]]
SAMPLING = dict(temperature=0.9, top_k=50)
SPEC_KEYS = ("host_dispatches", "fused_dispatches", "fused_steps",
             "fused_slots", "fused_slot_tokens", "fused_live_slots",
             "decoded_tokens", "spec_proposed_tokens", "spec_accepted_tokens",
             "spec_hit_slots", "tokens_per_dispatch", "spec_acceptance_rate")
_PARAMS: dict = {}
_PROMPT_CACHE: dict = {}


def _params(family):
    if family not in _PARAMS:
        je = JEngine(JAX_MODELS[family](size="tiny"), JConfig(**ENGINE_KW))
        _PARAMS[family] = (je.params, jax.tree.map(np.asarray, je.params))
    return _PARAMS[family]


def _jax(family="llama", **over):
    return JEngine(JAX_MODELS[family](size="tiny"),
                   JConfig(**dict(ENGINE_KW, **over)),
                   params=_params(family)[0])


def _port(family="llama", **over):
    return build_engine(family, "tiny", dict(ENGINE_KW, **over),
                        params=_params(family)[1], device="cpu")


def _prompts(family="llama"):
    """SEEDS, the first two followed by their first 14 greedy tokens:
    the history then holds the loop the model decodes, so drafts land
    from the first tick (and are rejected where the loop breaks)."""
    if family not in _PROMPT_CACHE:
        gen = _port(family).generate(SEEDS[:2], max_new_tokens=14)
        _PROMPT_CACHE[family] = [s + g for s, g in zip(SEEDS, gen)] + SEEDS[2:]
    return _PROMPT_CACHE[family]


def _metrics(e):
    m = e.serving_metrics()
    return {k: m[k] for k in SPEC_KEYS}


# ---------------------------------------------------------------------
# config and the drafter
# ---------------------------------------------------------------------

@pytest.mark.parametrize("bad", [
    {"draft_len": 0}, {"min_ngram": 0}, {"history_window": 7},
    {"draft_len": 4, "min_ngram": 3, "history_window": 7},
    {"draft_len": 8, "min_ngram": 2, "history_window": 10}])
def test_speculative_config_validation_as_jax(bad):
    """The block validates what JAX's validates (Field(ge=...) and the
    window-covers-a-match validator), with its messages; off by
    default."""
    assert RaggedInferenceEngineConfig().speculative.enabled is False
    spec = dict(SPEC, **bad)
    with pytest.raises(Exception) as want:
        JConfig(speculative=spec)
    with pytest.raises(ValueError) as got:
        RaggedInferenceEngineConfig.from_dict({"speculative": spec})
    for phrase in ("greater than or equal", "history_window"):
        if phrase in str(want.value):
            assert phrase in str(got.value)
    RaggedInferenceEngineConfig.from_dict({"speculative": dict(
        SPEC, draft_len=4, min_ngram=3, history_window=8)})


def _histories(seed, b=16, h=24, vocab=6):
    """Seeded histories: a -1-filled left edge of random width (some rows
    all -1 but their tail), period-1 and period-2 repeats, a small
    vocabulary (many matches) and rows with no match."""
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, vocab, (b, h))
    hist[0] = 7                                   # period 1
    hist[1] = np.tile([4, 5], h // 2)             # period 2
    hist[2] = np.arange(h) + 100                  # no earlier match
    for i in range(3, b, 2):
        hist[i, :rng.integers(1, h)] = -1         # -1 fill on the left
    hist[4, :-1] = -1                             # only the pending token
    return hist


@pytest.mark.parametrize("min_ngram,draft_len", [(1, 1), (2, 3), (3, 4),
                                                 (2, 7)])
@pytest.mark.parametrize("seed", [0, 1])
def test_draft_prompt_lookup_bit_equal_to_jax(seed, min_ngram, draft_len):
    """draft and eff equal to JAX's drafter on seeded histories: -1 fill,
    period-1 repeats (the full-continuation match outranks the adjacent
    one), the latest match winning, misses."""
    hist = _histories(seed)
    draft, eff = paged.draft_prompt_lookup(
        torch.from_numpy(hist), min_ngram=min_ngram, draft_len=draft_len)
    jd, je = jpaged.draft_prompt_lookup(
        jnp.asarray(hist, jnp.int32), min_ngram=min_ngram,
        draft_len=draft_len)
    np.testing.assert_array_equal(eff.numpy(), np.asarray(je))
    np.testing.assert_array_equal(draft.numpy(), np.asarray(jd))
    assert eff.dtype == torch.int32 and (eff.numpy() > 0).any()
    if draft_len > 1 and min_ngram > 1:
        assert eff[2] == 0 and eff[0] == draft_len     # miss; period 1


def test_draft_prompt_lookup_cases():
    """JAX's drafter cases (test_spec_decode.py:64): the continuation of
    the latest match, misses, a tail touching the -1 fill."""
    pad = [-1] * 6
    hist = torch.tensor([pad + [5, 6, 7, 9, 5, 6], pad + [1, 2, 3, 4, 5, 6],
                         [-1] * 10 + [3, 5]])
    draft, eff = paged.draft_prompt_lookup(hist, min_ngram=2, draft_len=3)
    assert eff.tolist() == [3, 0, 0] and draft[0].tolist() == [7, 9, 5]
    d2, e2 = paged.draft_prompt_lookup(
        torch.tensor([[1, 2, 8, 8, 1, 2, 9, 9, 9, 1, 2]]), min_ngram=2,
        draft_len=2)
    assert e2.tolist() == [2] and d2[0].tolist() == [9, 9]
    d3, e3 = paged.draft_prompt_lookup(torch.full((1, 6), 7), min_ngram=2,
                                       draft_len=3)
    assert e3.tolist() == [3] and d3[0].tolist() == [7, 7, 7]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_append_history_bit_equal_to_jax(seed):
    """Each row shifts by its own count and stays right-aligned; m = 0
    rows come back unchanged; equal to JAX's."""
    rng = np.random.default_rng(seed)
    hist = _histories(seed, b=8, h=12)
    emitted = rng.integers(0, 50, (8, 4))
    m = rng.integers(0, 5, 8)
    m[0] = 0
    got = paged.append_history(torch.from_numpy(hist),
                               torch.from_numpy(emitted),
                               torch.from_numpy(m).to(torch.int32))
    want = jpaged.append_history(jnp.asarray(hist, jnp.int32),
                                 jnp.asarray(emitted, jnp.int32),
                                 jnp.asarray(m, jnp.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0].tolist() == hist[0].tolist()


# ---------------------------------------------------------------------
# the tick and the loop against JAX's on the same operands
# ---------------------------------------------------------------------

def _at_dispatch_state(engines, uids, prompts):
    for e in engines:
        logits = e.put(uids, prompts)
        for u, lg in zip(uids, np.asarray(logits)):
            e.state_manager.extend(u, [int(np.argmax(lg))])


def _loop_pair(budgets):
    je, te = _jax(speculative=SPEC), _port(speculative=SPEC)
    uids = list(budgets)
    _at_dispatch_state((je, te), uids, _prompts()[:len(uids)])
    ops = je._spec_operands(uids, 4, budgets, 5)
    state = te._spec_operands(uids, 4, budgets, 5)
    for got, want in ((state.tables, ops[2]), (state.hist, ops[6]),
                      (state.row_keys, ops[5])):
        np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                      np.asarray(want).astype(np.int64))
    return je, te, ops, state


def test_spec_tick_matches_jax_spec_tick():
    """One verify tick (greedy; drafts proposed and accepted) against
    JAX's jitted _spec_tick: targets, commits, the carry, the history and
    the counters equal, the pools at 2e-4."""
    je, te, ops, state = _loop_pair({0: 12, 1: 9, 2: 0})
    tok, pos, tables, act, rem, keys, hist = ops
    fn = jax.jit(functools.partial(
        jpaged._spec_tick, je.model, draft_len=3, min_ngram=2, eos=-1,
        temperature=0.0, top_k=0, top_p=0.0, use_kernel=True))
    want = fn(je.params, je.pools, tok, pos, tables, act, rem, keys,
              hist=hist)
    steps = torch.zeros((), dtype=torch.int32)
    live = state.active.numpy().copy()
    target, m, stats = paged._spec_tick(
        te.model, te.pools, state.tokens, state.pos, state.tables,
        state.active, state.remaining, state.row_keys, state.hist, steps,
        draft_len=3, min_ngram=2, eos=-1, temperature=0.0, top_k=0,
        top_p=0.0)
    # an inactive or pad row's targets are read nowhere (it commits none)
    np.testing.assert_array_equal(target.numpy()[live],
                                  np.asarray(want[0])[live])
    got = (m, state.tokens, state.pos, state.active, state.remaining,
           state.hist, stats)
    for g, w in zip(got, want[1:8]):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(w).astype(np.int64))
    assert int(stats[1]) > 0 and int(steps) == 1     # a draft landed
    for n in ("k", "v"):
        np.testing.assert_allclose(te.pools[n].numpy(),
                                   np.asarray(want[8][n]), **TOL)


@pytest.mark.parametrize("sampling", ["greedy", "eos", "sampled"])
def test_spec_loop_matches_jax_fused_spec_decode_loop(sampling):
    """paged.fused_spec_decode_loop against the JAX engine's jitted loop
    on the same operands (rows ending at budget inside the dispatch, an
    inactive row, a pad row; an EOS that cuts a row mid-commit): output
    tokens, per-row pointers, steps, the carry, the history and the spec
    counters equal, the pools at 2e-4."""
    budgets = {0: 12, 1: 5, 2: 0}
    kw = dict(temperature=0.0, top_k=0, top_p=0.0, eos_id=None)
    if sampling == "sampled":
        kw.update(SAMPLING)
    elif sampling == "eos":
        e = _port(speculative=SPEC)
        _at_dispatch_state((e,), [0], _prompts()[:1])
        kw["eos_id"] = e.decode_fused([0], 4, budgets={0: 12})[0][5]
    je, te, ops, state = _loop_pair(budgets)
    want = je._spec_fn(4, kw["temperature"], kw["top_k"], kw["top_p"],
                       kw["eos_id"])(je.params, je.pools, *ops)
    got = paged.fused_spec_decode_loop(
        te.model, te.pools, state.tokens, state.pos, state.tables,
        state.active, state.remaining, state.row_keys, state.hist,
        num_steps=4, draft_len=3, min_ngram=2, **kw)
    for g, w in zip(got[:9], want[:9]):
        np.testing.assert_array_equal(np.asarray(g).astype(np.int64),
                                      np.asarray(w).astype(np.int64))
    out, ptr = got[0].numpy(), got[1].numpy()
    assert out.shape == (4, 16) and (out[2:] == -1).all()
    assert (ptr[2:] == 0).all()
    for i in range(4):
        assert (out[i, :ptr[i]] >= 0).all() and (out[i, ptr[i]:] == -1).all()
    if sampling == "greedy":
        # row 1 spends its budget of 5 inside the 4 ticks
        assert int(got[8][1]) > 0 and ptr[1] == 5 and ptr[0] > 4
    for n in ("k", "v"):
        np.testing.assert_allclose(te.pools[n].numpy(),
                                   np.asarray(want[9][n]), **TOL)


# ---------------------------------------------------------------------
# engines: decode_fused, generate_fused, the serve loop
# ---------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["chain", "ring"])
@pytest.mark.parametrize("family", list(JAX_MODELS))
def test_spec_generate_fused_greedy_matches_jax_and_spec_off(family, mode):
    """Greedy generate_fused with speculation, in chain and in ring mode
    (fused_admission, chain depth 3), equals the JAX spec engine's tokens
    and counters, the port's spec-off fused and per-tick tokens; drafts
    land; every block comes back."""
    prompts = _prompts(family)
    over = dict(speculative=SPEC)
    if mode == "ring":
        over.update(fused_admission=True, max_inflight_dispatches=3)
    ref = _port(family).generate(prompts, max_new_tokens=16)
    off = _port(family, **dict(over, speculative={"enabled": False}))
    assert off.generate_fused(prompts, 16, k_steps=3) == ref
    te, je = _port(family, **over), _jax(family, **over)
    got = te.generate_fused(prompts, max_new_tokens=16, k_steps=3)
    assert got == ref
    assert je.generate_fused(prompts, max_new_tokens=16, k_steps=3) == got
    assert _metrics(te) == _metrics(je)
    m = te.serving_metrics()
    assert 0 < m["spec_accepted_tokens"] <= m["spec_proposed_tokens"]
    assert m["tokens_per_dispatch"] > 1.0
    assert te.free_blocks == ENGINE_KW["num_kv_blocks"]
    assert not te.state_manager.seqs


@pytest.mark.parametrize("k", [2, 4])
def test_spec_sampled_matches_jax_and_spec_off(k):
    """Stochastic speculation: position-keyed targets, so the tokens are
    the JAX spec engine's at the same K, and the port's spec-off tokens
    at any K."""
    kw = dict(max_new_tokens=10, seed=13, **SAMPLING)
    got = _port(speculative=SPEC).generate_fused(_prompts(), k_steps=k, **kw)
    assert got == _jax(speculative=SPEC).generate_fused(_prompts(), k_steps=k,
                                                        **kw)
    assert got == _port().generate_fused(_prompts(), k_steps=3, **kw)
    assert got != _port().generate(_prompts(), max_new_tokens=10)


def test_decode_fused_spec_dispatch_commits_its_pointers():
    """One speculative dispatch: each row commits its pointer's tokens
    (up to K * (1 + draft_len), budget-capped), the last left pending:
    the per-tick generate()'s tokens."""
    te = _port(speculative=SPEC)
    prompts = _prompts()[:2]
    ref = _port().generate(prompts, max_new_tokens=21)
    _at_dispatch_state((te,), [0, 1], prompts)
    out = te.decode_fused([0, 1], k_steps=4, budgets={0: 20, 1: 3})
    assert 4 < len(out[0]) <= 16 and out[0] == ref[0][1:1 + len(out[0])]
    assert out[1] == ref[1][1:4]
    for u in (0, 1):
        seq = te.state_manager.seqs[u]
        assert seq.pending == 1 and seq.tokens[-len(out[u]):] == out[u]
    m = te.serving_metrics()
    assert m["spec_accepted_tokens"] > 0 and m["fused_steps"] == 4


def test_spec_eos_constrained_pool_and_cancel():
    """EOS inside an accepted run, a pool too small for both prompts
    (admission between dispatches) and a cancel mid-stream: tokens as the
    per-tick generate()'s, every block back."""
    free = _port().generate([_prompts()[0]], max_new_tokens=12)[0]
    eos = free[6]
    p = [_prompts()[0], [9, 8, 7]]
    ref = _port().generate(p, max_new_tokens=12, eos_id=eos)
    te = _port(speculative=SPEC)
    got = te.generate_fused(p, max_new_tokens=12, k_steps=4, eos_id=eos)
    assert got == ref and got[0][-1] == eos
    p2 = [list(range(10)), list(range(12))]
    ref2 = _port(num_kv_blocks=6).generate(p2, max_new_tokens=12)
    e2 = _port(num_kv_blocks=6, speculative=SPEC)
    assert e2.generate_fused(p2, max_new_tokens=12, k_steps=3) == ref2
    assert e2.free_blocks == 6 and not e2.state_manager.seqs
    e3 = _port(num_kv_blocks=16, speculative=SPEC)
    loop = FusedServeLoop(e3, k_steps=2)
    loop.submit(_prompts()[0], 80, uid=7)        # 14 of 16 blocks
    got3 = []
    while loop.has_work():
        for evt in loop.step():
            got3 += evt.tokens
            if len(got3) >= 6 and not evt.finished:
                loop.cancel(7)
    assert loop.counters["cancellations"] == 1 and len(got3) < 80
    assert e3.free_blocks == 16 and not e3.state_manager.seqs


def test_spec_admission_order_invariance():
    """Per-uid sampled streams do not depend on admission: batched and a
    one-row serial admission in the other order give the same tokens."""
    def serve(e, order):
        loop = FusedServeLoop(e, k_steps=3, seed=13, **SAMPLING)
        for uid in order:
            loop.submit(_prompts()[uid - 10], 8, uid=uid)
        out = {u: [] for u in order}
        while loop.has_work():
            for evt in loop.step():
                out[evt.uid].extend(evt.tokens)
        return out

    assert serve(_port(speculative=SPEC), [10, 11, 12]) == serve(
        _port(speculative=SPEC, max_ragged_sequence_count=1), [12, 11, 10])


@pytest.mark.parametrize("over", [
    dict(kv_cache={"enabled": True, "dtype": "int8"}),
    dict(kv_cache={"enabled": True, "dtype": "fp8", "granularity": "token"}),
    dict(prefix_cache={"enabled": True})])
def test_spec_on_quantized_and_prefix_cache_engines(over):
    """Speculation over int8/fp8 pools (a rejected draft slot's stale
    code and scale are written again before any query reads them) and
    with the prefix cache (a cache hit seeds the drafter's window as a
    cold admission does): the per-tick generate()'s tokens."""
    prefix = [1, 2, 3] * 6
    prompts = [prefix + [3, 1, 4], prefix + [1, 5], [9, 2, 6]]
    ref_engine = _port(**over)
    ref_engine.generate([prefix + [7]], max_new_tokens=4)
    ref = ref_engine.generate(prompts, max_new_tokens=12)
    te = _port(speculative=SPEC, **over)
    te.generate_fused([prefix + [7]], max_new_tokens=4, k_steps=3)
    assert te.generate_fused(prompts, max_new_tokens=12, k_steps=3) == ref
    m = te.serving_metrics()
    assert m["spec_accepted_tokens"] > 0
    if "prefix_cache" in over:
        assert m["prefix_hits"] > 0
    assert te.free_blocks == te.num_kv_blocks


def test_set_draft_len_toggles_between_chains():
    """set_draft_len(0) switches a spec loop to plain decode at the next
    chain boundary and back; set_chain_depth clamps to the configured
    depth; the tokens stay the spec-off ones."""
    prompts = _prompts()
    ref = _port().generate_fused(prompts, 24, k_steps=2)
    te = _port(speculative=SPEC, max_inflight_dispatches=3)
    loop = FusedServeLoop(te, k_steps=2)
    assert loop.set_chain_depth(9) == 3 and loop.set_chain_depth(0) == 1
    # depth 1: every step ends at a chain boundary, where a toggle applies
    assert loop.set_draft_len(0) == 0 and loop.spec
    out = {}
    for i, p in enumerate(prompts):
        loop.submit(p, 24, uid=i)
    for _ in range(2):
        for evt in loop.step():
            out.setdefault(evt.uid, []).extend(evt.tokens)
        assert not loop.spec
    assert te.serving_metrics()["fused_dispatches"] > 0
    assert loop.set_draft_len(5) == 3
    while loop.has_work():
        for evt in loop.step():
            out.setdefault(evt.uid, []).extend(evt.tokens)
    loop.step()
    assert loop.spec and [out[i] for i in range(3)] == ref
    assert te.serving_metrics()["spec_proposed_tokens"] > 0
