"""The port's ring mode (``fused_admission``: deepspeed_tpu_torch/inference/v2
``paged.fused_serve_loop`` / ``fused_spec_serve_loop`` and
``FusedServeLoop``'s ring discipline) against the JAX package's on the CPU,
fp32, with the JAX params carried across (``models/convert.py``): the JAX
ring tests (tests/test_serving.py:156-224) rerun on the port and held to
the JAX engine and loop.

Tokens and the serving counters are held equal; the loops' rings, epochs,
pointers and carry equal to JAX's on the same operands, the pools at 2e-4
(the JAX v2 tests' tolerance). On the CPU the loops run eagerly on the
kernels' plain versions; their graphs are checked on the card
(tests/test_torch_cuda.py).
"""

import jax
import numpy as np
import pytest

from deepspeed_tpu.inference.v2 import (
    InferenceEngineV2 as JEngine,
    RaggedInferenceEngineConfig as JConfig)
from deepspeed_tpu.inference.v2.serve_loop import (
    FusedServeLoop as JServeLoop, ServeRequest as JRequest)
from deepspeed_tpu.models import Llama as JLlama
from deepspeed_tpu_torch.inference.v2 import build_engine, paged
from deepspeed_tpu_torch.inference.v2.serve_loop import (FusedServeLoop,
                                                         ServeRequest)

TOL = dict(rtol=2e-4, atol=2e-4)
ENGINE_KW = dict(dtype="float32", kv_block_size=8, num_kv_blocks=128,
                 max_chunk_size=16)
SPEC = {"enabled": True, "draft_len": 3, "min_ngram": 2,
        "history_window": 64}
PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7], [6, 7, 8, 9, 10, 11]]
SAMPLING = dict(temperature=0.9, top_k=50, seed=13)
KEYS = ("host_dispatches", "fused_dispatches", "fused_steps", "fused_slots",
        "fused_slot_tokens", "fused_live_slots", "decoded_tokens",
        "dispatches_per_token", "fused_occupancy", "spec_proposed_tokens",
        "spec_accepted_tokens", "spec_hit_slots")
_PARAMS: list = []


def _params():
    if not _PARAMS:
        je = JEngine(JLlama(size="tiny"), JConfig(**ENGINE_KW))
        _PARAMS.extend([je.params, jax.tree.map(np.asarray, je.params)])
    return _PARAMS


def _jax(**over):
    return JEngine(JLlama(size="tiny"), JConfig(**dict(ENGINE_KW, **over)),
                   params=_params()[0])


def _port(**over):
    return build_engine("llama", "tiny", dict(ENGINE_KW, **over),
                        params=_params()[1], device="cpu")


def _metrics(e):
    m = e.serving_metrics()
    return {k: m[k] for k in KEYS}


def _serve(loop, submits):
    """Submit all, run to the end: ({uid: tokens}, [(uid, tokens,
    finished, error)] in order)."""
    for args, kw in submits:
        loop.submit(*args, **kw)
    out, events = {}, []
    while loop.has_work():
        for evt in loop.step():
            out.setdefault(evt.uid, []).extend(evt.tokens)
            events.append((evt.uid, evt.tokens, evt.finished, evt.error))
    return out, events


def test_ring_greedy_parity_matches_jax():
    """JAX test_fused_admission_ring_greedy_parity (:156): ring mode gives
    chain mode's greedy tokens at <= 0.25 dispatches a token, with
    the JAX ring engine's tokens and counters; every block comes back."""
    ref = _port().generate_fused(PROMPTS, max_new_tokens=10, k_steps=3)
    te = _port(fused_admission=True, max_inflight_dispatches=3)
    got = te.generate_fused(PROMPTS, max_new_tokens=10, k_steps=3)
    assert got == ref
    je = _jax(fused_admission=True, max_inflight_dispatches=3)
    assert je.generate_fused(PROMPTS, max_new_tokens=10, k_steps=3) == got
    assert _metrics(te) == _metrics(je)
    assert te.serving_metrics()["dispatches_per_token"] <= 0.25
    assert te.free_blocks == 128 and not te.state_manager.seqs


def test_ring_eos_swap_constrained_and_stochastic():
    """JAX :168: EOS ends a row on the device; under a pool too small for
    both prompts the second is pre-staged and swapped into the first's row
    on the device: the per-tick generate()'s tokens and the JAX ring engine's
    tokens and counters; sampled tokens equal across chain and ring and
    to the JAX ring engine's."""
    free = _port().generate([[1, 2, 3, 4, 5]], max_new_tokens=10)[0]
    eos = free[4]
    p = [[1, 2, 3, 4, 5], [9, 8, 7]]
    ref = _port().generate(p, max_new_tokens=10, eos_id=eos)
    got = _port(fused_admission=True).generate_fused(
        p, max_new_tokens=10, k_steps=4, eos_id=eos)
    assert got == ref and got[0][-1] == eos
    p2 = [list(range(10)), list(range(12))]
    ref2 = _port(num_kv_blocks=6).generate(p2, max_new_tokens=12)
    te, je = (f(num_kv_blocks=6, fused_admission=True) for f in (_port,
                                                                 _jax))
    got2 = te.generate_fused(p2, max_new_tokens=12, k_steps=3)
    assert got2 == ref2
    assert je.generate_fused(p2, max_new_tokens=12, k_steps=3) == got2
    assert _metrics(te) == _metrics(je)
    assert te.free_blocks == 6
    kw = dict(max_new_tokens=8, **SAMPLING)
    a = _port().generate_fused(PROMPTS[:2], k_steps=2, **kw)
    b = _port(fused_admission=True).generate_fused(PROMPTS[:2], k_steps=4,
                                                   **kw)
    assert a == b
    assert _jax(fused_admission=True).generate_fused(PROMPTS[:2], k_steps=4,
                                                     **kw) == b


def test_ring_in_graph_swap_occupies_the_freed_slot():
    """JAX :198: more prompts than decode rows; ring mode stages the
    waiting ones and a finished row takes its staged request inside the
    loop: the staged request's tokens come back in the same chain read as
    the row's first occupant's, with no operand build between them. The
    events equal the JAX ring loop's, the tokens chain mode's."""
    prompts = [[1, 2, 3], [4, 5], [6, 7, 8], [9, 10]]
    over = dict(max_ragged_sequence_count=2, fused_admission=True,
                max_inflight_dispatches=4)
    ref = _port(max_ragged_sequence_count=2).generate_fused(
        prompts, max_new_tokens=6, k_steps=3)
    te = _port(**over)
    loop = FusedServeLoop(te, k_steps=3)
    swaps = []
    drain = loop._drain_ring

    def watched(ev, rowset, stage_map, state):
        staged = set(stage_map.values())
        drain(ev, rowset, stage_map, state)
        # a staged request that got tokens in this read ran in its row
        swaps.extend(u for u in staged
                     if any(e.uid == u and e.tokens for e in ev))

    loop._drain_ring = watched
    submits = [((p, 6), dict(uid=i)) for i, p in enumerate(prompts)]
    got, events = _serve(loop, submits)
    assert [got[i] for i in range(4)] == [r[:6] for r in ref]
    assert swaps and loop.counters["admitted"] == 4
    want = _serve(JServeLoop(_jax(**over), k_steps=3), submits)
    assert (got, events) == want
    assert te.free_blocks == 128 and not te.state_manager.seqs


def _stage_pair(spec: bool):
    """A JAX and a port ring loop at a chain's start with the same state:
    rows 0 and 1 live (budgets 2 and 7: row 0 ends on the second tick),
    uid 2 staged for row 0 and uid 3 for row 1; their operands."""
    over = dict(fused_admission=True, max_ragged_sequence_count=2,
                **({"speculative": SPEC} if spec else {}))
    engines = (_jax(**over), _port(**over))
    prompts = [[1, 2, 3] * 5, [9, 8, 7], [4, 5, 4, 5, 4], [6, 7]]
    budgets = {0: 2, 1: 7, 2: 9, 3: 4}
    ops = []
    for e, (loop_cls, req_cls) in zip(engines, ((JServeLoop, JRequest),
                                                (FusedServeLoop,
                                                 ServeRequest))):
        logits = e.put(list(budgets), prompts)
        for u, lg in zip(budgets, np.asarray(logits)):
            e.state_manager.extend(u, [int(np.argmax(lg))])
            e.state_manager.reserve(u, budgets[u])
        loop = loop_cls(e, k_steps=6)
        loop.staged = {u: req_cls(uid=u, prompt=prompts[u],
                                  max_new_tokens=budgets[u])
                       for u in (2, 3)}
        ops.append(loop._serve_operands([0, 1], {0: 2, 1: 7}, {0: 2, 1: 3}))
    return engines, ops


@pytest.mark.parametrize("spec", [False, True])
def test_serve_loops_match_jax_and_epochs_attribute_tokens(spec):
    """paged.fused_serve_loop / fused_spec_serve_loop against the JAX
    engine's jitted loops on the same operands, greedy: the ring, its
    epochs (0 the row's first occupant, 1 its staged request, -1 an idle
    slot), the pointers, every carry operand and the steps equal; the
    pools at 2e-4. Row 0's occupant ends on its second tick and its stage
    takes the row on the device; row 1's stage waits for row 1's end."""
    (je, te), (jops, state) = _stage_pair(spec)
    np.testing.assert_array_equal(state.stage_tables.numpy(),
                                  np.asarray(jops[11]))
    kw = dict(temperature=0.0, top_k=0, top_p=0.0, eos_id=None)
    jfn = (je._spec_serve_fn if spec else je._serve_fn)(
        6, kw["temperature"], kw["top_k"], kw["top_p"], kw["eos_id"])
    s = state
    if spec:
        tok, pos, tab, act, rem, keys, epoch, s_tok, s_pos, s_rem, \
            s_keys, s_tab, s_valid, ring, ring_ep, ring_ptr, hist, \
            s_hist, sstat = jops
        want = jfn(je.params, je.pools, tok, pos, tab, act, rem, keys, hist,
                   epoch, s_tok, s_pos, s_rem, s_keys, s_tab, s_hist,
                   s_valid, ring, ring_ep, ring_ptr, sstat)
        got = paged.fused_spec_serve_loop(
            te.model, te.pools, s.tokens, s.pos, s.tables, s.active,
            s.remaining, s.row_keys, s.hist, s.epoch, s.stage_tokens,
            s.stage_pos, s.stage_rem, s.stage_keys, s.stage_tables,
            s.stage_hist, s.stage_valid, s.ring, s.ring_epochs, s.ring_ptr,
            s.spec_stats, num_steps=6, draft_len=3, min_ngram=2, **kw)
    else:
        want = jfn(je.params, je.pools, *jops)
        got = paged.fused_serve_loop(
            te.model, te.pools, s.tokens, s.pos, s.tables, s.active,
            s.remaining, s.row_keys, s.epoch, s.stage_tokens, s.stage_pos,
            s.stage_rem, s.stage_keys, s.stage_tables, s.stage_valid,
            s.ring, s.ring_epochs, s.ring_ptr, num_steps=6, **kw)
    # the ring without its trash column
    got = (got[0][:, :-1], got[1][:, :-1]) + got[2:]
    for g, w in zip(got[:-1], want[:-1]):
        np.testing.assert_array_equal(np.asarray(g).astype(np.int64),
                                      np.asarray(w).astype(np.int64))
    ring_ep = np.asarray(got[1])
    assert (ring_ep[0] == 1).any() and (ring_ep[0] == 0).sum() == 2
    assert np.asarray(got[-4 if spec else -3])[0] == 1    # row 0's epoch
    assert set(np.unique(ring_ep[1])) <= {-1, 0, 1}
    for n in ("k", "v"):
        np.testing.assert_allclose(te.pools[n].numpy(),
                                   np.asarray(want[-1][n]), **TOL)


@pytest.mark.parametrize("spec", [False, True])
def test_one_host_read_per_chain(spec):
    """Ring mode reads the device once a chain (counted on the loop and
    on the ring states), chain mode once a dispatch; both give the same
    tokens."""
    over = {"speculative": SPEC} if spec else {}
    chain = FusedServeLoop(_port(max_inflight_dispatches=3, **over),
                           k_steps=2)
    te = _port(fused_admission=True, max_inflight_dispatches=3, **over)
    ring = FusedServeLoop(te, k_steps=2)
    submits = [((p, 12), dict(uid=i)) for i, p in enumerate(PROMPTS)]
    assert _serve(chain, submits)[0] == _serve(ring, submits)[0]
    m = te.serving_metrics()
    assert chain.host_reads == chain.e.serving_metrics()["fused_dispatches"]
    assert ring.host_reads == ring.counters["chain_drains"]
    assert ring.host_reads == sum(s.reads for s in te._ring_states.values())
    assert ring.host_reads < m["fused_dispatches"]
