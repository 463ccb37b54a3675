"""The port's KV migration and disaggregated serving against the JAX
package, fp32 on the CPU (tests/test_disagg.py:62-395, :511, :557 rerun on
``deepspeed_tpu_torch``): the wire format bit for bit in both directions
for every payload dtype, export -> import continuation against the
never-moved run and against the JAX engines' own migration, a JAX export
imported into the port, int8 and fp8 pools travelling as stored, the
prefix-chain re-publish, every refused import leaving the pools untouched,
the serve loop's external-prefill admission in chain and ring mode,
preemption of an imported request, the router over fake replicas, and
the two-replica disaggregated run end to end.

The JAX params are carried across (``models/convert.py``); the JAX
engines run with their sanitizers off (the port refuses them). Tokens are
held equal. Every test leaves its engines empty (``_assert_clean``, as
JAX's). On the CPU the pools are written by the same ``index_copy_`` the
card runs; the card's pinned-memory path is checked in
tests/test_torch_cuda.py. ~30 s.
"""

import asyncio

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import (
    InferenceEngineV2 as JEngine,
    RaggedInferenceEngineConfig as JConfig)
from deepspeed_tpu.inference.v2.ragged import KVExportState as JState
from deepspeed_tpu.models import Llama as JLlama
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceEngineConfig,
                                              build_engine)
from deepspeed_tpu_torch.inference.v2.ragged import KVExportState
from deepspeed_tpu_torch.inference.v2.serve_loop import FusedServeLoop
from deepspeed_tpu_torch.serving import (AsyncInferenceServer,
                                         InferenceRouter, PrefillEngine,
                                         RequestFailed, RouterConfig,
                                         ServingConfig)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side runs tiny models: one intra-op thread a worker
    keeps it from spinning against the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


PROMPT = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11]
ENGINE_KW = dict(dtype="float32", kv_block_size=8, num_kv_blocks=64,
                 max_chunk_size=16, prefix_cache={"enabled": True})
INT8 = {"enabled": True, "dtype": "int8", "grow_pool": False}
FP8 = {"enabled": True, "dtype": "fp8", "grow_pool": False}
# one JAX pair, one port pair and their params, shared by the module's
# engine tests (each leaves every engine empty)
_SHARED: dict = {}


def _jax_pair():
    """(exporter, importer) JAX engines over one set of params."""
    if "jax" not in _SHARED:
        ja = JEngine(JLlama(size="tiny"), JConfig(**ENGINE_KW))
        jb = JEngine(JLlama(size="tiny"), JConfig(**ENGINE_KW),
                     params=ja.params)
        _SHARED["jax"] = (ja, jb)
        _SHARED["params"] = jax.tree.map(np.asarray, ja.params)
    return _SHARED["jax"]


def _port(**over):
    """A fresh port engine on the JAX params."""
    _jax_pair()
    return build_engine("llama", "tiny", dict(ENGINE_KW, **over),
                        params=_SHARED["params"], device="cpu")


def _port_pair():
    """(exporter, importer) port engines over one model: the importer is
    built with ``params=exporter.params`` and shares its weights."""
    if "port" not in _SHARED:
        ea = _port()
        eb = InferenceEngineV2(
            ea.model, RaggedInferenceEngineConfig.from_dict(ENGINE_KW),
            params=ea.params)
        _SHARED["port"] = (ea, eb)
    return _SHARED["port"]


def _refs(prompts, max_new=10, k=3):
    """The JAX engine's generate_fused tokens, one request at a time."""
    key = (tuple(map(tuple, prompts)), max_new, k)
    if key not in _SHARED:
        ja, _ = _jax_pair()
        _SHARED[key] = [ja.generate_fused([p], max_new_tokens=max_new,
                                          k_steps=k)[0] for p in prompts]
    return _SHARED[key]


def _assert_clean(e, nb=64):
    assert e.free_blocks == nb and not e.state_manager.seqs, \
        (e.free_blocks, e.state_manager.seqs)


def _continue(engine, uid, first, n, k=3):
    """decode_fused from an imported sequence until ``n`` tokens."""
    out = [first]
    while len(out) < n:
        out.extend(engine.decode_fused([uid], k_steps=k,
                                       budgets={uid: n - len(out)})[uid])
    engine.flush(uid)
    return out


def _pool_snapshot(engine):
    return ({k: v.data_ptr() for k, v in engine.pools.items()},
            {k: v.clone() for k, v in engine.pools.items()},
            engine.free_blocks, dict(engine.state_manager.seqs))


def _assert_untouched(engine, snap):
    ptrs, pools, free, seqs = snap
    assert {k: v.data_ptr() for k, v in engine.pools.items()} == ptrs
    for k, v in engine.pools.items():
        assert torch.equal(v.view(torch.uint8), pools[k].view(torch.uint8))
    assert engine.free_blocks == free
    assert engine.state_manager.seqs == seqs


# ---------------------------------------------------------------------
# wire format (host only)

# payload dtypes: (torch dtype, numpy dtype as the JAX engine holds it,
# the unsigned view both compare through)
WIRE = {"float32": (torch.float32, np.float32, np.uint32),
        "bfloat16": (torch.bfloat16, ml_dtypes.bfloat16, np.uint16),
        "float16": (torch.float16, np.float16, np.uint16),
        "int8": (torch.int8, np.int8, np.uint8),
        "fp8": (torch.float8_e4m3fn, ml_dtypes.float8_e4m3fn, np.uint8)}


def _payload_bits(name, seed=0):
    """{slab: unsigned bits} of a 2-layer, 3-block payload: random bits
    (every pattern, NaN codes included) for fp slabs, and for the
    quantized ones codes plus f32 scale slabs."""
    rng = np.random.default_rng(seed)
    _, _, ubits = WIRE[name]

    def bits(shape, u):
        return rng.integers(0, np.iinfo(u).max, shape, dtype=np.uint64
                            ).astype(u)

    out = {s: (bits((2, 3, 8, 2, 4), ubits), name) for s in "kv"}
    if name in ("int8", "fp8"):
        out.update({s: (rng.random((2, 3, 8, 2)).astype(np.float32)
                        .view(np.uint32), "float32") for s in ("ks", "vs")})
    return out


def _torch_payload(bits):
    return {k: torch.from_numpy(b.copy()).view(WIRE[n][0])
            for k, (b, n) in bits.items()}


def _numpy_payload(bits):
    return {k: b.view(WIRE[n][1]) for k, (b, n) in bits.items()}


def _bits(t):
    u = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()]
    return t.contiguous().view(u).numpy()


@pytest.mark.parametrize("name", list(WIRE))
def test_kv_export_wire_roundtrip_bit_exact(name):
    """JAX test_kv_export_wire_roundtrip_bit_exact (:62) for every payload
    dtype: to_bytes/from_bytes keep the tokens, the layout and every
    array bit for bit (NaN patterns included); a version bump is
    refused."""
    pay = _torch_payload(_payload_bits(name))
    st = KVExportState(tokens=list(range(25)), n_generated=1, seen=24,
                       block_size=8, kv_dtype=name, payload=pay,
                       handoff_id=7, source="prefill0")
    st2 = KVExportState.from_bytes(st.to_bytes())
    assert st2.tokens == st.tokens and st2.seen == 24
    assert st2.n_generated == 1 and st2.kv_dtype == name
    assert st2.handoff_id == 7 and st2.source == "prefill0"
    assert st2.prompt_tokens == list(range(24))
    assert st2.generated_tokens == [24]
    assert st2.payload_blocks == 3
    for k in pay:
        assert st2.payload[k].dtype == pay[k].dtype
        assert np.array_equal(_bits(st2.payload[k]), _bits(pay[k])), k
    assert st2.payload_bytes == st.payload_bytes
    bad = bytearray(st.to_bytes())
    idx = bad.find(b'"version": 1')
    bad[idx:idx + 12] = b'"version": 9'
    with pytest.raises(ValueError, match="wire version"):
        KVExportState.from_bytes(bytes(bad))


@pytest.mark.parametrize("name", list(WIRE))
def test_wire_buffers_interchange_with_jax(name):
    """A JAX to_bytes buffer decodes in the port and a port buffer decodes
    in JAX, arrays bit-equal through unsigned views; for the same state
    the two buffers are the same bytes."""
    bits = _payload_bits(name, seed=1)
    head = dict(tokens=[5, 6, 7, 8, 9], n_generated=2, seen=4,
                block_size=8, kv_dtype=name, handoff_id=None,
                source="engine")
    jst = JState(payload=_numpy_payload(bits), **head)
    tst = KVExportState(payload=_torch_payload(bits), **head)
    jbuf, tbuf = jst.to_bytes(), tst.to_bytes()
    assert jbuf == tbuf
    from_jax = KVExportState.from_bytes(jbuf)
    from_port = JState.from_bytes(tbuf)
    for k, (b, _) in bits.items():
        assert np.array_equal(_bits(from_jax.payload[k]).view(b.dtype), b)
        assert np.array_equal(np.asarray(from_port.payload[k]).view(
            b.dtype), b)
    assert from_jax.tokens == jst.tokens and from_port.seen == tst.seen


# ---------------------------------------------------------------------
# cross-engine round trips

def test_export_import_bit_identical_continuation():
    """JAX :106: prefill on A, export at the dispatch boundary, through
    the wire, import into B, continue: the greedy tokens equal the
    never-moved run, and the JAX engines' own export -> import
    continuation; B's pools are written in place (data_ptr unchanged);
    both engines end empty."""
    ea, eb = _port_pair()
    ja, jb = _jax_pair()
    ref = ea.generate_fused([PROMPT], max_new_tokens=12, k_steps=3)[0]
    _assert_clean(ea)
    jt0 = ja.prefill_request(42, PROMPT)
    jst = ja.export_request(42, n_generated=1)
    jout = _continue(jb, 42, jb.import_request(42, jst), 12)

    t0 = ea.prefill_request(42, PROMPT)
    assert t0 == ref[0] == jt0
    st = ea.export_request(42, n_generated=1, source="engineA")
    _assert_clean(ea)
    assert st.payload_blocks == 2 and st.seen == len(PROMPT)
    st = KVExportState.from_bytes(st.to_bytes())
    ptrs = {k: v.data_ptr() for k, v in eb.pools.items()}
    assert eb.import_request(42, st) == t0
    assert {k: v.data_ptr() for k, v in eb.pools.items()} == ptrs
    out = _continue(eb, 42, t0, 12)
    assert out == ref == jout
    _assert_clean(eb)
    _assert_clean(ja)
    _assert_clean(jb)


def test_jax_export_imports_into_the_port_and_back():
    """A JAX engine's export (through its wire buffer) imported into the
    port engine continues as the JAX importer does; a port export
    imported into a JAX engine continues as the port does."""
    ea, eb = _port_pair()
    ja, jb = _jax_pair()
    ja.prefill_request(43, PROMPT)
    buf = ja.export_request(43, n_generated=1).to_bytes()
    jout = _continue(jb, 43, jb.import_request(43, JState.from_bytes(buf)),
                     10)
    st = KVExportState.from_bytes(buf)
    assert set(st.payload) == {"k", "v"}
    assert st.payload["k"].dtype == torch.float32
    out = _continue(eb, 43, eb.import_request(43, st), 10)
    assert out == jout
    ea.prefill_request(44, PROMPT)
    tbuf = ea.export_request(44, n_generated=1).to_bytes()
    jout2 = _continue(jb, 44, jb.import_request(44, JState.from_bytes(tbuf)),
                      10)
    assert jout2 == out
    for e in (ea, eb, ja, jb):
        _assert_clean(e)


def test_single_token_prompt_exports_layout_only():
    """A one-token sequence scheduled but not yet run has no KV written at
    its boundary: the payload keeps the pool layout with zero blocks, and
    the importer computes it in its first dispatch, continuing as the
    never-moved run."""
    ea, eb = _port_pair()
    ref = ea.generate_fused([[7]], max_new_tokens=6, k_steps=3)[0]
    ea.schedule([45], [[7]])
    st = ea.export_request(45)
    assert st.payload_blocks == 0 and st.payload_bytes == 0
    assert {k: tuple(v.shape) for k, v in st.payload.items()} == {
        k: (v.shape[0], 0) + tuple(v.shape[2:]) for k, v in ea.pools.items()}
    st = KVExportState.from_bytes(st.to_bytes())
    assert eb.import_request(45, st) == 7
    out = []
    while len(out) < 6:
        out.extend(eb.decode_fused([45], k_steps=3,
                                   budgets={45: 6 - len(out)})[45])
    eb.flush(45)
    assert out == ref
    _assert_clean(ea)
    _assert_clean(eb)


def test_import_republishes_prefix_chain():
    """JAX :141: the migrated full blocks publish into the importer's
    prefix cache; a follow-up same-prefix prompt there admits warm."""
    ea, eb = _port_pair()
    ea.prefill_request(50, PROMPT)
    st = ea.export_request(50, n_generated=1)
    eb.import_request(50, st)
    assert eb.state_manager.cache.cached_blocks >= 1
    eb.reset_serving_metrics()
    eb.generate_fused([PROMPT + [30, 31, 32, 33, 34]], max_new_tokens=4,
                      k_steps=2)
    m = eb.serving_metrics()
    assert m["prefix_hits"] >= 1 and m["prefill_tokens_saved"] >= 8, m
    eb.flush(50)
    _assert_clean(ea)
    _assert_clean(eb)


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_export_import_quantized_pools_travel_as_stored(kv):
    """JAX :162, on int8 and fp8 pools: codes and f32 scale slabs travel
    as stored (no dequantize), the payload's bytes a token equal the
    engine's kv_bytes_per_token, the greedy continuation equals the
    never-moved run and the JAX engine's, and a quantized payload is
    refused by a full-precision engine before any pool is touched."""
    cache = {"int8": INT8, "fp8": FP8}[kv]
    qa = _port(kv_cache=cache)
    qb = InferenceEngineV2(qa.model, RaggedInferenceEngineConfig.from_dict(
        dict(ENGINE_KW, kv_cache=cache)), params=qa.params)
    ref = qa.generate_fused([PROMPT], max_new_tokens=10, k_steps=3)[0]
    if kv == "int8":
        ja, _ = _jax_pair()
        jq = JEngine(JLlama(size="tiny"), JConfig(**dict(
            ENGINE_KW, kv_cache=INT8)), params=ja.params)
        assert jq.generate_fused([PROMPT], max_new_tokens=10,
                                 k_steps=3)[0] == ref
    t0 = qa.prefill_request(7, PROMPT)
    st = qa.export_request(7, n_generated=1)
    assert set(st.payload) == {"k", "v", "ks", "vs"}
    assert st.payload["k"].dtype == qa.pools["k"].dtype
    assert st.payload["ks"].dtype == torch.float32
    assert st.kv_dtype == kv
    assert st.bytes_per_token() == pytest.approx(qa.kv_bytes_per_token(),
                                                 rel=1e-9)
    st = KVExportState.from_bytes(st.to_bytes())
    ptrs = {k: v.data_ptr() for k, v in qb.pools.items()}
    out = _continue(qb, 7, qb.import_request(7, st), 10)
    assert out == ref and out[0] == t0
    assert {k: v.data_ptr() for k, v in qb.pools.items()} == ptrs
    _assert_clean(qa)
    _assert_clean(qb)
    qa.prefill_request(8, PROMPT)
    st8 = qa.export_request(8, n_generated=1)
    ea, _ = _port_pair()
    snap = _pool_snapshot(ea)
    with pytest.raises(ValueError, match="dtype"):
        ea.import_request(8, st8)
    _assert_untouched(ea, snap)
    _assert_clean(qa)


def _mismatch(case):
    """(importer, state) for one layout mismatch."""
    ea, eb = _port_pair()
    if case == "slab_shape":
        # per-token scales into per-head scale pools
        src = _port(kv_cache=dict(INT8, granularity="token"))
        dst = _SHARED.setdefault("int8_head", _port(kv_cache=INT8))
        src.prefill_request(60, PROMPT)
        return dst, src.export_request(60, n_generated=1)
    ea.prefill_request(60, PROMPT)
    st = ea.export_request(60, n_generated=1)
    if case == "block_size":
        st.block_size = 16
    elif case == "slabs":
        del st.payload["v"]
    elif case == "payload_dtype":
        st.payload = {k: v.to(torch.bfloat16) for k, v in st.payload.items()}
    elif case == "payload_blocks":
        st.payload["v"] = st.payload["v"][:, :1]
    return eb, st


@pytest.mark.parametrize("case,match", [
    ("block_size", "block size"), ("slabs", "slabs"),
    ("slab_shape", "shape"), ("payload_dtype", "bfloat16"),
    ("payload_blocks", "blocks")])
def test_layout_mismatch_raises_before_any_pool_mutation(case, match):
    """Every layout mismatch raises ValueError before the importer
    allocates or writes: its pools keep their addresses and bytes, its
    free blocks and sequences are unchanged."""
    dst, st = _mismatch(case)
    snap = _pool_snapshot(dst)
    with pytest.raises(ValueError, match=match):
        dst.import_request(61, st)
    _assert_untouched(dst, snap)
    _assert_clean(dst)


@pytest.mark.parametrize("case,match", [
    ("pool_too_small", "exhausted"), ("uid_live", "already live"),
    ("not_at_boundary", "one pending token"), ("too_long", "max")])
def test_refused_import_leaks_nothing(case, match):
    """An import the pool cannot take (too few blocks, a live uid, a
    sequence off its dispatch boundary, a history past the engine's max
    length) raises RuntimeError with the pool and its accounting as they
    were."""
    ea, eb = _port_pair()
    ea.prefill_request(62, list(range(1, 31)))
    st = ea.export_request(62, n_generated=1)
    dst = eb
    if case == "pool_too_small":
        dst = _port(num_kv_blocks=3)
    elif case == "uid_live":
        eb.put([62], [[3, 4]])
    elif case == "not_at_boundary":
        st.seen -= 1
    elif case == "too_long":
        # a 16-token max length: two blocks a sequence
        dst = build_engine("llama", "tiny", ENGINE_KW, device="cpu",
                           max_seq_len=16)
    snap = _pool_snapshot(dst)
    with pytest.raises(RuntimeError, match=match):
        dst.import_request(62, st)
    _assert_untouched(dst, snap)
    eb.flush(62)
    _assert_clean(ea)
    _assert_clean(eb)


# ---------------------------------------------------------------------
# serve loop: external-prefill admission

@pytest.mark.parametrize("ring", [False, True])
def test_serve_loop_external_prefill_admission(ring):
    """JAX :235 in chain and ring mode: submit_imported through the
    FusedServeLoop skips the prefill pass, re-emits its carried first
    token, and streams the co-located run's tokens (the port's and the
    JAX engine's); the imports counter ticks, pools end clean. In ring
    mode the imported request also stages past max_ragged_sequence_count
    like any other (one decode row)."""
    ea, _ = _port_pair()
    over = dict(fused_admission=True, max_ragged_sequence_count=1) \
        if ring else {}
    eb = _port(**over)
    prompts = [PROMPT, [9, 8, 7]]
    refs = _refs(prompts)
    t0 = ea.prefill_request(70, PROMPT)
    st = ea.export_request(70, n_generated=1)
    loop = FusedServeLoop(eb, k_steps=3, strict=True, replica="rB")
    assert loop.replica == "rB"
    uid_m = loop.submit_imported(st, max_new_tokens=10, emit_carried=True)
    uid_f = loop.submit([9, 8, 7], 10)
    got = {uid_m: [], uid_f: []}
    while loop.has_work():
        for evt in loop.step():
            assert evt.error is None, evt
            got[evt.uid].extend(evt.tokens)
    assert got[uid_m] == refs[0] and got[uid_f] == refs[1]
    assert got[uid_m][0] == t0
    assert loop.counters["imports"] == 1
    with pytest.raises(ValueError, match="already generated"):
        loop.submit_imported(st, max_new_tokens=1)
    _assert_clean(ea)
    _assert_clean(eb)


def test_serve_loop_import_failure_fails_only_that_request():
    """A payload the engine refuses at admission ends that request with
    an error event; the loop serves the rest."""
    ea, eb = _port_pair()
    ea.prefill_request(71, PROMPT)
    st = ea.export_request(71, n_generated=1)
    st.block_size = 16
    loop = FusedServeLoop(eb, k_steps=3)
    bad = loop.submit_imported(st, max_new_tokens=10)
    ok = loop.submit([9, 8, 7], 10)
    errors, got = {}, []
    while loop.has_work():
        for evt in loop.step():
            if evt.error:
                errors[evt.uid] = evt.error
            if evt.uid == ok:
                got.extend(evt.tokens)
    assert set(errors) == {bad} and "block size" in errors[bad]
    assert got == _refs([PROMPT, [9, 8, 7]])[1]
    _assert_clean(ea)
    _assert_clean(eb)


def test_imported_request_preemption_restore():
    """JAX :557: a migrated request parked by a higher-priority arrival
    restores through the normal re-prefill and finishes as the
    never-moved runs do."""
    ea, _ = _port_pair()
    e_small = _port(num_kv_blocks=10)
    ref_lo = ea.generate_fused([PROMPT], max_new_tokens=40, k_steps=4)[0]
    ref_hi = ea.generate_fused([[9, 8, 7]], max_new_tokens=40,
                               k_steps=4)[0]
    t0 = ea.prefill_request(90, PROMPT)
    st = ea.export_request(90, n_generated=1)

    async def main():
        async with AsyncInferenceServer(
                e_small, ServingConfig(k_steps=4)) as s:
            lo = await s.submit_imported(st, max_new_tokens=40,
                                         priority=2, emit_carried=True)
            first = await lo.__anext__()
            hi = await s.submit([9, 8, 7], max_new_tokens=40, priority=0)
            out_hi = await hi.tokens()
            out_lo = [first] + await lo.tokens()
            return out_lo, out_hi, s.metrics()

    out_lo, out_hi, m = asyncio.run(main())
    assert out_lo[0] == t0
    assert out_lo == ref_lo and out_hi == ref_hi
    assert m["imports"] == 1
    assert m["preemptions"] >= 1 and m["restores"] >= 1, m
    _assert_clean(e_small, nb=10)
    _assert_clean(ea)


# ---------------------------------------------------------------------
# router units over fake replicas (host only)

class _FakeHandle:
    def __init__(self, tokens=None, fail=None):
        self._tokens = list(tokens or [])
        self._fail = fail
        self.cancelled = False

    def cancel(self):
        self.cancelled = True

    def __aiter__(self):
        self._i = 0
        return self

    async def __anext__(self):
        if self._i < len(self._tokens):
            self._i += 1
            return self._tokens[self._i - 1]
        if self._fail is not None:
            raise RequestFailed(self._fail)
        raise StopAsyncIteration


class _FakeReplica:
    """Duck-typed AsyncInferenceServer for the placement units."""

    def __init__(self, name, affinity=0, open_=0, free=100,
                 accepting=True, tokens=(1, 2, 3), fail=None,
                 reject=False):
        self.config = ServingConfig(replica=name)
        self._affinity = affinity
        self.open_requests = open_
        self.free_blocks = free
        self.accepting = accepting
        self._tokens = list(tokens)
        self._fail = fail
        self._reject = reject
        self.submits: list = []

    async def start(self):
        pass

    async def stop(self, drain=True):
        pass

    def prefix_affinity(self, tokens):
        return self._affinity

    async def submit(self, prompt, *, max_new_tokens=None,
                     priority=None, uid=None):
        if self._reject:
            raise RuntimeError("serving queue full")
        self.submits.append(("submit", list(prompt), max_new_tokens, uid))
        return _FakeHandle(self._tokens, fail=self._fail)

    async def submit_imported(self, state, *, max_new_tokens=None,
                              priority=None, uid=None,
                              emit_carried=False):
        self.submits.append(("imported", state, max_new_tokens, uid))
        return _FakeHandle(self._tokens, fail=self._fail)

    def metrics(self):
        return {"decoded_tokens": 0, "imports": 0,
                "prefix_hit_rate": 0.0, "prefill_tokens_saved": 0}


def _route(replicas, prompt, config=None, **submit_kw):
    async def main():
        router = InferenceRouter(replicas, config)
        async with router:
            h = await router.submit(prompt, **submit_kw)
            toks = await h.tokens()
        return toks, h, router

    return asyncio.run(main())


def test_router_prefix_affinity_placement():
    """JAX :322: the replica holding the longest cached prefix chain wins
    even when more loaded; the counters attribute the decision."""
    warm = _FakeReplica("warm", affinity=3, open_=5)
    cold = _FakeReplica("cold", affinity=0, open_=0)
    toks, h, router = _route([cold, warm], [1, 2, 3], max_new_tokens=8)
    assert toks == [1, 2, 3] and h.replica == "warm"
    assert router.stats["routed_affinity"] == 1
    assert warm.submits and not cold.submits


def test_router_least_loaded_fallback_and_backpressure():
    """JAX :334: no affinity -> least loaded; a replica over
    max_open_per_replica is skipped even with the best prefix; one under
    the free-block watermark drains."""
    busy = _FakeReplica("busy", open_=9)
    idle = _FakeReplica("idle", open_=1)
    _, h, router = _route([busy, idle], [5, 6], max_new_tokens=4)
    assert h.replica == "idle"
    assert router.stats["routed_least_loaded"] == 1
    capped = _FakeReplica("capped", affinity=3, open_=4)
    ok = _FakeReplica("ok", open_=2)
    _, h2, router2 = _route([capped, ok], [5, 6],
                            config={"max_open_per_replica": 4})
    assert h2.replica == "ok"
    assert router2.stats["backpressure_skips"] >= 1
    dry = _FakeReplica("dry", free=2, open_=0)
    wet = _FakeReplica("wet", free=50, open_=7)
    _, h3, router3 = _route([dry, wet], [5, 6],
                            config={"drain_free_block_watermark": 8})
    assert h3.replica == "wet"
    assert router3.stats["drain_skips"] >= 1
    # a refusing replica is skipped for the next candidate
    full = _FakeReplica("full", affinity=5, reject=True)
    spare = _FakeReplica("spare")
    _, h4, router4 = _route([full, spare], [5, 6])
    assert h4.replica == "spare" and router4.stats["backpressure_skips"]


def test_router_reroutes_failed_request_with_history():
    """JAX :364: a mid-stream failure resubmits prompt + streamed tokens
    under the same uid to the next replica; the client stream is
    seamless; past reroute_retries the failure surfaces."""
    flaky = _FakeReplica("flaky", affinity=2, tokens=(10, 11),
                         fail="KV pool exhausted")
    backup = _FakeReplica("backup", tokens=(12, 13))
    toks, h, router = _route([flaky, backup], [1, 2], max_new_tokens=4)
    assert toks == [10, 11, 12, 13]
    assert h.replica == "backup"
    assert router.stats["reroutes"] == 1
    kind, prompt2, max_new2, uid2 = backup.submits[0]
    assert kind == "submit"
    assert prompt2 == [1, 2, 10, 11]
    assert max_new2 == 2
    assert uid2 == flaky.submits[0][3]
    f1 = _FakeReplica("f1", tokens=(), fail="boom")
    f2 = _FakeReplica("f2", tokens=(), fail="boom")

    async def fail_main():
        router = InferenceRouter([f1, f2], {"reroute_retries": 1})
        async with router:
            hh = await router.submit([1], max_new_tokens=4)
            with pytest.raises(RequestFailed, match="reroute"):
                await hh.tokens()
        return router

    assert asyncio.run(fail_main()).stats["failed"] == 1


def test_router_requires_prefill_engine_for_disaggregation():
    """JAX :395, and the router's config refuses unknown keys."""
    with pytest.raises(ValueError, match="PrefillEngine"):
        InferenceRouter([_FakeReplica("a")],
                        {"disaggregation": {"enabled": True}})
    with pytest.raises(ValueError, match="unknown config key"):
        InferenceRouter([_FakeReplica("a")], {"affinity": True})


# ---------------------------------------------------------------------
# the disaggregated run end to end

def test_router_two_replica_disagg_end_to_end():
    """JAX :511: a prefill engine and two decode replicas behind the
    router with disaggregation on: the greedy streams equal the JAX
    engine's single-request runs for co-located and migrated prompts,
    imports land on the replicas, the migrated bytes equal the exported
    payloads, a request finished at prefill never reaches a replica, and
    every pool ends clean."""
    ea, eb = _port_pair()
    prompts = [[1, 2, 3, 4, 5], [9, 8, 7], [6, 7, 8, 9, 10, 11],
               [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13]]
    refs = _refs(prompts)
    e_pre = _port()
    e_r1 = InferenceEngineV2(
        ea.model, RaggedInferenceEngineConfig.from_dict(ENGINE_KW),
        params=ea.params)

    async def main():
        reps = [AsyncInferenceServer(eb, ServingConfig(k_steps=3)),
                AsyncInferenceServer(e_r1, ServingConfig(k_steps=3))]
        router = InferenceRouter(
            reps, RouterConfig(disaggregation={
                "enabled": True, "prefill_threshold_tokens": 6}),
            prefill=PrefillEngine(e_pre))
        async with router:
            hs = [await router.submit(p, max_new_tokens=10)
                  for p in prompts]
            outs = [await h.tokens() for h in hs]
            h1 = await router.submit(prompts[3], max_new_tokens=1)
            assert len(await h1.tokens()) == 1
            return outs, router.metrics()

    outs, m = asyncio.run(main())
    assert outs == refs
    assert m["prefill_handoffs"] == 3
    assert sum(r["imports"] for r in m["replicas"].values()) == 2
    assert m["prefill"]["prefills"] == 3
    assert m["migrated_bytes"] == m["prefill"]["exported_bytes"] > 0
    assert m["completed"] == 5 and m["failed"] == 0
    for e in (ea, eb, e_pre, e_r1):
        _assert_clean(e)
