"""The port's quantized KV cache and prefix cache against the JAX package,
fp32 on the CPU: the KV quantizer bit for bit, the pool sizing arithmetic,
the config rules, the paged attention's plain version on int8/fp8 pools
against the Pallas kernel in interpret mode (2e-5, as
tests/test_torch_paged_attention.py), and the engine against the JAX
engine on carried params (logits at 2e-4 as tests/test_kv_quant.py:225,
pool codes and scales after each put, greedy tokens, prefix counters).

The pools' scales are the absmax of k/v vectors over 127 or 448, so they
carry the last-bit differences of the two frameworks' k/v projections
(held at 2e-6 relative); a code may flip by one step where a vector
element sits on a rounding boundary, which the tests count (0 at these
inputs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import (
    InferenceEngineV2 as JEngine,
    KVCacheConfig as JKVCacheConfig,
    RaggedInferenceEngineConfig as JConfig)
from deepspeed_tpu.inference.v2 import paged as jpaged
from deepspeed_tpu.inference.v2.ragged import (
    kv_block_bytes as j_kv_block_bytes,
    quantized_block_budget as j_quantized_block_budget)
from deepspeed_tpu.models import Llama as JLlama
from deepspeed_tpu.ops.layers import alibi_slopes as jax_alibi_slopes
from deepspeed_tpu.ops.pallas import quantization as jquant
from deepspeed_tpu_torch.inference.v2 import (KVCacheConfig,
                                              RaggedInferenceEngineConfig,
                                              build_engine)
from deepspeed_tpu_torch.inference.v2 import paged as tpaged
from deepspeed_tpu_torch.inference.v2.ragged import (kv_block_bytes,
                                                     quantized_block_budget)
from deepspeed_tpu_torch.ops import quantization as tquant


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side runs tiny models: one intra-op thread a worker
    keeps it from spinning against the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = dict(rtol=2e-4, atol=2e-4)
ENGINE_KW = dict(dtype="float32", kv_block_size=8, num_kv_blocks=32,
                 max_chunk_size=16)
INT8 = {"enabled": True, "dtype": "int8"}
FP8 = {"enabled": True, "dtype": "fp8"}
KV = {"int8": INT8, "fp8": FP8}
_JAX_ENGINES: dict = {}


def _key(kw):
    return tuple(sorted((k, tuple(sorted(v.items())) if isinstance(v, dict)
                         else v) for k, v in kw.items()))


def _jax_engine(**over):
    """One JAX engine per config, shared by the module's tests (each test
    flushes what it scheduled)."""
    kw = dict(ENGINE_KW, **over)
    if _key(kw) not in _JAX_ENGINES:
        _JAX_ENGINES[_key(kw)] = JEngine(JLlama(size="tiny"), JConfig(**kw))
    return _JAX_ENGINES[_key(kw)]


def _pair(**over):
    """(JAX engine, port engine on the same params and config)."""
    je = _jax_engine(**over)
    te = build_engine("llama", "tiny", dict(ENGINE_KW, **over),
                      params=jax.tree.map(np.asarray, je.params),
                      device="cpu")
    return je, te


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, 512, n).tolist()


def _to_torch(a) -> torch.Tensor:
    """A JAX array as a torch tensor; fp8 goes across as its bytes."""
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _ordinal(codes: np.ndarray) -> np.ndarray:
    """int8 codes, or fp8-e4m3 bytes, as integers one apart per step of
    the format (fp8 is sign-magnitude: +0 and -0 are both 0)."""
    if codes.dtype == np.int8:
        return codes.astype(np.int64)
    mag = (codes & 0x7F).astype(np.int64)
    return np.where(codes & 0x80, -mag, mag)


# ---------------------------------------------------------------------
# the quantizer and the sizing arithmetic
# ---------------------------------------------------------------------

@pytest.mark.parametrize("granularity", ["head", "token"])
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_kv_quantize_bit_equal_to_jax(kv_dtype, granularity):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 7, 8, 128))
         * rng.uniform(1e-3, 1e3, (4, 7, 8, 1))).astype(np.float32)
    x[0, 0] = 0.0                  # a zero token: scale floored, codes 0
    hs = 8 if granularity == "head" else 1
    jc, js = jquant.kv_quantize(jnp.asarray(x), kv_dtype, hs)
    tc, ts = tquant.kv_quantize(torch.from_numpy(x), kv_dtype, hs)
    assert tc.dtype == tquant.KV_STORE_DTYPES[kv_dtype]
    assert ts.dtype == torch.float32 and ts.shape == (4, 7, hs)
    np.testing.assert_array_equal(tc.view(torch.uint8).numpy(),
                                  np.asarray(jc).view(np.uint8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert not tquant.kv_dequantize(tc[0, 0], ts[0, 0]).any()
    np.testing.assert_array_equal(
        tquant.kv_dequantize(tc, ts).numpy(),
        np.asarray(jquant.kv_dequantize(jc, js)))


@pytest.mark.parametrize("granularity", ["head", "token"])
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_kv_quantize_fp16_input_bit_equal_to_jax(kv_dtype, granularity):
    """An fp16 engine writes fp16 k/v into the pools: both quantizers
    widen them to fp32 first, so the codes and scales are the JAX
    package's bit for bit, at magnitudes across fp16's range (subnormal
    up to ~1e4) and on a zero token."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((4, 7, 8, 128))
         * rng.uniform(1e-6, 1e4, (4, 7, 8, 1))).astype(np.float16)
    x[0, 0] = 0.0
    x[1, 2, 3, :5] = np.float16(6e-8)        # fp16 subnormals
    hs = 8 if granularity == "head" else 1
    jc, js = jquant.kv_quantize(jnp.asarray(x), kv_dtype, hs)
    tc, ts = tquant.kv_quantize(torch.from_numpy(x), kv_dtype, hs)
    np.testing.assert_array_equal(tc.view(torch.uint8).numpy(),
                                  np.asarray(jc).view(np.uint8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    back = tquant.kv_dequantize(tc, ts, torch.float16)
    assert back.dtype == torch.float16 and torch.isfinite(back).all()
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jquant.kv_dequantize(jc, js, jnp.float16)))


def test_kv_quantize_roundtrip_bounds_and_determinism():
    """As tests/test_kv_quant.py:69-88: int8 within 0.02 and fp8 within
    0.08 of the largest element, repeatable, zeros stay zeros."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(3, 5, 4, 16)).astype(np.float32))
    for dt, bound in (("int8", 0.02), ("fp8", 0.08)):
        for hs in (4, 1):
            q, s = tquant.kv_quantize(x, dt, hs)
            assert s.shape == x.shape[:2] + (hs,)
            back = tquant.kv_dequantize(q, s)
            assert float((back - x).abs().max() / x.abs().max()) < bound
            q2, s2 = tquant.kv_quantize(x, dt, hs)
            assert torch.equal(q.view(torch.uint8), q2.view(torch.uint8))
            assert torch.equal(s, s2)
    qz, sz = tquant.kv_quantize(torch.zeros(2, 2, 4), "int8", 2)
    assert not tquant.kv_dequantize(qz, sz).any()
    with pytest.raises(ValueError, match="scale_heads"):
        tquant.kv_quantize(x, "int8", 2)


def test_block_bytes_budget_and_bytes_per_token_match_jax():
    for bs in (8, 64):
        for hkv in (1, 2, 8):
            for d in (16, 64, 128):
                for item in (4, 2, 1):
                    for hs in (0, 1, hkv):
                        assert kv_block_bytes(bs, hkv, d, item, hs) \
                            == j_kv_block_bytes(bs, hkv, d, item, hs)
                full = kv_block_bytes(bs, hkv, d, 2)
                for hs in (1, hkv):
                    quant = kv_block_bytes(bs, hkv, d, 1, scale_heads=hs)
                    for nb in (4, 32, 512):
                        assert quantized_block_budget(nb, full, quant) \
                            == j_quantized_block_budget(nb, full, quant)
                for fmt in ("fp32", "float32", "fp16", "bf16", "bfloat16",
                            "int8", "fp8"):
                    for hs in (0, 1, hkv):
                        assert tquant.kv_bytes_per_token(hkv, d, fmt, hs) \
                            == jquant.kv_bytes_per_token(hkv, d, fmt, hs)
    assert quantized_block_budget(4, 100, 1000) == 4      # never shrinks
    with pytest.raises(ValueError, match="unknown kv dtype"):
        tquant.kv_bytes_per_token(2, 16, "int4")
    # Llama-3-8B's layout (bs 64, 8 kv heads of 128): 512 bf16 blocks'
    # bytes hold 992 int8 blocks with per-head scales, 1020 per token
    full = kv_block_bytes(64, 8, 128, 2)
    assert full == 262_144
    assert quantized_block_budget(
        512, full, kv_block_bytes(64, 8, 128, 1, scale_heads=8)) == 992
    assert quantized_block_budget(
        512, full, kv_block_bytes(64, 8, 128, 1, scale_heads=1)) == 1020


def test_kv_cache_config_defaults_and_refusals():
    cfg, jcfg = RaggedInferenceEngineConfig(), JConfig()
    for block in ("kv_cache", "prefix_cache"):
        ours, theirs = getattr(cfg, block), getattr(jcfg, block)
        for name, value in ours.model_dump().items():
            assert value == getattr(theirs, name), (block, name)
    assert cfg.kv_cache.enabled is False and cfg.kv_cache.dtype == "int8"
    assert cfg.kv_cache.granularity == "head" and cfg.kv_cache.grow_pool
    for bad in ({"dtype": "int4"}, {"granularity": "channel"}):
        with pytest.raises(Exception):
            JKVCacheConfig(**bad)
        with pytest.raises(ValueError, match="kv_cache"):
            KVCacheConfig.from_dict(bad)
        with pytest.raises(ValueError, match="kv_cache"):
            RaggedInferenceEngineConfig.from_dict({"kv_cache": bad})
    # enabled with dtype fp16: the no-op rung
    e = build_engine("llama", "tiny", dict(ENGINE_KW, kv_cache={
        "enabled": True, "dtype": "fp16"}), device="cpu")
    assert sorted(e.pools) == ["k", "v"] and e.num_kv_blocks == 32
    assert e.pools["k"].dtype == torch.float32 and e.kv_dtype == "float32"


SIZING = {"off": {}, "fp16_noop": {"enabled": True, "dtype": "fp16"},
          "int8": INT8, "int8_token": dict(INT8, granularity="token"),
          "int8_fixed": dict(INT8, grow_pool=False), "fp8": FP8}


@pytest.mark.parametrize("name", list(SIZING))
def test_pool_sizing_matches_jax_engine(name):
    """Block count, pool shapes and dtypes, pool bytes and bytes per
    token, and the serving metrics the port reports, as the JAX engine's
    (tests/test_kv_quant.py:158-189)."""
    je, te = _pair(kv_cache=SIZING[name])
    assert te.num_kv_blocks == je.num_kv_blocks \
        == te.state_manager.allocator.num_blocks
    assert sorted(te.pools) == sorted(je.pools)
    for n, t in te.pools.items():
        assert tuple(t.shape) == tuple(je.pools[n].shape), n
        assert str(t.dtype).removeprefix("torch.") \
            == np.dtype(je.pools[n].dtype).name, n
        assert not t.view(torch.uint8).any(), n          # zero-initialized
    assert te.kv_pool_bytes() == je.kv_pool_bytes()
    assert te.kv_bytes_per_token() == je.kv_bytes_per_token()
    assert te.kv_dtype == je.kv_dtype
    jm = je.serving_metrics()
    for key, value in te.serving_metrics().items():
        assert value == jm[key], key
    if name in ("int8", "int8_token", "fp8"):
        off = _jax_engine()
        assert te.num_kv_blocks >= 2 * off.num_kv_blocks
        assert te.kv_pool_bytes() <= off.kv_pool_bytes()


# ---------------------------------------------------------------------
# paged attention on quantized pools
# ---------------------------------------------------------------------

B, HQ, HKV, D, NB, BS, MAXB = 3, 4, 2, 32, 16, 8, 5
VARIANTS = {"causal": {}, "window": {"window": 11}, "alibi": {"alibi": True}}


def _quant_inputs(sq, kv_dtype, hs, seed=0):
    """One call's inputs as JAX arrays: fp q/k_new/v_new, quantized pools
    made by the JAX quantizer from random fp pools, a permuted table with
    a padded slot past the pool, and rows with pos0 > 0."""
    rng = np.random.default_rng(seed)

    def f(*s):
        return jnp.asarray(rng.standard_normal(s).astype(np.float32))

    tables = rng.permutation(NB)[:B * MAXB].reshape(B, MAXB).astype(np.int32)
    tables[1, -1] = NB
    kc, ks = jquant.kv_quantize(f(NB, BS, HKV, D), kv_dtype, hs)
    vc, vs = jquant.kv_quantize(f(NB, BS, HKV, D), kv_dtype, hs)
    args = (f(B, sq, HQ, D), f(B, sq, HKV, D), f(B, sq, HKV, D), kc, vc,
            jnp.asarray(tables), jnp.asarray([13, 0, 24], jnp.int32),
            jnp.asarray([sq, 0, sq] if sq == 1 else [sq, sq - 3, sq],
                        jnp.int32))
    return args, dict(k_scale=ks, v_scale=vs)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("sq", [1, 8])
@pytest.mark.parametrize("kv_dtype,hs", [("int8", HKV), ("fp8", 1)])
def test_plain_kernel_matches_pallas_kernel_on_quantized_pools(
        kv_dtype, hs, sq, variant):
    args, scales = _quant_inputs(sq, kv_dtype, hs)
    kw = {}
    if "window" in VARIANTS[variant]:
        kw["window"] = VARIANTS[variant]["window"]
    if VARIANTS[variant].get("alibi"):
        kw["alibi_slopes"] = np.array(jax_alibi_slopes(HQ))
    ref = np.asarray(jpaged.paged_attention_kernel(*args, **scales, **kw))
    if "alibi_slopes" in kw:
        kw["alibi_slopes"] = torch.from_numpy(kw["alibi_slopes"])
    got = tpaged.paged_attention_kernel(
        *(_to_torch(a) for a in args),
        **{k: _to_torch(v) for k, v in scales.items()}, **kw).numpy()
    tl = np.asarray(args[-1])
    for b in range(B):
        np.testing.assert_allclose(got[b, :tl[b]], ref[b, :tl[b]],
                                   atol=2e-5, rtol=2e-5)
        assert not got[b, tl[b]:].any()


@pytest.mark.parametrize("kv_dtype,hs", [("int8", HKV), ("fp8", 1)])
def test_gather_scales_and_dequantized_pages_match_jax(kv_dtype, hs):
    args, scales = _quant_inputs(8, kv_dtype, hs, seed=3)
    tables = args[5]
    js = jpaged.gather_scales(scales["k_scale"], tables)
    ts = tpaged.gather_scales(_to_torch(scales["k_scale"]),
                              _to_torch(tables))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    ref = (jpaged.gather_pages(args[3], tables).astype(jnp.float32)
           * js[..., :, None])
    got = tpaged.dequantize_pages(_to_torch(args[3]),
                                  _to_torch(scales["k_scale"]),
                                  _to_torch(tables))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------

def _pools_match(je, te) -> int:
    """Scales within 2e-6 relative; codes equal up to one step. Returns
    the count of codes one step apart."""
    flips = 0
    for n in ("k", "v"):
        a = _ordinal(np.asarray(je.pools[n]).view(
            np.int8 if je.pools[n].dtype == jnp.int8 else np.uint8))
        b = _ordinal(te.pools[n].view(
            torch.int8 if te.pools[n].dtype == torch.int8
            else torch.uint8).numpy())
        step = np.abs(a - b)
        assert step.max() <= 1, n
        flips += int(step.sum())
    for n in ("ks", "vs"):
        np.testing.assert_allclose(te.pools[n].numpy(),
                                   np.asarray(je.pools[n]), rtol=2e-6,
                                   atol=0)
    return flips


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_put_logits_and_pools_match_jax_engine(kv_dtype):
    je, te = _pair(kv_cache=KV[kv_dtype])
    prompt = _prompt(21, seed=1)   # two chunks: the second reads the pool
    ref = je.put([7], [prompt])
    np.testing.assert_allclose(te.put([7], [prompt]).numpy(),
                               np.asarray(ref), **TOL)
    flips = _pools_match(je, te)
    nxt = int(np.argmax(np.asarray(ref[0])))
    np.testing.assert_allclose(te.put([7], [[nxt]]).numpy(),
                               np.asarray(je.put([7], [[nxt]])), **TOL)
    flips += _pools_match(je, te)
    assert flips == 0
    assert te.query(7) == je.query(7) == (22, 3)
    je.flush(7)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_greedy_generate_identical_to_jax_engine(kv_dtype):
    je, te = _pair(kv_cache=KV[kv_dtype])
    prompts = [_prompt(n, seed) for n, seed in ((5, 11), (9, 12), (20, 14))]
    ref = je.generate(prompts, max_new_tokens=8)
    assert te.generate(prompts, max_new_tokens=8) == ref
    assert te.free_blocks == te.num_kv_blocks


@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_prefix_cache_matches_jax_engine(kv):
    """A shared 16-token prefix (2 full blocks) published by a cold run,
    then a warm batch of three prompts on it, twice: the same hits,
    saved tokens and outputs as the JAX engine (tests/test_kv_quant.py
    :274-292, on generate), the two warm runs identical, and every block
    back (cached blocks with refcount 0 count as free)."""
    over = dict(prefix_cache={"enabled": True})
    if kv == "int8":
        over["kv_cache"] = INT8
    je, te = _pair(**over)
    prefix = _prompt(16, seed=30)
    prompts = [prefix + _prompt(n, seed) for n, seed in ((3, 31), (5, 32),
                                                         (8, 33))]
    runs = []
    for e in (je, te):
        cold = e.generate([prompts[0]], max_new_tokens=6)
        e.reset_serving_metrics()
        warm = e.generate(prompts, max_new_tokens=6)
        m = e.serving_metrics()
        warm2 = e.generate(prompts, max_new_tokens=6)
        assert warm2 == warm
        assert e.free_blocks == e.num_kv_blocks
        runs.append((cold, warm, m))
    (jcold, jwarm, jm), (tcold, twarm, tm) = runs
    assert (tcold, twarm) == (jcold, jwarm)
    assert tm["prefix_hits"] == jm["prefix_hits"] == 6
    assert tm["prefill_tokens_saved"] == jm["prefill_tokens_saved"] == 48
    for key in ("prefix_misses", "prefix_evictions", "prefix_hit_rate",
                "prefix_cached_blocks", "prefix_evictable_blocks"):
        assert tm[key] == jm[key], key


# fp16 engines: k/v and the logits carry fp16 roundings made at other
# places by the two frameworks (tests/test_torch_v2_engine.py FP16_TOL)
FP16_TOL = dict(rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_fp16_engine_on_quantized_pools_matches_jax_engine(kv_dtype):
    """The fp16 engine writing int8/fp8 pools: put() logits within
    FP16_TOL of the JAX fp16 engine's, the pools' scales within one fp16
    rounding of k/v (2^-10 relative) and at most a few codes one step
    apart (an element of an fp16 k/v vector on a rounding boundary), and
    greedy generate() token for token."""
    je, te = _pair(dtype="fp16", kv_cache=KV[kv_dtype])
    prompt = _prompt(21, seed=6)   # two chunks: the second reads the pool
    ref = je.put([7], [prompt])
    got = te.put([7], [prompt])
    assert got.dtype == torch.float16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref).astype(np.float32),
                               **FP16_TOL)
    nxt = int(np.argmax(np.asarray(ref[0])))
    np.testing.assert_allclose(
        te.put([7], [[nxt]]).float().numpy(),
        np.asarray(je.put([7], [[nxt]])).astype(np.float32), **FP16_TOL)
    for n in ("k", "v"):
        a = _ordinal(np.asarray(je.pools[n]).view(
            np.int8 if je.pools[n].dtype == jnp.int8 else np.uint8))
        b = _ordinal(te.pools[n].view(
            torch.int8 if te.pools[n].dtype == torch.int8
            else torch.uint8).numpy())
        assert np.abs(a - b).max() <= 1, n
        flips = int(np.abs(a - b).sum())
        assert flips <= 1e-3 * a.size, (n, flips)
    for n in ("ks", "vs"):
        np.testing.assert_allclose(te.pools[n].numpy(),
                                   np.asarray(je.pools[n]), rtol=2 ** -10,
                                   atol=0)
    je.flush(7)
    te.flush(7)
    prompts = [_prompt(n, seed) for n, seed in ((5, 11), (9, 12), (20, 14))]
    ref_out = je.generate(prompts, max_new_tokens=6)
    assert te.generate(prompts, max_new_tokens=6) == ref_out
    assert te.free_blocks == te.num_kv_blocks
