"""The port's v2 serving engine (deepspeed_tpu_torch/inference/v2) against
the JAX engine (deepspeed_tpu/inference/v2), fp32 on the CPU, with the
JAX engine's params carried across: put() logits at the JAX v2 tests'
tolerance (tests/test_inference_v2.py:52-61) and greedy generate() token
for token. Plus the host-side bookkeeping and the config rules."""

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import (
    InferenceEngineV2 as JEngine,
    RaggedInferenceEngineConfig as JConfig)
from deepspeed_tpu.models import GPT2 as JGPT2, Llama as JLlama
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.v2 import (BlockedAllocator,
                                              DSStateManager,
                                              RaggedInferenceEngineConfig,
                                              build_engine)

TOL = dict(rtol=2e-4, atol=2e-4)
ENGINE_KW = dict(dtype="float32", kv_block_size=8, num_kv_blocks=128,
                 max_chunk_size=16)
JAX_MODELS = {"llama": JLlama, "gpt2": JGPT2}
_JAX_ENGINES: dict = {}


def _jax_engine(family, model, **over):
    """One JAX engine per (family, model overrides, config), shared by the
    module's tests (each test flushes what it scheduled)."""
    kw = dict(ENGINE_KW, **over)
    key = (family, tuple(sorted(model.items())), tuple(sorted(kw.items())))
    if key not in _JAX_ENGINES:
        _JAX_ENGINES[key] = JEngine(
            JAX_MODELS[family](size="tiny", **model), JConfig(**kw))
    return _JAX_ENGINES[key]


def _pair(family, model=None, **over):
    """(JAX engine, port engine on the same params)."""
    model = model or {}
    je = _jax_engine(family, model, **over)
    params = jax.tree.map(np.asarray, je.params)
    te = build_engine(family, "tiny", dict(ENGINE_KW, **over),
                      params=params, device="cpu", **model)
    return je, te


def _close(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, 512, n).tolist()


@pytest.mark.parametrize("family", list(JAX_MODELS))
def test_put_prefill_then_decode_matches_jax_engine(family):
    je, te = _pair(family)
    prompt = _prompt(11, seed=1)
    ref = je.put([7], [prompt])
    got = te.put([7], [prompt])
    _close(got, ref)
    nxt = int(np.argmax(np.asarray(ref[0])))
    _close(te.put([7], [[nxt]]), je.put([7], [[nxt]]))
    assert te.query(7) == je.query(7) == (12, 2)
    je.flush(7)


@pytest.mark.parametrize("family", list(JAX_MODELS))
def test_chunked_prefill_matches_jax_engine(family):
    je, te = _pair(family)
    prompt = _prompt(40, seed=2)
    _close(te.put([3], [prompt]), je.put([3], [prompt]))
    # 40 tokens at a 16-token budget: three SplitFuse chunks
    assert te.serving_stats["host_dispatches"] == 3
    assert te.query(3)[0] == je.query(3)[0] == 40
    je.flush(3)


# the paged attention's sliding window (Mistral) and ALiBi (Bloom) paths
# through the engine; a 20-token prompt takes two 16-token chunks
MODEL_VARIANTS = {
    "llama-window-parallel": ("llama", dict(
        sliding_window=6, parallel_residual=True, rotary_pct=0.5)),
    "gpt2-alibi": ("gpt2", dict(position_embedding="alibi",
                                embed_layernorm=True)),
}


@pytest.mark.parametrize("variant", list(MODEL_VARIANTS))
def test_window_and_alibi_models_match_jax_engine(variant):
    family, model = MODEL_VARIANTS[variant]
    je, te = _pair(family, model)
    prompt = _prompt(20, seed=5)
    _close(te.put([5], [prompt]), je.put([5], [prompt]))
    _close(te.put([5], [[3]]), je.put([5], [[3]]))
    assert te.serving_stats["host_dispatches"] == 3
    je.flush(5)


def test_mixed_prefill_decode_batch_matches_jax_engine():
    je, te = _pair("llama")
    p1, p2 = _prompt(5, seed=3), _prompt(21, seed=4)
    for e in (je, te):
        e.put([1], [p1])
    # one drain: uid 1 decodes while uid 2 prefills in 16-token chunks
    ref = je.put([1, 2], [[11], p2])
    got = te.put([1, 2], [[11], p2])
    _close(got, ref)
    assert te.serving_stats["host_dispatches"] == 1 + 2
    je.flush([1, 2])


# prompts and seeds chosen so that every greedy step of the JAX model
# has a top-2 logit gap above the logits tolerance (checked below): a
# mismatch then points at a bug, not at a near-tie
GEN_PROMPTS = {"llama": [(5, 11), (9, 12), (13, 13), (20, 14)],
               "gpt2": [(5, 21), (9, 22), (13, 23), (20, 24)]}


@pytest.mark.parametrize("family", list(JAX_MODELS))
def test_greedy_generate_identical_to_jax_engine(family):
    # 6 blocks x 8 tokens cannot hold all four requests (12 blocks of
    # worst-case budget): admission waits for flushes
    je, te = _pair(family, num_kv_blocks=6)
    prompts = [_prompt(n, seed) for n, seed in GEN_PROMPTS[family]]
    new = 8
    ref = je.generate(prompts, max_new_tokens=new)
    got = te.generate(prompts, max_new_tokens=new)
    assert got == ref
    assert all(len(o) == new for o in got)
    assert te.free_blocks == 6
    jm = JAX_MODELS[family](size="tiny")
    for prompt, out in zip(prompts, ref):
        full = np.asarray([prompt + out])
        logits = np.asarray(jm.apply(je.params, full))[0]
        for j in range(new):
            row = logits[len(prompt) - 1 + j]
            top2 = np.sort(row)[-2:]
            assert top2[1] - top2[0] > 2e-4, (prompt, j)
            assert int(np.argmax(row)) == out[j]


def test_blocked_allocator():
    a = BlockedAllocator(8)
    got = a.allocate(3)
    assert len(set(got)) == 3 and a.free_blocks == 5
    with pytest.raises(RuntimeError):
        a.allocate(6)
    a.free(got)
    assert a.free_blocks == 8


def test_state_manager_admission():
    m = DSStateManager(block_size=4, num_blocks=4, max_blocks_per_seq=3)
    assert m.can_schedule(0, 8)          # 2 blocks
    m.extend(0, list(range(8)))
    assert m.allocator.free_blocks == 2
    assert not m.can_schedule(0, 8)      # would exceed max_blocks_per_seq
    assert not m.can_schedule(1, 12)     # only 2 free blocks
    m.flush(0)
    assert m.allocator.free_blocks == 4


def test_pool_exhaustion_and_flush():
    te = build_engine("llama", "tiny", dict(ENGINE_KW, num_kv_blocks=8),
                      device="cpu")
    te.put([0], [list(range(30))])       # 4 blocks
    with pytest.raises(RuntimeError, match="exhaust"):
        te.put([1], [list(range(40))])   # needs 5, only 4 free
    te.flush(0)
    te.put([1], [list(range(40))])
    assert te.query(0) == (0, 0)
    with pytest.raises(ValueError, match="never fit"):
        te.generate([list(range(60))], max_new_tokens=10)


def test_config_rejects_unknown_keys_and_takes_aliases():
    with pytest.raises(ValueError, match="unknown config key"):
        RaggedInferenceEngineConfig.from_dict({"kv_blok_size": 8})
    with pytest.raises(ValueError, match="unknown config key"):
        RaggedInferenceEngineConfig.from_dict({"kv_cache": {"enable": 1}})
    c = RaggedInferenceEngineConfig.from_dict({"tp": {"tp_size": 1},
                                               "dtype": "bf16"})
    assert c.torch_dtype == torch.bfloat16 and c.kv_block_size == 64
    assert RaggedInferenceEngineConfig.from_any(c, seed=3).seed == 3
    base = DeepSpeedInferenceConfig.from_any({"dtype": "fp32"}, seed=5)
    assert base.torch_dtype == torch.float32 and base.seed == 5


@pytest.mark.parametrize("setting", [
    {"tensor_parallel": {"tp_size": 2}}, {"kv_cache": {"enabled": True}},
    {"prefix_cache": {"enabled": True}}, {"speculative": {"enabled": True}},
    {"fused_admission": True}, {"quantize_weights": True},
    {"quantize_moe_experts": True}])
def test_unported_features_raise(setting):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_engine("llama", "tiny", dict(ENGINE_KW, **setting),
                     device="cpu")
