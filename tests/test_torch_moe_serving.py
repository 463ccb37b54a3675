"""The MoE families served by the port's engines (``build_engine`` and the
v1 ``init_inference``) against the JAX package's, fp32 on the CPU, on
tests/test_torch_moe_models.py's perturbed weights.

- v2, ``Mixtral("tiny")``, ``Mixtral("ref")`` and ``Qwen2MoE("tiny")``:
  the first tick's logits (a prefill chunk padded to JAX's buckets: pad
  slots route and claim expert slots, so they must be JAX's) within 1e-5
  of the largest, and the greedy tokens of ``generate()`` and of
  ``generate_fused`` (chain mode, K 4) equal to the JAX engine's; the
  capacity form, the grouped form (``moe_grouped_dispatch``) and the int8
  experts (``quantize_moe_experts``); speculative chain mode and ring
  mode on Mixtral tiny;
- v1, Mixtral tiny: ``forward`` logits and ``generate`` tokens in the
  capacity form, the grouped form, with int8 experts and both;
- Qwen2-MoE under ``quantize_weights`` (widened so its leaves pass the
  64 Ki-element floor): the routed experts and the shared expert's
  matrices int8, tokens equal to JAX's;
- ``moe_grouped_dispatch`` binds to the engine's copy of the model, never
  the shared instance;
- ``paged.dead_row_attention`` against the JAX kernel's own output at the
  pad slots (plain, windowed and int8 pools), and ``paged_forward`` with
  ``pads=False`` equal to the default on a chunk without pads.
"""

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as ds
from deepspeed_tpu import models as jm
from deepspeed_tpu.inference.v2 import build_engine as jbuild_engine
from deepspeed_tpu_torch import models as tm
from deepspeed_tpu_torch.inference.v2 import build_engine, paged
from test_torch_moe_models import moe_case

ENGINE_KW = dict(dtype="float32", kv_block_size=8, num_kv_blocks=64,
                 max_chunk_size=16)
MODES = {"capacity": {}, "grouped": {"moe_grouped_dispatch": True},
         "int8_experts": {"quantize_moe_experts": True}}
LOGITS_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _prompts(vocab, lens=(11, 20, 5), seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).tolist() for n in lens]


def _tokens(outs):
    return [list(map(int, o)) for o in outs]


def _rel(got, ref) -> float:
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("family, size, mode", [
    *(("mixtral", "tiny", m) for m in MODES), ("mixtral", "ref", "capacity"),
    *(("qwen2_moe", "tiny", m) for m in MODES)])
def test_v2_engine_matches_jax(family, size, mode):
    _, params, _ = moe_case(family, size)
    cfg = dict(ENGINE_KW, **MODES[mode])
    prompts = _prompts(moe_case(family, size)[2].config.vocab_size)
    je = jbuild_engine(family, size, dict(cfg), params=params)
    te = build_engine(family, size, dict(cfg), params=params, device="cpu")
    assert te.model.moe_serving_dispatch == (mode == "grouped")
    if mode == "int8_experts":
        assert te.model.params["layers/experts/w_up_q"].dtype == torch.int8
    want = np.asarray(je.put([1, 2, 3], prompts))
    got = te.put([1, 2, 3], prompts).numpy()
    assert _rel(got, want) < LOGITS_TOL
    je.flush([1, 2, 3])
    te.flush([1, 2, 3])
    want = _tokens(je.generate(prompts, max_new_tokens=6))
    assert te.generate(prompts, max_new_tokens=6) == want
    fused = _tokens(je.generate_fused(prompts, max_new_tokens=9, k_steps=4,
                                      temperature=0.0))
    assert te.generate_fused(prompts, max_new_tokens=9, k_steps=4,
                             temperature=0.0) == fused
    assert te.free_blocks == te.num_kv_blocks


@pytest.mark.parametrize("mode", [
    {"speculative": {"enabled": True}}, {"fused_admission": True}])
def test_spec_and_ring_modes_match_jax(mode):
    """Spec chain mode's verify ticks (S_new 1 + draft_len, dead draft
    slots routing) and ring mode's in-loop admission, greedy, against the
    JAX engine in the same mode; prompts followed by their own greedy
    tokens, so drafts land."""
    _, params, _ = moe_case("mixtral", "tiny")
    base = _prompts(512, lens=(9, 14, 6))
    plain = build_engine("mixtral", "tiny", dict(ENGINE_KW), params=params,
                         device="cpu")
    prompts = [p + o for p, o in zip(
        base, plain.generate(base, max_new_tokens=12))]
    cfg = dict(ENGINE_KW, **mode)
    je = jbuild_engine("mixtral", "tiny", dict(cfg), params=params)
    te = build_engine("mixtral", "tiny", dict(cfg), params=params,
                      device="cpu")
    want = _tokens(je.generate_fused(prompts, max_new_tokens=10, k_steps=4,
                                     temperature=0.0))
    assert te.generate_fused(prompts, max_new_tokens=10, k_steps=4,
                             temperature=0.0) == want
    if "speculative" in mode:
        assert te.serving_metrics()["spec_accepted_tokens"] > 0


@pytest.mark.parametrize("mode", ["capacity", "grouped", "int8_experts",
                                  "int8_grouped"])
def test_v1_engine_matches_jax(mode):
    _, params, _ = moe_case("mixtral", "tiny")
    cfg = {"dtype": "float32", "max_out_tokens": 48,
           "quantize_moe_experts": "int8" in mode,
           "moe_grouped_dispatch": "grouped" in mode}
    je = jds.init_inference(jm.Mixtral(size="tiny", max_seq_len=64),
                            config=dict(cfg),
                            params=jax.tree.map(np.asarray, params))
    te = ds.init_inference(tm.Mixtral(size="tiny", max_seq_len=64,
                                      device="cpu"),
                           config=dict(cfg), params=params)
    tokens = np.random.default_rng(1).integers(0, 512, (2, 12))
    want = np.asarray(je.forward(tokens))
    assert _rel(te.forward(tokens).numpy(), want) < LOGITS_TOL
    want = np.asarray(je.generate(tokens, max_new_tokens=6))
    assert np.array_equal(te.generate(tokens, max_new_tokens=6).numpy(),
                          want)


def test_shared_expert_under_quantize_weights():
    wide = dict(hidden_size=256, num_heads=4, num_kv_heads=2,
                intermediate_size=512)
    jmodel = jm.Qwen2MoE(size="tiny", **wide)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(5)))
    cfg = dict(ENGINE_KW, quantize_weights=True)
    je = jbuild_engine("qwen2_moe", "tiny", dict(cfg), params=params, **wide)
    te = build_engine("qwen2_moe", "tiny", dict(cfg), params=params,
                      device="cpu", **wide)
    names = set(te.model.params)
    for leaf in ("layers/shared/w_gate", "layers/shared/w_down",
                 "layers/experts/w_up", "layers/wq"):
        assert leaf + "_q" in names and leaf not in names, leaf
    assert "layers/shared/gate_proj" in names      # too narrow to quantize
    prompts = _prompts(512)
    want = _tokens(je.generate(prompts, max_new_tokens=6))
    assert te.generate(prompts, max_new_tokens=6) == want


def test_grouped_dispatch_binds_to_the_engine_copy():
    model = tm.Mixtral(size="tiny", max_seq_len=64, device="cpu")
    eng = ds.init_inference(model, dtype="float32", max_out_tokens=48)
    assert eng.module.moe_serving_dispatch is False
    eng = ds.init_inference(model, dtype="float32", max_out_tokens=48,
                            moe_grouped_dispatch=True)
    assert eng.module.moe_serving_dispatch is True
    assert model.moe_serving_dispatch is False
    assert eng.module.params is model.params
    out = eng.generate(np.zeros((2, 8), np.int64), max_new_tokens=4)
    assert out.shape == (2, 12)
    ds.initialize(model=model, config={"train_batch_size": 2})
    assert model.moe_serving_dispatch is False


@pytest.mark.parametrize("case", ["plain", "window", "int8"])
def test_dead_row_attention_matches_the_jax_kernel(case):
    """The pad slots' attention values are the JAX kernel's, for the rows
    that hold a pad slot; the other rows' pages are not read."""
    from deepspeed_tpu.inference.v2 import paged as jpaged
    rng = np.random.default_rng(11)
    b, sq, hq, hkv, d, nb, bs, width = 4, 3, 4, 2, 8, 12, 4, 3
    q = rng.standard_normal((b, sq, hq, d), np.float32)
    k_new = rng.standard_normal((b, sq, hkv, d), np.float32)
    v_new = rng.standard_normal((b, sq, hkv, d), np.float32)
    k_pool = rng.standard_normal((nb, bs, hkv, d), np.float32)
    v_pool = rng.standard_normal((nb, bs, hkv, d), np.float32)
    tables = rng.permutation(nb)[:b * width].reshape(b, width).astype(
        np.int32)
    # block 0, where the pages a row skips point, on a page it visits
    at = tuple(np.argwhere(tables == 0)[0])
    tables[at], tables[2, 1] = tables[2, 1], 0
    pos0 = np.array([5, 0, 9, 12], np.int32)
    true_len = np.array([1, 3, 0, 2], np.int32)
    window = 6 if case == "window" else None
    scales = {}
    if case == "int8":
        k_pool = rng.integers(-127, 128, k_pool.shape).astype(np.int8)
        v_pool = rng.integers(-127, 128, v_pool.shape).astype(np.int8)
        scales = {n: rng.uniform(0.01, 0.02, (nb, bs, hkv)).astype(
            np.float32) for n in ("k_scale", "v_scale")}
    ref = np.asarray(jpaged.paged_attention_kernel(
        q, k_new, v_new, k_pool, v_pool, tables, pos0, true_len,
        window=window, sanitize_pools=False, **scales))
    rows = torch.from_numpy(true_len < sq)
    got = paged.dead_row_attention(
        torch.from_numpy(v_new), torch.from_numpy(v_pool),
        torch.from_numpy(tables), torch.from_numpy(pos0), window=window,
        v_scale=(torch.from_numpy(scales["v_scale"]) if scales else None),
        rows=rows).repeat_interleave(hq // hkv, dim=1).numpy()
    for i in range(b):
        for j in range(true_len[i], sq):
            np.testing.assert_allclose(got[i], ref[i, j], rtol=1e-5,
                                       atol=1e-6)
    assert not rows[3] or true_len[3] < sq


def test_paged_forward_without_pads_equals_the_default():
    """``pads=False`` on a chunk with every slot live skips the pad pass
    and changes nothing."""
    model = moe_case("mixtral", "tiny")[2]
    nb, bs = 8, 4
    cfg = model.config
    hkv, d = cfg.num_kv_heads, cfg.head_dim
    pools = {n: torch.randn(cfg.num_layers, nb, bs, hkv, d,
                            generator=torch.Generator().manual_seed(i))
             for i, n in enumerate("kv")}
    tokens = torch.randint(0, cfg.vocab_size, (2, 3),
                           generator=torch.Generator().manual_seed(2))
    pos0 = torch.tensor([5, 2], dtype=torch.int32)
    tables = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32)
    true_len = torch.tensor([3, 3], dtype=torch.int32)
    outs = [paged.paged_forward(
        model, {n: t.clone() for n, t in pools.items()}, tokens, pos0,
        tables, true_len, pads=pads)[0] for pads in (True, False)]
    assert torch.isfinite(outs[0]).all()
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
