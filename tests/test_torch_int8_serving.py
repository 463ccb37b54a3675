"""Weight-only int8 serving in the port (``quantize_weights`` and
pre-quantized ``params`` trees through ``init_inference`` and
``build_engine``; deepspeed_tpu_torch/inference/engine.py,
inference/v2/engine_v2.py, models/convert.py ``load_serving_params``,
models/transformer.py's per-layer dequant) against the JAX engines
(deepspeed_tpu/inference/engine.py:69-80, inference/v2/engine_v2.py),
fp32 on the CPU, on the JAX init's weights.

Held: the quantized leaves and their codes and scales bit-equal to
JAX's ``quantize_dense_params``; v1 ``forward`` logits within 1e-5 of
their largest and ``generate`` greedy tokens equal to JAX's; v2
``generate`` and ``generate_fused`` tokens equal to the JAX v2 engine's;
the refusals JAX makes (``dtype="int8"``, ``quantize_weights`` with tp >
1) with its messages; the float tree never built by ``build_engine``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu import models as jm
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JV2
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JRC
from deepspeed_tpu.linear.quantization import quantize_dense_params
from deepspeed_tpu_torch import models as tm
from deepspeed_tpu_torch.inference.v2 import build_engine
from deepspeed_tpu_torch.models.convert import flatten_tree

# wide enough that quantize_weights's default min_size (65536) takes
# every projection and the head
WIDE = dict(hidden_size=256, num_heads=4, num_kv_heads=2,
            intermediate_size=512)
V2_CFG = dict(dtype="float32", kv_block_size=16, num_kv_blocks=64,
              max_chunk_size=64)
PROMPTS = [[1, 2, 3, 4, 5, 6, 7], [9, 8, 7], [40, 41, 42, 43, 44, 45]]


def _tree(family, **over):
    jmodel = jm.get_model_class(family)(size="tiny", **over)
    return jmodel, jax.tree.map(np.asarray,
                                jmodel.init(jax.random.PRNGKey(0)))


def _tokens(seed=0, shape=(2, 12)):
    return np.random.default_rng(seed).integers(0, 500, shape)


def _v1_pair(family, params, quantize, **over):
    jmodel = jm.get_model_class(family)(size="tiny", **over)
    je = jds.init_inference(jmodel, dtype="float32", max_out_tokens=64,
                            params=jax.tree.map(jnp.asarray, params),
                            quantize_weights=quantize)
    te = tds.init_inference(
        tm.get_model_class(family)(size="tiny", device="cpu", **over),
        dtype="float32", max_out_tokens=64, params=params,
        quantize_weights=quantize)
    return je, te


def _same_leaves(jparams, model):
    """The engine's parameters are JAX's tree leaf for leaf: int8 codes
    equal, the float leaves (scales among them) bit-equal."""
    want = flatten_tree(jax.tree.map(np.asarray, jparams))
    got = dict(model.params)
    assert sorted(want) == sorted(got)
    for name, v in want.items():
        g = got[name].detach()
        if name.endswith("_q"):
            assert g.dtype == torch.int8
            np.testing.assert_array_equal(g.numpy(), v)
        else:
            np.testing.assert_array_equal(g.float().numpy(),
                                          np.asarray(v, np.float32))


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_v1_quantize_weights_matches_jax():
    """``quantize_weights=True`` quantizes the JAX leaves (every
    projection and the head; norms, biases and the embedding whole) to
    JAX's codes and scales; forward and greedy generate as JAX's."""
    jmodel, params = _tree("llama", **WIDE)
    je, te = _v1_pair("llama", params, True, **WIDE)
    _same_leaves(je.params, te.module)
    assert "layers/wq_q" in te.module.params and \
        "lm_head_q" in te.module.params
    assert "layers/ln1_scale" in te.module.params
    toks = _tokens()
    _close(te.forward(toks).numpy(), je.forward(jnp.asarray(toks)))
    np.testing.assert_array_equal(
        te.generate(toks, max_new_tokens=8).numpy(),
        np.asarray(je.generate(jnp.asarray(toks), max_new_tokens=8)))


@pytest.mark.parametrize("family", ["llama", "gpt2", "phi", "gptj"])
def test_v1_prequantized_tree_matches_jax(family):
    """A ``params`` tree holding ``name_q`` / ``name_s`` pairs (JAX
    ``quantize_dense_params`` at min_size 1, so the tiny preset's leaves
    are quantized) is served as it is, by families with a tied head, a
    biased head and a parallel block."""
    jmodel, params = _tree(family)
    qparams = jax.tree.map(np.asarray, quantize_dense_params(
        jax.tree.map(jnp.asarray, params), min_size=1,
        scale_dtype=jnp.float32))
    je, te = _v1_pair(family, qparams, False)
    _same_leaves(je.params, te.module)
    toks = _tokens(1)
    _close(te.forward(toks).numpy(), je.forward(jnp.asarray(toks)))
    np.testing.assert_array_equal(
        te.generate(toks, max_new_tokens=6).numpy(),
        np.asarray(je.generate(jnp.asarray(toks), max_new_tokens=6)))


@pytest.mark.parametrize("mode", ["quantize_weights", "prequantized"])
def test_v2_int8_engine_matches_jax(mode):
    """The v2 engine (build_engine) with ``quantize_weights`` or a
    pre-quantized tree: generate() and generate_fused tokens equal to the
    JAX v2 engine's generate(); the first prefill's logits within 1e-5
    of their largest."""
    jmodel, params = _tree("llama", **WIDE)
    quantize = mode == "quantize_weights"
    given = params if quantize else jax.tree.map(
        np.asarray, quantize_dense_params(jax.tree.map(jnp.asarray, params),
                                          scale_dtype=jnp.float32))
    je = JV2(jmodel, JRC(quantize_weights=quantize, **V2_CFG),
             params=jax.tree.map(jnp.asarray, given))
    te = build_engine("llama", "tiny", dict(V2_CFG, quantize_weights=quantize),
                      params=given, device="cpu", **WIDE)
    _same_leaves(je.params, te.model)
    want = [list(map(int, t)) for t in je.generate(PROMPTS,
                                                   max_new_tokens=6)]
    assert te.generate(PROMPTS, max_new_tokens=6) == want
    assert te.generate_fused(PROMPTS, max_new_tokens=6, k_steps=3) == want
    jl = je.put([7], [PROMPTS[0]])
    tl = te.put([7], [PROMPTS[0]])
    _close(tl.numpy(), np.asarray(jl))


def test_build_engine_never_builds_the_float_tree():
    """With quantize_weights, build_engine builds the model without float
    weights (meta tensors) and the loader gives each leaf its value: the
    engine holds int8 codes and scales for the quantized leaves, no float
    copy of them, at about half the bytes of the fp32/float tree in
    bf16."""
    from deepspeed_tpu_torch.models.transformer import deferred_weights
    with deferred_weights():
        m = tm.Llama(size="tiny", device="cpu", **WIDE)
    assert all(p.is_meta for p in m.params.values())
    assert not tm.Llama(size="tiny", device="cpu").params[
        "embed/tokens"].is_meta
    cfg = dict(V2_CFG, dtype="bfloat16")
    q = build_engine("llama", "tiny", dict(cfg, quantize_weights=True),
                     device="cpu", **WIDE)
    f = build_engine("llama", "tiny", cfg, device="cpu", **WIDE)
    names = set(q.model.params)
    assert not any(p.is_meta for p in q.model.params.values())
    assert "layers/wq" not in names and {"layers/wq_q", "layers/wq_s",
                                         "lm_head_q"} <= names
    nbytes = [sum(p.numel() * p.element_size() for p in e.model.params
                  .values()) for e in (q, f)]
    assert nbytes[0] < 0.75 * nbytes[1]
    # the same seeded draws: the int8 engine quantizes the float engine's
    # weights before the cast (within a bf16 rounding of its logits)
    tl_q = q.put([1], [PROMPTS[0]]).float()
    tl_f = f.put([1], [PROMPTS[0]]).float()
    assert float((tl_q - tl_f).abs().max()) < 0.1 * float(
        tl_f.abs().max())


def test_int8_refusals_are_jax_s():
    """``dtype="int8"`` raises JAX's own NotImplementedError and message
    in both engines; ``quantize_weights`` with tp > 1 JAX's."""
    jmodel, _ = _tree("llama")
    model = tm.Llama(size="tiny", device="cpu")
    with pytest.raises(NotImplementedError) as jerr:
        jds.init_inference(jmodel, dtype="int8")
    with pytest.raises(NotImplementedError) as terr:
        tds.init_inference(model, dtype="int8")
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(NotImplementedError) as terr:
        build_engine("llama", "tiny", dict(V2_CFG, dtype="int8"),
                     device="cpu")
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(NotImplementedError) as jerr:
        jds.init_inference(jmodel, dtype="float32", quantize_weights=True,
                           tensor_parallel={"tp_size": 2})
    for build in (
            lambda: tds.init_inference(model, dtype="float32",
                                       quantize_weights=True,
                                       tensor_parallel={"tp_size": 2}),
            lambda: build_engine("llama", "tiny", dict(
                V2_CFG, quantize_weights=True,
                tensor_parallel={"tp_size": 2}), device="cpu")):
        with pytest.raises(NotImplementedError) as terr:
            build()
        assert str(terr.value) == str(jerr.value)
    _, params = _tree("llama")
    bad = dict(flatten_tree(params))
    bad["layers/wq_q"] = bad.pop("layers/wq")
    with pytest.raises(ValueError, match="parameter names differ"):
        tds.init_inference(tm.Llama(size="tiny", device="cpu"),
                           dtype="float32", params=bad)


def _bad_shape(flat, name):
    leaf = flat[name]
    flat[name] = np.zeros((*leaf.shape[:-1], leaf.shape[-1] + 1),
                          leaf.dtype)
    return flat


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("name", ["layers/wq", "layers/wq_q", "layers/wq_s",
                                  "final_norm/scale"])
def test_loader_checks_shapes(name, quantize):
    """Every engine load goes through one loader, which raises on a leaf
    of the wrong shape as ``load_jax_params`` does: a float leaf, a
    pre-quantized pair's codes (the leaf's shape) or its scales (that
    shape with the contraction axis reduced to 1), with or without
    ``quantize_weights``."""
    _, params = _tree("llama", **WIDE)
    flat = dict(flatten_tree(params))
    if name.endswith(("_q", "_s")):
        flat.update(flatten_tree(jax.tree.map(np.asarray, {
            "layers": quantize_dense_params(
                {"layers": {"wq": jnp.asarray(flat.pop("layers/wq"))}},
                scale_dtype=jnp.float32)["layers"]})))
    with pytest.raises(ValueError, match=f"{name}: shape"):
        tds.init_inference(tm.Llama(size="tiny", device="cpu", **WIDE),
                           dtype="float32", params=_bad_shape(flat, name),
                           quantize_weights=quantize)


def test_loader_shares_only_the_model_s_own_leaves():
    """A float load keeps a leaf that already is the model's parameter
    (engines over one model share it) and copies any other given tensor;
    with ``quantize_weights`` the model's own float leaves are quantized
    too, to the codes a fresh tree gets."""
    other = tm.Llama(size="tiny", device="cpu", **WIDE)
    other.init_params(torch.Generator().manual_seed(0))
    given = dict(other.params)
    model = tm.Llama(size="tiny", device="cpu", **WIDE)
    tds.init_inference(model, dtype="float32", params=given)
    for name, p in model.params.items():
        assert p.data_ptr() != given[name].data_ptr()
        assert torch.equal(p, given[name])
    own = dict(model.params)
    tds.init_inference(model, dtype="float32", params=own)
    assert all(model.params[n] is p for n, p in own.items())
    fresh = tm.Llama(size="tiny", device="cpu", **WIDE)
    tds.init_inference(fresh, dtype="float32", params=given,
                       quantize_weights=True)
    tds.init_inference(model, dtype="float32", params=own,
                       quantize_weights=True)
    assert sorted(model.params) == sorted(fresh.params)
    assert "layers/wq" not in model.params
    for name, p in fresh.params.items():
        assert torch.equal(model.params[name], p)
