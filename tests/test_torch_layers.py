"""The port's plain ops (deepspeed_tpu_torch/ops/layers.py) and models
against the JAX package's, on the same numpy inputs, in fp32 on the CPU;
and the JAX -> port parameter carry (models/convert.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import GPT2 as JGPT2, Llama as JLlama
from deepspeed_tpu.ops import layers as J
from deepspeed_tpu_torch.models import GPT2, Llama, load_jax_params
from deepspeed_tpu_torch.models.convert import flatten_tree
from deepspeed_tpu_torch.ops import layers as T

ATOL = 1e-6


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, ref, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=rtol)


def test_norms_match_jax():
    x, scale, bias = _x(3, 5, 64), _x(64, seed=1), _x(64, seed=2)
    _close(T.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5),
           J.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5))
    _close(T.layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                        torch.from_numpy(bias), 1e-5),
           J.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                        jnp.asarray(bias), 1e-5))


@pytest.mark.parametrize("name", ["gelu", "silu"])
def test_activations_match_jax(name):
    x = _x(4, 33) * 3
    _close(getattr(T, name)(torch.from_numpy(x)),
           getattr(J, name)(jnp.asarray(x)))


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rotary_with_positions_matches_jax(theta):
    x = _x(2, 5, 3, 16)
    pos = np.asarray([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int64)
    tcos, tsin = T.rotary_embedding(32, 16, theta)
    jcos, jsin = J.rotary_embedding(32, 16, theta)
    _close(tcos, jcos, atol=0.0)
    _close(tsin, jsin, atol=0.0)
    _close(T.apply_rotary(torch.from_numpy(x), tcos, tsin,
                          torch.from_numpy(pos)),
           J.apply_rotary(jnp.asarray(x), jcos, jsin, jnp.asarray(pos)))
    _close(T.apply_rotary(torch.from_numpy(x), tcos, tsin),
           J.apply_rotary(jnp.asarray(x), jcos, jsin))


@pytest.mark.parametrize("heads", [4, 6])
def test_alibi_slopes_match_jax(heads):
    _close(T.alibi_slopes(heads), J.alibi_slopes(heads), atol=0.0)


def test_gqa_attention_matches_jax():
    q, k, v = _x(2, 7, 4, 16), _x(2, 7, 2, 16, seed=1), _x(2, 7, 2, 16,
                                                           seed=2)
    bias = T.window_bias(7, 3)
    np.testing.assert_array_equal(bias.numpy(), np.asarray(J.window_bias(7, 3)))
    _close(T.dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                   bias=bias),
           J.dot_product_attention(*map(jnp.asarray, (q, k, v)),
                                   bias=jnp.asarray(bias.numpy())))


FAMILIES = {"llama": (JLlama, Llama), "gpt2": (JGPT2, GPT2)}
# the block's other switches, each against the JAX model built the same way
VARIANTS = {
    "llama": ("llama", {}),
    "gpt2": ("gpt2", {}),
    "llama-parallel-partial-rope-window": ("llama", dict(
        parallel_residual=True, parallel_dual_norm=True, rotary_pct=0.5,
        sliding_window=4, attn_qkv_bias=True)),
    "gpt2-alibi-embed-ln-untied-relu": ("gpt2", dict(
        position_embedding="alibi", embed_layernorm=True,
        tie_embeddings=False, lm_head_bias=True, activation="relu")),
}


def _pair(family, **overrides):
    jcls, tcls = FAMILIES[family]
    jm = jcls(size="tiny", **overrides)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = tcls(size="tiny", device="cpu", **overrides)
    load_jax_params(tm, tree)
    return jm, tree, tm


@pytest.mark.parametrize("family", list(FAMILIES))
def test_load_jax_params_round_trips_every_leaf(family):
    _, tree, tm = _pair(family)
    flat = flatten_tree(tree)
    assert set(flat) == set(tm.params.keys())
    for name, leaf in flat.items():
        np.testing.assert_array_equal(tm.params[name].detach().numpy(),
                                      leaf, err_msg=name)
    assert sum(p.numel() for p in tm.params.values()) \
        == tm.config.num_params()


def test_load_jax_params_rejects_mismatches():
    _, tree, tm = _pair("llama")
    bad = dict(tree, layers=dict(tree["layers"]))
    bad["layers"]["wq"] = bad["layers"]["wq"][:, :, :8]
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(tm, bad)
    bad = dict(tree, extra=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="unexpected"):
        load_jax_params(tm, bad)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_contiguous_apply_matches_jax(variant):
    family, overrides = VARIANTS[variant]
    jm, tree, tm = _pair(family, **overrides)
    tokens = np.random.default_rng(4).integers(0, 512, (2, 9))
    ref = jm.apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(tokens))
    with torch.no_grad():
        got = tm.apply(torch.from_numpy(tokens))
    _close(got, ref, atol=2e-4, rtol=2e-4)
