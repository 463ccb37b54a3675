"""BERT and its encoder layer in the port (deepspeed_tpu_torch
``ops/transformer.py``, ``models/bert.py``) against the JAX package's, fp32
on the CPU, on the same seeded numpy inputs and the JAX init carried
across:

- ``DeepSpeedTransformerLayer`` pre-LN and post-LN, with and without the
  additive padding mask (JAX ``training=False``): the output within 1e-5
  of its largest element, each of the twelve parameters' grads within
  1e-5 of the largest element of its tensor (a tensor's scale at least
  1e-3 of the layer's largest grad, tests/test_torch_train_engine.py's
  floor), the input's grad likewise;
- dropout from an explicit generator: live at rate 0.5 (two generators
  give two outputs, one generator twice the same), rate 0 and
  ``training=False`` equal the plain layer, ``gelu_checkpoint``'s grads
  equal the plain layer's under the same draws;
- ``Bert("tiny")``: ``num_params`` against JAX's and the parameters,
  logits with and without the mask within 1e-5 of their largest, JAX's
  padding invariance (tests/test_model_families.py
  ``test_bert_encoder_end_to_end``), loss (1e-6 relative) and grads with
  tuple and dict batches, the ``max_seq_len`` error;
- ``initialize(Bert("tiny"))`` for 3 ``train_batch`` steps on (tokens,
  targets, mask) against the JAX engine from the same weights, with
  tests/test_torch_train_engine.py ``test_engine_steps_match_jax_fp32``'s
  bounds (each loss within 1e-5 relative, the grad norm within 1e-4, the
  params after 3 steps within 5e-5 of the norm of their total change).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as ds
from deepspeed_tpu.models import Bert as JBert
from deepspeed_tpu.ops import transformer as JT
from deepspeed_tpu_torch.models import Bert
from deepspeed_tpu_torch.models.convert import flatten_tree, load_jax_params
from deepspeed_tpu_torch.ops import transformer as TT

TOL = 1e-5
LOSS_RTOL = 1e-6
LAYER = dict(hidden_size=64, intermediate_size=256, heads=4,
             num_hidden_layers=2)


def _mask(rows=2, seq=16, pad_from=10):
    """[B, S] HF mask: the last row padded from ``pad_from``."""
    m = np.ones((rows, seq), np.int32)
    m[-1, pad_from:] = 0
    return m


def _additive(mask):
    return np.where(mask[:, None, None, :] > 0, 0.0,
                    -1e30).astype(np.float32)


def _layer_pair(pre_ln, **over):
    """JAX and port layers of one config, the JAX init carried across."""
    kw = dict(LAYER, pre_layer_norm=pre_ln, **over)
    jl = JT.DeepSpeedTransformerLayer(JT.DeepSpeedTransformerConfig(
        **dict(kw, training=False)))
    params = jax.tree.map(np.asarray, jl.init(jax.random.PRNGKey(3)))
    tl = TT.DeepSpeedTransformerLayer(TT.DeepSpeedTransformerConfig(**kw),
                                      device="cpu")
    with torch.no_grad():
        for name, leaf in params.items():
            tl.params[name].copy_(torch.from_numpy(np.array(leaf)))
    return jl, tl, params


def _close(got, ref, what, floor=0.0):
    scale = max(float(np.abs(ref).max()), floor)
    err = float(np.abs(np.asarray(got) - ref).max())
    assert err <= TOL * scale, (what, err / scale)


def _grads_close(grads, jgrads):
    assert set(grads) == set(jgrads)
    top = max(float(np.abs(g).max()) for g in jgrads.values())
    for name, g in jgrads.items():
        _close(grads[name], g, name, 1e-3 * top)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("pre_ln", [True, False])
def test_layer_matches_jax(pre_ln, masked):
    jl, tl, params = _layer_pair(pre_ln)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    cot = rng.standard_normal((2, 16, 64)).astype(np.float32)
    bias = _additive(_mask()) if masked else None

    def jf(p, x):
        out = jl.apply(p, x, attention_mask=None if bias is None
                       else jnp.asarray(bias))
        return jnp.sum(out * cot), out

    (_, jout), (jgrads, jgx) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(jax.tree.map(jnp.asarray, params),
                                          jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = tl(xt, None if bias is None else torch.from_numpy(bias))
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out.detach().numpy(), np.asarray(jout), "output")
    _grads_close({n: p.grad.numpy() for n, p in tl.params.items()},
                 jax.tree.map(np.asarray, jgrads))
    assert len(jgrads) == 12
    _close(xt.grad.numpy(), np.asarray(jgx), "input grad")


def _dropout_layer(**over):
    kw = dict(LAYER, attn_dropout_ratio=0.5, hidden_dropout_ratio=0.5)
    cfg = TT.DeepSpeedTransformerConfig(**dict(kw, **over))
    return TT.DeepSpeedTransformerLayer(
        cfg, device="cpu", generator=torch.Generator().manual_seed(0))


def test_dropout_is_live_and_drawn_from_the_generator():
    layer = _dropout_layer()
    x = torch.randn(2, 16, 64, generator=torch.Generator().manual_seed(1))

    def run(seed):
        return layer(x, generator=torch.Generator().manual_seed(seed))

    plain = layer(x)                     # no generator: no dropout
    a, b, a2 = run(0), run(1), run(0)
    assert torch.equal(a, a2)
    assert not torch.equal(a, b)
    assert not torch.allclose(a, plain)
    layer.config.training = False
    assert torch.equal(layer(x, generator=torch.Generator()), plain)
    off = _dropout_layer(attn_dropout_ratio=0.0, hidden_dropout_ratio=0.0)
    off.load_state_dict(layer.state_dict())
    assert torch.equal(off(x, generator=torch.Generator().manual_seed(0)),
                       plain)


@pytest.mark.parametrize("pre_ln", [True, False])
def test_gelu_checkpoint_recomputes_with_the_same_draws(pre_ln):
    """The FFN block recomputed in the backward sees the dropout mask of
    its forward: output and every grad equal the plain layer's."""
    runs = []
    for ck in (False, True):
        layer = _dropout_layer(gelu_checkpoint=ck, pre_layer_norm=pre_ln)
        x = torch.randn(2, 16, 64, generator=torch.Generator().manual_seed(1),
                        requires_grad=True)
        out = layer(x, generator=torch.Generator().manual_seed(5))
        out.square().sum().backward()
        runs.append((out.detach(), x.grad,
                     {n: p.grad for n, p in layer.params.items()}))
    (o0, gx0, g0), (o1, gx1, g1) = runs
    assert torch.equal(o0, o1)
    torch.testing.assert_close(gx1, gx0, rtol=0, atol=1e-6)
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], rtol=0, atol=1e-6,
                                   msg=name)


def test_return_tuple_and_unknown_config_key():
    layer = TT.DeepSpeedTransformerLayer(
        TT.DeepSpeedTransformerConfig(**LAYER, return_tuple=True),
        device="cpu")
    out = layer(torch.zeros(1, 4, 64))
    assert isinstance(out, tuple) and out[0].shape == (1, 4, 64)
    with pytest.raises(TypeError):
        TT.DeepSpeedTransformerConfig(hiden_size=8)
    assert TT.DeepSpeedTransformerConfig() == TT.DeepSpeedTransformerConfig(
        **{f: getattr(JT.DeepSpeedTransformerConfig(), f)
           for f in JT.DeepSpeedTransformerConfig.__dataclass_fields__})


# ------------------------------------------------------------------- BERT
def _bert_pair(**over):
    jm = JBert(size="tiny", **over)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = Bert(size="tiny", device="cpu", **over)
    load_jax_params(tm, tree)
    return jm, tm, tree


def _mlm_batch(rows=2, seq=32, seed=0, pad_from=28):
    """JAX's end-to-end test's batch: 15% of positions are targets, the
    last row padded from ``pad_from``."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 512, (rows, seq))
    targets = np.where(rng.random((rows, seq)) < 0.15, tokens, -100)
    return tokens, targets, _mask(rows, seq, pad_from)


def test_bert_num_params():
    jm, tm, tree = _bert_pair()
    n = sum(p.numel() for p in tm.params.values())
    assert tm.config.num_params() == jm.config.num_params() == n
    assert set(flatten_tree(tree)) == set(tm.params.keys())
    for size in ("base", "large", "distil"):
        assert Bert(size=size, device="meta").config.num_params() == \
            JBert(size=size).config.num_params()
    assert tm.config.flops_per_token(128) == \
        jm.config.flops_per_token(128)


@pytest.mark.parametrize("masked", [False, True])
def test_bert_logits_match_jax(masked):
    jm, tm, tree = _bert_pair()
    tokens, _, mask = _mlm_batch()
    m = mask if masked else None
    ref = np.asarray(jm.apply(jax.tree.map(jnp.asarray, tree),
                              jnp.asarray(tokens),
                              attention_mask=None if m is None
                              else jnp.asarray(m)))
    with torch.no_grad():
        got = tm.apply(torch.from_numpy(tokens),
                       None if m is None else torch.from_numpy(m))
    _close(got.numpy(), ref, "logits")


def test_bert_padding_does_not_reach_real_positions():
    _, tm, _ = _bert_pair()
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 512, (8, 32))
    mask = np.ones((8, 32), np.int32)
    mask[:, 28:] = 0
    tokens2 = tokens.copy()
    tokens2[:, 30] = (tokens2[:, 30] + 5) % 512
    with torch.no_grad():
        l1 = tm.apply(torch.from_numpy(tokens), torch.from_numpy(mask))
        l2 = tm.apply(torch.from_numpy(tokens2), torch.from_numpy(mask))
    torch.testing.assert_close(l1[:, :28], l2[:, :28], rtol=0, atol=1e-5)
    assert not torch.allclose(l1[:, 28:], l2[:, 28:])


@pytest.mark.parametrize("form", ["tuple", "dict"])
def test_bert_loss_and_grads_match_jax(form):
    jm, tm, tree = _bert_pair()
    tokens, targets, mask = _mlm_batch()
    if form == "dict":
        jbatch = {"input_ids": jnp.asarray(tokens),
                  "labels": jnp.asarray(targets),
                  "attention_mask": jnp.asarray(mask)}
        tbatch = {"input_ids": torch.from_numpy(tokens),
                  "labels": torch.from_numpy(targets),
                  "attention_mask": torch.from_numpy(mask)}
    else:
        jbatch = tuple(map(jnp.asarray, (tokens, targets, mask)))
        tbatch = tuple(map(torch.from_numpy, (tokens, targets, mask)))
    jloss, jgrads = jax.value_and_grad(jm.loss)(
        jax.tree.map(jnp.asarray, tree), jbatch)
    loss = tm.loss(tbatch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_RTOL)
    _grads_close({n: p.grad.numpy() for n, p in tm.params.items()},
                 flatten_tree(jax.tree.map(np.asarray, jgrads)))
    nll, count = tm.loss_terms(tbatch)
    assert int(count) == int((targets != -100).sum())
    torch.testing.assert_close(nll / count, loss.detach())


def test_bert_refuses_a_sequence_past_max_seq_len():
    _, tm, _ = _bert_pair()
    with pytest.raises(ValueError, match="exceeds max_seq_len 128"):
        tm.apply(torch.zeros(1, 129, dtype=torch.long))
    with pytest.raises(ValueError, match="either an explicit config"):
        Bert(tm.config, size="tiny", device="cpu")


def test_bert_engine_steps_match_jax(devices8):
    """3 train_batch steps of BERT-tiny, fp32, GA 2, AdamW, clipping
    engaged, ZeRO 2, on (tokens, targets, mask): the JAX engine on
    conftest's 8-device mesh against the port's from the same weights."""
    cfg = {"train_batch_size": 16, "gradient_accumulation_steps": 2,
           "optimizer": {"type": "AdamW",
                         "params": {"lr": 1e-3, "weight_decay": 0.01}},
           "gradient_clipping": 0.5, "steps_per_print": 2,
           "zero_optimization": {"stage": 2}}
    jm, tm, tree = _bert_pair()
    jeng, *_ = jds.initialize(
        model=jm, model_parameters=jax.tree.map(jnp.asarray, tree),
        config=dict(cfg, mesh={"fsdp": -1}))
    teng, *_ = ds.initialize(model=tm, model_parameters=tree, config=cfg)
    start = {k: v.detach().clone() for k, v in
             teng.master_state_dict().items()}
    losses = []
    for step in range(3):
        batch = _mlm_batch(rows=16, seed=step)
        jl = float(jeng.train_batch(batch))
        losses.append(float(teng.train_batch(batch)))
        np.testing.assert_allclose(losses[-1], jl, rtol=1e-5)
        jn, tn = jeng.get_global_grad_norm(), teng.get_global_grad_norm()
        assert jn > 0.5 and abs(tn - jn) <= 1e-4 * jn
    want = flatten_tree(jax.tree.map(np.asarray, jeng.state["params"]))
    got = teng.master_state_dict()
    moved = np.sqrt(sum(np.sum((want[n] - start[n].numpy()) ** 2)
                        for n in want))
    err = np.sqrt(sum(np.sum((got[n].numpy() - want[n]) ** 2)
                      for n in want))
    assert err <= 5e-5 * moved, (err, moved)
    assert teng.tput_timer.flops_per_sample == \
        tm.config.flops_per_token(128) * 128
