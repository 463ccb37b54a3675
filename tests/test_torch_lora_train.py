"""LoRA fine-tuning in the port (deepspeed_tpu_torch/linear/
optimized_linear.py ``LoRAModel`` through ``initialize`` /
``train_batch``) against the JAX package's (deepspeed_tpu/linear/
``LoRAModel`` through its engine), fp32 on the CPU.

The JAX LoRAModel's frozen base (its QuantizedParameter codes and
scales) and adapters are carried across (``models/convert.py``
``lora_from_jax``), the adapters' ``b`` perturbed so that the adapter
path counts from the first step. Held: three steps of the engine (AdamW,
GA 2, clipping) with the losses within 1e-5 relative and the adapters
after the steps within 1e-4 of the norm of their change (over the
elements whose first gradient is not within rounding of zero, which
Adam's first steps move by ~lr either way); the master and
the grads as large as the adapters, nothing more; the frozen base
unchanged bit for bit; the forward on the effective weights (logits and
the KV-cache decode) against JAX's; every remat policy against none.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as ds
from deepspeed_tpu import linear as jl
from deepspeed_tpu import models as jm
from deepspeed_tpu_torch import linear as tl
from deepspeed_tpu_torch import models as tm
from deepspeed_tpu_torch.models.convert import flatten_tree, lora_from_jax

R = 8


def _pair(family, quant=True, **over):
    """(JAX LoRAModel, port LoRAModel on the same base and adapters,
    the adapters as a JAX tree)."""
    jmodel = jl.LoRAModel(jm.get_model_class(family)(size="tiny", **over),
                          jl.LoRAConfig(lora_r=R),
                          jl.QuantizationConfig() if quant else None)
    rng = np.random.default_rng(len(family))
    ads = {n: {"a": np.asarray(ab["a"]),
               "b": (0.02 * rng.standard_normal(ab["b"].shape)).astype(
                   np.float32)}
           for n, ab in jmodel.lora_state.adapters.items()}
    frozen, tads = lora_from_jax(jmodel.frozen, ads)
    model = tl.LoRAModel(
        tm.get_model_class(family)(size="tiny", device="cpu", **over),
        tl.LoRAConfig(lora_r=R), frozen=frozen, adapters=tads)
    return jmodel, model, ads


def _batch(rows=16, seq=32, seed=0):
    tok = np.random.default_rng(seed).integers(0, 512, (rows, seq + 1))
    return tok[:, :-1], tok[:, 1:]


CONFIG = {"train_batch_size": 16, "gradient_accumulation_steps": 2,
          "optimizer": {"type": "AdamW",
                        "params": {"lr": 1e-3, "weight_decay": 0.01}},
          "gradient_clipping": 0.5, "steps_per_print": 100,
          "zero_optimization": {"stage": 2}}


@pytest.mark.parametrize("family,quant", [("llama", True), ("gpt2", True),
                                          ("phi", True), ("llama", False)])
def test_lora_engine_matches_jax(family, quant, devices8):
    """Three train_batch steps of the port's engine on a LoRAModel against
    the JAX engine's: losses within 1e-5 relative, the adapters after the
    steps within 1e-4 of the norm of their change; the master holds the
    adapters alone; the frozen base is unchanged bit for bit."""
    jmodel, model, ads = _pair(family, quant)
    jeng, *_ = jds.initialize(model=jmodel,
                              model_parameters=jax.tree.map(jnp.asarray, ads),
                              config=dict(CONFIG, mesh={"fsdp": -1}))
    flat = {f"{n}/{k}": v for n, ab in ads.items() for k, v in ab.items()}
    teng, *_ = ds.initialize(model=model, model_parameters=flat,
                             config=CONFIG)
    master = teng.master_state_dict()
    assert sorted(master) == sorted(flat) == sorted(model.params)
    numel = sum(v.size for v in flat.values())
    assert sum(t.numel() for t in master.values()) == numel
    assert teng._master.numel() < numel + 64 * len(flat)
    frozen0 = {n: (leaf.codes.clone(), leaf.scales.clone())
               if tl.is_quantized(leaf) else leaf.clone()
               for n, leaf in model.frozen.items()}
    assert any(tl.is_quantized(v) for v in model.frozen.values()) == quant
    for step in range(3):
        batch = _batch(seed=step)
        jloss = float(jeng.train_batch(batch))
        tloss = float(teng.train_batch(batch))
        np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
        if step == 0:
            g0 = {n: v.clone() for n, v in teng._grad_views.items()}
    # Adam's first steps move an element by ~lr whatever its gradient's
    # size, so an element whose gradient is within rounding of zero (1e-6
    # of the largest: the two sides' sums differ by ~1e-7 of it) may move
    # apart on the two sides; the bound holds over the others, which must
    # be all but a few
    big = max(float(g.abs().max()) for g in g0.values())
    held = {n: (g.abs() > 1e-6 * big).numpy() for n, g in g0.items()}
    assert sum(int((~m).sum()) for m in held.values()) <= 1e-3 * numel
    want = flatten_tree(jax.tree.map(np.asarray, jeng.state["params"]))
    got = teng.master_state_dict()
    moved = np.sqrt(sum(np.sum((want[n] - flat[n]) ** 2) for n in flat))
    err = np.sqrt(sum(np.sum(((got[n].numpy() - want[n]) * held[n]) ** 2)
                      for n in flat))
    assert moved > 0 and err <= 1e-4 * moved, (err, moved)
    for n, leaf in model.frozen.items():
        if tl.is_quantized(leaf):
            assert torch.equal(leaf.codes, frozen0[n][0])
            assert torch.equal(leaf.scales, frozen0[n][1])
        else:
            assert torch.equal(leaf, frozen0[n])
    assert model.flops_per_token(32) == jmodel.flops_per_token(32)


@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_lora_forward_and_decode_match_jax(family):
    """The forward on the effective weights (built a layer at a time)
    against JAX's module on LoRAModel.effective_params, and the KV-cache
    decode: logits within 1e-5 of their largest."""
    jmodel, model, ads = _pair(family)
    eff = jmodel.effective_params(jax.tree.map(jnp.asarray, ads))
    tok = np.random.default_rng(1).integers(0, 512, (2, 12))
    want = np.asarray(jmodel.module.apply(eff, jnp.asarray(tok)))
    with torch.no_grad():
        got = model.apply(torch.from_numpy(tok)).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    jcache = jmodel.init_cache(2, 16)
    jlog, _ = jmodel.decode(jax.tree.map(jnp.asarray, ads),
                            jnp.asarray(tok), jcache)
    with torch.no_grad():
        cache = model.init_cache(2, 16)
        tlog, cache = model.decode(torch.from_numpy(tok), cache)
    assert cache["index"] == 12
    assert np.abs(tlog.numpy() - np.asarray(jlog)).max() <= 1e-5 * scale
    merged = model.effective_params()
    for name, v in flatten_tree(jax.tree.map(np.asarray, eff)).items():
        np.testing.assert_allclose(merged[name].detach().numpy(), v,
                                   rtol=1e-6, atol=1e-6 * np.abs(v).max())


@pytest.mark.parametrize("policy", ["segments", "nothing_saveable",
                                    "save_attn_ffn"])
def test_lora_remat_policies_match_no_remat(policy):
    """The loss and the adapters' grads under each remat policy (the
    merge of a layer inside the recomputed segments) equal remat off's
    within 1e-6 relative; the model's own parameter dict is empty."""
    runs = []
    for remat in (False, True):
        _, model, _ = _pair("llama", remat=remat, remat_policy=policy,
                            attn_impl="flash")
        assert len(model.module.params) == 0
        loss = model.loss(tuple(torch.from_numpy(a) for a in _batch(4, 32)))
        loss.backward()
        runs.append((float(loss.detach()), {n: p.grad.clone()
                                   for n, p in model.params.items()}))
    (l0, g0), (l1, g1) = runs
    assert abs(l1 - l0) <= 1e-6 * abs(l0)
    for n, g in g0.items():
        torch.testing.assert_close(g1[n], g, rtol=1e-6,
                                   atol=1e-6 * float(g.abs().max()))


def test_lora_model_draws_its_base_and_adapters():
    """Built from a seed: the base is the model's seeded draw (JAX draws
    it from module.init), the targets those of LoRAConfig's defaults,
    quantized as quantize_param quantizes the draw, b zero so the model
    starts as its quantized base; the same seed gives the same model; the
    model's own parameter dict is released."""
    a = tl.LoRAModel(tm.Llama(size="tiny", device="cpu"), seed=3,
                     quantization_config=tl.QuantizationConfig())
    b = tl.LoRAModel(tm.Llama(size="tiny", device="cpu"), seed=3,
                     quantization_config=tl.QuantizationConfig())
    assert len(a.module.params) == 0
    assert sorted(a.targets) == sorted(
        f"layers/{w}" for w in ("wq", "wk", "wv", "wo", "w_gate", "w_up",
                                "w_down"))
    for n, p in a.params.items():
        assert torch.equal(p, b.params[n])
        assert not n.endswith("/b") or not p.any()
    base = tm.Llama(size="tiny", device="cpu")
    base.init_params(torch.Generator().manual_seed(3))
    for name in a.targets:
        qp = tl.quantize_param(base.params[name].detach())
        assert torch.equal(a.frozen[name].codes, qp.codes)
        assert torch.equal(a.frozen[name].scales, qp.scales)
    tok = torch.from_numpy(np.random.default_rng(2).integers(0, 512, (2, 8)))
    with torch.no_grad():
        eff = a.effective_params()
        assert torch.equal(eff["layers/wq"],
                           a.frozen["layers/wq"].dequantized())
        assert torch.equal(eff["embed/tokens"], base.params["embed/tokens"])
        torch.testing.assert_close(a.apply(tok), base.apply(tok), rtol=0.1,
                                   atol=0.05)
    with pytest.raises(ValueError, match="together"):
        tl.LoRAModel(tm.Llama(size="tiny", device="cpu"),
                     frozen=a.frozen)


def test_engine_names_lora_and_refuses_other_models():
    """A LoRAModel is one of the port's own models (params and loss): the
    engine takes it as it is; an object it cannot adapt raises the model
    adapters' TypeError (JAX ``_as_model``)."""
    from deepspeed_tpu_torch.runtime.engine import _as_model
    lora = tl.LoRAModel(tm.Llama(size="tiny", device="cpu"),
                        tl.LoRAConfig(lora_r=4))
    assert _as_model(lora) is lora
    with pytest.raises(TypeError, match="cannot adapt"):
        ds.initialize(model=object(), config={"train_batch_size": 2})
