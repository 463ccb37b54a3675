"""Model adapters in the port (deepspeed_tpu_torch ``models/adapters.py``
and the engine's ``_as_model``) against the JAX package's
(``deepspeed_tpu/models/adapters.py``), fp32 on the CPU, from the same
seeded weights:

- ``FunctionalModel`` over one small LM (an embedding, tanh, a biased
  vocab projection) written in jnp and in torch: the default next-token
  loss and a caller's ``loss_fn``, loss within 1e-6 relative and grads
  within 1e-5 of each tensor's largest element; 3 engine steps against
  the JAX engine (each loss within 1e-5 relative, the params within 5e-5
  of the norm of their total change, tests/test_torch_train_engine.py's
  bounds);
- ``ModuleModel`` (an ``nn.Module``) against JAX's ``FlaxModel`` (a flax
  module of the same layers, its Dense kernel the transpose of the
  Linear's weight), the same checks, the module given to the engine as
  it is (``dont_change_device``: left on the CPU);
- ``wrap_model``'s ``TypeError``, and a ``loss_fn`` trained across two
  gloo ranks on the exact wire: every rank evaluates it over the global
  batch, so the run is the single-rank run's.
"""

import os
import subprocess
import sys
import textwrap

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import deepspeed_tpu as jds
import deepspeed_tpu_torch as ds
from deepspeed_tpu.models import adapters as JA
from deepspeed_tpu.ops.layers import cross_entropy_loss as jce
from deepspeed_tpu_torch.models import adapters as TA
from deepspeed_tpu_torch.models.convert import flatten_tree, load_jax_params
from deepspeed_tpu_torch.ops.layers import cross_entropy_loss as tce
from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine

V, D = 64, 16
TOL = 1e-5
CFG = {"train_batch_size": 16, "gradient_accumulation_steps": 2,
       "optimizer": {"type": "AdamW",
                     "params": {"lr": 1e-2, "weight_decay": 0.01}},
       "gradient_clipping": 1.0, "steps_per_print": 2,
       "zero_optimization": {"stage": 2}}


def _batch(rows=4, seq=8, seed=0):
    tok = np.random.default_rng(seed).integers(0, V, (rows, seq + 1))
    return tok[:, :-1], tok[:, 1:]


# --------------------------------------------------- the functional LM
def j_init(rng):
    k1, k2 = jax.random.split(rng)
    return {"embed": jax.random.normal(k1, (V, D)) * 0.5,
            "out": {"w": jax.random.normal(k2, (D, V)) * 0.5,
                    "b": jnp.zeros((V,))}}


def j_apply(params, tokens):
    h = jnp.tanh(params["embed"][tokens])
    return h @ params["out"]["w"] + params["out"]["b"]


def j_loss(params, batch):
    tokens, targets = batch
    logits = j_apply(params, tokens)
    return jce(logits, targets) + 1e-2 * jnp.mean(jnp.square(logits))


def t_init(gen):
    return {"embed": torch.randn(V, D, generator=gen,
                                 device=gen.device) * 0.5,
            "out": {"w": torch.randn(D, V, generator=gen,
                                     device=gen.device) * 0.5,
                    "b": torch.zeros(V, device=gen.device)}}


def t_apply(params, tokens):
    h = torch.tanh(params["embed"][tokens])
    return h @ params["out"]["w"] + params["out"]["b"]


def t_loss(params, batch):
    tokens, targets = batch
    logits = t_apply(params, tokens)
    return tce(logits, targets) + 1e-2 * logits.square().mean()


def _functional(with_loss):
    tree = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0)))
    jm = JA.FunctionalModel(j_init, j_apply, j_loss if with_loss else None)
    tm = TA.FunctionalModel(t_init, t_apply, t_loss if with_loss else None,
                            device="cpu")
    load_jax_params(tm, tree)
    return jm, tm, tree


# ------------------------------------------------------- the module LM
class FlaxLM(fnn.Module):
    @fnn.compact
    def __call__(self, tokens):
        h = jnp.tanh(fnn.Embed(V, D)(tokens))
        return fnn.Dense(V)(h)


class TorchLM(nn.Module):
    def __init__(self):
        super().__init__()
        self.emb = nn.Embedding(V, D)
        self.out = nn.Linear(D, V)

    def forward(self, tokens):
        return self.out(torch.tanh(self.emb(tokens)))


def _to_torch_names(tree) -> dict:
    """A FlaxLM tree as TorchLM's ModuleModel params (Dense kernel ->
    Linear weight, transposed)."""
    return {"emb/weight": np.asarray(tree["Embed_0"]["embedding"]),
            "out/weight": np.asarray(tree["Dense_0"]["kernel"]).T.copy(),
            "out/bias": np.asarray(tree["Dense_0"]["bias"])}


def _module():
    jm = JA.FlaxModel(FlaxLM())
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    torch.manual_seed(0)
    tm = TA.wrap_model(TorchLM(), device="cpu")
    assert isinstance(tm, TA.ModuleModel)
    load_jax_params(tm, _to_torch_names(tree))
    return jm, tm, tree


def _grads_close(grads: dict, jgrads: dict):
    assert set(grads) == set(jgrads)
    for name, g in jgrads.items():
        scale = float(np.abs(g).max())
        err = float(np.abs(grads[name] - g).max())
        assert err <= TOL * scale, (name, err / scale)


def _loss_and_grads(jm, tm, tree, batch, jgrad_names=None):
    jloss, jgrads = jax.value_and_grad(jm.loss)(
        jax.tree.map(jnp.asarray, tree), tuple(map(jnp.asarray, batch)))
    loss = tm.loss(tuple(map(torch.from_numpy, batch)))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    jflat = (jgrad_names or flatten_tree)(jax.tree.map(np.asarray, jgrads))
    _grads_close({n: p.grad.numpy() for n, p in tm.params.items()}, jflat)


@pytest.mark.parametrize("with_loss", [False, True])
def test_functional_model_loss_and_grads_match_jax(with_loss):
    jm, tm, tree = _functional(with_loss)
    _loss_and_grads(jm, tm, tree, _batch())
    assert tm.loss_splits is not with_loss
    if with_loss:
        with pytest.raises(NotImplementedError, match="own loss_fn"):
            tm.loss_terms(tuple(map(torch.from_numpy, _batch())))
    else:
        dict_loss = tm.loss({"tokens": torch.from_numpy(_batch()[0]),
                             "targets": torch.from_numpy(_batch()[1])})
        torch.testing.assert_close(dict_loss, tm.loss(
            tuple(map(torch.from_numpy, _batch()))))


def test_module_model_loss_and_grads_match_flax():
    jm, tm, tree = _module()
    _loss_and_grads(jm, tm, tree, _batch(), _to_torch_names)


def _engine_steps_match(jm, tm, tree, tree_for_torch,
                        dont_change_device=False):
    jeng, *_ = jds.initialize(
        model=jm, model_parameters=jax.tree.map(jnp.asarray, tree),
        config=dict(CFG, mesh={"fsdp": -1}))
    if dont_change_device:      # the reference engine's switch
        teng = DeepSpeedEngine(model=tm, model_parameters=tree_for_torch,
                               config=CFG, dont_change_device=True)
    else:
        teng, *_ = ds.initialize(model=tm, model_parameters=tree_for_torch,
                                 config=CFG)
    start = {k: v.detach().clone() for k, v in
             teng.master_state_dict().items()}
    losses = []
    batch = _batch(rows=16)
    for _ in range(3):
        jl = float(jeng.train_batch(batch))
        losses.append(float(teng.train_batch(batch)))
        np.testing.assert_allclose(losses[-1], jl, rtol=1e-5)
    assert losses[-1] < losses[0]
    return jeng, teng, start


def _params_close(want, got, start):
    moved = np.sqrt(sum(np.sum((want[n] - start[n].numpy()) ** 2)
                        for n in want))
    err = np.sqrt(sum(np.sum((got[n].numpy() - want[n]) ** 2)
                      for n in want))
    assert err <= 5e-5 * moved, (err, moved)


@pytest.mark.parametrize("with_loss", [False, True])
def test_functional_model_engine_steps_match_jax(with_loss, devices8):
    jm, tm, tree = _functional(with_loss)
    jeng, teng, start = _engine_steps_match(jm, tm, tree, tree)
    _params_close(flatten_tree(jax.tree.map(np.asarray,
                                            jeng.state["params"])),
                  teng.master_state_dict(), start)
    assert teng.tput_timer.tflops() is None     # no FLOP count: no MFU


def test_module_model_engine_trains_the_module_in_place(devices8):
    jm, tm, tree = _module()
    module = tm.module
    jeng, teng, start = _engine_steps_match(jm, module, tree,
                                            _to_torch_names(tree),
                                            dont_change_device=True)
    _params_close(_to_torch_names(jax.tree.map(np.asarray,
                                               jeng.state["params"])),
                  teng.master_state_dict(), start)
    # the engine trains the module's own parameters, where they were
    assert teng.module.module is module
    assert teng.device == torch.device("cpu")
    torch.testing.assert_close(module.out.bias.detach(),
                               teng.master_state_dict()["out/bias"])


def test_wrap_model_refuses_what_it_cannot_adapt():
    for wrap in (JA.wrap_model, TA.wrap_model):
        with pytest.raises(TypeError, match="cannot adapt .* into the "
                                            "Model protocol"):
            wrap(object())
    with pytest.raises(TypeError, match="cannot adapt"):
        ds.initialize(model=object(), config={"train_batch_size": 2})

    class PipelineModule(nn.Module):      # the reference's, by its name
        pass

    with pytest.raises(NotImplementedError, match="Slice D item 12"):
        ds.initialize(model=PipelineModule(), config={"train_batch_size": 2})


def test_functional_model_without_a_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TA.FunctionalModel(t_init, t_apply)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TA.wrap_model((t_init, t_apply))       # a FunctionalModel


RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, {root!r})
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.models.adapters import FunctionalModel

    def init(gen):
        return {{"w": torch.randn(8, 8, generator=gen)}}

    def apply(params, tokens):
        return params["w"][tokens]

    def loss(params, batch):
        # not a mean over rows: the largest row's mean square
        return apply(params, batch[0]).square().mean((1, 2)).max()

    torch.set_num_threads(1)
    world = int(sys.argv[2])
    if world > 1:
        comm.init_distributed("gloo", init_method="file://{store}",
                              rank=int(sys.argv[1]), world_size=world)
    tokens = np.random.default_rng(0).integers(0, 8, (4, 3))
    losses = []
    for with_loss in (True, False):
        eng, *_ = ds.initialize(
            model=FunctionalModel(init, apply, loss if with_loss else None,
                                  device="cpu"),
            config={{"train_batch_size": 4, "steps_per_print": 100,
                     "optimizer": {{"type": "AdamW",
                                    "params": {{"lr": 1e-2}}}}}})
        for _ in range(3):
            batch = (tokens, np.roll(tokens, 1, axis=1))
            losses.append(float(eng.train_batch(batch)))
    print("LOSSES", " ".join(repr(x) for x in losses))
    if world > 1:
        dist.destroy_process_group()
""")


def test_loss_fn_trains_across_ranks(tmp_path):
    """A FunctionalModel with its own loss_fn (the largest row's mean, not
    a mean over rows) trains at W = 2 on the exact wire: each rank
    evaluates it over the global batch and keeps half its gradient, so
    the losses are the single-rank run's within 1e-6 relative; the
    default loss trains beside it."""
    tests = os.path.dirname(os.path.abspath(__file__))
    script = tmp_path / "rank.py"
    script.write_text(RANK.format(root=os.path.dirname(tests),
                                  store=str(tmp_path / "store")))
    runs = [[(r, 2) for r in range(2)], [(0, 1)]]
    procs = [[subprocess.Popen([sys.executable, str(script), str(r), str(w)],
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                               text=True) for r, w in run] for run in runs]
    losses = []
    for run in procs:
        for p in run:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            line = next(x for x in out.splitlines() if x.startswith("LOSSES"))
            losses.append([float(x) for x in line.split()[1:]])
    (a, b), one = losses[:2], losses[2]
    assert a == b
    np.testing.assert_allclose(a, one, rtol=1e-6)
    assert a[2] < a[0] and a[5] < a[3]
