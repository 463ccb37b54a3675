"""Every remat policy of the port (deepspeed_tpu_torch/models/transformer.py,
runtime/activation_checkpointing/checkpointing.py ``remat``) against
remat=False and against the JAX model under the same policy, on the CPU.

Rematerialisation changes memory and recompute, not math: under every
policy the loss and the grads equal remat=False's (1e-6: the recompute
repeats the same CPU ops) and the JAX model's with the same
``remat_policy`` (loss 1e-5 relative, each grad within 2e-5 of the largest
of its tensor, tests/test_torch_train_engine.py's model tolerances). A
policy that silently recomputed everything would pass those checks, so
the matmuls the backward runs are counted with a TorchDispatchMode: the
recompute adds, over remat=False's backward, exactly the projections
(``aten.mm``) and attention products (``aten.bmm``) the policy's name
leaves unsaved. The names JAX cannot run are refused, as JAX fails on
them at its first traced step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import deepspeed_tpu_torch as ds
from deepspeed_tpu.models import GPT2 as JGPT2, Llama as JLlama
from deepspeed_tpu_torch.models import GPT2, Llama
from deepspeed_tpu_torch.models.convert import flatten_tree
from deepspeed_tpu_torch.models.transformer import (POLICY_FACTORIES,
                                                    REMAT_POLICIES)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side runs tiny models: one intra-op thread a worker
    keeps it from spinning against the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


FAMILIES = {"gpt2": (JGPT2, GPT2), "llama": (JLlama, Llama)}
_aten = torch.ops.aten

# matmuls the backward reruns per layer, over remat=False's backward, with
# the reference attention: (mm, bmm). torch's non-reentrant checkpoint
# reruns a region in order and stops once the last saved tensor the
# backward needs exists, so a region's last matmul never reruns.
RECOMPUTED = {
    "gpt2": {
        # the whole block up to the down projection
        "nothing_saveable": (5, 2),
        "everything_saveable": (0, 0),
        # every matmul output saved
        "dots_saveable": (0, 0), "checkpoint_dots": (0, 0),
        # projections saved, attention's batched products rerun
        "dots_with_no_batch_dims_saveable": (0, 2),
        "checkpoint_dots_with_no_batch_dims": (0, 2),
        # q, k (v is its region's last), the scores (the attention output
        # is saved), the output and up projections (the ffn is saved)
        "save_attn_ffn": (4, 1),
        # q, k, and the up projection; attention outside any checkpoint
        "segments": (3, 0),
    },
    "llama": {
        "nothing_saveable": (6, 2), "everything_saveable": (0, 0),
        "dots_saveable": (0, 0), "checkpoint_dots": (0, 0),
        "dots_with_no_batch_dims_saveable": (0, 2),
        "checkpoint_dots_with_no_batch_dims": (0, 2),
        # q, k, v (rope follows them), the scores, the output, gate and up
        # projections
        "save_attn_ffn": (6, 1),
        "segments": (5, 0),
    },
}


class _CountDots(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = self.bmm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (_aten.mm.default, _aten.addmm.default):
            self.mm += 1
        elif func in (_aten.bmm.default, _aten.baddbmm.default):
            self.bmm += 1
        return func(*args, **(kwargs or {}))


def _batch(rows=2, seq=24, seed=0):
    tok = np.random.default_rng(seed).integers(0, 512, (rows, seq + 1))
    return tok[:, :-1], tok[:, 1:]


def _port_run(family, tree, **over):
    """Loss, grads and the backward's (mm, bmm) counts of the port."""
    model = FAMILIES[family][1](size="tiny", device="cpu", **over)
    ds.models.load_jax_params(model, tree)
    tokens, targets = map(torch.from_numpy, _batch())
    loss = model.loss((tokens, targets))
    count = _CountDots()
    with count:
        loss.backward()
    return (float(loss.detach()), {n: p.grad for n, p in
                                   model.params.items()},
            (count.mm, count.bmm), model.config.num_layers)


@pytest.fixture(scope="module")
def trees():
    return {f: jax.tree.map(np.asarray, j(size="tiny").init(
        jax.random.PRNGKey(0))) for f, (j, _) in FAMILIES.items()}


@pytest.fixture(scope="module")
def no_remat(trees):
    return {f: _port_run(f, trees[f], remat=False) for f in FAMILIES}


@pytest.mark.parametrize("policy", REMAT_POLICIES)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_policy_matches_no_remat_and_recomputes_what_it_names(
        family, policy, trees, no_remat):
    loss, grads, dots, layers = _port_run(family, trees[family], remat=True,
                                          remat_policy=policy)
    ref_loss, ref_grads, ref_dots, _ = no_remat[family]
    assert abs(loss - ref_loss) <= 1e-6 * abs(ref_loss)
    for name, g in ref_grads.items():
        torch.testing.assert_close(grads[name], g, rtol=0, atol=1e-6,
                                   msg=name)
    mm, bmm = RECOMPUTED[family][policy]
    assert dots == (ref_dots[0] + layers * mm, ref_dots[1] + layers * bmm)


@pytest.mark.parametrize("policy", ["save_attn_ffn", "dots_saveable",
                                    "segments"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_policy_with_flash_attention_matches_no_remat(family, policy, trees):
    """attn_impl="flash" (on the CPU the kernels' plain versions inside
    their autograd Function): the recompute reruns the forward, and the
    grads are remat=False's."""
    loss, grads, _, _ = _port_run(family, trees[family], remat=True,
                                  remat_policy=policy, attn_impl="flash")
    ref_loss, ref_grads, _, _ = _port_run(family, trees[family], remat=False,
                                          attn_impl="flash")
    assert abs(loss - ref_loss) <= 1e-6 * abs(ref_loss)
    for name, g in ref_grads.items():
        torch.testing.assert_close(grads[name], g, rtol=0, atol=1e-6,
                                   msg=name)


@pytest.mark.parametrize("policy", REMAT_POLICIES)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_policy_matches_jax_model(family, policy, trees):
    jm = FAMILIES[family][0](size="tiny", remat=True, remat_policy=policy)
    tree = trees[family]
    tokens, targets = _batch()
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(
        jax.tree.map(jnp.asarray, tree),
        (jnp.asarray(tokens), jnp.asarray(targets)))
    loss, grads, _, _ = _port_run(family, tree, remat=True,
                                  remat_policy=policy)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    jgrads = flatten_tree(jax.tree.map(np.asarray, jgrads))
    top = max(float(np.abs(g).max()) for g in jgrads.values())
    for name, g in jgrads.items():
        scale = max(float(np.abs(g).max()), 1e-3 * top)
        assert np.abs(grads[name].numpy() - g).max() <= 2e-5 * scale, name


@pytest.mark.parametrize("name", [*POLICY_FACTORIES, "no_such_policy"])
def test_names_jax_cannot_run_are_refused(name, trees):
    """A jax.checkpoint_policies factory: the JAX model passes it to
    jax.checkpoint as the policy, and its first traced step raises
    TypeError; the port raises TypeError when the model is built. An
    unknown name: JAX raises AttributeError, the port ValueError."""
    jm = JGPT2(size="tiny", remat=True, remat_policy=name)
    tokens, targets = _batch()
    want = AttributeError if name == "no_such_policy" else TypeError
    with pytest.raises(want):
        jax.jit(jax.grad(jm.loss))(
            jax.tree.map(jnp.asarray, trees["gpt2"]),
            (jnp.asarray(tokens), jnp.asarray(targets)))
    got = ValueError if name == "no_such_policy" else TypeError
    with pytest.raises(got, match="remat_policy"):
        GPT2(size="tiny", device="cpu", remat=True, remat_policy=name)
    GPT2(size="tiny", device="cpu", remat=False, remat_policy=name)


@pytest.mark.parametrize("policy", ["save_attn_ffn",
                                    "dots_with_no_batch_dims_saveable",
                                    "none"])
def test_engine_plumbs_every_policy(policy):
    """activation_checkpointing.policy reaches the model (JAX
    engine.py:130-143): "none" turns remat off."""
    eng, *_ = ds.initialize(model=GPT2(size="tiny", device="cpu"), config={
        "train_batch_size": 2,
        "activation_checkpointing": {"policy": policy}})
    c = eng.model_config
    assert c.remat == (policy != "none")
    if policy != "none":
        assert c.remat_policy == policy
    loss = eng.train_batch(_batch(rows=2, seq=8))
    assert torch.isfinite(loss)
