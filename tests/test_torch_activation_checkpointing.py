"""The port's activation checkpointing
(deepspeed_tpu_torch/runtime/activation_checkpointing/checkpointing.py)
against the JAX module, on the CPU: tests/test_runtime_misc.py's cases
on the same numpy inputs through both, plus the policies and
cpu_checkpointing the config selects. Tolerances: the JAX test's 1e-5 on
the value and 1e-4 relative on the grads; absolute, 1e-6 of the largest
grad (the grads reach 160, and the two frameworks sum in another order:
an element of 0.29 differs by 8.9e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from deepspeed_tpu.runtime.activation_checkpointing import (
    checkpointing as jckpt)
from deepspeed_tpu_torch.runtime.activation_checkpointing import (
    checkpointing as ckpt)


@pytest.fixture(autouse=True)
def _reset():
    yield
    ckpt.reset()
    jckpt.reset()


def _inputs():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((32, 32)).astype(np.float32),
            rng.standard_normal((8, 32)).astype(np.float32))


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _grad_run(w, x, block, use_ckpt):
    """sum(block(x)^2) and its grad, with the backward's matmul count."""
    xt = torch.from_numpy(x).requires_grad_()
    out = ckpt.checkpoint(block, xt) if use_ckpt else block(xt)
    loss = (out ** 2).sum()
    count = _CountMM()
    with count:
        loss.backward()
    return float(loss.detach()), xt.grad.numpy(), count.n


@pytest.mark.parametrize("ac", [
    {}, {"policy": "dots_saveable"}, {"policy": "everything_saveable"},
    {"policy": "dots_with_no_batch_dims_saveable"},
    {"cpu_checkpointing": True}, {"partition_activations": True}])
def test_checkpoint_matches_uncheckpointed_and_jax(ac):
    """test_runtime_misc.py::test_checkpoint_matches_uncheckpointed, under
    each activation_checkpointing setting of both modules: the value and
    the grad equal the plain block's and JAX's checkpoint of it. The
    backward's matmuls show what was saved: tanh(x @ w) @ w.T has two
    projections, whose grads take four matmuls; nothing_saveable (the
    default) and partition_activations (a no-op without tp) rerun the
    first (the last of a region never reruns), the dot policies and
    cpu_checkpointing (its output offloaded to host memory) none."""
    w, x = _inputs()
    wt = torch.from_numpy(w)
    if ac:
        cfg = {"activation_checkpointing": ac}
        ckpt.configure(deepspeed_config=cfg)
        jckpt.configure(deepspeed_config=cfg)

    def block(x):
        return torch.tanh(x @ wt) @ wt.T

    plain = _grad_run(w, x, block, False)
    got = _grad_run(w, x, block, True)
    np.testing.assert_allclose(got[0], plain[0], rtol=1e-6)
    np.testing.assert_allclose(got[1], plain[1], rtol=1e-6, atol=1e-6)
    rerun = 0 if ac.get("policy", "nothing_saveable") != "nothing_saveable" \
        or ac.get("cpu_checkpointing") else 1
    assert got[2] == plain[2] + rerun

    def jblock(x):
        return jnp.tanh(x @ w) @ w.T

    jf = lambda x: jnp.sum(jckpt.checkpoint(jblock, x) ** 2)  # noqa: E731
    np.testing.assert_allclose(got[0], float(jf(jnp.asarray(x))), rtol=1e-5)
    jg = np.asarray(jax.jit(jax.grad(jf))(jnp.asarray(x)))
    np.testing.assert_allclose(got[1], jg, rtol=1e-4,
                               atol=1e-6 * np.abs(jg).max())


def test_checkpoint_configure_and_wrapper():
    cfg = {"activation_checkpointing": {"partition_activations": True,
                                        "cpu_checkpointing": False}}
    ckpt.configure(deepspeed_config=cfg)
    assert ckpt.is_configured()
    block = ckpt.checkpoint_wrapper(lambda x: x @ torch.eye(16))
    assert float(block(torch.ones((4, 16))).sum()) == 64.0
    jckpt.configure(deepspeed_config=cfg)
    jblock = jckpt.checkpoint_wrapper(lambda x: x @ jnp.eye(16))
    assert float(jax.jit(lambda x: jblock(x).sum())(jnp.ones((4, 16)))) \
        == 64.0
    ckpt.configure(checkpoint_in_cpu=True, num_checkpoints=4)
    assert ckpt._CONFIG.cpu_checkpointing
    assert ckpt._CONFIG.number_checkpoints == 4
    ckpt.reset()
    assert not ckpt.is_configured()


def test_rng_tracker_deterministic_streams():
    """Forks of a stream differ; reseeding replays them; an unknown stream
    refuses (the JAX tracker's contract, with torch generators)."""
    ckpt.model_parallel_cuda_manual_seed(1234)
    tr = ckpt.get_cuda_rng_tracker()
    g1 = tr.fork("model-parallel-rng")
    g2 = tr.fork("model-parallel-rng")
    a, b = (torch.rand(8, generator=g) for g in (g1, g2))
    assert not torch.equal(a, b)
    ckpt.model_parallel_cuda_manual_seed(1234)
    assert torch.equal(torch.rand(8, generator=tr.fork("model-parallel-rng")),
                       a)
    other = torch.rand(8, generator=tr.fork("data-parallel-rng"))
    assert not torch.equal(other, a)
    with pytest.raises(ValueError):
        tr.fork("nope")
    with pytest.raises(ValueError, match="exists"):
        tr.add("data-parallel-rng", 1)
    states = tr.get_states()
    c = torch.rand(8, generator=tr.fork("data-parallel-rng"))
    tr.set_states(states)
    assert torch.equal(torch.rand(8, generator=tr.fork("data-parallel-rng")),
                       c)


def test_dropout_in_a_checkpoint_replays_in_the_recompute():
    """A dropout inside a checkpointed block draws the same mask in the
    recompute: the grad equals the uncheckpointed block's with the same
    generator state."""
    x = torch.from_numpy(_inputs()[1])

    def run(use_ckpt):
        torch.manual_seed(7)
        xt = x.clone().requires_grad_()
        block = lambda x: torch.nn.functional.dropout(  # noqa: E731
            torch.tanh(x), 0.5)
        out = ckpt.checkpoint(block, xt) if use_ckpt else block(xt)
        out.sum().backward()
        return xt.grad

    torch.testing.assert_close(run(True), run(False), rtol=0, atol=0)
