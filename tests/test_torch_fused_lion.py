"""The port's Lion (deepspeed_tpu_torch/ops/fused_optimizers.py: Lion,
lion_plain, fused_lion_step) against the JAX package's Pallas
``fused_lion`` (interpret mode on the CPU) and ``optax.lion``, on the same
numpy inputs, 3 steps with fresh grads each step, at the JAX test's
tolerance (tests/test_pallas_kernels.py:145-160: 1e-6 absolute, 1e-5
relative). JAX's fused Lion returns the delta new_p - p, which the caller
adds back; the port writes new_p, so the two differ by up to an ulp of p.
The port updates flat buffers, so each test concatenates the tree."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepspeed_tpu.ops.pallas.fused_optimizers import fused_lion
from deepspeed_tpu.runtime.optimizers import build_optimizer as jbuild
from deepspeed_tpu_torch.ops.fused_optimizers import (Lion, fused_lion_step,
                                                      lion_plain)
from deepspeed_tpu_torch.runtime.optimizers import build_optimizer

SHAPES = {"one": (1,), "w": (40, 17), "b": (5,), "odd": (70, 33),
          "big": (2 ** 16 + 5,)}


def _tree(shapes, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


def _jax_run(tx, params, grads):
    p = jax.tree.map(jnp.asarray, params)
    state = tx.init(p)
    for g in grads:
        u, state = tx.update(jax.tree.map(jnp.asarray, g), state, p)
        p = optax.apply_updates(p, u)
    return {k: np.asarray(v) for k, v in p.items()}


def _flat(tree, names):
    return torch.cat([torch.from_numpy(tree[k]).reshape(-1) for k in names])


def _port_run(opt, params, grads):
    names = list(params)
    flat = _flat(params, names)
    state = opt.init(flat)
    for g in grads:
        opt.step(state, flat, _flat(g, names))
    assert int(state["count"]) == len(grads)
    out, off = {}, 0
    for k in names:
        n = params[k].size
        out[k] = flat[off:off + n].reshape(params[k].shape).numpy()
        off += n
    return out


def _close(got, ref):
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-6, rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("wd", [0.0, 0.05])
def test_lion_matches_jax_fused_lion_and_optax(wd, fused):
    """Sizes 1 to 2^16+5 (no multiple of 4 or 128 among most), with and
    without weight decay; the plain path (fused=False) is optax.lion's
    arithmetic, the fused switch takes the same plain version on the CPU."""
    params = _tree(SHAPES, 0)
    grads = [_tree(SHAPES, s) for s in (1, 2, 3)]
    got = _port_run(Lion(1e-2, weight_decay=wd, fused=fused), params, grads)
    _close(got, _jax_run(fused_lion(1e-2, weight_decay=wd), params, grads))
    _close(got, _jax_run(optax.lion(1e-2, weight_decay=wd), params, grads))


def _linear(step):
    """optax.linear_schedule(0.0, 1e-2, 5) on tensors."""
    frac = torch.clamp(torch.as_tensor(step, dtype=torch.float32), 0, 5) / 5
    return (0.0 - 1e-2) * (1 - frac) + 1e-2


def test_schedule_betas_and_count_match_jax_fused_lion():
    """lr from the schedule at the pre-increment count (the first step
    uses lr(0) = 0, so it moves only m); non-default betas."""
    params = _tree({"w": (13, 7)}, 0)
    grads = [_tree({"w": (13, 7)}, s) for s in (1, 2, 3)]
    ref = _jax_run(fused_lion(optax.linear_schedule(0.0, 1e-2, 5), b1=0.8,
                              b2=0.95, weight_decay=0.01), params, grads)
    got = _port_run(Lion(_linear, b1=0.8, b2=0.95, weight_decay=0.01),
                    params, grads)
    _close(got, ref)


def test_clip_coefficient_overflow_skip_and_copy():
    """coef scales g before the sign and the moment (the engine's clip);
    apply=0 (an fp16 overflow step) leaves p, m, the count and the copy
    as they were; the copy is p in the compute dtype."""
    params = _tree({"w": (40,)}, 0)
    grads = _tree({"w": (40,)}, 1)
    scaled = {"w": grads["w"] * np.float32(0.25)}
    ref = _jax_run(fused_lion(1e-2, weight_decay=0.1), params, [scaled])
    p = torch.from_numpy(params["w"].copy())
    opt = Lion(1e-2, weight_decay=0.1)
    state = opt.init(p)
    out = torch.zeros(40, dtype=torch.bfloat16)
    opt.step(state, p, torch.from_numpy(grads["w"]), coef=torch.tensor(0.25),
             out=out)
    np.testing.assert_allclose(p.numpy(), ref["w"], atol=1e-6, rtol=1e-5)
    assert torch.equal(out, p.bfloat16())
    np.testing.assert_allclose(state["exp_avg"].numpy(),
                               0.01 * scaled["w"], rtol=1e-6)
    before = [p.clone(), state["exp_avg"].clone(), out.clone()]
    opt.step(state, p, torch.full((40,), float("inf")),
             apply=torch.tensor(0.0), out=out)
    for b, a in zip(before, (p, state["exp_avg"], out)):
        assert torch.equal(b, a)
    assert int(state["count"]) == 1


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("params", [
    {"lr": 1e-3, "weight_decay": 0.01},
    {"lr": 1e-3, "betas": [0.95, 0.98]},
    {"lr": 1e-3, "betas": []}])
def test_build_optimizer_lion_as_the_jax_factory(params, fused):
    """Lion, FusedLion and CPULion build Lion; betas as the JAX factory
    reads them (optimizers.py:66, 84, 104): absent -> (0.9, 0.999), the
    Adam default popped before the Lion branch; empty -> optax's (0.9,
    0.99). Both factories' optimizers then give the same params over 3
    steps."""
    cfg = dict(params, fused_kernel=fused)
    sched = lambda step: torch.tensor(1e-3)  # noqa: E731
    for name in ("Lion", "FusedLion", "CPULion"):
        opt = build_optimizer(name, cfg, sched)
        assert isinstance(opt, Lion) and opt.fused == fused
    betas = params.get("betas", (0.9, 0.999))
    assert (opt.b1, opt.b2) == pytest.approx(tuple(betas) or (0.9, 0.99))
    assert opt.weight_decay == params.get("weight_decay", 0.0)
    tree = _tree({"w": (9, 11)}, 4)
    grads = [_tree({"w": (9, 11)}, s) for s in (5, 6, 7)]
    ref = _jax_run(jbuild("Lion", cfg, optax.constant_schedule(1e-3)),
                   tree, grads)
    _close(_port_run(opt, tree, grads), ref)


def test_cpu_step_is_the_plain_version():
    """On CPU tensors the wrapper takes the plain version: no launch."""
    p = torch.zeros(8)
    hp = torch.tensor([1e-3, 0.9, 0.99, 1.0, 1.0])
    before = fused_lion_step.launches
    fused_lion_step(p, torch.ones(8), torch.zeros(8), hp, weight_decay=0.0)
    assert fused_lion_step.launches == before
    ref = torch.zeros(8)
    lion_plain(ref, torch.ones(8), torch.zeros(8), hp, weight_decay=0.0)
    assert torch.equal(p, ref) and torch.all(p == -1e-3)
