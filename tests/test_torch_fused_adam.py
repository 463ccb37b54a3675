"""The port's Adam (deepspeed_tpu_torch/ops/fused_optimizers.py) against the
JAX package's Pallas ``fused_adam`` (interpret mode on the CPU) and optax,
on the same numpy inputs, 3 steps, at the JAX test's tolerance
(tests/test_pallas_kernels.py:82-142: 1e-6 absolute, 1e-5 relative). The
port updates flat buffers, so each test concatenates the parameter tree."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepspeed_tpu.ops.pallas.fused_optimizers import fused_adam
from deepspeed_tpu_torch.ops.fused_optimizers import Adam, fused_adam_step
from deepspeed_tpu_torch.runtime.optimizers import build_optimizer


def _tree(shapes, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


def _jax_run(tx, params, grads, steps=3):
    p = jax.tree.map(jnp.asarray, params)
    g = jax.tree.map(jnp.asarray, grads)
    state = tx.init(p)
    for _ in range(steps):
        u, state = tx.update(g, state, p)
        p = optax.apply_updates(p, u)
    return {k: np.asarray(v) for k, v in p.items()}


def _port_run(opt, params, grads, steps=3):
    names = list(params)
    flat = torch.cat([torch.from_numpy(params[k]).reshape(-1) for k in names])
    g = torch.cat([torch.from_numpy(grads[k]).reshape(-1) for k in names])
    state = opt.init(flat)
    for _ in range(steps):
        opt.step(state, flat, g)
    assert int(state["count"]) == steps
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


def _linear(step):
    """optax.linear_schedule(0.0, 1e-2, 5) on tensors."""
    frac = torch.clamp(torch.as_tensor(step, dtype=torch.float32), 0, 5) / 5
    return (0.0 - 1e-2) * (1 - frac) + 1e-2


def test_schedule_matches_jax_fused_adam():
    """lr from the schedule at the pre-increment count (first step lr(0))."""
    params = _tree({"w": (13, 7)}, 0)
    grads = _tree({"w": (13, 7)}, 1)
    ref = _jax_run(fused_adam(optax.linear_schedule(0.0, 1e-2, 5),
                              weight_decay=0.01), params, grads)
    _close(_port_run(Adam(_linear, weight_decay=0.01), params, grads), ref)


def test_l2_mode_matches_jax_fused_adam_and_optax():
    params = _tree({"w": (11, 9)}, 0)
    grads = _tree({"w": (11, 9)}, 1)
    got = _port_run(Adam(1e-2, weight_decay=0.05, adamw_mode=False), params,
                    grads)
    _close(got, _jax_run(fused_adam(1e-2, weight_decay=0.05,
                                    adamw_mode=False), params, grads))
    _close(got, _jax_run(optax.chain(optax.add_decayed_weights(0.05),
                                     optax.adam(1e-2)), params, grads))


@pytest.mark.parametrize("fused", [True, False])
def test_odd_sizes_match_jax_fused_adam_and_optax_adamw(fused):
    """Sizes that are no multiple of 4 or 128, a zero tensor with unit
    grads; the plain (non-fused) path is optax.adamw's arithmetic."""
    params = _tree({"w": (70, 33)}, 0)
    params["b"] = np.zeros(5, np.float32)
    grads = _tree({"w": (70, 33)}, 1)
    grads["b"] = np.ones(5, np.float32)
    got = _port_run(Adam(1e-2, weight_decay=0.01, fused=fused), params,
                    grads)
    _close(got, _jax_run(fused_adam(1e-2, weight_decay=0.01), params, grads))
    _close(got, _jax_run(optax.adamw(1e-2, weight_decay=0.01), params, grads))


def test_clip_coefficient_and_overflow_skip():
    """coef scales g before the moments (the engine's clip); apply=0 (an
    fp16 overflow step) leaves everything as it was."""
    params = _tree({"w": (40,)}, 0)
    grads = _tree({"w": (40,)}, 1)
    scaled = {"w": grads["w"] * np.float32(0.25)}
    ref = _jax_run(fused_adam(1e-2), params, scaled, steps=1)
    p = torch.from_numpy(params["w"].copy())
    opt = Adam(1e-2)
    state = opt.init(p)
    opt.step(state, p, torch.from_numpy(grads["w"]),
             coef=torch.tensor(0.25))
    np.testing.assert_allclose(p.numpy(), ref["w"], atol=1e-6, rtol=1e-5)
    before = [p.clone(), state["exp_avg"].clone()]
    out = torch.zeros(40, dtype=torch.bfloat16)
    opt.step(state, p, torch.full((40,), float("inf")),
             apply=torch.tensor(0.0), out=out)
    assert torch.equal(before[0], p) and torch.equal(before[1],
                                                     state["exp_avg"])
    assert int(state["count"]) == 1
    assert torch.equal(out, p.bfloat16())


def test_build_optimizer_names_and_the_fused_switch():
    sched = lambda step: torch.tensor(1e-3)  # noqa: E731
    fused = build_optimizer("FusedAdam", {"lr": 1e-4, "weight_decay": 0.01,
                                          "fused_kernel": True}, sched)
    assert fused.fused and fused.adamw_mode and fused.weight_decay == 0.01
    plain = build_optimizer("Adam", {"adam_w_mode": False,
                                     "betas": (0.8, 0.9)}, sched)
    assert not plain.fused and not plain.adamw_mode
    assert (plain.b1, plain.b2) == (0.8, 0.9)
    assert build_optimizer("adamw", {"adam_w_mode": False}, sched).adamw_mode
    for name in ("FusedLamb", "SGD", "Adagrad", "Adafactor", "OneBitAdam"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_optimizer(name, {}, sched)
    with pytest.raises(ValueError, match="unknown optimizer"):
        build_optimizer("Nadam", {}, sched)


def test_cpu_step_is_the_plain_version():
    """On CPU tensors the wrapper takes the plain version: no launch."""
    p = torch.zeros(8)
    hp = torch.tensor([1e-3, 0.9, 0.999, 1e-8, 10.0, 1000.0, 1.0, 1.0])
    before = fused_adam_step.launches
    fused_adam_step(p, torch.ones(8), torch.zeros(8), torch.zeros(8), hp,
                    weight_decay=0.0, adamw_mode=True)
    assert fused_adam_step.launches == before
    assert torch.all(p < 0)
