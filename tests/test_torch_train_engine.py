"""The port's training slice (deepspeed_tpu_torch: runtime/config.py,
lr_schedules.py, loss_scaler.py, engine.py with train_batch and the
forward/backward/step triple, models' loss, loss_chunk and remat,
ops.layers.cross_entropy_loss) against the JAX package on the CPU, on the
same numpy inputs and the same initial weights (carried across as numpy
trees). The JAX engine runs on conftest's 8-device virtual mesh; batches
are 16 rows so its data-parallel size divides them. Tolerances are stated
at each comparison."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as ds
from deepspeed_tpu.models import GPT2 as JGPT2, Llama as JLlama
from deepspeed_tpu.ops import layers as JL
from deepspeed_tpu.runtime import loss_scaler as JS
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
from deepspeed_tpu.runtime.lr_schedules import build_schedule as jschedule
from deepspeed_tpu_torch.models import GPT2, Llama
from deepspeed_tpu_torch.models.convert import flatten_tree
from deepspeed_tpu_torch.ops import layers as TL
from deepspeed_tpu_torch.runtime import loss_scaler as TS
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.lr_schedules import build_schedule


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side runs tiny models: one intra-op thread a worker
    keeps it from spinning against the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


FAMILIES = {"gpt2": (JGPT2, GPT2), "llama": (JLlama, Llama)}


def _pair(family, **over):
    """JAX and port models of one tiny config, with the JAX init tree."""
    jcls, tcls = FAMILIES[family]
    jm = jcls(size="tiny", **over)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = tcls(size="tiny", device="cpu", **over)
    return jm, tm, tree


def _batch(rows=16, seq=32, seed=0):
    tok = np.random.default_rng(seed).integers(0, 512, (rows, seq + 1))
    return tok[:, :-1], tok[:, 1:]


# ------------------------------------------------------------- loss pieces
@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
def test_cross_entropy_matches_jax(z_loss):
    """Value and logits-gradient, with ignore_index tokens: 1e-6."""
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 7, 33)) * 3).astype(np.float32)
    targets = rng.integers(0, 33, (2, 7))
    targets[0, :3] = -100
    targets[1, 5] = -100

    def jf(x):
        return JL.cross_entropy_loss(x, jnp.asarray(targets), z_loss=z_loss)

    jv, jg = jax.value_and_grad(jf)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    tv = TL.cross_entropy_loss(x, torch.from_numpy(targets), z_loss=z_loss)
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), atol=1e-6)
    all_ignored = TL.cross_entropy_loss(x, torch.full((2, 7), -100))
    assert float(all_ignored.detach()) == 0.0


@pytest.mark.parametrize("family", list(FAMILIES))
def test_model_loss_and_grads_with_flash_match_jax(family):
    """GPT-2-tiny and the GQA Llama-tiny (4 q heads over 2 kv heads),
    attn_impl="flash", fp32: loss within 1e-5 relative, every gradient
    within 2e-5 of the largest gradient of its tensor (the JAX
    flash-gradient tolerance is 2e-4; measured ~1e-6). The key bias's
    exact gradient is zero (softmax ignores a shift shared by a row's
    scores), so both sides hold rounding noise there: a tensor's scale is
    at least 1e-3 of the largest gradient of the model."""
    jm, tm, tree = _pair(family, attn_impl="flash")
    ds.models.load_jax_params(tm, tree)
    tokens, targets = _batch(rows=2, seq=64)
    jloss, jgrads = jax.value_and_grad(jm.loss)(
        jax.tree.map(jnp.asarray, tree),
        (jnp.asarray(tokens), jnp.asarray(targets)))
    loss = tm.loss((torch.from_numpy(tokens), torch.from_numpy(targets)))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    grads = flatten_tree(jax.tree.map(np.asarray, jgrads))
    top = max(float(np.abs(g).max()) for g in grads.values())
    for name, g in grads.items():
        got = tm.params[name].grad.numpy()
        scale = max(float(np.abs(g).max()), 1e-3 * top)
        assert np.abs(got - g).max() <= 2e-5 * scale, name


@pytest.mark.parametrize("policy", ["nothing_saveable", "segments"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_policies_match_no_remat(family, policy):
    """Rematerialisation changes memory, not math: loss and grads equal
    remat=False's (1e-6; recomputation repeats the same CPU ops)."""
    _, ref_m, tree = _pair(family, attn_impl="flash", remat=False)
    _, m, _ = _pair(family, attn_impl="flash", remat=True,
                    remat_policy=policy)
    tokens, targets = map(torch.from_numpy, _batch(rows=2, seq=40))
    losses = []
    for model in (ref_m, m):
        ds.models.load_jax_params(model, tree)
        losses.append(model.loss((tokens, targets)))
        losses[-1].backward()
    np.testing.assert_allclose(float(losses[1].detach()),
                               float(losses[0].detach()), rtol=1e-6)
    for name, p in m.params.items():
        np.testing.assert_allclose(p.grad.numpy(),
                                   ref_m.params[name].grad.numpy(),
                                   atol=1e-6, err_msg=name)


def test_unported_training_options_raise():
    """Every remat policy the JAX model runs is ported; the names it
    cannot run are refused (tests/test_torch_remat.py holds them to
    JAX), and a policy is read only under remat."""
    GPT2(size="tiny", device="cpu", remat_policy="save_attn_ffn")
    with pytest.raises(TypeError, match="remat_policy"):
        GPT2(size="tiny", device="cpu",
             remat_policy="save_only_these_names")
    with pytest.raises(ValueError, match="remat_policy"):
        GPT2(size="tiny", device="cpu", remat_policy="dots")
    GPT2(size="tiny", device="cpu", remat=False, remat_policy="dots")


def _masked_batch(rows=2, seq=64, seed=3):
    """A batch with ignored targets (-100): a whole row's tail and a few
    scattered positions, so chunks hold different numbers of valid
    targets."""
    tokens, targets = _batch(rows=rows, seq=seq, seed=seed)
    targets = targets.copy()
    targets[0, seq // 2:] = -100
    targets[1, ::7] = -100
    return tokens, targets


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_chunk_matches_jax_chunked_loss(family, remat):
    """GPT-2-tiny and Llama-tiny, S 64, loss_chunk 16, fp32, -100 targets:
    loss and grads of the port's chunked cross-entropy against the JAX
    model's ``_chunked_loss`` on the same weights (loss 1e-5 relative,
    every gradient within 1e-5 of the largest gradient of its tensor,
    floored at 1e-3 of the model's largest, as the flash test above), and
    against the port's own unchunked loss (1e-6: the same function summed
    in another order)."""
    jm, tm, tree = _pair(family, loss_chunk=16, remat=remat)
    _, dense, _ = _pair(family, remat=remat)
    for m in (tm, dense):
        ds.models.load_jax_params(m, tree)
    tokens, targets = _masked_batch()
    jloss, jgrads = jax.value_and_grad(jm.loss)(
        jax.tree.map(jnp.asarray, tree),
        (jnp.asarray(tokens), jnp.asarray(targets)))
    batch = (torch.from_numpy(tokens), torch.from_numpy(targets))
    loss = tm.loss(batch)
    loss.backward()
    ref = dense.loss(batch)
    ref.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(ref.detach()),
                               rtol=1e-6)
    grads = flatten_tree(jax.tree.map(np.asarray, jgrads))
    top = max(float(np.abs(g).max()) for g in grads.values())
    for name, g in grads.items():
        got = tm.params[name].grad.numpy()
        scale = max(float(np.abs(g).max()), 1e-3 * top)
        assert np.abs(got - g).max() <= 1e-5 * scale, name
        np.testing.assert_allclose(got, dense.params[name].grad.numpy(),
                                   atol=1e-6 * scale, err_msg=name)


def test_loss_chunk_edge_cases_as_in_jax():
    """An S that loss_chunk does not divide raises ValueError in both
    packages; loss_chunk above S is one chunk of S; all targets ignored
    gives 0, not NaN."""
    jm, tm, tree = _pair("gpt2", loss_chunk=24)
    ds.models.load_jax_params(tm, tree)
    tokens, targets = _batch(rows=2, seq=40)
    with pytest.raises(ValueError, match="loss_chunk"):
        jm.loss(jax.tree.map(jnp.asarray, tree),
                (jnp.asarray(tokens), jnp.asarray(targets)))
    with pytest.raises(ValueError, match="loss_chunk"):
        tm.loss((torch.from_numpy(tokens), torch.from_numpy(targets)))
    _, big, _ = _pair("gpt2", loss_chunk=128)
    _, dense, _ = _pair("gpt2")
    for m in (big, dense):
        ds.models.load_jax_params(m, tree)
    batch = (torch.from_numpy(tokens), torch.from_numpy(targets))
    np.testing.assert_allclose(float(big.loss(batch).detach()),
                               float(dense.loss(batch).detach()), rtol=1e-6)
    ignored = big.loss((batch[0], torch.full_like(batch[1], -100)))
    assert float(ignored.detach()) == 0.0


def test_alibi_with_flash_is_refused_as_in_jax():
    """The flash kernel has no ALiBi bias: both packages refuse the pair
    with ValueError; ALiBi stays on the exact path."""
    from deepspeed_tpu.models import gpt2 as jax_gpt2
    kw = dict(position_embedding="alibi", attn_impl="flash")
    with pytest.raises(ValueError, match="ALiBi"):
        jax_gpt2.GPT2(jax_gpt2.gpt2_config("tiny", **kw))
    with pytest.raises(ValueError, match="ALiBi"):
        GPT2(size="tiny", device="cpu", **kw)
    GPT2(size="tiny", device="cpu", position_embedding="alibi")


# ---------------------------------------------------------------- schedules
SCHEDULES = [
    (None, {}),
    ("WarmupLR", {"warmup_num_steps": 100, "warmup_type": "log"}),
    ("WarmupLR", {"warmup_min_lr": 1e-5, "warmup_num_steps": 30,
                  "warmup_type": "linear"}),
    ("WarmupDecayLR", {"total_num_steps": 500, "warmup_num_steps": 100}),
    ("WarmupCosineLR", {"total_num_steps": 500, "warmup_num_steps": 100,
                        "warmup_min_ratio": 0.1, "cos_min_ratio": 0.01}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-3,
                  "cycle_first_step_size": 50, "decay_step_size": 10,
                  "decay_lr_rate": 0.1}),
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-4,
                     "lr_range_test_step_size": 20,
                     "lr_range_test_step_rate": 2.0,
                     "lr_range_test_staircase": True}),
]


@pytest.mark.parametrize("name,params", SCHEDULES)
def test_lr_schedules_match_jax(name, params):
    """Both compute in fp32: 1e-6 relative at every step, for host ints
    and for a 0-d step tensor (the engine's device counter)."""
    ours = build_schedule(name, params, 1e-3)
    ref = jschedule(name, params, 1e-3)
    for step in (0, 1, 2, 5, 29, 30, 49, 50, 99, 100, 101, 150, 499, 1000):
        want = float(ref(jnp.asarray(step, jnp.int32)))
        np.testing.assert_allclose(float(ours(step)), want, rtol=1e-6)
        np.testing.assert_allclose(
            float(ours(torch.tensor(step, dtype=torch.int32))), want,
            rtol=1e-6)
    with pytest.raises(ValueError, match="unknown scheduler"):
        build_schedule("Nope", {}, 1e-3)


# ------------------------------------------------------------- loss scaler
@pytest.mark.parametrize("loss_scale", [0.0, 128.0])
def test_loss_scaler_matches_jax(loss_scale):
    cfg = dict(enabled=True, loss_scale=loss_scale, initial_scale_power=8,
               loss_scale_window=3, hysteresis=2, min_loss_scale=2.0)
    jstate = JS.init_loss_scale(jds.runtime.config.FP16Config(**cfg))
    tstate = TS.init_loss_scale(ds.runtime.config.FP16Config(**cfg))
    kw = dict(dynamic=loss_scale == 0, scale_window=3, min_scale=2.0,
              hysteresis=2)
    for overflow in [0, 0, 0, 1, 0, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0]:
        jstate = JS.update_loss_scale(jstate, jnp.asarray(bool(overflow)),
                                      **kw)
        tstate = TS.update_loss_scale(tstate, torch.tensor(bool(overflow)),
                                      **kw)
        assert [float(x) for x in tstate] == [float(x) for x in jstate]
    grads = [torch.ones(3), torch.tensor([1.0, float("inf")])]
    assert not bool(TS.grads_finite(grads))
    assert bool(TS.grads_finite(grads[:1]))


# ------------------------------------------------------------------- config
@pytest.mark.parametrize("tb,mb,ga,dp", [
    (32, 4, None, 2), (32, None, 2, 2), (None, 4, 2, 2), (32, None, None, 4),
    (None, 3, None, 2), (None, None, None, 4), (24, 4, 3, 2),
    (30, 4, 2, 2), (0, None, None, 1), (8, 16, None, 1)])
def test_batch_size_resolution_matches_jax(tb, mb, ga, dp):
    cfg = {k: v for k, v in (("train_batch_size", tb),
                             ("train_micro_batch_size_per_gpu", mb),
                             ("gradient_accumulation_steps", ga))
           if v is not None}
    try:
        want = JConfig(**cfg).resolve_batch_sizes(dp)
    except ValueError:
        with pytest.raises(ValueError):
            DeepSpeedConfig.from_any(cfg).resolve_batch_sizes(dp)
        return
    assert DeepSpeedConfig.from_any(cfg).resolve_batch_sizes(dp) == want


def test_config_accepts_every_jax_block_by_name():
    ours = {f.name for f in dataclasses.fields(DeepSpeedConfig)}
    assert ours == set(JConfig.model_fields)
    cfg = DeepSpeedConfig.from_any({
        "mesh": {"fsdp": -1, "tp": 1}, "telemetry": {"enabled": False},
        "elasticity": {"max_acceptable_batch_size": 2000},
        "moe": {"enabled": False}, "fp16": {"auto_cast": False},
        "activation_checkpointing": {"policy": "segments"},
        "zero_optimization": {"stage": 2, "overlap_comm": True,
                              "offload_optimizer": {"device": "none"}},
        "prescale_gradients": False, "memory_breakdown": False})
    assert cfg.activation_checkpointing.fields_set == {"policy"}
    assert cfg.zero_optimization.stage == 2
    assert cfg.compute_dtype == torch.float32


@pytest.mark.parametrize("over", [
    {"mesh": {"tp": 2}}, {"mesh": {"dp": 2, "sp": 2}},
    {"telemetry": {"enabled": True}},
    {"telemetry": {"span_buffer_size": 16}},
    {"moe": {"router_telemetry": True}},    # moe.enabled is ported
    {"sequence_parallel": {"mode": "ring"}}, {"pipeline": {"stages": 2}},
    {"compression_training": {"weight_quantization": {}}},
    {"hybrid_engine": {"enabled": True}}, {"wall_clock_breakdown": True},
    {"flops_profiler": {"enabled": True}},
    {"autotuning": {"enabled": True}}, {"aio": {"queue_depth": 16}}])
def test_config_refuses_what_is_not_ported(over):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DeepSpeedConfig.from_any(over)


@pytest.mark.parametrize("over", [
    {"train_batchsize": 4}, {"telemetry": {"enabld": True}},
    {"bf16": {"enabled": True, "loss_scale": 1.0}}])
def test_config_refuses_unknown_keys(over):
    with pytest.raises(ValueError, match="unknown"):
        DeepSpeedConfig.from_any(over)


@pytest.mark.parametrize("zero", [
    {"stage": 3, "offload_param": {"device": "cpu"}},
    {"offload_optimizer": {"device": "cpu"}},
    {"offload_optimizer": {"device": "nvme"}},
    {"stage": 3, "offload_param": {"device": "nvme"}}])
def test_initialize_refuses_multi_rank_and_offload_zero(zero):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ds.initialize(model=GPT2(size="tiny", device="cpu"),
                      config={"train_batch_size": 2,
                              "zero_optimization": zero})


# ------------------------------------------------------------------- engine
def _engines(family, cfg, **over):
    jm, tm, tree = _pair(family, **over)
    jeng, *_ = jds.initialize(
        model=jm, model_parameters=jax.tree.map(jnp.asarray, tree),
        config=dict(cfg, mesh={"fsdp": -1}))
    teng, *_ = ds.initialize(model=tm, model_parameters=tree, config=cfg)
    return jeng, teng


def _train_config(**over):
    cfg = {"train_batch_size": 16, "gradient_accumulation_steps": 2,
           "optimizer": {"type": "AdamW",
                         "params": {"lr": 1e-3, "weight_decay": 0.01}},
           "gradient_clipping": 0.5, "steps_per_print": 2,
           "zero_optimization": {"stage": 2}}
    cfg.update(over)
    return cfg


@pytest.mark.parametrize("fused", [False, True])
def test_engine_steps_match_jax_fp32(fused, devices8):
    """GPT-2-tiny with flash attention and segments remat, fp32, GA=2,
    clipping engaged (grad norm > 0.5), a warmup schedule, 3 steps on
    fresh batches. The loss of every step within 1e-5 relative and the
    grad norm within 1e-4 (measured ~1e-7 and ~4e-6: summation order);
    after 3 steps the distance between the two sets of fp32 params within
    5e-5 of the norm of their total change (measured ~7e-6), taken over
    the whole model: Adam's early updates are ~lr*sign(g), so a grad that
    is zero up to rounding (the key bias's) may move an element by up to
    2*lr on either side, which a norm tolerates and a worst-element bound
    would not."""
    cfg = _train_config(
        optimizer={"type": "FusedAdam",
                   "params": {"lr": 1e-3, "weight_decay": 0.01,
                              "fused_kernel": fused}},
        scheduler={"type": "WarmupLR", "params": {"warmup_num_steps": 4}})
    jeng, teng = _engines("gpt2", cfg, attn_impl="flash",
                          remat_policy="segments")
    start = {k: v.detach().clone() for k, v in
             teng.master_state_dict().items()}
    for step in range(3):
        batch = _batch(seed=step)
        jl = float(jeng.train_batch(batch))
        tl = float(teng.train_batch(batch))
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        jn, tn = jeng.get_global_grad_norm(), teng.get_global_grad_norm()
        assert jn > 0.5 and abs(tn - jn) <= 1e-4 * jn
    want = flatten_tree(jax.tree.map(np.asarray, jeng.state["params"]))
    got = teng.master_state_dict()
    moved = np.sqrt(sum(np.sum((want[n] - start[n].numpy()) ** 2)
                        for n in want))
    err = np.sqrt(sum(np.sum((got[n].numpy() - want[n]) ** 2)
                      for n in want))
    assert err <= 5e-5 * moved, (err, moved)
    assert teng.get_lr() == pytest.approx(jeng.get_lr(), rel=1e-6)
    assert int(teng._step) == int(jeng.state["step"]) == 3


def test_engine_bf16_tracks_jax():
    """bf16 compute, fp32 master, fused Adam: params are bf16 views of one
    buffer; the loss falls and stays within 2e-2 relative of the JAX bf16
    engine's (bf16 rounds at other places in the two frameworks)."""
    cfg = _train_config(bf16={"enabled": True}, gradient_accumulation_steps=1,
                        optimizer={"type": "FusedAdam", "params": {
                            "lr": 1e-3, "fused_kernel": True}})
    jeng, teng = _engines("llama", cfg, attn_impl="flash",
                          remat_policy="segments")
    losses = []
    for _ in range(4):
        batch = _batch(seed=11)
        jl = float(jeng.train_batch(batch))
        losses.append(float(teng.train_batch(batch)))
        np.testing.assert_allclose(losses[-1], jl, rtol=2e-2)
    assert losses[-1] < losses[0]
    params = teng.module_state_dict()
    assert all(p.dtype == torch.bfloat16 for p in params.values())
    assert all(p.dtype == torch.float32
               for p in teng.master_state_dict().values())


def test_engine_fp16_loss_scaling_and_overflow():
    """The JAX engine's fp16 contract: the scale grows after good steps;
    an overflow step skips the update (master and step counter unchanged)
    and halves the scale."""
    cfg = _train_config(fp16={"enabled": True, "initial_scale_power": 4,
                              "loss_scale_window": 2, "hysteresis": 1},
                        gradient_accumulation_steps=1, train_batch_size=4)
    eng, opt, loader, sched = ds.initialize(
        model=GPT2(size="tiny", device="cpu", remat=False), config=cfg)
    assert loader is None and sched.get_last_lr() == [pytest.approx(1e-3)]
    assert opt.loss_scale == 16.0
    for _ in range(5):
        eng.train_batch(_batch(rows=4, seq=16))
    grown = opt.loss_scale
    assert grown > 16.0
    with torch.no_grad():
        eng.module.params["final_norm/scale"][0] = float("inf")
    before = eng._master.clone()
    steps = int(eng._step)
    eng.train_batch(_batch(rows=4, seq=16))
    assert bool(eng._last_metrics["overflow"])
    assert int(eng._step) == steps and eng.overflow_steps == 1
    assert torch.equal(eng._master, before)
    assert opt.loss_scale == grown / 2


def test_engine_api_surface():
    """The accessors, and the forward/backward/step triple running: a
    backward without a forward refuses, step() before the boundary does
    nothing, forward(); backward(); step() applies one step."""
    eng, opt, loader, sched = ds.initialize(
        model=GPT2(size="tiny", device="cpu"),
        config={"train_batch_size": 2, "activation_checkpointing": {
            "policy": "none"}})
    assert eng.model_config.remat is False
    assert eng.zero_optimization_stage() == 0 and loader is None
    with pytest.raises(RuntimeError, match="forward"):
        eng.backward()
    before = eng._master.clone()
    eng.step()
    assert eng.global_steps == 0 and torch.equal(eng._master, before)
    loss = eng(_batch(rows=2, seq=8))
    assert loss.shape == () and loss.requires_grad
    eng.backward()
    assert eng.is_gradient_accumulation_boundary()
    eng.step()
    assert eng.global_steps == 1 and int(eng._step) == 1
    assert eng.global_samples == 2 and not torch.equal(eng._master, before)
    with pytest.raises(ValueError, match="rows"):
        eng.train_batch(_batch(rows=4, seq=8))
    loss = eng.eval_batch(_batch(rows=2, seq=8))
    assert loss.shape == () and not loss.requires_grad
    with pytest.raises(TypeError, match="remat_policy"):
        ds.initialize(model=GPT2(size="tiny", device="cpu"), config={
            "train_batch_size": 2, "activation_checkpointing": {
                "policy": "offload_dot_with_no_batch_dims"}})


# ------------------------------------------------ forward/backward/step
def _triple(engine, batch, ga):
    """One step of DeepSpeed's loop: per micro-batch engine(micro),
    engine.backward(loss); then engine.step(). Returns the micro losses."""
    tokens, targets = batch
    mb = tokens.shape[0] // ga
    losses = []
    for i in range(ga):
        micro = (tokens[i * mb:(i + 1) * mb], targets[i * mb:(i + 1) * mb])
        loss = engine(micro)
        engine.backward(loss)
        losses.append(float(loss.detach()))
    assert engine.is_gradient_accumulation_boundary()
    engine.step()
    assert not engine.is_gradient_accumulation_boundary()
    return losses


@pytest.mark.parametrize("opt", ["AdamW", "Lion"])
def test_triple_matches_train_batch(opt):
    """The triple with GA 2 and the port's train_batch from the same
    weights, 2 steps of Lion or AdamW with clipping and loss_chunk: params
    within 2e-5 (tests/test_engine.py:87-106). Both run the same two
    halves, so the numbers come out equal; step counters and the last
    loss agree too."""
    cfg = _train_config(optimizer={"type": opt, "params": {
        "lr": 1e-3, "weight_decay": 0.01, "fused_kernel": True}})
    engines, init = [], None
    for _ in range(2):
        m = Llama(size="tiny", device="cpu", attn_impl="flash",
                  remat_policy="segments", loss_chunk=8)
        eng, *_ = ds.initialize(model=m, config=cfg, model_parameters=init)
        init = init or {n: t.clone() for n, t in
                        eng.master_state_dict().items()}
        engines.append(eng)
    for step in range(2):
        batch = _batch(seed=step)
        want = float(engines[0].train_batch(batch))
        got = _triple(engines[1], batch, ga=2)
        np.testing.assert_allclose(np.mean(got), want, rtol=1e-6)
    a, b = (e.master_state_dict() for e in engines)
    for name in a:
        np.testing.assert_allclose(b[name].numpy(), a[name].numpy(),
                                   atol=2e-5, rtol=2e-5, err_msg=name)
    assert engines[1].global_steps == engines[0].global_steps == 2
    assert engines[1].global_samples == 32 and int(engines[1]._step) == 2


TRIPLE_CASES = {
    # name: (family, config overrides); every case clips (grad norm above
    # the 0.5 threshold) and accumulates 2 micro-batches
    "adamw": ("gpt2", {}),
    "lion": ("llama", {"optimizer": {"type": "Lion", "params": {
        "lr": 1e-3, "betas": [0.9, 0.99], "weight_decay": 0.01,
        "fused_kernel": True}}}),
    "fp16_loss_scale": ("gpt2", {"fp16": {
        "enabled": True, "initial_scale_power": 8, "loss_scale_window": 2,
        "hysteresis": 1}}),
}


@pytest.mark.parametrize("case", list(TRIPLE_CASES))
def test_triple_matches_jax_triple(case, devices8):
    """engine(micro); engine.backward(loss); engine.step() with GA 2 on
    the port and on the JAX engine from the same weights, 3 steps on fresh
    batches, flash attention and segments remat. fp32: every micro loss
    within 1e-5 relative, the grad norm within 1e-4, the master params
    after 3 steps within 1e-4 of the norm of their total change: at a
    constant lr of 1e-3 Adam's first steps move a few elements whose grads
    are near zero by ~lr on either side of rounding noise, so the JAX
    triple itself lands 4.8e-5 from the JAX engine's train_batch and 5.8e-5
    from the port (measured; the port's triple equals its own train_batch
    exactly, test_triple_matches_train_batch). Lion runs on the
    Llama family: Lion's update is lr * sign(m), and GPT-2's key bias has
    a gradient that is zero up to rounding, whose sign is noise in both
    packages. fp16 (loss scaling from 2^8, growing every 2 steps): the
    loss scale equal after every step; losses within 2e-2 relative and
    params within 5e-2 of their change (fp16 rounds at other places in the
    two frameworks, as bf16 in test_engine_bf16_tracks_jax)."""
    family, over = TRIPLE_CASES[case]
    cfg = _train_config(**over)
    jeng, teng = _engines(family, cfg, attn_impl="flash",
                          remat_policy="segments")
    fp16 = case.startswith("fp16")
    start = {k: v.detach().clone() for k, v in
             teng.master_state_dict().items()}
    for step in range(3):
        batch = _batch(seed=10 + step)
        tl = _triple(teng, batch, ga=2)
        jl = []
        for i in range(2):
            micro = (batch[0][i * 8:(i + 1) * 8], batch[1][i * 8:(i + 1) * 8])
            loss = jeng.forward(micro)
            jeng.backward(loss)
            jl.append(float(loss))
        jeng.step()
        np.testing.assert_allclose(tl, jl, rtol=2e-2 if fp16 else 1e-5)
        jn, tn = jeng.get_global_grad_norm(), teng.get_global_grad_norm()
        assert jn > 0.5
        assert abs(tn - jn) <= (2e-2 if fp16 else 1e-4) * jn
        if fp16:
            assert teng.optimizer.loss_scale == float(
                jeng.state["loss_scale"].scale)
    want = flatten_tree(jax.tree.map(
        np.asarray, jeng.state["master" if fp16 else "params"]))
    got = teng.master_state_dict()
    moved = np.sqrt(sum(np.sum((want[n] - start[n].numpy()) ** 2)
                        for n in want))
    err = np.sqrt(sum(np.sum((got[n].numpy() - want[n]) ** 2)
                      for n in want))
    assert err <= (5e-2 if fp16 else 1e-4) * moved, (err, moved)
    assert teng.global_steps == jeng.global_steps == 3
    assert int(teng._step) == int(jeng.state["step"])


def test_step_waits_for_the_boundary_and_forward_keeps_no_stale_graph():
    """With GA 2: step() after one backward does nothing; a forward
    without a backward, then a new forward, leaves the engine holding only
    the new loss (the old graph is freed with the caller's reference);
    backward(None) takes the last forward's loss."""
    import gc
    import weakref
    eng, *_ = ds.initialize(
        model=GPT2(size="tiny", device="cpu", attn_impl="flash",
                   remat_policy="segments", loss_chunk=8),
        config=_train_config(train_batch_size=4))
    tokens, targets = _batch(rows=4, seq=16)
    first = (tokens[:2], targets[:2])
    before = eng._master.clone()
    eng.backward(eng(first))
    eng.step()
    assert not eng.is_gradient_accumulation_boundary()
    assert eng.global_steps == 0 and torch.equal(eng._master, before)
    stale = weakref.ref(eng(first))      # a forward, no backward
    eng(first)
    gc.collect()
    assert stale() is None               # the old loss and its graph freed
    eng.backward()
    assert eng._last_loss is None and eng.is_gradient_accumulation_boundary()
    eng.step()
    assert eng.global_steps == 1 and eng._micro_count == 0


def test_no_sync_asserts_as_in_jax():
    """At ZeRO stage 1 no_sync allows forward/backward inside it and
    refuses step() inside it and reentry; at stage 2 it refuses, as the
    JAX engine does (engine.py:1527-1532)."""
    eng, *_ = ds.initialize(
        model=GPT2(size="tiny", device="cpu", remat=False),
        config=_train_config(train_batch_size=4,
                             zero_optimization={"stage": 1}))
    tokens, targets = _batch(rows=4, seq=8)
    with eng.no_sync():
        eng.backward(eng((tokens[:2], targets[:2])))
        with pytest.raises(AssertionError, match="step"):
            eng.step()
        with pytest.raises(AssertionError, match="reentry"):
            eng.no_sync()
    eng.backward(eng((tokens[2:], targets[2:])))
    eng.step()
    assert eng.global_steps == 1
    eng2, *_ = ds.initialize(
        model=GPT2(size="tiny", device="cpu", remat=False),
        config=_train_config(train_batch_size=4))
    with pytest.raises(AssertionError, match="ZeRO stage 2"):
        eng2.no_sync()
