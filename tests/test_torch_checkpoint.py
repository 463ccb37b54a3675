"""The port's checkpoints (deepspeed_tpu_torch: runtime/checkpoint_engine.py,
runtime/checkpointing.py, checkpoint/universal.py, zero_to_fp32.py,
ds_to_universal.py, utils/tensor_fragment.py, and the inference engines'
checkpoint loader) on the CPU, at tiny sizes as the JAX package's
tests/test_checkpoint.py and test_engine.py::test_checkpoint_roundtrip.

Within the port everything is held bit for bit: a resumed run against the
run that did not stop, JAX's subsets of a load, the async engine's deferred
``latest``, the fp16 loss scale and skipped steps, Lion's single moment and
an MoE model's expert stacks through every format.

Against the JAX package the weights are carried over (``model_parameters``
from one JAX init tree), and the two packages meet only through the
interchange formats, the universal directory and the ``.npz`` files, never
through the native files: JAX -> universal -> port and port -> universal ->
JAX each continue within the bounds of
``tests/test_torch_train_engine.py::test_engine_steps_match_jax_fp32``
(losses 1e-5 relative; the parameters' distance within 5e-5 of the norm of
their total change), the ``.npz`` exports have JAX's names and dtypes, and
both serving engines serve a port checkpoint directory token for token as
JAX's engines serve JAX's ``zero_to_fp32`` output."""

import json
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as ds
from deepspeed_tpu.checkpoint import (
    convert_zero_checkpoint_to_fp32_state_dict as j_to_fp32,
    ds_to_universal as j_to_universal, flatten_with_names as j_names)
from deepspeed_tpu.inference.v2 import (
    InferenceEngineV2 as JEngineV2,
    RaggedInferenceEngineConfig as JConfigV2)
from deepspeed_tpu.models import GPT2 as JGPT2
from deepspeed_tpu.models.qwen import Qwen2MoE as JQwen2MoE
from deepspeed_tpu.utils import tensor_fragment as jtf
from deepspeed_tpu_torch.checkpoint import (
    convert_zero_checkpoint_to_fp32_state_dict, ds_to_universal,
    flatten_with_names, get_fp32_state_dict_from_zero_checkpoint)
from deepspeed_tpu_torch.inference.v2 import build_engine
from deepspeed_tpu_torch.models import GPT2
from deepspeed_tpu_torch.models.convert import flatten_tree
from deepspeed_tpu_torch.models.qwen import Qwen2MoE
from deepspeed_tpu_torch.runtime import checkpoint_engine as CE
from deepspeed_tpu_torch.utils import tensor_fragment as tf

ROWS, SEQ = 16, 16
ENGINE_KW = dict(dtype="float32", kv_block_size=8, num_kv_blocks=128,
                 max_chunk_size=16)


def _batch(seed, rows=ROWS, seq=SEQ, vocab=512):
    tok = np.random.default_rng(seed).integers(0, vocab, (rows, seq + 1))
    return tok[:, :-1], tok[:, 1:]


def _config(**over):
    cfg = {"train_batch_size": ROWS, "gradient_accumulation_steps": 2,
           "optimizer": {"type": "AdamW",
                         "params": {"lr": 1e-3, "weight_decay": 0.01}},
           "gradient_clipping": 0.5, "steps_per_print": 100,
           "zero_optimization": {"stage": 2},
           "scheduler": {"type": "WarmupLR",
                         "params": {"warmup_num_steps": 4}}}
    cfg.update(over)
    return cfg


def _engine(cfg, seed=1234, model=GPT2, **model_kw):
    m = model(size="tiny", device="cpu", **model_kw)
    eng, *_ = ds.initialize(model=m, config=dict(cfg, seed=seed))
    return eng


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _state(eng) -> dict:
    """Everything a resume must restore, by name."""
    out = {"master/" + k: v.clone() for k, v in
           eng.master_state_dict().items()}
    out.update({"params/" + k: v.clone() for k, v in
                eng.module_state_dict().items()})
    out.update({"opt/" + k: v.clone() for k, v in eng.opt_state.items()})
    out["step"] = eng._step.clone()
    out.update({f"scale/{i}": t.clone()
                for i, t in enumerate(eng._loss_scale)})
    return out


# ------------------------------------------------------------- within port
RESUME_CASES = {
    "bf16_fused_adam_zero2": dict(bf16={"enabled": True}, optimizer={
        "type": "FusedAdam", "params": {"lr": 1e-3, "fused_kernel": True}}),
    "fp32_adamw_zero0_async": dict(zero_optimization={"stage": 0},
                                   checkpoint={"async_save": True}),
}


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_resume_is_bit_equal_to_the_run_that_did_not_stop(case, tmp_path):
    """JAX's round trip (tests/test_engine.py:223-240) held bit for bit:
    client state, global_steps, params, master, moments, step, loss scale,
    and the next losses of an engine built from another seed."""
    cfg = _config(**RESUME_CASES[case])
    a = _engine(cfg)
    for i in range(2):
        a.train_batch(_batch(i))
    a.save_checkpoint(str(tmp_path), client_state={"note": "hi"})
    a.checkpoint_engine.commit("global_step2")
    saved = _state(a)
    ref = [float(a.train_batch(_batch(i))) for i in (2, 3)]
    b = _engine(cfg, seed=99)
    path, client = b.load_checkpoint(str(tmp_path))
    assert path == str(tmp_path / "global_step2")
    assert client == {"note": "hi"}
    assert b.global_steps == 2 and b.global_samples == 2 * ROWS
    assert _equal(_state(b), saved)
    assert [float(b.train_batch(_batch(i))) for i in (2, 3)] == ref
    assert _equal(_state(b), _state(a))
    meta = json.loads((tmp_path / "global_step2" / "ds_meta.json")
                      .read_text())
    assert sorted(meta) == ["client_state", "dtype", "global_samples",
                            "global_steps", "skipped_steps", "zero_stage"]
    files = sorted(os.listdir(tmp_path / "global_step2" / "state"))
    assert files == ["index.json", "rank0.safetensors"]


def test_load_subsets_are_jax_subsets(tmp_path):
    """``load_module_only`` restores the params alone, and
    ``load_optimizer_states=False`` params, master, step and loss scale
    (JAX checkpointing.py:173-179); the counters come from ds_meta in
    both."""
    cfg = _config(bf16={"enabled": True})
    a = _engine(cfg)
    a.train_batch(_batch(0))
    a.save_checkpoint(str(tmp_path))
    saved = _state(a)
    for kw, restored in (
            (dict(load_module_only=True), ("params/",)),
            (dict(load_optimizer_states=False),
             ("params/", "master/", "step", "scale/"))):
        b = _engine(cfg, seed=7)
        fresh = _state(b)
        b.load_checkpoint(str(tmp_path), **kw)
        got = _state(b)
        for k in got:
            want = saved if k.startswith(restored) else fresh
            assert torch.equal(got[k], want[k]), (kw, k)
        assert b.global_steps == 1


def test_missing_latest_returns_none(tmp_path):
    eng = _engine(_config())
    assert eng.load_checkpoint(str(tmp_path)) == (None, {})


def test_async_engine_defers_latest(tmp_path, monkeypatch):
    """``latest`` names a tag only after ``commit`` (or the next save)
    waited for its write; a failed background write raises at commit and
    leaves ``latest`` where it was."""
    eng = _engine(_config(checkpoint={"async_save": True}))
    ce_latest = tmp_path / "latest"
    eng.train_batch(_batch(0))
    eng.save_checkpoint(str(tmp_path))
    assert isinstance(eng.checkpoint_engine, CE.AsyncCheckpointEngine)
    assert not ce_latest.exists()
    eng.checkpoint_engine.commit("global_step1")
    assert ce_latest.read_text() == "global_step1"
    eng.train_batch(_batch(1))
    eng.save_checkpoint(str(tmp_path))
    assert ce_latest.read_text() == "global_step1"
    eng.train_batch(_batch(2))
    eng.save_checkpoint(str(tmp_path))        # flushes global_step2
    assert ce_latest.read_text() == "global_step2"
    eng.checkpoint_engine.commit("global_step3")
    assert ce_latest.read_text() == "global_step3"

    def fail(*a):
        raise OSError("disk full")

    monkeypatch.setattr(CE, "_write", fail)
    eng.train_batch(_batch(3))
    eng.save_checkpoint(str(tmp_path))
    with pytest.raises(RuntimeError, match="background"):
        eng.checkpoint_engine.commit("global_step4")
    assert ce_latest.read_text() == "global_step3"


def test_fp16_loss_scale_and_skipped_steps(tmp_path):
    """A plain load restores the dynamic loss scale and the skipped steps;
    a universal load restores the skipped steps from ds_meta and leaves
    the loss scale at the engine's initial one (JAX
    load_universal_checkpoint restores no loss scale)."""
    cfg = _config(fp16={"enabled": True, "initial_scale_power": 4,
                        "loss_scale_window": 2, "hysteresis": 1},
                  gradient_accumulation_steps=1)
    a = _engine(cfg, remat=False)
    for i in range(4):                        # the scale grows to 64
        a.train_batch(_batch(i))
    with torch.no_grad():
        a.module.params["final_norm/scale"][0] = float("inf")
    a.backward(a(_batch(4)))
    a.step()
    assert a.skipped_steps == 1 and a.overflow_steps == 1
    a.save_checkpoint(str(tmp_path))
    b = _engine(cfg, seed=5, remat=False)
    b.load_checkpoint(str(tmp_path))
    assert b.skipped_steps == 1 and b.global_steps == 5
    assert all(torch.equal(x, y) for x, y in zip(a._loss_scale,
                                                 b._loss_scale))
    assert float(a._loss_scale.scale) == 32.0
    ds_to_universal(str(tmp_path), str(tmp_path / "uni"))
    c = _engine(dict(cfg, checkpoint={"load_universal": True}), seed=5,
                remat=False)
    c.load_checkpoint(str(tmp_path / "uni"), tag=".")
    assert c.skipped_steps == 1 and int(c._step) == int(a._step) == 4
    assert float(c._loss_scale.scale) == 16.0
    assert torch.equal(c._master, a._master)


def test_lion_single_moment_through_universal(tmp_path):
    """Lion's one moment is exp_avg, bit for bit through universal; the
    step counter resumes at the checkpoint's step."""
    cfg = _config(optimizer={"type": "Lion", "params": {
        "lr": 1e-4, "betas": [0.9, 0.99], "weight_decay": 0.01,
        "fused_kernel": True}}, bf16={"enabled": True})
    a = _engine(cfg)
    for i in range(2):
        a.train_batch(_batch(i))
    a.save_checkpoint(str(tmp_path / "ckpt"))
    ds_to_universal(str(tmp_path / "ckpt"), str(tmp_path / "uni"))
    meta = json.loads((tmp_path / "uni" / "ds_universal_meta.json")
                      .read_text())
    assert set(meta["n_moments"].values()) == {1} and meta["step"] == 2
    assert sorted(os.listdir(tmp_path / "uni" / "zero" / "layers" / "wq")) \
        == ["exp_avg.npy", "fp32.npy"]
    b = _engine(dict(cfg, checkpoint={"load_universal": True}), seed=3)
    b.load_checkpoint(str(tmp_path / "uni"), tag=".")
    assert _equal(_state(b), _state(a))
    assert float(b.train_batch(_batch(2))) == float(a.train_batch(_batch(2)))


def test_moe_names_survive_every_format(tmp_path):
    """Qwen2-MoE tiny (expert stacks, router, shared expert): the plain
    load, universal, zero_to_fp32 and save_16bit_model all carry JAX's
    names of the model's tree."""
    cfg = _config(bf16={"enabled": True}, gradient_accumulation_steps=1)
    a = _engine(cfg, model=Qwen2MoE)
    a.train_batch(_batch(0, vocab=a.model_config.vocab_size))
    a.save_checkpoint(str(tmp_path / "ckpt"))
    want = [n for n, _ in j_names(jax.eval_shape(
        JQwen2MoE(size="tiny").init, jax.random.PRNGKey(0)))]
    assert "layers/experts/w_gate" in want
    assert [n for n, _ in flatten_with_names(a.module_state_dict())] == want
    b = _engine(cfg, seed=4, model=Qwen2MoE)
    b.load_checkpoint(str(tmp_path / "ckpt"))
    assert _equal(_state(b), _state(a))
    ds_to_universal(str(tmp_path / "ckpt"), str(tmp_path / "uni"))
    meta = json.loads((tmp_path / "uni" / "ds_universal_meta.json")
                      .read_text())
    assert meta["param_names"] == want
    assert list(get_fp32_state_dict_from_zero_checkpoint(
        str(tmp_path / "ckpt"))) == want
    a.save_16bit_model(str(tmp_path))
    with np.load(tmp_path / "model_weights.npz") as z:
        assert sorted(z.files) == sorted(want)
    c = _engine(dict(cfg, checkpoint={"load_universal": True}), seed=4,
                model=Qwen2MoE)
    c.load_checkpoint(str(tmp_path / "uni"), tag=".")
    assert _equal(c.master_state_dict(), a.master_state_dict())


def test_memory_tier_checkpoints_are_refused(tmp_path):
    """The JAX memory tiers' files name Slice E: a tag directory holding
    host_opt_rank*.npz (every reader), a streamed-engine .npz given to
    ds_to_universal."""
    eng = _engine(_config())
    eng.save_checkpoint(str(tmp_path))
    np.savez(tmp_path / "global_step0" / "host_opt_rank0.npz",
             x=np.zeros(1))
    for call in (lambda: eng.load_checkpoint(str(tmp_path)),
                 lambda: get_fp32_state_dict_from_zero_checkpoint(
                     str(tmp_path)),
                 lambda: ds.init_inference(
                     GPT2(size="tiny", device="cpu"),
                     config={"dtype": "float32",
                             "checkpoint": str(tmp_path)})):
        with pytest.raises(NotImplementedError, match="Slice E"):
            call()
    np.savez(tmp_path / "global_step0" / "streamed_state.npz",
             x=np.zeros(1))
    with pytest.raises(NotImplementedError, match="Slice E"):
        ds_to_universal(str(tmp_path), str(tmp_path / "uni"))


def _cli(module, argv, monkeypatch):
    """``python -m deepspeed_tpu_torch.checkpoint.<module> argv``, run in
    this process: as ``__main__`` through runpy where the module is not
    imported yet (so the package's function ``ds_to_universal`` stays what
    the name binds), else through its ``main``."""
    name = f"deepspeed_tpu_torch.checkpoint.{module}"
    if name in sys.modules:
        sys.modules[name].main(argv)
        return
    monkeypatch.setattr(sys, "argv", [module] + argv)
    runpy.run_module(name, run_name="__main__")


def test_clis_and_tensor_fragment_setters(tmp_path, monkeypatch):
    """Both CLIs on a checkpoint (no card, no process group), and the
    tensor_fragment setters read back through the getters and a
    checkpoint."""
    eng = _engine(_config(bf16={"enabled": True}))
    eng.train_batch(_batch(0))
    w = np.arange(np.prod(eng.plan.shapes["layers/wq"]), dtype=np.float32)
    w = w.reshape(eng.plan.shapes["layers/wq"]) / w.size
    assert tf.safe_set_full_fp32_param(eng, "wq", w)
    assert tf.safe_set_full_optimizer_state(eng, "layers/wq", "nu", w * 2)
    assert not tf.safe_set_full_fp32_param(eng, "nonexistent", w)
    assert np.array_equal(tf.safe_get_full_fp32_param(eng, "layers/wq"), w)
    assert np.array_equal(tf.safe_get_full_optimizer_state(
        eng, "wq", "exp_avg_sq"), w * 2)
    assert torch.equal(eng.module.params["layers/wq"].detach(),
                       torch.from_numpy(w).bfloat16())
    assert tf.safe_get_full_grad(eng, "wq") is None
    tokens, targets = _batch(1)
    eng.backward(eng((tokens[:8], targets[:8])))
    assert tf.safe_get_full_grad(eng, "wq").shape == w.shape
    eng.save_checkpoint(str(tmp_path / "ckpt"))
    _cli("zero_to_fp32", [str(tmp_path / "ckpt"), str(tmp_path / "fp32.npz")],
         monkeypatch)
    with np.load(tmp_path / "fp32.npz") as z:
        assert np.array_equal(z["layers/wq"], w)
    _cli("ds_to_universal", ["--input_folder", str(tmp_path / "ckpt"),
                             "--output_folder", str(tmp_path / "uni")],
         monkeypatch)
    assert np.array_equal(np.load(tmp_path / "uni" / "zero" / "layers" /
                                  "wq" / "exp_avg_sq.npy"), w * 2)


# ------------------------------------------------------------- against JAX
@pytest.fixture(scope="module")
def mirrored(tmp_path_factory):
    """A JAX engine and a port engine, fp32, from one JAX init tree, two
    steps each on the same batches; each package's checkpoint of that
    state and its exports, written before anything continues."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    d = tmp_path_factory.mktemp("ckpt_jax")
    jm = JGPT2(size="tiny")
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    cfg = _config()
    jeng, *_ = jds.initialize(
        model=jm, model_parameters=jax.tree.map(jnp.asarray, tree),
        config=dict(cfg, mesh={"fsdp": -1}))
    teng, *_ = ds.initialize(model=GPT2(size="tiny", device="cpu"),
                             model_parameters=tree, config=cfg)
    losses = [(float(jeng.train_batch(_batch(i))),
               float(teng.train_batch(_batch(i)))) for i in range(2)]
    jeng.save_checkpoint(str(d / "jax"))
    j_to_universal(str(d / "jax"), str(d / "jax_uni"))
    j_to_fp32(str(d / "jax"), str(d / "jax_fp32.npz"))
    jeng.save_16bit_model(str(d), "jax16.npz")
    teng.save_checkpoint(str(d / "port"))
    ds_to_universal(str(d / "port"), str(d / "port_uni"))
    convert_zero_checkpoint_to_fp32_state_dict(str(d / "port"),
                                               str(d / "port_fp32.npz"))
    teng.save_16bit_model(str(d), "port16.npz")
    getters = {}
    for name in ("layers/wq", "embed/tokens", "final_norm/scale"):
        getters[name] = [
            (mod.safe_get_full_fp32_param(e, name),
             mod.safe_get_full_optimizer_state(e, name, "exp_avg"),
             mod.safe_get_full_optimizer_state(e, name, "exp_avg_sq"))
            for mod, e in ((jtf, jeng), (tf, teng))]
    return dict(dir=d, tree=tree, cfg=cfg, jeng=jeng, teng=teng, jm=jm,
                losses=losses, getters=getters)


def _distance(got: dict, want: dict) -> float:
    return float(np.sqrt(sum(np.sum((np.asarray(got[n], np.float64)
                                     - np.asarray(want[n], np.float64)) ** 2)
                             for n in want)))


def test_mirrored_run_and_npz_exports_match_jax(mirrored):
    """The two steps agree (1e-5); ``zero_to_fp32`` and
    ``save_16bit_model`` have JAX's key sets and dtypes, their values
    within 5e-5 of the parameters' total change (measured 9e-6); the
    universal directories hold the same param names and moments."""
    for jl, tl in mirrored["losses"]:
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
    d, start = mirrored["dir"], flatten_tree(mirrored["tree"])
    for jname, tname in (("jax_fp32.npz", "port_fp32.npz"),
                         ("jax16.npz", "port16.npz")):
        with np.load(d / jname) as j, np.load(d / tname) as t:
            assert sorted(t.files) == sorted(j.files)
            assert all(t[n].dtype == j[n].dtype for n in j.files)
            jd, td = dict(j), dict(t)
        assert _distance(td, jd) <= 5e-5 * _distance(jd, start)
    jmeta, tmeta = (json.loads((d / u / "ds_universal_meta.json").read_text())
                    for u in ("jax_uni", "port_uni"))
    assert tmeta["param_names"] == jmeta["param_names"]
    assert tmeta["n_moments"] == jmeta["n_moments"]
    assert tmeta["step"] == jmeta["step"] == 2
    assert tmeta["ds_meta"]["global_steps"] == 2


def test_tensor_fragment_getters_match_jax(mirrored):
    """fp32 param, exp_avg and exp_avg_sq by name on the mirrored state:
    each within 5e-5 of its norm (measured: 1e-7 for the params, 5e-6 for
    the moments)."""
    for name, (jv, tv) in mirrored["getters"].items():
        for j, t in zip(jv, tv):
            assert t.shape == j.shape and t.dtype == np.float32
            err = np.linalg.norm(t - j)
            assert err <= 5e-5 * np.linalg.norm(j), (name, err)


def test_serving_from_checkpoint_matches_jax(mirrored):
    """v1 (``init_inference`` with ``checkpoint`` set to the directory)
    and v2 (``build_engine`` with it in the engine config) serve the port
    checkpoint: greedy tokens equal to the same engines built from the
    engine's parameters, and to JAX's v1 and v2 engines served from JAX's
    zero_to_fp32 .npz of the mirrored run."""
    d, teng = mirrored["dir"], mirrored["teng"]
    npz = str(d / "jax_fp32.npz")
    prompts = np.random.default_rng(3).integers(0, 512, (2, 7))
    v1 = ds.init_inference(GPT2(size="tiny", device="cpu"), config={
        "dtype": "float32", "checkpoint": str(d / "port")})
    v1_direct = ds.init_inference(GPT2(size="tiny", device="cpu"),
                                  config={"dtype": "float32"},
                                  params=teng.gathered_params())
    jv1 = jds.init_inference(mirrored["jm"], dtype="float32",
                             checkpoint=npz)
    got = v1.generate(prompts, max_new_tokens=6).numpy()
    assert np.array_equal(got, v1_direct.generate(
        prompts, max_new_tokens=6).numpy())
    assert np.array_equal(got, np.asarray(jv1.generate(
        jnp.asarray(prompts), max_new_tokens=6)))
    plist = [list(map(int, p)) for p in prompts] + [list(range(40, 60))]
    v2 = build_engine("gpt2", "tiny",
                      dict(ENGINE_KW, checkpoint=str(d / "port" /
                                                     "global_step2")),
                      device="cpu")
    v2_direct = build_engine("gpt2", "tiny", ENGINE_KW,
                             params=teng.gathered_params(), device="cpu")
    jv2 = JEngineV2(JGPT2(size="tiny"), JConfigV2(**ENGINE_KW,
                                                   checkpoint=npz))
    toks = v2.generate(plist, max_new_tokens=6)
    assert toks == v2_direct.generate(plist, max_new_tokens=6)
    assert toks == jv2.generate(plist, max_new_tokens=6)


def test_universal_both_ways_continues_within_bounds(mirrored):
    """JAX -> its ds_to_universal -> the port's load_universal_checkpoint
    into a fresh engine, and port -> universal -> JAX's loader into a
    fresh JAX engine; each pair continues two steps (losses 1e-5, the
    parameters' distance within 5e-5 of their total change)."""
    d, cfg, tree = mirrored["dir"], mirrored["cfg"], mirrored["tree"]
    jeng, teng = mirrored["jeng"], mirrored["teng"]
    t2 = _engine(dict(cfg, checkpoint={"load_universal": True}), seed=9)
    t2.load_checkpoint(str(d / "jax_uni"), tag=".")
    assert t2.global_steps == 2 and int(t2._step) == 2
    jm2 = JGPT2(size="tiny")
    j2, *_ = jds.initialize(
        model=jm2, model_parameters=jm2.init(jax.random.PRNGKey(5)),
        config=dict(cfg, mesh={"fsdp": -1},
                    checkpoint={"load_universal": True}))
    j2.load_checkpoint(str(d / "port_uni"), tag=".")
    assert int(j2.state["step"]) == 2
    for i in (2, 3):
        b = _batch(i)
        jl, tl = float(jeng.train_batch(b)), float(t2.train_batch(b))
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        jl, tl = float(j2.train_batch(b)), float(teng.train_batch(b))
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
    start = flatten_tree(tree)
    for j, t in ((jeng, t2), (j2, teng)):
        want = flatten_tree(jax.tree.map(np.asarray, j.state["params"]))
        got = {n: v.numpy() for n, v in t.master_state_dict().items()}
        assert _distance(got, want) <= 5e-5 * _distance(want, start)
        assert int(t._step) == int(j.state["step"]) == 4
