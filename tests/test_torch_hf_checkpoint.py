"""Hugging Face checkpoint directories through the port's reader and entry
points (deepspeed_tpu_torch ``checkpoint/huggingface.py``,
``inference/v2/engine_factory.py`` ``build_hf_engine``,
``init_inference(path)``), on the CPU. tests/test_torch_hf_families.py
holds the fifteen families' logits, leaves and configs.

- The port's safetensors reader is bit-equal to ``safetensors``'
  ``safe_open`` for BF16, F16, F32, I64, BOOL and a zero-size tensor, and
  ``safe_open`` reads the port's writer bit-equal; other dtypes raise.
- Sharded safetensors (``model.safetensors.index.json``) and
  ``pytorch_model.bin`` read bit-equal to the single file; a bf16
  checkpoint's leaves stay bf16.
- ``init_inference(path)`` (the v1 engine) and ``build_hf_engine(path,
  device="cpu")`` (v2) give HF ``generate``'s greedy tokens; their
  parameters equal ``from_pretrained``'s; ``params=`` skips the read.
- Fine-tuning from the loaded weights through ``initialize`` starts from
  them and lowers the loss.
"""

import json

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch.checkpoint import (HuggingFaceCheckpointEngine,
                                            from_pretrained)
from deepspeed_tpu_torch.checkpoint.huggingface import (SafetensorsFile,
                                                        save_safetensors)
from deepspeed_tpu_torch.inference.v2 import build_hf_engine
from deepspeed_tpu_torch.models.convert import flatten_tree, materialize
from safetensors import safe_open
from safetensors.torch import save_file
from test_hf_checkpoint import _save


def _tensors():
    g = torch.Generator().manual_seed(0)
    return {
        "bf16": torch.randn(3, 5, generator=g).to(torch.bfloat16),
        "f16": torch.randn(7, generator=g).to(torch.float16),
        "f32": torch.randn(2, 3, 4, generator=g),
        "i64": torch.randint(-2**40, 2**40, (9,), generator=g),
        "bool": torch.rand(4, 3, generator=g) > 0.5,
        "empty": torch.zeros(0, 6),
        "scalar": torch.tensor(1.5),
    }


def _bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and _bytes(a) == _bytes(b))


def _bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def test_reader_matches_safe_open(tmp_path):
    path = str(tmp_path / "t.safetensors")
    ts = _tensors()
    save_file(ts, path, metadata={"format": "pt"})
    ours = SafetensorsFile(path)
    assert sorted(ours.keys()) == sorted(ts)
    assert ours.metadata == {"format": "pt"}
    with safe_open(path, framework="pt") as f:
        for key in ts:
            assert _bit_equal(ours.get(key), f.get_tensor(key)), key
    # the mapped tensor is writable and the file stays as it was
    ours.get("f32").zero_()
    with safe_open(path, framework="pt") as f:
        assert _bit_equal(f.get_tensor("f32"), ts["f32"])


def test_writer_is_read_by_safe_open(tmp_path):
    path = str(tmp_path / "w.safetensors")
    ts = _tensors()
    n = save_safetensors(ts, path)
    assert n == sum(t.numel() * t.element_size() for t in ts.values())
    with safe_open(path, framework="pt") as f:
        assert f.metadata() == {"format": "pt"}
        for key, t in ts.items():
            assert _bit_equal(f.get_tensor(key), t), key


def test_reader_refuses_other_dtypes(tmp_path):
    path = str(tmp_path / "i32.safetensors")
    save_file({"x": torch.arange(4, dtype=torch.int32)}, path)
    with pytest.raises(NotImplementedError, match="I32"):
        SafetensorsFile(path).get("x")
    with pytest.raises(NotImplementedError, match="int32"):
        save_safetensors({"x": torch.arange(4, dtype=torch.int32)}, path)
    with pytest.raises(FileNotFoundError, match="config.json"):
        HuggingFaceCheckpointEngine(str(tmp_path))


def test_sharded_bin_and_bf16_checkpoints(tmp_path):
    hf, d = _save(tmp_path, "llama")
    _, p0 = from_pretrained(d, device="cpu")
    sh = tmp_path / "sharded"
    hf.save_pretrained(str(sh), safe_serialization=True,
                       max_shard_size="40KB")
    assert (sh / "model.safetensors.index.json").exists()
    assert len(list(sh.glob("*.safetensors"))) > 1
    bn = tmp_path / "bin"
    hf.save_pretrained(str(bn), safe_serialization=False)
    assert (bn / "pytorch_model.bin").exists()
    for other in (sh, bn):
        _, p1 = from_pretrained(str(other), device="cpu")
        a, b = flatten_tree(materialize(p0)), flatten_tree(materialize(p1))
        assert set(a) == set(b)
        for k in a:
            assert _bit_equal(a[k], b[k]), (other.name, k)
    b16 = tmp_path / "bf16"
    hf.to(torch.bfloat16).save_pretrained(str(b16), safe_serialization=True)
    _, p2 = from_pretrained(str(b16), device="cpu")
    a = flatten_tree(materialize(p0))
    for k, leaf in flatten_tree(materialize(p2)).items():
        assert leaf.dtype == torch.bfloat16, k
        assert _bit_equal(leaf, a[k].to(torch.bfloat16)), k


def _greedy_ref(hf, prompt, n):
    with torch.no_grad():
        return hf.generate(torch.tensor([prompt]), max_new_tokens=n,
                           do_sample=False)[0].tolist()


def test_init_inference_from_hf_dir(tmp_path):
    hf, d = _save(tmp_path, "llama")
    eng = ds.init_inference(d, dtype="float32", max_out_tokens=32,
                            device="cpu")
    out = eng.generate(np.asarray([[1, 2, 3, 4]]), max_new_tokens=4,
                       do_sample=False)
    assert np.asarray(out).tolist()[0] == _greedy_ref(hf, [1, 2, 3, 4], 4)
    model, params = from_pretrained(d, device="cpu")
    for name, p in model.params.items():
        assert torch.equal(eng.module.params[name], p), name
    # params= skips the read: the engine serves the given weights
    zeroed = {k: torch.zeros_like(v)
              for k, v in flatten_tree(materialize(params)).items()}
    eng2 = ds.init_inference(d, dtype="float32", max_out_tokens=32,
                             device="cpu", params=zeroed)
    assert all(float(p.detach().abs().max()) == 0.0
               for p in eng2.module.params.values())
    with pytest.raises(ValueError, match="checkpoint path"):
        ds.init_inference(model, dtype="float32", device="cpu")


def test_build_hf_engine_serves(tmp_path):
    hf, d = _save(tmp_path, "llama")
    eng = build_hf_engine(d, {"dtype": "float32"}, device="cpu")
    prompts = [[1, 2, 3, 4], [9, 8, 7, 6, 5, 4, 3]]
    toks = eng.generate(prompts, max_new_tokens=5)
    for prompt, got in zip(prompts, toks):
        assert list(map(int, got)) == _greedy_ref(hf, prompt, 5)[
            len(prompt):]
    model, _ = from_pretrained(d, device="cpu")
    assert set(eng.model.params.keys()) == set(model.params.keys())
    for name, p in model.params.items():
        assert torch.equal(eng.model.params[name], p), name


def test_finetune_pretrained_weights(tmp_path):
    _, d = _save(tmp_path, "llama")
    model, params = from_pretrained(d, device="cpu")
    engine, _, _, _ = ds.initialize(
        model=model, model_parameters=params,
        config={"train_batch_size": 8,
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
                "zero_optimization": {"stage": 2}})
    # the engine starts from the loaded weights, not a fresh draw
    master = engine.master_state_dict()
    for name, leaf in flatten_tree(materialize(params)).items():
        assert torch.equal(master[name], leaf.float()), name
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(3):
        t = rng.integers(0, 250, (8, 16))
        losses.append(float(engine.train_batch(
            {"tokens": t, "targets": t})))
    assert losses[-1] < losses[0]


def test_config_json_fields_reach_the_model(tmp_path):
    """config.json's fields (not the family's tiny preset) size the model
    the entry points build."""
    _, d = _save(tmp_path, "mistral")
    with open(f"{d}/config.json") as f:
        hf_cfg = json.load(f)
    eng = build_hf_engine(d, {"dtype": "float32"}, device="cpu")
    c = eng.model.config
    assert (c.hidden_size, c.num_layers, c.num_heads, c.num_kv_heads,
            c.sliding_window, c.vocab_size) == (
        hf_cfg["hidden_size"], hf_cfg["num_hidden_layers"],
        hf_cfg["num_attention_heads"], hf_cfg["num_key_value_heads"],
        hf_cfg["sliding_window"], hf_cfg["vocab_size"])
    assert c.norm_type == "rmsnorm"
