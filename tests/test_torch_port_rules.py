"""Rules of the PyTorch port (deepspeed_tpu_torch): it imports neither jax
nor anything of the JAX package, and its entry points run on the card
unless the caller asks for the CPU."""

import pathlib
import re
import subprocess
import sys

import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.inference.v2 import build_engine
from deepspeed_tpu_torch.models import GPT2

PKG = pathlib.Path(deepspeed_tpu_torch.__file__).parent


def test_import_pulls_in_no_jax_and_no_jax_package():
    modules = sorted(
        "deepspeed_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix(
            "").parts) for p in PKG.rglob("*.py") if p.name != "__init__.py")
    assert "deepspeed_tpu_torch.runtime.engine" in modules
    assert "deepspeed_tpu_torch.ops.flash_attention" in modules
    assert "deepspeed_tpu_torch.ops.sparse_attention.kernels" in modules
    assert "deepspeed_tpu_torch.ops.sparse_attention.sparsity_config" \
        in modules
    for new_module in ("checkpoint.huggingface", "models.bert",
                       "models.adapters", "ops.transformer"):
        assert "deepspeed_tpu_torch." + new_module in modules
    code = ("import sys, deepspeed_tpu_torch, " + ", ".join(modules) + "\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'pydantic', "
            "'deepspeed_tpu', 'safetensors', 'transformers'))\n"
            "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120,
                         cwd=str(PKG.parent))
    assert out.stdout.strip() == ""


def test_sources_import_no_jax_and_no_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|"
                         r"pydantic|deepspeed_tpu|safetensors|transformers)"
                         r"(\.|\s|$)", re.M)
    hits = [str(p.relative_to(PKG)) for p in PKG.rglob("*.py")
            if pattern.search(p.read_text())]
    assert hits == []


def test_entry_point_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_engine("llama", "tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_engine("llama", "tiny", device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deepspeed_tpu_torch.initialize(
            model=GPT2(size="125m", vocab_size=50304,
                       remat_policy="segments", attn_impl="flash"),
            config={"train_batch_size": 24, "bf16": {"enabled": True}})


def test_new_entry_points_need_a_card(monkeypatch, tmp_path):
    """BERT, the encoder layer, the adapters (an ``nn.Module`` given to
    ``initialize`` too), the HF entry points, the MoE families and the
    ``MoE`` layer's parameters run on the card unless the caller asks for
    the CPU."""
    from deepspeed_tpu_torch.checkpoint.huggingface import (
        HuggingFaceCheckpointEngine, from_pretrained)
    from deepspeed_tpu_torch.inference.v2 import build_hf_engine
    from deepspeed_tpu_torch.models import Bert, FunctionalModel, wrap_model
    from deepspeed_tpu_torch.models.mixtral import Mixtral
    from deepspeed_tpu_torch.models.qwen import Qwen2MoE
    from deepspeed_tpu_torch.moe import MoE
    from deepspeed_tpu_torch.ops.transformer import (
        DeepSpeedTransformerConfig, DeepSpeedTransformerLayer)
    (tmp_path / "config.json").write_text(
        '{"architectures": ["LlamaForCausalLM"], "vocab_size": 64, '
        '"hidden_size": 16, "intermediate_size": 32, '
        '"num_hidden_layers": 1, "num_attention_heads": 2}')
    (tmp_path / "pytorch_model.bin").write_bytes(b"")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: Bert(size="tiny"),
                 lambda: DeepSpeedTransformerLayer(
                     DeepSpeedTransformerConfig(hidden_size=16, heads=2)),
                 lambda: FunctionalModel(lambda g: {"w": torch.ones(2)},
                                         lambda p, t: p["w"]),
                 lambda: wrap_model(torch.nn.Linear(2, 2)),
                 lambda: deepspeed_tpu_torch.initialize(
                     model=torch.nn.Linear(2, 2),
                     config={"train_batch_size": 2}),
                 lambda: HuggingFaceCheckpointEngine(str(tmp_path)),
                 lambda: build_hf_engine(str(tmp_path)),
                 lambda: from_pretrained(str(tmp_path)),
                 lambda: deepspeed_tpu_torch.init_inference(str(tmp_path)),
                 lambda: Mixtral(size="tiny"),
                 lambda: Qwen2MoE(size="tiny"),
                 lambda: MoE(8, 16, 2).init()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
