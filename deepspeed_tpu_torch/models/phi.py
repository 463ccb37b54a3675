"""Phi family. Phi-2: parallel residual with one LayerNorm and partial rotary
embeddings (D 80); Phi-3: llama-style RMSNorm + SwiGLU (D 96 at mini)
(counterpart of ``deepspeed_tpu/models/phi.py``: the same presets and
defaults)."""

from __future__ import annotations

from .base import ModelConfig, register_model
from .transformer import DecoderLM


def phi_config(size: str = "2", **overrides) -> ModelConfig:
    presets = {
        "tiny": dict(hidden_size=64, num_layers=2, num_heads=4,
                     intermediate_size=256, vocab_size=512,
                     max_seq_len=128, rotary_pct=0.5),
        "2": dict(hidden_size=2560, num_layers=32, num_heads=32,
                  intermediate_size=10240, vocab_size=51200,
                  max_seq_len=2048, rotary_pct=0.4),
    }
    base = dict(norm_type="layernorm", activation="gelu",
                position_embedding="rope", use_bias=True,
                parallel_residual=True, tie_embeddings=False)
    base.update(presets[size])
    base.update(overrides)
    return ModelConfig(**base)


def phi3_config(size: str = "mini", **overrides) -> ModelConfig:
    presets = {
        "tiny": dict(hidden_size=64, num_layers=2, num_heads=4,
                     num_kv_heads=2, intermediate_size=128, vocab_size=512,
                     max_seq_len=128),
        "mini": dict(hidden_size=3072, num_layers=32, num_heads=32,
                     num_kv_heads=32, intermediate_size=8192,
                     vocab_size=32064, max_seq_len=4096),
    }
    base = dict(norm_type="rmsnorm", activation="swiglu",
                position_embedding="rope", use_bias=False,
                tie_embeddings=False)
    base.update(presets[size])
    base.update(overrides)
    return ModelConfig(**base)


@register_model("phi")
class Phi(DecoderLM):
    def __init__(self, config: ModelConfig | None = None,
                 size: str | None = None, *, device=None, dtype=None,
                 **overrides):
        if config is not None and (size is not None or overrides):
            raise ValueError(
                "pass either an explicit config or size/overrides, not both")
        super().__init__(config or phi_config(size or "2", **overrides),
                         device=device, dtype=dtype)


@register_model("phi3")
class Phi3(DecoderLM):
    def __init__(self, config: ModelConfig | None = None,
                 size: str | None = None, *, device=None, dtype=None,
                 **overrides):
        if config is not None and (size is not None or overrides):
            raise ValueError(
                "pass either an explicit config or size/overrides, not both")
        super().__init__(config or phi3_config(size or "mini", **overrides),
                         device=device, dtype=dtype)
