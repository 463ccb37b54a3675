"""Mistral family: llama-style GQA with sliding-window attention (counterpart
of ``deepspeed_tpu/models/mistral.py``: the same presets and defaults)."""

from __future__ import annotations

from .base import ModelConfig, register_model
from .transformer import DecoderLM


def mistral_config(size: str = "7b", **overrides) -> ModelConfig:
    presets = {
        "tiny": dict(hidden_size=64, num_layers=2, num_heads=4,
                     num_kv_heads=2, intermediate_size=128, vocab_size=512,
                     max_seq_len=128, sliding_window=32),
        "7b": dict(hidden_size=4096, num_layers=32, num_heads=32,
                   num_kv_heads=8, intermediate_size=14336,
                   vocab_size=32000, max_seq_len=8192,
                   sliding_window=4096),
    }
    base = dict(norm_type="rmsnorm", activation="swiglu",
                position_embedding="rope", use_bias=False,
                tie_embeddings=False, rope_theta=10000.0)
    base.update(presets[size])
    base.update(overrides)
    return ModelConfig(**base)


@register_model("mistral")
class Mistral(DecoderLM):
    def __init__(self, config: ModelConfig | None = None,
                 size: str | None = None, *, device=None, dtype=None,
                 **overrides):
        if config is not None and (size is not None or overrides):
            raise ValueError(
                "pass either an explicit config or size/overrides, not both")
        super().__init__(config or mistral_config(size or "7b", **overrides),
                         device=device, dtype=dtype)
