"""Bloom family: ALiBi, LayerNorm after the word embeddings, full biases, tied
embeddings (counterpart of ``deepspeed_tpu/models/bloom.py``: the same
presets and defaults)."""

from __future__ import annotations

from .base import ModelConfig, register_model
from .transformer import DecoderLM


def bloom_config(size: str = "560m", **overrides) -> ModelConfig:
    presets = {
        "tiny": dict(hidden_size=64, num_layers=2, num_heads=4,
                     intermediate_size=256, vocab_size=512,
                     max_seq_len=128),
        "560m": dict(hidden_size=1024, num_layers=24, num_heads=16,
                     intermediate_size=4096, vocab_size=250880,
                     max_seq_len=2048),
        "7b1": dict(hidden_size=4096, num_layers=30, num_heads=32,
                    intermediate_size=16384, vocab_size=250880,
                    max_seq_len=2048),
        "176b": dict(hidden_size=14336, num_layers=70, num_heads=112,
                     intermediate_size=57344, vocab_size=250880,
                     max_seq_len=2048),
    }
    base = dict(norm_type="layernorm", activation="gelu",
                position_embedding="alibi", use_bias=True,
                embed_layernorm=True, tie_embeddings=True)
    base.update(presets[size])
    base.update(overrides)
    return ModelConfig(**base)


@register_model("bloom")
class Bloom(DecoderLM):
    def __init__(self, config: ModelConfig | None = None,
                 size: str | None = None, *, device=None, dtype=None,
                 **overrides):
        if config is not None and (size is not None or overrides):
            raise ValueError(
                "pass either an explicit config or size/overrides, not both")
        super().__init__(config or bloom_config(size or "560m", **overrides),
                         device=device, dtype=dtype)
