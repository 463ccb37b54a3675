"""Falcon family: parallel attention + MLP sharing one input LayerNorm, rope,
multi-query attention on 7B (counterpart of
``deepspeed_tpu/models/falcon.py``: the same presets and defaults)."""

from __future__ import annotations

from .base import ModelConfig, register_model
from .transformer import DecoderLM


def falcon_config(size: str = "7b", **overrides) -> ModelConfig:
    presets = {
        "tiny": dict(hidden_size=64, num_layers=2, num_heads=4,
                     num_kv_heads=1, intermediate_size=256, vocab_size=512,
                     max_seq_len=128),
        "7b": dict(hidden_size=4544, num_layers=32, num_heads=71,
                   num_kv_heads=1, intermediate_size=4544 * 4,
                   vocab_size=65024, max_seq_len=2048),
        "40b": dict(hidden_size=8192, num_layers=60, num_heads=128,
                    num_kv_heads=8, intermediate_size=8192 * 4,
                    vocab_size=65024, max_seq_len=2048),
    }
    base = dict(norm_type="layernorm", activation="gelu",
                position_embedding="rope", use_bias=False,
                parallel_residual=True, tie_embeddings=True)
    base.update(presets[size])
    base.update(overrides)
    return ModelConfig(**base)


@register_model("falcon")
class Falcon(DecoderLM):
    def __init__(self, config: ModelConfig | None = None,
                 size: str | None = None, *, device=None, dtype=None,
                 **overrides):
        if config is not None and (size is not None or overrides):
            raise ValueError(
                "pass either an explicit config or size/overrides, not both")
        super().__init__(config or falcon_config(size or "7b", **overrides),
                         device=device, dtype=dtype)
