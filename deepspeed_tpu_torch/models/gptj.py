"""GPT-J family: partial rotary (rotary_dim 64 of head_dim 256), parallel
attention + MLP sharing one LayerNorm, unbiased attention, biased MLP,
untied head (counterpart of ``deepspeed_tpu/models/gptj.py``: the same
presets and defaults)."""

from __future__ import annotations

from .base import ModelConfig, register_model
from .transformer import DecoderLM


def gptj_config(size: str = "6b", **overrides) -> ModelConfig:
    presets = {
        "tiny": dict(hidden_size=64, num_layers=2, num_heads=4,
                     intermediate_size=256, vocab_size=512,
                     max_seq_len=128, rotary_pct=0.5),
        "6b": dict(hidden_size=4096, num_layers=28, num_heads=16,
                   intermediate_size=16384, vocab_size=50400,
                   max_seq_len=2048, rotary_pct=0.25),  # rotary_dim 64
    }
    base = dict(norm_type="layernorm", activation="gelu",
                position_embedding="rope", use_bias=False, mlp_bias=True,
                parallel_residual=True, tie_embeddings=False)
    base.update(presets[size])
    base.update(overrides)
    return ModelConfig(**base)


@register_model("gptj")
class GPTJ(DecoderLM):
    def __init__(self, config: ModelConfig | None = None,
                 size: str | None = None, *, device=None, dtype=None,
                 **overrides):
        if config is not None and (size is not None or overrides):
            raise ValueError(
                "pass either an explicit config or size/overrides, not both")
        super().__init__(config or gptj_config(size or "6b", **overrides),
                         device=device, dtype=dtype)
