"""GPT-NeoX family: partial rotary, parallel residual with separate LayerNorms
for attention and MLP, full biases, untied head (D 96 at 20b) (counterpart
of ``deepspeed_tpu/models/gptneox.py``: the same presets and defaults)."""

from __future__ import annotations

from .base import ModelConfig, register_model
from .transformer import DecoderLM


def gptneox_config(size: str = "20b", **overrides) -> ModelConfig:
    presets = {
        "tiny": dict(hidden_size=64, num_layers=2, num_heads=4,
                     intermediate_size=256, vocab_size=512,
                     max_seq_len=128, rotary_pct=0.5),
        "pythia-1.4b": dict(hidden_size=2048, num_layers=24, num_heads=16,
                            intermediate_size=8192, vocab_size=50304,
                            max_seq_len=2048, rotary_pct=0.25),
        "20b": dict(hidden_size=6144, num_layers=44, num_heads=64,
                    intermediate_size=24576, vocab_size=50432,
                    max_seq_len=2048, rotary_pct=0.25),
    }
    base = dict(norm_type="layernorm", activation="gelu",
                position_embedding="rope", use_bias=True,
                parallel_residual=True, parallel_dual_norm=True,
                tie_embeddings=False)
    base.update(presets[size])
    base.update(overrides)
    return ModelConfig(**base)


@register_model("gptneox")
class GPTNeoX(DecoderLM):
    def __init__(self, config: ModelConfig | None = None,
                 size: str | None = None, *, device=None, dtype=None,
                 **overrides):
        if config is not None and (size is not None or overrides):
            raise ValueError(
                "pass either an explicit config or size/overrides, not both")
        super().__init__(config or gptneox_config(size or "20b", **overrides),
                         device=device, dtype=dtype)
