"""OPT family: learned positions, LayerNorm, ReLU MLP, biases (counterpart of
``deepspeed_tpu/models/opt.py``: the same presets and defaults)."""

from __future__ import annotations

from .base import ModelConfig, register_model
from .transformer import DecoderLM


def opt_config(size: str = "1.3b", **overrides) -> ModelConfig:
    presets = {
        "tiny": dict(hidden_size=64, num_layers=2, num_heads=4,
                     intermediate_size=256, vocab_size=512,
                     max_seq_len=128),
        "125m": dict(hidden_size=768, num_layers=12, num_heads=12,
                     intermediate_size=3072, vocab_size=50272,
                     max_seq_len=2048),
        "1.3b": dict(hidden_size=2048, num_layers=24, num_heads=32,
                     intermediate_size=8192, vocab_size=50272,
                     max_seq_len=2048),
        "13b": dict(hidden_size=5120, num_layers=40, num_heads=40,
                    intermediate_size=20480, vocab_size=50272,
                    max_seq_len=2048),
        "66b": dict(hidden_size=9216, num_layers=64, num_heads=72,
                    intermediate_size=36864, vocab_size=50272,
                    max_seq_len=2048),
    }
    # OPT's FFN activation is ReLU (HF OPTConfig activation_function
    # default; caught by the HF logits-parity suite — gelu diverged)
    base = dict(norm_type="layernorm", activation="relu",
                position_embedding="learned", use_bias=True,
                tie_embeddings=True)
    base.update(presets[size])
    base.update(overrides)
    return ModelConfig(**base)


@register_model("opt")
class OPT(DecoderLM):
    def __init__(self, config: ModelConfig | None = None,
                 size: str | None = None, *, device=None, dtype=None,
                 **overrides):
        if config is not None and (size is not None or overrides):
            raise ValueError(
                "pass either an explicit config or size/overrides, not both")
        super().__init__(config or opt_config(size or "1.3b", **overrides),
                         device=device, dtype=dtype)
