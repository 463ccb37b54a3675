"""Mixtral family (counterpart of ``deepspeed_tpu/models/mixtral.py``: the
same presets and defaults): a decoder whose FFN is a top-k routed mixture
of experts. The preset is here for the registry; the model is refused, as
MoE models are not ported yet (ROADMAP Slice D item 12)."""

from __future__ import annotations

from .base import ModelConfig, register_model
from .transformer import DecoderLM


def mixtral_config(size: str = "8x7b", **overrides) -> ModelConfig:
    presets = {
        "tiny": dict(hidden_size=64, num_layers=2, num_heads=4,
                     num_kv_heads=2, intermediate_size=128, vocab_size=512,
                     max_seq_len=128, num_experts=4, moe_top_k=2),
        # MoE reference config: big enough that routing,
        # ep sharding and the dispatch wire dominate like a real MoE
        # block (8 experts top-2 -> 4x total/active param ratio in the
        # FFN), small enough for the bench rig and slow tests
        "ref": dict(hidden_size=256, num_layers=4, num_heads=4,
                    num_kv_heads=4, intermediate_size=512,
                    vocab_size=4096, max_seq_len=512, num_experts=8,
                    moe_top_k=2, capacity_factor=1.25),
        "8x7b": dict(hidden_size=4096, num_layers=32, num_heads=32,
                     num_kv_heads=8, intermediate_size=14336,
                     vocab_size=32000, max_seq_len=4096, num_experts=8,
                     moe_top_k=2, rope_theta=1e6),
    }
    base = dict(norm_type="rmsnorm", activation="swiglu",
                position_embedding="rope", use_bias=False,
                tie_embeddings=False)
    base.update(presets[size])
    base.update(overrides)
    return ModelConfig(**base)


@register_model("mixtral")
class Mixtral(DecoderLM):
    def __init__(self, config: ModelConfig | None = None,
                 size: str | None = None, *, device=None, dtype=None,
                 **overrides):
        if config is not None and (size is not None or overrides):
            raise ValueError(
                "pass either an explicit config or size/overrides, not both")
        config = config or mixtral_config(size or "8x7b", **overrides)
        if config.num_experts <= 0:
            raise ValueError("Mixtral requires num_experts > 0")
        super().__init__(config, device=device, dtype=dtype)
