"""InternLM family: the Llama architecture; 7B biases every attention
projection (q/k/v and o) and leaves the MLP unbiased, 20B has no biases
(counterpart of ``deepspeed_tpu/models/internlm.py``: the same presets and
defaults)."""

from __future__ import annotations

from .base import ModelConfig, register_model
from .transformer import DecoderLM


def internlm_config(size: str = "7b", **overrides) -> ModelConfig:
    presets = {
        "tiny": dict(hidden_size=64, num_layers=2, num_heads=4,
                     num_kv_heads=4, intermediate_size=128,
                     vocab_size=512, max_seq_len=128),
        "7b": dict(hidden_size=4096, num_layers=32, num_heads=32,
                   num_kv_heads=32, intermediate_size=11008,
                   vocab_size=103168, max_seq_len=2048),
        "20b": dict(hidden_size=5120, num_layers=60, num_heads=40,
                    num_kv_heads=40, intermediate_size=13824,
                    vocab_size=103168, max_seq_len=4096,
                    use_bias=False, mlp_bias=None),  # 20B is bias-free
    }
    # 7B layout: q/k/v/o biased (use_bias) but the MLP unbiased
    # (mlp_bias=False) — the InternLM delta vs Llama
    base = dict(norm_type="rmsnorm", activation="swiglu",
                position_embedding="rope", use_bias=True,
                mlp_bias=False, tie_embeddings=False)
    base.update(presets[size])
    base.update(overrides)
    return ModelConfig(**base)


@register_model("internlm")
class InternLM(DecoderLM):
    def __init__(self, config: ModelConfig | None = None,
                 size: str | None = None, *, device=None, dtype=None,
                 **overrides):
        if config is not None and (size is not None or overrides):
            raise ValueError(
                "pass either an explicit config or size/overrides, not both")
        super().__init__(config or internlm_config(size or "7b", **overrides),
                         device=device, dtype=dtype)
