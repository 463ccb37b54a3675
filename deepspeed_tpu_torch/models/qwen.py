"""Qwen family (counterpart of ``deepspeed_tpu/models/qwen.py``: the same
presets and defaults): llama-style decoders with qkv biases, and
Qwen2-MoE, Mixtral's routed experts plus a shared expert."""

from __future__ import annotations

import torch

from ..ops import layers as L
from ..ops.quantization import dequantize_dense
from .base import ModelConfig, register_model
from .mixtral import Mixtral
from .transformer import _STD, DecoderLM


def qwen_config(size: str = "7b", **overrides) -> ModelConfig:
    presets = {
        "tiny": dict(hidden_size=64, num_layers=2, num_heads=4,
                     num_kv_heads=2, intermediate_size=128, vocab_size=512,
                     max_seq_len=128),
        "7b": dict(hidden_size=4096, num_layers=32, num_heads=32,
                   num_kv_heads=32, intermediate_size=11008,
                   vocab_size=151936, max_seq_len=8192),
        "72b": dict(hidden_size=8192, num_layers=80, num_heads=64,
                    num_kv_heads=64, intermediate_size=24576,
                    vocab_size=152064, max_seq_len=32768,
                    rope_theta=1e6),
    }
    base = dict(norm_type="rmsnorm", activation="swiglu",
                position_embedding="rope", use_bias=False,
                attn_qkv_bias=True, tie_embeddings=False)
    base.update(presets[size])
    base.update(overrides)
    return ModelConfig(**base)


def qwen2_config(size: str = "7b", **overrides) -> ModelConfig:
    presets = {
        "tiny": dict(hidden_size=64, num_layers=2, num_heads=4,
                     num_kv_heads=2, intermediate_size=128, vocab_size=512,
                     max_seq_len=128),
        "7b": dict(hidden_size=3584, num_layers=28, num_heads=28,
                   num_kv_heads=4, intermediate_size=18944,
                   vocab_size=152064, max_seq_len=32768, rope_theta=1e6),
    }
    base = dict(norm_type="rmsnorm", activation="swiglu",
                position_embedding="rope", use_bias=False,
                attn_qkv_bias=True, tie_embeddings=False)
    base.update(presets[size])
    base.update(overrides)
    return ModelConfig(**base)


def qwen2_moe_config(size: str = "a2.7b", **overrides) -> ModelConfig:
    presets = {
        "tiny": dict(hidden_size=64, num_layers=2, num_heads=4,
                     num_kv_heads=2, intermediate_size=128, vocab_size=512,
                     max_seq_len=128, num_experts=4, moe_top_k=2,
                     moe_num_shared_experts=1),
        "a2.7b": dict(hidden_size=2048, num_layers=24, num_heads=16,
                      num_kv_heads=16, intermediate_size=1408,
                      vocab_size=151936, max_seq_len=8192,
                      num_experts=60, moe_top_k=4, rope_theta=1e6,
                      moe_num_shared_experts=1),
    }
    base = dict(norm_type="rmsnorm", activation="swiglu",
                position_embedding="rope", use_bias=False,
                attn_qkv_bias=True, tie_embeddings=False,
                # HF Qwen2-MoE norm_topk_prob defaults False: raw
                # softmax probs combine the top-k experts
                moe_norm_topk=False)
    base.update(presets[size])
    base.update(overrides)
    return ModelConfig(**base)


@register_model("qwen")
class Qwen(DecoderLM):
    def __init__(self, config: ModelConfig | None = None,
                 size: str | None = None, *, device=None, dtype=None,
                 **overrides):
        if config is not None and (size is not None or overrides):
            raise ValueError(
                "pass either an explicit config or size/overrides, not both")
        super().__init__(config or qwen_config(size or "7b", **overrides),
                         device=device, dtype=dtype)


@register_model("qwen2")
class Qwen2(DecoderLM):
    def __init__(self, config: ModelConfig | None = None,
                 size: str | None = None, *, device=None, dtype=None,
                 **overrides):
        if config is not None and (size is not None or overrides):
            raise ValueError(
                "pass either an explicit config or size/overrides, not both")
        super().__init__(config or qwen2_config(size or "7b", **overrides),
                         device=device, dtype=dtype)


@register_model("qwen2_moe")
class Qwen2MoE(Mixtral):
    """Routed experts plus a shared expert whose output is added through a
    sigmoid gate (JAX ``Qwen2MoE``; reference: qwen_v2_moe modules). The
    n shared experts are one n-times-wider SwiGLU MLP, ``layers/shared/
    {w_gate, w_up}`` [L, d, n*f], ``w_down`` [L, n*f, d] and ``gate_proj``
    [L, d, 1]."""

    def __init__(self, config: ModelConfig | None = None,
                 size: str | None = None, *, device=None, dtype=None,
                 **overrides):
        if config is None:
            config = qwen2_moe_config(size or "a2.7b", **overrides)
        elif size is not None or overrides:
            raise ValueError(
                "pass either an explicit config or size/overrides, not both")
        super().__init__(config, device=device, dtype=dtype)

    def _param_spec(self):
        spec = super()._param_spec()
        c = self.config
        if c.moe_num_shared_experts <= 0:
            return spec
        d, nl = c.hidden_size, c.num_layers
        fs = c.intermediate_size * c.moe_num_shared_experts
        spec.update({
            "layers/shared/w_gate": ((nl, d, fs), _STD),
            "layers/shared/w_up": ((nl, d, fs), _STD),
            "layers/shared/w_down": ((nl, fs, d), _STD / (2 * nl) ** 0.5),
            "layers/shared/gate_proj": ((nl, d, 1), _STD),
        })
        return spec

    def _mlp(self, p: dict, h):
        out, aux = super()._mlp(p, h)
        sh = {k[7:]: v for k, v in p.items() if k.startswith("shared/")}
        if not sh:
            return out, aux
        # weight-only int8 quantizes the shared matrices like any other
        # layer-stacked leaves; dequantized here, at their use
        sh = dequantize_dense(sh, h.dtype)
        shared = (L.silu(h @ sh["w_gate"]) * (h @ sh["w_up"])) @ sh["w_down"]
        gate = torch.sigmoid(h @ sh["gate_proj"])
        return out + gate * shared, aux

    def partition_rules(self):
        return super().partition_rules() + [
            (r"layers/shared/(w_gate|w_up)$", (None, None, "tp")),
            (r"layers/shared/w_down$", (None, "tp", None)),
            (r"layers/shared/gate_proj$", ()),
        ]
