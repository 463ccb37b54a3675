"""Mixtral family (counterpart of ``deepspeed_tpu/models/mixtral.py``: the
same presets, defaults and parameter tree): a decoder whose FFN is a top-k
routed mixture of experts (``moe/sharded_moe.py``).

Parameters: ``layers/router`` [L, d, E] and ``layers/experts/{w_up,
w_gate}`` [L, E, d, f], ``layers/experts/w_down`` [L, E, f, d] in place of
the dense FFN's leaves. Training and serving take the capacity form
(``moe_ffn``); ``moe_serving_dispatch`` (set on a serving engine's copy of
the model by ``moe_grouped_dispatch``) takes the grouped form without
capacity. The training engine binds the ``moe`` config block's routing
overrides (``moe_capacity_factor``, ``moe_min_capacity``) and, across
ranks, ``moe_dispatcher`` (``moe/dispatch.py``: global gating and the
dispatch/combine exchange; the expert stacks then hold this rank's ``E /
ep`` experts, split on dim 1 by the ``ep`` rules of
:meth:`partition_rules`); ``moe_router_telemetry`` raises where it is set,
naming its ROADMAP item. ``moe_metrics_hook``, when set, receives each
layer's routing metrics (drop fraction, expert load).
"""

from __future__ import annotations

from ..moe.sharded_moe import (TELEMETRY_UNPORTED, dequantize_experts,
                               moe_ffn, moe_ffn_grouped)
from .base import ModelConfig, register_model
from .transformer import _STD, DecoderLM

_DENSE_FFN = ("w_up", "w_down", "w_gate", "w_up_b", "w_down_b", "w_gate_b")


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
    # set on a serving engine's copy by moe_grouped_dispatch: the grouped
    # form (exact top-k, no capacity) instead of the capacity form
    moe_serving_dispatch = False
    # bound by the training engine from the moe config block (None: this
    # config's values, and no dispatcher); moe_router_telemetry keeps JAX's
    # name and has one working value (False): the moe block refuses the
    # other before a model sees it, and a value set by hand raises where it
    # is read
    moe_dispatcher = None
    moe_capacity_factor = None
    moe_min_capacity = None
    moe_router_telemetry = False
    moe_metrics_hook = None
    # the expert stacks are the leaves too large to draw whole in fp32
    layerwise_draws = frozenset(
        f"layers/experts/{n}" for n in ("w_up", "w_gate", "w_down"))

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

    def _param_spec(self):
        spec = {k: v for k, v in super()._param_spec().items()
                if k.split("/")[-1] not in _DENSE_FFN}
        c = self.config
        d, f, nl, e = (c.hidden_size, c.intermediate_size, c.num_layers,
                       c.num_experts)
        resid_std = _STD / (2 * nl) ** 0.5
        spec.update({
            "layers/router": ((nl, d, e), _STD),
            "layers/experts/w_up": ((nl, e, d, f), _STD),
            "layers/experts/w_gate": ((nl, e, d, f), _STD),
            "layers/experts/w_down": ((nl, e, f, d), resid_std),
        })
        return spec

    @property
    def routes_pads(self) -> bool:
        return not self.moe_serving_dispatch

    def _dequantized(self, p: dict) -> dict:
        """A layer's weight-only int8 pairs dequantized, the routed
        experts' apart: :meth:`_mlp` hands those to the grouped form as
        codes and scales, and dequantizes them for the capacity form."""
        experts = {k: v for k, v in p.items() if k.startswith("experts/")}
        rest = super()._dequantized(
            {k: v for k, v in p.items() if k not in experts})
        return {**rest, **experts}

    def _mlp(self, p: dict, h):
        c = self.config
        experts = {k[8:]: v for k, v in p.items() if k.startswith("experts/")}
        if self.moe_serving_dispatch:
            # int8 experts go to the grouped GEMM as codes and scales
            return moe_ffn_grouped(h, p["router"], experts, k=c.moe_top_k,
                                   activation=c.activation,
                                   normalize_topk=c.moe_norm_topk)
        experts = dequantize_experts(experts, h.dtype)
        if self.moe_router_telemetry:
            raise NotImplementedError(TELEMETRY_UNPORTED)
        cf, mc = self.moe_capacity_factor, self.moe_min_capacity
        return moe_ffn(
            h, p["router"], experts, k=c.moe_top_k,
            capacity_factor=c.capacity_factor if cf is None else cf,
            min_capacity=c.min_capacity if mc is None else mc,
            activation=c.activation, normalize_topk=c.moe_norm_topk,
            dispatcher=self.moe_dispatcher, metrics_hook=self.moe_metrics_hook)

    def partition_rules(self):
        rules = [r for r in super().partition_rules()
                 if "w_up" not in r[0] and "w_down" not in r[0]
                 and "w_gate" not in r[0]]
        return rules + [
            (r"layers/router", ()),
            (r"layers/experts/(w_up|w_gate)$", (None, "ep", None, "tp")),
            (r"layers/experts/w_down$", (None, "ep", "tp", None)),
        ]
