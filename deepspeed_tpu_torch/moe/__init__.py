from .layer import MoE  # noqa: F401
from .sharded_moe import (  # noqa: F401
    dequantize_experts,
    moe_ffn,
    moe_ffn_grouped,
    quantize_experts,
    top_k_gating,
)
