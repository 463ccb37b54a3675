"""Configs for the optimized-linear subsystem (counterpart of
``deepspeed_tpu/linear/config.py``; reference: deepspeed/linear/config.py
LoRAConfig / QuantizationConfig), with the JAX package's defaults."""

from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass
class LoRAConfig:
    """reference: linear/config.py:10.

    lora_r: adapter rank; lora_alpha: scaling (effective scale alpha/r).
    base_weight_sharding, offload, offload_ratio, delay_lora_init: kept for
    config parity with the JAX package (its frozen base shards over the
    fsdp axis; the port's engine trains a LoRAModel on one rank).
    target_mods: the path components LoRA applies to.
    """
    lora_r: int = 64
    lora_alpha: float = 16.0
    base_weight_sharding: int = 1
    offload: bool = False
    offload_ratio: float = 0.0
    delay_lora_init: bool = False
    target_mods: List[str] = dataclasses.field(
        default_factory=lambda: [
            # HF-style names (external checkpoints)
            "q_proj", "k_proj", "v_proj", "o_proj",
            "gate_proj", "up_proj", "down_proj",
            # the DecoderLM weight names (models/transformer.py)
            "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
        ])


@dataclasses.dataclass
class QuantizationConfig:
    """reference: linear/config.py:37. q_format "int": q_bits in {4, 6, 8}
    symmetric int codes; "fp": q_bits in {6, 8, 12} float formats
    (``ops/fp_quant.py``: torch float8 at 8 bits, bit-packed fp6/fp12).
    group_size is elements per quantization block."""
    q_bits: int = 8
    mantissa_bits: int = 3
    group_size: int = 512
    q_format: str = "int"     # "int" | "fp"
