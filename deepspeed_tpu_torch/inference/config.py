"""Inference config (reference: deepspeed/inference/config.py
DeepSpeedInferenceConfig — dtype, tensor_parallel, max_out_tokens,
kernel-injection and cuda-graph knobs). Same field names and defaults as
``deepspeed_tpu/inference/config.py``; ``dtype`` resolves to a
``torch.dtype``."""

from __future__ import annotations

import dataclasses
import json
from typing import Any, ClassVar, Optional

import torch

from ..runtime.config_utils import DeepSpeedConfigModel

_DTYPES = {"float32": torch.float32, "fp32": torch.float32,
           "float16": torch.float16, "fp16": torch.float16,
           "half": torch.float16, "bfloat16": torch.bfloat16,
           "bf16": torch.bfloat16, "int8": torch.int8}


@dataclasses.dataclass
class DeepSpeedTPConfig(DeepSpeedConfigModel):
    """reference: inference/config.py DeepSpeedTPConfig"""
    enabled: bool = True
    tp_size: int = 1
    mpu: Optional[Any] = None
    tp_group: Optional[Any] = None


@dataclasses.dataclass
class DeepSpeedInferenceConfig(DeepSpeedConfigModel):
    """Field names follow the reference so configs port unchanged."""
    ALIASES: ClassVar[dict[str, str]] = {"tp": "tensor_parallel"}

    dtype: str = "bfloat16"
    tensor_parallel: DeepSpeedTPConfig = dataclasses.field(
        default_factory=DeepSpeedTPConfig)
    max_out_tokens: int = 1024
    min_out_tokens: int = 1
    max_tokens: int = 1024
    checkpoint: Optional[str] = None
    replace_with_kernel_inject: bool = False
    replace_method: str = "auto"
    enable_cuda_graph: bool = False
    triangular_masking: bool = True
    return_tuple: bool = True
    seed: int = 0
    quantize_moe_experts: bool = False
    quantize_weights: bool = False
    moe_grouped_dispatch: bool = False

    @classmethod
    def from_any(cls, config=None, **kwargs) -> "DeepSpeedInferenceConfig":
        if isinstance(config, cls):
            if kwargs:
                merged = config.model_dump()
                merged.update(kwargs)
                return cls.from_dict(merged)
            return config
        if isinstance(config, str):
            with open(config) as f:
                config = json.load(f)
        config = dict(config or {})
        config.update(kwargs)
        return cls.from_dict(config)

    @property
    def torch_dtype(self) -> torch.dtype:
        name = str(self.dtype).replace("torch.", "")
        if name not in _DTYPES:
            raise ValueError(f"unknown dtype {self.dtype!r}; "
                             f"known: {sorted(_DTYPES)}")
        return _DTYPES[name]
