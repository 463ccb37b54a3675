"""Optimized linear / LoRA / quantized weights (counterpart of
``deepspeed_tpu/linear/``; reference: deepspeed/linear/)."""

from .config import LoRAConfig, QuantizationConfig  # noqa: F401
from .optimized_linear import (LoRAModel, LoRAState, OptimizedLinear,  # noqa: F401
                               fuse_lora, lora_transform, make_merge_fn)
from .quantization import (QuantizedParameter, dequantize_tree,  # noqa: F401
                           is_quantized, quantize_param)
