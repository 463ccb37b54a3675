"""FastGen-equivalent inference on PyTorch (counterpart of
``deepspeed_tpu/inference/v2``)."""

from .engine_factory import SUPPORTED_MODEL_TYPES, build_engine  # noqa: F401
from .engine_v2 import (InferenceEngineV2, KVCacheConfig,  # noqa: F401
                        PrefixCacheConfig, RaggedInferenceEngineConfig)
from .ragged import (BlockedAllocator, DSStateManager,  # noqa: F401
                     PrefixCache)
