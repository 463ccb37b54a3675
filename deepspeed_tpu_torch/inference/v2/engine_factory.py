"""Engine factory (counterpart of
``deepspeed_tpu/inference/v2/engine_factory.py``; reference:
inference/v2/engine_factory.py build_hf_engine — maps an architecture
name to its model implementation and constructs InferenceEngineV2)."""

from __future__ import annotations

from typing import Optional

from ...models import get_model_class
from ...utils.device import resolve_device
from .engine_v2 import InferenceEngineV2, RaggedInferenceEngineConfig

__all__ = ["build_engine", "SUPPORTED_MODEL_TYPES"]

# the families ported so far (the JAX package serves fifteen)
SUPPORTED_MODEL_TYPES = ("gpt2", "llama")


def build_engine(model_type: str, size: str = "tiny",
                 engine_config: RaggedInferenceEngineConfig | dict |
                 None = None,
                 params: Optional[dict] = None, device=None,
                 **model_overrides) -> InferenceEngineV2:
    """Build a v2 engine for a registered model family and size.

    ``params`` is a JAX-layout tree of numpy arrays (see
    ``models/convert.py``); None draws random weights from the config's
    seed. ``device`` None means ``cuda`` and raises where no card is
    present; pass ``device="cpu"`` for the plain PyTorch path."""
    if model_type not in SUPPORTED_MODEL_TYPES:
        raise ValueError(
            f"unsupported model_type {model_type!r}; supported: "
            f"{SUPPORTED_MODEL_TYPES}")
    dev = resolve_device(device)
    if engine_config is None:
        engine_config = RaggedInferenceEngineConfig()
    elif isinstance(engine_config, dict):
        engine_config = RaggedInferenceEngineConfig.from_dict(engine_config)
    model = get_model_class(model_type)(
        size=size, device=dev, dtype=engine_config.torch_dtype,
        **model_overrides)
    return InferenceEngineV2(model, engine_config, params=params)
