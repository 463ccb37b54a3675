"""Engine factory (counterpart of
``deepspeed_tpu/inference/v2/engine_factory.py``; reference:
inference/v2/engine_factory.py build_hf_engine — maps an architecture
name to its model implementation and constructs InferenceEngineV2)."""

from __future__ import annotations

from typing import Optional

from ...models import get_model_class
from ...models.transformer import deferred_weights
from ...utils.device import resolve_device
from .engine_v2 import (InferenceEngineV2, RaggedInferenceEngineConfig,
                        _refuse_unported)

__all__ = ["build_engine", "build_hf_engine", "SUPPORTED_MODEL_TYPES"]

# the JAX package's table (reference engine_factory.py names + bloom, gptj,
# gptneox, internlm); mixtral and qwen2_moe serve with every expert on the
# card (moe/)
SUPPORTED_MODEL_TYPES = ("gpt2", "llama", "mistral", "mixtral", "falcon",
                         "opt", "phi", "phi3", "qwen", "qwen2", "qwen2_moe",
                         "bloom", "gptj", "gptneox", "internlm")


def _engine_config(engine_config) -> RaggedInferenceEngineConfig:
    """The engine config (None: the defaults; a dict: parsed), refused
    where it asks for what is not ported before any model is built in its
    dtype (int8 is refused)."""
    if engine_config is None:
        engine_config = RaggedInferenceEngineConfig()
    elif isinstance(engine_config, dict):
        engine_config = RaggedInferenceEngineConfig.from_dict(engine_config)
    _refuse_unported(engine_config)
    return engine_config


def build_engine(model_type: str, size: str = "tiny",
                 engine_config: RaggedInferenceEngineConfig | dict |
                 None = None,
                 params: Optional[dict] = None, device=None,
                 **model_overrides) -> InferenceEngineV2:
    """Build a v2 engine for a registered model family and size.

    ``params`` is a JAX-layout tree of numpy arrays (see
    ``models/convert.py``); None draws random weights from the config's
    seed. ``device`` None means ``cuda`` and raises where no card is
    present; pass ``device="cpu"`` for the plain PyTorch path. The model
    is built without weights and the engine gives it each leaf in turn
    (cast, or int8 with ``quantize_weights``), so no second float tree
    exists on the device."""
    if model_type not in SUPPORTED_MODEL_TYPES:
        raise ValueError(
            f"unsupported model_type {model_type!r}; supported: "
            f"{SUPPORTED_MODEL_TYPES}")
    dev = resolve_device(device)
    engine_config = _engine_config(engine_config)
    with deferred_weights():        # the loader gives every leaf
        model = get_model_class(model_type)(
            size=size, device=dev, dtype=engine_config.torch_dtype,
            **model_overrides)
    return InferenceEngineV2(model, engine_config, params=params)


def build_hf_engine(path: str,
                    engine_config: RaggedInferenceEngineConfig | dict |
                    None = None, device=None,
                    **model_overrides) -> InferenceEngineV2:
    """Serve a pretrained model from an HF checkpoint directory (reference:
    engine_factory.py:69 build_hf_engine + checkpoint/huggingface_engine.py
    HuggingFaceCheckpointEngine): config.json picks the family and its
    config (``model_overrides`` on top), and the engine loads the
    checkpoint's tensors leaf by leaf, each copied to ``device`` and
    stacked into the port's layout there only when the loader reaches it
    (``checkpoint/huggingface.py``).
    ``device`` as :func:`build_engine`'s."""
    from ...checkpoint.huggingface import hf_model
    engine_config = _engine_config(engine_config)
    model, params = hf_model(path, device, engine_config.torch_dtype,
                             **model_overrides)
    return InferenceEngineV2(model, engine_config, params=params)
