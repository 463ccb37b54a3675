"""Inference (serving) for the port: the v1 engine (``init_inference``)
and the ragged v2 engine (``inference.v2``)."""

from .config import DeepSpeedInferenceConfig  # noqa: F401
from .engine import InferenceEngine  # noqa: F401
