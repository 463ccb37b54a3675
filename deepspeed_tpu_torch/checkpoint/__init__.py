"""Checkpoint ingestion of the port (counterpart of
``deepspeed_tpu/checkpoint/``): Hugging Face checkpoint directories.
``universal.py`` and ``zero_to_fp32.py`` are not ported yet (ROADMAP
Slice E item 13)."""

from .huggingface import HuggingFaceCheckpointEngine, from_pretrained

__all__ = ["HuggingFaceCheckpointEngine", "from_pretrained"]
