"""Activation checkpointing (counterpart of
``deepspeed_tpu/runtime/activation_checkpointing/``; reference:
deepspeed/runtime/activation_checkpointing/)."""

from . import checkpointing  # noqa: F401
