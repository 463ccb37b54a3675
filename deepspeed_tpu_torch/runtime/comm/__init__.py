"""Quantized gradient collectives (counterpart of
``deepspeed_tpu/runtime/comm``)."""
