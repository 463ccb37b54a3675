"""Collectives on torch.distributed (counterpart of ``deepspeed_tpu/comm``)."""
