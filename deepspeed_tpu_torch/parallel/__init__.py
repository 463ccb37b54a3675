"""Device meshes over ranks (counterpart of ``deepspeed_tpu/parallel``)."""
