"""deepspeed_tpu_torch: the PyTorch/CUDA port of deepspeed_tpu.

A second package beside the JAX one, ported slice by slice; the JAX
package is the reference each slice is held against. Ported so far: the
v2 serving path (``inference.v2.build_engine``) with its hand-written
Hopper paged-attention kernel (``csrc/paged_attention.cu``). It imports
torch and numpy, never jax and nothing of ``deepspeed_tpu``.
"""

from .inference.v2 import build_engine  # noqa: F401

__version__ = "0.1.0"
