"""deepspeed_tpu_torch: the PyTorch/CUDA port of deepspeed_tpu.

A second package beside the JAX one, ported slice by slice; the JAX
package is the reference each slice is held against. Ported so far:

  - ``initialize(model=..., config=...)`` -> (engine, optimizer, None,
    lr_scheduler): the training engine (``runtime/engine.py``), whose
    ``train_batch`` and ``forward``/``backward``/``step`` run
    GPT-2/Llama-family models with the hand-written Hopper
    flash-attention (``csrc/flash_attention.cu``), fused-Adam
    (``csrc/fused_adam.cu``) and fused-Lion (``csrc/fused_lion.cu``)
    kernels;
  - ``ops.sparse_attention``: ``SparseSelfAttention`` on the
    block-sparse attention kernels (``csrc/block_sparse_attention.cu``);
  - ``inference.v2.build_engine``: the v2 serving path with its
    paged-attention kernel (``csrc/paged_attention.cu``).

It imports torch and numpy, never jax and nothing of ``deepspeed_tpu``.
"""

from .inference.v2 import build_engine  # noqa: F401
from .runtime.config import DeepSpeedConfig  # noqa: F401

__version__ = "0.1.0"


def initialize(args=None,
               model=None,
               optimizer=None,
               model_parameters=None,
               training_data=None,
               lr_scheduler=None,
               distributed_port=None,
               mpu=None,
               dist_init_required=None,
               collate_fn=None,
               config=None,
               mesh_param=None,
               config_params=None):
    """Initialize the training engine (reference: deepspeed/__init__.py:69).

    ``model`` is a model of the port (``models.GPT2(...)``, ...); the
    engine runs on its device. Returns ``(engine, optimizer, None,
    lr_scheduler)``: the data loader is not ported yet.

    ``PipelineModule`` (no ``loss``/``params``), the layer-streamed ZeRO
    engine (stage 3, ``offload_param``) and the hybrid engine
    (``hybrid_engine.enabled``) raise ``NotImplementedError`` naming their
    ROADMAP slice, from the engine and the config.
    """
    from .runtime.engine import DeepSpeedEngine

    config = DeepSpeedConfig.from_any(
        config if config is not None else config_params)
    engine = DeepSpeedEngine(
        args=args, model=model, optimizer=optimizer,
        model_parameters=model_parameters, training_data=training_data,
        lr_scheduler=lr_scheduler, mpu=mpu, config=config,
        collate_fn=collate_fn, mesh_param=mesh_param)
    return engine, engine.optimizer, engine.training_dataloader, \
        engine.lr_scheduler
