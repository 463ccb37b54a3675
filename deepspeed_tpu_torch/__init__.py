"""deepspeed_tpu_torch: the PyTorch/CUDA port of deepspeed_tpu.

A second package beside the JAX one, ported slice by slice; the JAX
package is the reference each slice is held against. Ported so far:

  - ``initialize(model=..., config=...)`` -> (engine, optimizer, None,
    lr_scheduler): the training engine (``runtime/engine.py``), whose
    ``train_batch`` and ``forward``/``backward``/``step`` run
    GPT-2/Llama-family models with the hand-written Hopper
    flash-attention (``csrc/flash_attention.cu``), fused-Adam
    (``csrc/fused_adam.cu``) and fused-Lion (``csrc/fused_lion.cu``)
    kernels, on one rank or across ranks of ``torch.distributed``
    (``comm/``) with ZeRO stages 1-3 and the ZeRO++ int8 wire (qwZ/qgZ)
    on the block-quantize kernels (``csrc/quantize_int8.cu``);
  - ``ops.sparse_attention``: ``SparseSelfAttention`` on the
    block-sparse attention kernels (``csrc/block_sparse_attention.cu``);
  - ``inference.v2.build_engine``: the v2 serving path with its
    paged-attention kernel (``csrc/paged_attention.cu``), for every dense
    family the JAX package serves (gpt2, llama, mistral, falcon, opt,
    phi, phi3, qwen, qwen2, bloom, gptj, gptneox, internlm);
  - ``init_inference(model=..., config=...)``: the v1 engine
    (``inference/engine.py``), a static KV cache and an eager decode loop;
  - ``models.Bert`` (on ``ops/transformer.py``'s encoder layer) and the
    model adapters (``models/adapters.py``: an ``nn.Module`` or an
    ``(init, apply[, loss])`` tuple) through ``initialize``;
  - Hugging Face checkpoint directories (``checkpoint/huggingface.py``):
    ``from_pretrained``, ``inference.v2.build_hf_engine(path)`` and
    ``init_inference(path)``.

It imports torch and numpy, never jax and nothing of ``deepspeed_tpu``.
"""

from .inference.v2 import build_engine  # noqa: F401
from .runtime.config import DeepSpeedConfig  # noqa: F401

__version__ = "0.1.0"


def init_inference(model=None, config=None, device=None, **kwargs):
    """Build the v1 inference engine (reference:
    deepspeed/__init__.py:291). ``model`` is a model of the port, on the
    device it was built for; ``params`` (a keyword) is a JAX-layout tree
    of numpy arrays or a flat ``{"layers/wq": ...}`` mapping, else the
    weights come from ``config["checkpoint"]`` (a ``.npz``) or are drawn
    from ``config["seed"]``. ``model`` may also be an HF checkpoint
    directory (reference: inference/engine.py:326 and
    module_inject/load_checkpoint.py:21): config.json builds the family's
    model on ``device`` (None: the card) in the config's dtype, and its
    tensors load leaf by leaf (``checkpoint/huggingface.py``); a
    ``params`` keyword skips that read."""
    from .inference.config import DeepSpeedInferenceConfig
    from .inference.engine import InferenceEngine, _refuse_unported
    params = kwargs.pop("params", None)
    cfg = DeepSpeedInferenceConfig.from_any(config, **kwargs)
    if isinstance(model, str):
        from .checkpoint.huggingface import hf_model
        _refuse_unported(cfg)   # before the model is built in cfg's dtype
        model, lazy = hf_model(model, device, cfg.torch_dtype)
        if params is None:
            params = lazy
    elif device is not None:
        raise ValueError("device= is for a checkpoint path; a model runs "
                         "on the device it was built for")
    return InferenceEngine(model, cfg, params=params)


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

    Where the environment names a world larger than one (``WORLD_SIZE``,
    as torchrun sets it) and no process group is up, this joins one
    (``comm.init_distributed``, as the JAX engine does); a caller may also
    join one first (gloo, a file store). ZeRO stages 1-3 then shard over
    the ranks, with the ZeRO++ int8 wire (``zero_quantized_weights``,
    ``zero_quantized_gradients``) on request.

    A model that is not the port's own (an ``nn.Module``, an ``(init,
    apply[, loss])`` tuple) goes through ``models/adapters.py``.
    ``PipelineModule``, the layer-streamed ZeRO
    engine (stage 3, ``offload_param``), hpZ, MiCS, the two-hop and fp8
    wires, meshes other than pure ``fsdp`` or ``dp`` and the hybrid engine
    (``hybrid_engine.enabled``) raise ``NotImplementedError`` naming their
    ROADMAP item, from the engine and the config.
    """
    import os

    from .comm import comm
    from .runtime.engine import DeepSpeedEngine

    if int(os.environ.get("WORLD_SIZE", "1")) > 1 \
            and not comm.is_initialized():
        comm.init_distributed()

    config = DeepSpeedConfig.from_any(
        config if config is not None else config_params)
    engine = DeepSpeedEngine(
        args=args, model=model, optimizer=optimizer,
        model_parameters=model_parameters, training_data=training_data,
        lr_scheduler=lr_scheduler, mpu=mpu, config=config,
        collate_fn=collate_fn, mesh_param=mesh_param)
    return engine, engine.optimizer, engine.training_dataloader, \
        engine.lr_scheduler
