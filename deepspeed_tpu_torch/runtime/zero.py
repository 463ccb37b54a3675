"""ZeRO as a sharding plan (counterpart of ``deepspeed_tpu/runtime/zero.py``;
reference: deepspeed/runtime/zero/).

The JAX ``ZeroShardingPlan`` puts the fsdp mesh axis on each leaf's
largest still-unsharded divisible dim (``overlay_axis``): the fp32 master
and the optimizer state at stage >= 1, the gradients at stage >= 2, the
parameters at stage 3. The port keeps that plan as one split dim (or
None) per leaf and stage, over the fsdp ranks of the world
(``parallel/mesh.py``): a leaf is split only when the fsdp size W > 1 and
it has at least 2048 elements, on its largest dim that W divides (the
first such dim on ties, as Python's ``max``). At W = 1 nothing is split,
so every stage, and the ZeRO++ wire, computes what stage 0 does.

``ZeroPlan`` reads the ``zero_optimization`` block and refuses what is not
ported: hpZ, MiCS, the hierarchical two-hop wire, the fp8 wire and
offload, each naming its ROADMAP item. ZeRO-3 with ``offload_param`` is
the JAX package's layer-streamed engine (``deepspeed_tpu/__init__.py:73``).
"""

from __future__ import annotations

from .config import ZeroConfig

MIN_SPLIT = 2 ** 11    # JAX overlay_axis min_size

_SLICE_D = "port Queue 1, Slice D item 11"
_SLICE_E = "port Queue 1, Slice E (memory tiers)"


class ZeroPlan:
    """The ported subset of the ``zero_optimization`` block."""

    def __init__(self, config: ZeroConfig):
        if config.stage not in (0, 1, 2, 3):
            raise ValueError(f"zero_optimization.stage {config.stage} "
                             f"(0-3)")
        quantized = (config.zero_quantized_weights
                     or config.zero_quantized_gradients)
        if config.zero_quantized_dtype not in ("int8", "fp8"):
            raise ValueError(f"zero_quantized_dtype "
                             f"{config.zero_quantized_dtype!r}: int8 or fp8")
        if config.zero_quantized_rounding not in ("nearest", "stochastic"):
            raise ValueError(f"zero_quantized_rounding "
                             f"{config.zero_quantized_rounding!r}: nearest "
                             f"or stochastic")
        unported = {
            "zero_hpz_partition_size > 1 (hpZ)":
                config.zero_hpz_partition_size > 1,
            "mics_shard_size > 1 (MiCS)": config.mics_shard_size > 1,
            "zero_hierarchical_allgather (the two-hop wire)":
                config.zero_hierarchical_allgather,
            "zero_quantized_dtype=fp8 (the fp8 wire, ops/fp_quant.py)":
                quantized and config.zero_quantized_dtype == "fp8",
        }
        for what, on in unported.items():
            if on:
                raise NotImplementedError(
                    f"{what} is not ported yet (ROADMAP: {_SLICE_D})")
        if config.stage == 3 and config.offload_param.device != "none":
            raise NotImplementedError(
                "ZeRO-3 with offload_param (the layer-streamed engine) is "
                f"not ported yet (ROADMAP: {_SLICE_E})")
        for what, block in (("offload_optimizer", config.offload_optimizer),
                            ("offload_param", config.offload_param)):
            if block.device != "none" or getattr(block, "stream", None):
                raise NotImplementedError(
                    f"zero_optimization.{what} is not ported yet (ROADMAP: "
                    f"{_SLICE_E})")
        self.stage = config.stage
        self.quantize_weights = config.zero_quantized_weights
        self.quantize_gradients = config.zero_quantized_gradients
        self.rounding = config.zero_quantized_rounding


def overlay_dim(shape, world: int, min_size: int = MIN_SPLIT) -> int | None:
    """The dim ZeRO splits a leaf of ``shape`` on over ``world`` ranks, or
    None (JAX ``overlay_axis`` on an unsharded spec)."""
    numel = 1
    for d in shape:
        numel *= d
    if world <= 1 or numel < min_size:
        return None
    candidates = [d for d in range(len(shape)) if shape[d] % world == 0]
    if not candidates:
        return None
    return max(candidates, key=lambda d: shape[d])


class ZeroShardingPlan:
    """Per leaf, the dim split over the ``world`` fsdp ranks, or None, for
    the parameters (``param_dims``, stage 3), the gradients (``grad_dims``,
    stage >= 2) and the fp32 master and optimizer state (``master_dims``,
    stage >= 1). ``shapes`` maps leaf names to full shapes."""

    def __init__(self, stage: int, world: int, shapes: dict):
        if stage not in (0, 1, 2, 3):
            raise ValueError(f"ZeRO stage must be 0-3, got {stage}")
        self.stage = stage
        self.world = world
        self.shapes = {n: tuple(s) for n, s in shapes.items()}
        dims = {n: overlay_dim(s, world) for n, s in self.shapes.items()}
        none = dict.fromkeys(dims)
        self.param_dims = dims if stage >= 3 else none
        self.grad_dims = dims if stage >= 2 else none
        self.master_dims = dims if stage >= 1 else none

    def shard_shape(self, name: str, dim: int | None) -> tuple[int, ...]:
        """The shape this rank holds of leaf ``name`` split on ``dim``."""
        shape = list(self.shapes[name])
        if dim is not None:
            shape[dim] //= self.world
        return tuple(shape)
