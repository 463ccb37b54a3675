"""ZeRO (counterpart of ``deepspeed_tpu/runtime/zero.py``).

The JAX ``ZeroShardingPlan`` shards parameters, gradients and optimizer
state over the mesh's data axes by stage. The port runs one process on one
device so far: at world size 1, stages 0, 1 and 2 shard nothing (every
shard is the whole tree) and differ in nothing the step does. The plan
records the stage and refuses what needs more than one rank or a memory
tier: stage 3, a process group larger than one, offload and the ZeRO++
wire.
"""

from __future__ import annotations

import torch.distributed as dist

from .config import ZeroConfig


def world_size() -> int:
    return dist.get_world_size() if (dist.is_available()
                                     and dist.is_initialized()) else 1


class ZeroPlan:
    def __init__(self, config: ZeroConfig, world: int = 1):
        if config.stage not in (0, 1, 2, 3):
            raise ValueError(f"zero_optimization.stage {config.stage} "
                             f"(0-3)")
        multi_rank = {
            "zero_optimization.stage=3": config.stage == 3,
            f"a process group of {world}": world > 1,
            "zero_hpz_partition_size > 1": config.zero_hpz_partition_size > 1,
            "zero_quantized_weights": config.zero_quantized_weights,
            "zero_quantized_gradients": config.zero_quantized_gradients,
            "zero_hierarchical_allgather": config.zero_hierarchical_allgather,
            "mics_shard_size > 1": config.mics_shard_size > 1,
        }
        for what, on in multi_rank.items():
            if on:
                raise NotImplementedError(
                    f"{what} is not ported yet (ROADMAP: port Queue 1, "
                    f"Slice D (multi-rank ZeRO))")
        for what, block in (("offload_optimizer", config.offload_optimizer),
                            ("offload_param", config.offload_param)):
            if block.device != "none" or getattr(block, "stream", None):
                raise NotImplementedError(
                    f"zero_optimization.{what} is not ported yet (ROADMAP: "
                    f"port Queue 1, Slice E (memory tiers))")
        self.stage = config.stage
        self.world = world
