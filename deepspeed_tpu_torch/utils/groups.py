"""Process groups (counterpart of ``deepspeed_tpu/utils/groups.py``;
reference: deepspeed/utils/groups.py).

The JAX module names mesh axes as groups; here each axis set of the
topology (``parallel/mesh.py``) is a ``torch.distributed`` process group:
the ranks that share every other coordinate, in rank order, so a rank's
group rank is its index over the axes (the chunk order of a dim split over
them). :func:`axis_group` makes every group of an axis set at once, on
every rank in the same order (``comm.new_group``), and keeps it; a group
of every rank is the world group. The getters read the topology the engine
set (``parallel/mesh.set_topology``), else the default mesh (fsdp over the
world). The model-, expert-, pipeline- and sequence-parallel groups come
with their slices (ROADMAP Slice D item 12).
"""

from __future__ import annotations

from ..comm import comm
from ..parallel.mesh import (BATCH_AXES, SHARD_AXES, Topology, TopologyConfig,
                             get_topology)

DATA_PARALLEL_GROUP = BATCH_AXES            # ("dp", "fsdp", "zps")
SHARDED_DP_GROUP = SHARD_AXES               # ("fsdp", "zps")
ZERO_PARAM_INTRA_PARALLEL_GROUP = ("zps",)  # hpZ / MiCS, the two-hop inner
ZERO_OUTER_GROUP = ("fsdp",)                # the two-hop wire's outer hop
DP_REPLICA_GROUP = ("dp",)
EXPERT_PARALLEL_GROUP = ("ep",)
EXPERT_DATA_PARALLEL_GROUP = BATCH_AXES     # the expert grads' reduction

_GROUPS: dict = {}


def topology() -> Topology:
    """The topology the engine set, else fsdp over the world."""
    return get_topology() or Topology(TopologyConfig(), comm.get_world_size(),
                                      comm.get_rank())


def axis_group(axes, topo: Topology | None = None):
    """This rank's process group over the mesh axes ``axes`` (None outside
    a process group). The first call for a partition makes every group of
    it, so every rank must make that call, in the same order."""
    topo = topo or topology()
    partition = topo.group_ranks(axes)
    if not comm.is_initialized():
        return None
    import torch.distributed as dist
    key = (id(dist.group.WORLD), tuple(map(tuple, partition)))
    if key not in _GROUPS:
        _GROUPS[key] = comm.new_group(partition)
    return _GROUPS[key]


def get_data_parallel_group():
    """Every batch rank (dp x fsdp x zps)."""
    return axis_group(DATA_PARALLEL_GROUP)


def get_sharded_data_parallel_group():
    """The ranks ZeRO shards over (fsdp x zps)."""
    return axis_group(SHARDED_DP_GROUP)


def get_zero_param_intra_parallel_group():
    """reference: groups.py:531 _create_zero_param_parallel_group: the zps
    sub-group (hpZ's and MiCS's shards, the two-hop wire's inner hop)."""
    return axis_group(ZERO_PARAM_INTRA_PARALLEL_GROUP)


def get_zero_outer_group():
    """The fsdp ranks at one zps coordinate: the two-hop wire's outer
    hop."""
    return axis_group(ZERO_OUTER_GROUP)


def get_data_parallel_replica_group():
    """The dp ranks at one shard coordinate: the replicas a mixed mesh
    all-reduces over after the reduce-scatter."""
    return axis_group(DP_REPLICA_GROUP)


def get_expert_parallel_group(group_name: str = "ep"):
    """The ep ranks at one batch coordinate: the holders of a token
    shard's other experts (JAX ``get_expert_parallel_group``)."""
    return axis_group(EXPERT_PARALLEL_GROUP)


def get_expert_data_parallel_group(group_name: str = "ep"):
    """The batch ranks at one ep coordinate: the ranks holding the same
    experts, over which their gradients are summed (JAX
    ``get_expert_data_parallel_group``)."""
    return axis_group(EXPERT_DATA_PARALLEL_GROUP)


def get_expert_parallel_world_size(group_name: str = "ep") -> int:
    return topology().expert_parallel_size


def get_data_parallel_world_size() -> int:
    return comm.get_world_size(get_data_parallel_group())


def get_data_parallel_rank() -> int:
    return comm.get_rank(get_data_parallel_group())
