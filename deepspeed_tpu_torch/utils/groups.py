"""Process groups (counterpart of ``deepspeed_tpu/utils/groups.py``;
reference: deepspeed/utils/groups.py).

The JAX module names mesh axes as groups. The port runs the pure
sharded-DP meshes of ``parallel/mesh.py``, where the data-parallel group
is every rank of the world: ``None``, which every collective of
``comm/comm.py`` reads as the world group. The model-, expert-, pipeline-
and sequence-parallel groups come with their slices (ROADMAP Slice D).
"""

from __future__ import annotations

from ..comm import comm


def get_data_parallel_group():
    """The world group (``None``): the only group the pure sharded-DP
    meshes need."""
    return None


def get_data_parallel_world_size() -> int:
    return comm.get_world_size(get_data_parallel_group())


def get_data_parallel_rank() -> int:
    return comm.get_rank(get_data_parallel_group())
