"""The mesh over ranks (counterpart of ``deepspeed_tpu/parallel/mesh.py``).

The JAX ``MeshTopology`` lays devices out on named axes, outermost to
innermost ``AXIS_ORDER``, with the batch split over ``BATCH_AXES``. The
port runs one rank per device and ports the pure sharded-DP meshes:
``{"fsdp": W}`` (ZeRO shards over every rank; the default, fsdp -1
absorbing the world) and ``{"dp": W}`` (plain replicas, nothing sharded).
Any other axis larger than one, or dp and fsdp both larger than one,
raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import math

AXIS_ORDER = ("pp", "dp", "fsdp", "zps", "ep", "sp", "tp")
BATCH_AXES = ("dp", "fsdp", "zps")

# the ROADMAP item (port Queue 1) that ports each axis not ported yet
UNPORTED_AXES = {
    "tp": "Slice D item 12 (tensor parallelism, parallel/partition.py)",
    "sp": "Slice D item 12 (sequence/)",
    "pp": "Slice D item 12 (runtime/pipe/)",
    "ep": "Slice D item 12, expert parallelism (moe/dispatch.py, "
          "runtime/comm/moe_alltoall.py)",
    "zps": "Slice D item 11 (hpZ/MiCS, the zps axis)",
}
MIXED_DP = "Slice D item 11 (mixed dp x fsdp meshes)"


@dataclasses.dataclass(frozen=True)
class TopologyConfig:
    """Degrees for each axis; -1 for fsdp absorbs the remaining ranks."""

    pp: int = 1
    dp: int = 1
    fsdp: int = -1
    zps: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    @classmethod
    def from_mesh_block(cls, block: dict) -> "TopologyConfig":
        return cls(**{k: v for k, v in block.items() if k != "dcn"})

    def resolve(self, n_ranks: int) -> dict[str, int]:
        """Axis -> size over ``n_ranks`` (JAX ``TopologyConfig.resolve``)."""
        sizes = {a: getattr(self, a) for a in AXIS_ORDER}
        fixed = math.prod(v for v in sizes.values() if v != -1)
        n_auto = sum(1 for v in sizes.values() if v == -1)
        if n_auto > 1:
            raise ValueError("at most one axis may be -1 (auto)")
        if n_auto == 1:
            if n_ranks % fixed != 0:
                raise ValueError(f"device count {n_ranks} not divisible by "
                                 f"fixed axis product {fixed}")
            sizes = {a: (n_ranks // fixed if v == -1 else v)
                     for a, v in sizes.items()}
        if math.prod(sizes.values()) != n_ranks:
            raise ValueError(f"axis product {sizes} != device count "
                             f"{n_ranks}")
        return sizes


def check_ported(sizes: dict[str, int]) -> None:
    """``NotImplementedError`` naming the ROADMAP item of the first axis
    (or axis pair) of ``sizes`` the port does not run yet; -1 (auto)
    counts as ported."""
    for axis, where in UNPORTED_AXES.items():
        if sizes.get(axis, 1) not in (1, -1):
            raise NotImplementedError(
                f"mesh {axis}={sizes[axis]} is not ported yet (ROADMAP: "
                f"port Queue 1, {where})")
    if sizes.get("dp", 1) > 1 and sizes.get("fsdp", 1) > 1:
        raise NotImplementedError(
            f"mesh dp={sizes['dp']} x fsdp={sizes['fsdp']} is not ported "
            f"yet (ROADMAP: port Queue 1, {MIXED_DP})")


class Topology:
    """Axis sizes over the ranks of the world (JAX ``MeshTopology``
    without the device array: rank r is the r-th device)."""

    def __init__(self, config: TopologyConfig | None = None,
                 world: int = 1):
        self.config = config or TopologyConfig()
        self.sizes = self.config.resolve(world)
        check_ported(self.sizes)

    @property
    def data_parallel_size(self) -> int:
        return self.sizes["dp"] * self.sizes["fsdp"] * self.sizes["zps"]

    @property
    def fsdp_size(self) -> int:
        """Ranks ZeRO shards over (the sharded-DP axes)."""
        return self.sizes["fsdp"] * self.sizes["zps"]

    def batch_axes(self) -> tuple[str, ...]:
        return tuple(a for a in BATCH_AXES if self.sizes[a] > 1) or ("dp",)

    def __repr__(self):
        axes = ", ".join(f"{a}={self.sizes[a]}" for a in AXIS_ORDER)
        return f"Topology({axes})"
