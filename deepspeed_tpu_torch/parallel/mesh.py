"""The mesh over ranks (counterpart of ``deepspeed_tpu/parallel/mesh.py``).

The JAX ``MeshTopology`` lays devices out on named axes, outermost to
innermost ``AXIS_ORDER``, as ``np.asarray(devices).reshape(shape)``, with
the batch split over ``BATCH_AXES``. The port runs one rank per device in
the same order: rank r sits at ``np.unravel_index(r, shape)``, so ``zps``
is the innermost batch axis and a group over an axis set holds the ranks
that share every other coordinate, in rank order. Ported: the
data-parallel axes ``dp`` (replicas), ``fsdp`` (ZeRO shards; -1 absorbs
the world) and ``zps`` (the sub-axis carved out of fsdp for hpZ and MiCS,
or set directly for the two-hop wire), in any mix, and ``ep`` (expert
parallelism: the routed experts split over it, everything else replicated
over it; ranks that differ only in ``ep`` take the same batch rows, as
JAX keeps activations replicated over ``ep``). Any other axis larger than
one raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

AXIS_ORDER = ("pp", "dp", "fsdp", "zps", "ep", "sp", "tp")
BATCH_AXES = ("dp", "fsdp", "zps")
SHARD_AXES = ("fsdp", "zps")          # ZeRO's full sharded-DP extent

# the ROADMAP item (port Queue 1) that ports each axis not ported yet
UNPORTED_AXES = {
    "tp": "Slice D item 12 (tensor parallelism, parallel/partition.py)",
    "sp": "Slice D item 12 (sequence/)",
    "pp": "Slice D item 12 (runtime/pipe/)",
}


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
    """``NotImplementedError`` naming the ROADMAP item of the first axis of
    ``sizes`` the port does not run yet; -1 (auto) counts as ported."""
    for axis, where in UNPORTED_AXES.items():
        if sizes.get(axis, 1) not in (1, -1):
            raise NotImplementedError(
                f"mesh {axis}={sizes[axis]} is not ported yet (ROADMAP: "
                f"port Queue 1, {where})")


def live_axes(axes, sizes: dict[str, int]) -> tuple[str, ...]:
    """``axes`` in ``AXIS_ORDER`` order without the size-1 ones."""
    return tuple(a for a in AXIS_ORDER if a in axes and sizes[a] > 1)


class Topology:
    """Axis sizes over the ranks of the world and rank ``rank``'s place on
    them (JAX ``MeshTopology``: rank r is the r-th device of the reshaped
    device array)."""

    def __init__(self, config: TopologyConfig | None = None,
                 world: int = 1, rank: int = 0):
        self.config = config or TopologyConfig()
        self.sizes = self.config.resolve(world)
        check_ported(self.sizes)
        self.world = world
        self.rank = rank
        self.shape = tuple(self.sizes[a] for a in AXIS_ORDER)

    def coordinates(self, rank: int | None = None) -> dict[str, int]:
        """Axis -> the rank's coordinate (JAX's device array position)."""
        r = self.rank if rank is None else rank
        return dict(zip(AXIS_ORDER, (int(c) for c in
                                     np.unravel_index(r, self.shape))))

    def axis_size(self, axes) -> int:
        return math.prod(self.sizes[a] for a in axes)

    def axis_index(self, axes, rank: int | None = None) -> int:
        """The rank's index over ``axes``: its coordinates read outer-major,
        inner-minor in ``AXIS_ORDER`` (JAX's multi-axis ``axis_index``, the
        chunk order of a dim split over those axes)."""
        coords = self.coordinates(rank)
        index = 0
        for a in AXIS_ORDER:
            if a in axes:
                index = index * self.sizes[a] + coords[a]
        return index

    def group_ranks(self, axes) -> list[list[int]]:
        """Every group over ``axes``: the ranks that share all the other
        coordinates, each group in rank order (its group rank is the
        rank's :meth:`axis_index`), the groups ordered by the other
        coordinates."""
        ranks = np.arange(self.world).reshape(self.shape)
        inner = [i for i, a in enumerate(AXIS_ORDER) if a in axes]
        outer = [i for i in range(len(AXIS_ORDER)) if i not in inner]
        n = math.prod(self.shape[i] for i in inner)
        return ranks.transpose(outer + inner).reshape(-1, n).tolist()

    def first_rank(self, axes, index: int) -> int:
        """The lowest rank at ``index`` over ``axes``: the one whose other
        coordinates are all 0."""
        return next(g[index] for g in self.group_ranks(axes))

    @property
    def data_parallel_size(self) -> int:
        return self.axis_size(BATCH_AXES)

    @property
    def expert_parallel_size(self) -> int:
        return self.sizes["ep"]

    @property
    def fsdp_size(self) -> int:
        """Ranks ZeRO shards over (the sharded-DP axes)."""
        return self.axis_size(SHARD_AXES)

    def batch_axes(self) -> tuple[str, ...]:
        return tuple(a for a in BATCH_AXES if self.sizes[a] > 1) or ("dp",)

    def __repr__(self):
        axes = ", ".join(f"{a}={self.sizes[a]}" for a in AXIS_ORDER)
        return f"Topology({axes})"


_GLOBAL_TOPOLOGY: Topology | None = None


def set_topology(topo: Topology | None) -> None:
    """The topology the ``utils/groups.py`` getters read (the engine sets
    it, as JAX's does)."""
    global _GLOBAL_TOPOLOGY
    _GLOBAL_TOPOLOGY = topo


def get_topology() -> Topology | None:
    return _GLOBAL_TOPOLOGY
