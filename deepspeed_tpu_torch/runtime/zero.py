"""ZeRO as a sharding plan (counterpart of ``deepspeed_tpu/runtime/zero.py``;
reference: deepspeed/runtime/zero/).

The JAX ``ZeroShardingPlan`` puts the sharded-DP mesh axes on each leaf's
largest still-unsharded divisible dim (``overlay_axis``): the fp32 master
and the optimizer state at stage >= 1, the gradients at stage >= 2, the
parameters at stage 3. The port keeps that plan as one split dim (or
None) per leaf and tree, with the mesh axes and the rank count that dim
is split over (``parallel/mesh.py``): a leaf is split only when that
count W > 1 and it has at least 2048 elements, on its largest dim that W
divides (the first such dim on ties, as Python's ``max``). At W = 1
nothing is split, so every stage, and the ZeRO++ wire, computes what
stage 0 does.

The axis sets are JAX's (``runtime/zero.py:129-159``): fsdp x zps for
every tree by default; under **hpZ** the parameters over zps alone (a
secondary partition replicated across fsdp) and the rest over fsdp x zps;
under **MiCS** every tree over zps alone. Each axis set splits on its own
dim, so under hpZ a leaf's parameter dim and its master dim may differ.

Expert parallelism comes first: a leaf whose partition rule puts ``ep``
on a dim that the mesh's ep divides (``layers/experts/w_*``: E, dim 1) is
split over ep on that dim in every tree and at every stage
(``ep_dims``), as JAX's base specs carry the rule; the ZeRO axes then go
on the largest remaining divisible dim (``overlay_axis`` skips a dim a
spec already splits), the size threshold and the divisibility read on the
global shape. ``shapes`` are then what a rank of one ep coordinate holds
in full (the ep dim divided), ``global_shapes`` the leaves' own, and the
ZeRO groups lie within an ep coordinate.

``ZeroPlan`` reads the ``zero_optimization`` block and refuses offload,
naming its ROADMAP item. ZeRO-3 with ``offload_param`` is the JAX
package's layer-streamed engine (``deepspeed_tpu/__init__.py:73``).
"""

from __future__ import annotations

import re

from .config import ZeroConfig

MIN_SPLIT = 2 ** 11    # JAX overlay_axis min_size
FULL_AXES = ("fsdp", "zps")
INNER_AXES = ("zps",)

_SLICE_E = "port Queue 1, Slice E (memory tiers)"


class ZeroPlan:
    """The ported subset of the ``zero_optimization`` block."""

    def __init__(self, config: ZeroConfig):
        if config.stage not in (0, 1, 2, 3):
            raise ValueError(f"zero_optimization.stage {config.stage} "
                             f"(0-3)")
        if config.zero_quantized_dtype not in ("int8", "fp8"):
            raise ValueError(f"zero_quantized_dtype "
                             f"{config.zero_quantized_dtype!r}: int8 or fp8")
        if config.zero_quantized_rounding not in ("nearest", "stochastic"):
            raise ValueError(f"zero_quantized_rounding "
                             f"{config.zero_quantized_rounding!r}: nearest "
                             f"or stochastic")
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
        self.wire_dtype = config.zero_quantized_dtype
        self.hierarchical = config.zero_hierarchical_allgather
        self.hpz = config.zero_hpz_partition_size > 1
        self.mics = config.mics_shard_size > 1

    def exact_only(self) -> None:
        """Drop the ZeRO++ flags: the exact collectives (an ep mesh, where
        JAX falls back to XLA's)."""
        self.quantize_weights = self.quantize_gradients = False
        self.hierarchical = False

    @property
    def explicit_wire(self) -> bool:
        """The ZeRO++ wire (qwZ, qgZ or the two-hop collectives): JAX
        computes the step in shard_map form then, each rank's loss the mean
        over its own rows (``runtime/engine.py`` ``_make_grad_fn``)."""
        return (self.quantize_weights or self.quantize_gradients
                or self.hierarchical)


def overlay_dim(shape, world: int, min_size: int = MIN_SPLIT,
                taken: int | None = None) -> int | None:
    """The dim ZeRO splits a leaf of (global) ``shape`` on over ``world``
    ranks, or None (JAX ``overlay_axis``; ``taken``: a dim the spec already
    splits)."""
    numel = 1
    for d in shape:
        numel *= d
    if world <= 1 or numel < min_size:
        return None
    candidates = [d for d in range(len(shape))
                  if d != taken and shape[d] % world == 0]
    if not candidates:
        return None
    return max(candidates, key=lambda d: shape[d])


def ep_split_dims(rules, shapes: dict, ep: int) -> dict:
    """name -> the dim the ``ep`` axis splits, for each leaf whose first
    matching partition rule (``re.search`` on the name, as JAX
    ``match_rules``) names ``ep`` on a dim that ``ep`` divides (JAX
    ``filter_spec_for_mesh`` drops it elsewhere); no leaf at ep = 1."""
    out = {}
    if ep <= 1:
        return out
    for name, shape in shapes.items():
        if len(shape) == 0:
            continue
        spec = next((sp for pattern, sp in rules
                     if re.search(pattern, name)), ())
        for dim, entry in enumerate(spec):
            axes = entry if isinstance(entry, tuple) else (entry,)
            if "ep" in axes and dim < len(shape) and shape[dim] % ep == 0:
                out[name] = dim
    return out


class ZeroShardingPlan:
    """Per leaf, the dim split over the ranks of its tree's axis set, or
    None, for the parameters (``param_dims``, stage 3), the gradients
    (``grad_dims``, stage >= 2) and the fp32 master and optimizer state
    (``master_dims``, stage >= 1); ``param_axes`` / ``state_axes`` and
    ``param_world`` / ``state_world`` name the mesh axes and the rank count
    of each (the gradients and the master take the state's). ``world`` is
    the full sharded-DP extent (fsdp x zps), ``inner`` its zps part;
    ``shapes`` maps leaf names to full shapes. ``ep_dims`` (name -> dim,
    :func:`ep_split_dims`) are split over ``ep`` ranks first: ``shapes``
    then become an ep coordinate's (``global_shapes`` keeps the given
    ones)."""

    def __init__(self, stage: int, world: int, shapes: dict, *,
                 inner: int = 1, hpz: bool = False, mics: bool = False,
                 ep: int = 1, ep_dims: dict | None = None):
        if stage not in (0, 1, 2, 3):
            raise ValueError(f"ZeRO stage must be 0-3, got {stage}")
        if (hpz or mics) and inner <= 1:
            raise ValueError(
                "hpZ/MiCS need the mesh's zps axis > 1 (set "
                "zero_hpz_partition_size / mics_shard_size in the config)")
        self.stage = stage
        self.world = world
        self.ep = ep
        self.ep_dims = dict(ep_dims or {})
        self.global_shapes = {n: tuple(s) for n, s in shapes.items()}
        self.shapes = {n: self.shard_shape(n, self.ep_dims.get(n), ep,
                                           self.global_shapes)
                       for n in self.global_shapes}
        self.param_axes = INNER_AXES if hpz or mics else FULL_AXES
        self.state_axes = INNER_AXES if mics else FULL_AXES
        self.param_world = inner if hpz or mics else world
        self.state_world = inner if mics else world
        g, taken = self.global_shapes, self.ep_dims.get
        state = {n: overlay_dim(g[n], self.state_world, taken=taken(n))
                 for n in g}
        param = (state if self.param_world == self.state_world else
                 {n: overlay_dim(g[n], self.param_world, taken=taken(n))
                  for n in g})
        none = dict.fromkeys(state)
        self.param_dims = param if stage >= 3 else none
        self.grad_dims = state if stage >= 2 else self.param_dims
        self.master_dims = state if stage >= 1 else self.param_dims

    def shard_shape(self, name: str, dim: int | None,
                    world: int | None = None,
                    shapes: dict | None = None) -> tuple[int, ...]:
        """The shape a rank holds of leaf ``name`` (of ``shapes``, default
        :attr:`shapes`) split on ``dim`` over ``world`` ranks (default:
        :attr:`world`)."""
        shape = list((self.shapes if shapes is None else shapes)[name])
        if dim is not None:
            shape[dim] //= self.world if world is None else world
        return tuple(shape)

    def param_shard_shape(self, name: str) -> tuple[int, ...]:
        return self.shard_shape(name, self.param_dims[name],
                                self.param_world)

    def state_shard_shape(self, name: str) -> tuple[int, ...]:
        return self.shard_shape(name, self.master_dims[name],
                                self.state_world)
