"""ZeRO-3's gathers and reductions with the ZeRO++ wire (counterpart of
``deepspeed_tpu/runtime/zeropp.py``; reference: partition_parameters.py:761
CUDAQuantizer for qwZ, coalesced_collectives.py:31 for qgZ).

The JAX package writes the step in explicit-SPMD form inside
``shard_map`` so that its weight all-gathers and gradient reduce-scatters
are its own collectives; the port's engine calls the same two halves
eagerly on ``torch.distributed`` process groups (``utils/groups.py``):

- :func:`gather_params`: each parameter split over the parameter group is
  reassembled from the ranks' shards, at int8 or fp8 width (qwZ,
  ``ops/quantization.quantized_all_gather``) for a shard of at least
  ``MIN_QUANT_SIZE`` elements when ``zero_quantized_weights`` is on, else
  exactly (``comm.all_gather``). On the two-hop wire
  (``zero_hierarchical_allgather``, a dim split over fsdp x zps) the inner
  zps hop gathers at full precision and the outer fsdp hop carries the
  inner-gathered tensor, quantized under qwZ (:func:`hierarchical_all_
  gather`).
- :func:`reduce_grads`: each full-size local fp32 gradient with a split
  dim is reduce-scattered to this rank's shard over the shard group, at
  int8 or fp8 width (qgZ, ``runtime/comm/coalesced_collectives``; the
  two-hop form on the hierarchical wire) for a gradient of at least
  ``4 * MIN_QUANT_SIZE`` elements when ``zero_quantized_gradients`` is on,
  else exactly; then all-reduced over the batch ranks that do not shard it
  (dp on a mixed mesh; fsdp and dp under MiCS). A leaf with no split dim
  is all-reduced over every batch rank. With ``mean`` every gradient is
  then divided by the number of batch ranks: on the ZeRO++ wire each
  rank's loss is the mean over its own rows, as JAX ``pmean``s the
  per-shard means there (``runtime/zeropp.py:213-236``). On the exact
  wire each rank's loss is its NLL sum over the global count of valid
  targets, JAX's mean over the global batch, and the sum is the answer.

On the exact wire the engine gathers and reduces a layer at a time
(JAX's scan over the layers, in which XLA gathers each layer's slice and
reduce-scatters its gradient inside the step that runs it):
:func:`gather_layers` gathers layer l of the split stacked leaves from
this rank's shards in one collective (started, so layer l+1's runs while
layer l computes: the engine's prefetch) and :func:`reduce_layers`
reduces layer l's gradients into the grad shards' layer in one, then
over the rest group; each is layer l of the whole-tree exact halves
above bit for bit at two ranks a group. The
ZeRO++ wires keep the whole tree, as JAX's ``shard_map`` body gathers it
before ``value_and_grad`` (``deepspeed_tpu/runtime/zeropp.py:215-219``)
and reduces the gradient tree after it (``:227-233``): their codes are
held to JAX's bit for bit, and whether a leaf is quantized depends on its
whole shard's size (``MIN_QUANT_SIZE``).

The wire applies to the pure sharded-DP meshes (tp = sp = pp = ep = 1);
on an ep mesh the engine warns and runs the exact collectives
(:func:`quantized_collectives_unsupported_reason`), as JAX's engine does.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..comm import comm
from ..ops.quantization import quantized_all_gather
from .comm.coalesced_collectives import (
    HOP1_SALT, HOP2_SALT, hierarchical_quantized_reduce_scatter,
    quantized_reduce_scatter, wire_generator)

# leaves smaller than this skip quantization: scales and padding are not
# worth it (JAX zeropp.py:64)
MIN_QUANT_SIZE = 2 ** 12
def hierarchical_all_gather(x: torch.Tensor, dim: int, outer_group,
                            inner_group, quantized: bool = False,
                            wire_dtype: str = "int8",
                            use_kernel=None) -> torch.Tensor:
    """Two-hop weight all-gather: over ``inner_group`` at full precision,
    then over ``outer_group``, quantized under qwZ. At full precision it
    is the one-hop gather bit for bit: the chunks stay outer-major,
    inner-minor (JAX ``zeropp.py:107``)."""
    x = comm.all_gather(x, group=inner_group, axis=dim)
    if quantized:
        return quantized_all_gather(x, dim, group=outer_group,
                                    use_kernel=use_kernel,
                                    wire_dtype=wire_dtype)
    return comm.all_gather(x, group=outer_group, axis=dim)


def _gather_param(x: torch.Tensor, dim: Optional[int], quantized: bool,
                  group=None, use_kernel=None, wire_dtype: str = "int8",
                  hierarchy=None) -> torch.Tensor:
    """The full parameter from this rank's shard ``x`` (split on ``dim``;
    None: ``x`` is the whole parameter). ``hierarchy`` is (outer group,
    inner group) on the two-hop wire."""
    if dim is None:
        return x
    quant = quantized and x.numel() >= MIN_QUANT_SIZE
    if hierarchy is not None:
        return hierarchical_all_gather(x, dim, *hierarchy, quantized=quant,
                                       wire_dtype=wire_dtype,
                                       use_kernel=use_kernel)
    if quant:
        return quantized_all_gather(x, dim, group=group,
                                    use_kernel=use_kernel,
                                    wire_dtype=wire_dtype)
    return comm.all_gather(x, group=group, axis=dim)


def _reduce_grad(g: torch.Tensor, dim: Optional[int], n_batch: int,
                 quantized: bool, group=None, rounding: str = "nearest",
                 generator=None, use_kernel=None,
                 mean: bool = True, wire_dtype: str = "int8",
                 hierarchy=None, batch_group=None, rest_group=None
                 ) -> torch.Tensor:
    """This rank's fp32 shard (split on ``dim`` over ``group``) of the
    batch ranks' mean (``mean``) or sum of the full-size local gradient
    ``g``; ``batch_group`` holds every batch rank (default ``group``),
    ``rest_group`` the batch ranks outside ``group`` (None: none). On the
    two-hop wire (``hierarchy``) a quantized gradient takes both hops
    (``generator`` then the hops' pair), an exact one the one-hop
    reduce-scatter, as in JAX."""
    if dim is not None:
        if quantized and g.numel() >= MIN_QUANT_SIZE * 4:
            if hierarchy is not None:
                g = hierarchical_quantized_reduce_scatter(
                    g, dim, *hierarchy, rounding=rounding,
                    generators=generator or (None, None),
                    use_kernel=use_kernel, dtype=torch.float32,
                    wire_dtype=wire_dtype)
            else:
                g = quantized_reduce_scatter(
                    g, dim, group=group, rounding=rounding,
                    generator=generator, use_kernel=use_kernel,
                    dtype=torch.float32, wire_dtype=wire_dtype)
        else:
            g = comm.reduce_scatter(g.float(), group=group, axis=dim)
        if rest_group is not None:
            g = comm.all_reduce(g.float().contiguous(), group=rest_group)
    elif n_batch > 1:
        g = comm.all_reduce(g.float().clone(), group=(
            group if batch_group is None else batch_group))
    return g.float() / n_batch if mean else g.float()


def gather_params(shards: dict, dims: dict, *, quantize_weights: bool,
                  group=None, use_kernel=None, wire_dtype: str = "int8",
                  hierarchy=None) -> dict:
    """name -> the full parameter, from this rank's shards and the plan's
    ``dims`` (``ZeroShardingPlan.param_dims``) over ``group`` (or the
    ``hierarchy``'s two hops)."""
    return {name: _gather_param(x, dims[name], quantize_weights, group,
                                use_kernel, wire_dtype, hierarchy)
            for name, x in shards.items()}


def reduce_grads(grads: dict, dims: dict, *, n_batch: int,
                 quantize_gradients: bool, rounding: str = "nearest",
                 step: int = 0, group=None, use_kernel=None,
                 mean: bool = True, wire_dtype: str = "int8",
                 hierarchy=None, batch_group=None, rest_group=None) -> dict:
    """name -> this rank's fp32 gradient shard (``dims``:
    ``ZeroShardingPlan.grad_dims``, split over ``group``). Stochastic
    int8 rounding draws from one generator seeded from ``step`` and the
    rank's index in ``group``, shared by the step's leaves in order (JAX
    keys one draw per leaf on the same step); the two-hop wire draws each
    hop from its own (JAX's salts 0x9c3 and 0x9c4)."""
    gen = None
    if quantize_gradients and rounding == "stochastic" \
            and wire_dtype == "int8" and grads:
        device = next(iter(grads.values())).device
        rank = comm.get_rank(group)
        gen = (tuple(wire_generator(step, rank, device, salt)
                     for salt in (HOP1_SALT, HOP2_SALT))
               if hierarchy is not None
               else wire_generator(step, rank, device))
    return {name: _reduce_grad(g, dims[name], n_batch, quantize_gradients,
                               group, rounding, gen, use_kernel, mean,
                               wire_dtype, hierarchy, batch_group,
                               rest_group)
            for name, g in grads.items()}


def _owner(layer: int, n_layers: int, group) -> tuple[int, int]:
    """(the group rank holding layer ``layer`` of a stack split on its
    layer dim, the layer's index in that rank's shard)."""
    return divmod(layer, n_layers // comm.get_world_size(group))


def gather_layers(shards: dict, dims: dict, layer: int, group=None
                  ) -> comm.Pending:
    """Layer ``layer`` of stacked ``[L, ...]`` parameters in full, from
    this rank's ``shards`` (name -> its shard, split on ``dims[name]``
    over ``group``), started (the exact wire; ``wait()`` gives name -> the
    layer, each in a storage of its own). The slices ``shard[layer]`` of
    the leaves split on dim > 0 go packed flat through one all-gather, so
    a layer costs one collective, and each leaf's part is assembled along
    its ``dim - 1``; a leaf split on dim 0, where each rank holds L / W
    whole layers, is broadcast from the rank holding the layer. Bit for
    bit layer ``layer`` of :func:`gather_params`' exact gather."""
    packed = [n for n in shards if dims[n]]
    slices = {n: shards[n][layer] for n in packed}
    flat = (comm.all_gather_async(
        torch.cat([slices[n].reshape(-1) for n in packed]), group)
        if packed else None)
    alone = {}
    for n in shards:
        if dims[n] is None:
            raise ValueError(f"{n}: gather_layers takes parameters split "
                             f"over group")
        if dims[n] == 0:
            shard = shards[n]
            owner, local = _owner(layer, shard.shape[0]
                                  * comm.get_world_size(group), group)
            buf = (shard[local].clone() if comm.get_rank(group) == owner
                   else torch.empty(shard.shape[1:], dtype=shard.dtype,
                                    device=shard.device))
            alone[n] = comm.broadcast_async(buf, owner, group)

    def result():
        out = {}
        if flat is not None:
            world = comm.get_world_size(group)
            rows = flat.wait().view(world, -1)
            off = 0
            for n in packed:
                shape, k = slices[n].shape, slices[n].numel()
                piece = rows[:, off:off + k].reshape(world, *shape)
                out[n] = comm.assemble(piece, dims[n] - 1)
                off += k
        out.update({n: h.wait() for n, h in alone.items()})
        return {n: out[n] for n in shards}

    return comm.Pending(None, result)


# the layer reduction packs its leaves' fp32 chunks into buffers of at most
# this many bytes, one reduce-scatter each (a layer of Mixtral-8x7B's
# experts is 3 GB in fp32; a GPT-2 layer's 28 MB takes one)
PACK_BYTES = 2 ** 28


def _buckets(names, nbytes: dict, limit: int) -> list[list]:
    """``names`` in order, cut into runs of at most ``limit`` bytes (a
    leaf larger than ``limit`` alone in its run)."""
    out, run, total = [], [], 0
    for n in names:
        if run and total + nbytes[n] > limit:
            out.append(run)
            run, total = [], 0
        run.append(n)
        total += nbytes[n]
    return out + ([run] if run else [])


def reduce_layers(grads: dict, dims: dict, layer: int, n_layers: int,
                  group=None, rest_group=None) -> dict:
    """This rank's fp32 part of the batch ranks' sum of layer ``layer``'s
    full local gradients ``grads`` (name -> the layer's gradient of a
    stacked leaf whose gradient is split on ``dims[name]`` over ``group``;
    the exact wire): those split on dim > 0 packed, in runs of at most
    :data:`PACK_BYTES` in fp32, into one reduce-scatter a run (each
    leaf's chunk along its ``dim - 1``), a dim-0 one reduced to the
    rank that holds the layer (None on the others); then the all-reduce
    over ``rest_group``, the batch ranks that hold the same shard (dp
    replicas; fsdp and dp under MiCS). Bit for bit layer ``layer`` of
    :func:`reduce_grads`' exact reduction at two ranks a group (a sum of
    two values has one order)."""
    world = comm.get_world_size(group)
    out = {}
    packed = [n for n in grads if dims[n]]
    cols = {n: grads[n].numel() // world for n in packed}
    for bucket in _buckets(packed, {n: 4 * world * cols[n] for n in packed},
                           PACK_BYTES):
        g0 = grads[bucket[0]]
        buf = torch.empty(world, sum(cols[n] for n in bucket),
                          dtype=torch.float32, device=g0.device)
        off = 0
        for n in bucket:            # each rank's chunk of each leaf, fp32
            shape, d = tuple(grads[n].shape), dims[n] - 1
            moved = (world,) + shape[:d] + (shape[d] // world,) + shape[d + 1:]
            buf[:, off:off + cols[n]].view(moved).copy_(grads[n].reshape(
                shape[:d] + (world, shape[d] // world) + shape[d + 1:]
            ).movedim(d, 0))
            off += cols[n]
        piece = comm.reduce_scatter(buf.view(-1), group)
        del buf
        if rest_group is not None:
            comm.all_reduce(piece, group=rest_group)
        off = 0
        for n in bucket:
            out[n] = piece[off:off + cols[n]].view(
                comm.chunk_shape(grads[n].shape, world, dims[n] - 1))
            off += cols[n]
    for n in grads:
        if dims[n] is None:
            raise ValueError(f"{n}: reduce_layers takes gradients split "
                             f"over group")
        if dims[n] == 0:
            owner, _ = _owner(layer, n_layers, group)
            mine = comm.reduce(grads[n].float().clone(), owner, group)
            out[n] = None
            if comm.get_rank(group) == owner:
                if rest_group is not None:
                    comm.all_reduce(mine, group=rest_group)
                out[n] = mine
    return {n: out[n] for n in grads}


def quantized_collectives_unsupported_reason(sizes: dict
                                            ) -> Optional[str]:
    """None when qwZ/qgZ apply to a mesh of axis ``sizes``, else the
    constraint that fails (JAX ``zeropp.py:310``, its message)."""
    bad = {a: int(sizes.get(a, 1)) for a in ("tp", "sp", "pp", "ep")
           if sizes.get(a, 1) > 1}
    if not bad:
        return None
    axes = ", ".join(f"{a}={n}" for a, n in sorted(bad.items()))
    return (
        "quantized collectives (zero_quantized_weights/gradients) "
        "require a pure sharded-DP mesh — every model-parallel axis "
        f"must be 1, but this mesh has {axes}. Those axes' collectives "
        "live inside the model forward where the explicit-SPMD wire "
        "protocol cannot intercept them (ZeRO++ is a ZeRO-3 "
        "data-parallel feature). Drop the quantization flags or set "
        f"mesh.{{{'/'.join(sorted(bad))}}} to 1.")


def hierarchical_allgather_unsupported_reason(
        sizes: dict, hpz: bool = False, mics: bool = False) -> Optional[str]:
    """None when the two-hop fsdp x zps collectives apply to a mesh of
    axis ``sizes``, else the failing constraint (JAX ``zeropp.py:334``,
    its messages)."""
    zps = int(sizes.get("zps", 1))
    fsdp = int(sizes.get("fsdp", 1))
    if zps <= 1:
        return ("zero_hierarchical_allgather requires the mesh's zps "
                f"axis > 1 (got zps={zps}); set mesh.zps (the MiCS-"
                "style fsdp×zps split) so the two-hop collectives have "
                "an inner group to gather over")
    if fsdp <= 1:
        return ("zero_hierarchical_allgather requires an outer fsdp "
                f"axis > 1 alongside zps={zps} (got fsdp={fsdp}); with "
                "a single outer group there is no slow-link hop to "
                "save")
    if hpz or mics:
        which = "zero_hpz_partition_size" if hpz else "mics_shard_size"
        return (f"zero_hierarchical_allgather is incompatible with "
                f"{which}: hpZ/MiCS already replicate parameters "
                "across fsdp (sharding only over zps), so weight "
                "gathers never touch the slow links — the two-hop "
                "gather needs params sharded over the full fsdp×zps "
                "extent")
    return None
