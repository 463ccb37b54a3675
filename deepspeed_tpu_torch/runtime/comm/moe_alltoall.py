"""The MoE dispatch/combine exchange (counterpart of
``deepspeed_tpu/runtime/comm/moe_alltoall.py``; reference:
deepspeed/moe/sharded_moe.py _AllToAll and the ZeRO++ qgZ wire of
coalesced_collectives.py).

Gating is global, so every token shard holds a partial dispatch table
``[E_local, C, D]`` over the whole capacity range of its experts: slot
``(e, c)`` holds a token only where one of this rank's tokens claimed it.
Summing those partials over the token ranks while scattering the capacity
dim is the dispatch all-to-all (an all-to-all and a local sum, which is
how qgZ lowers a reduce-scatter): :func:`moe_dispatch_exchange`. The
combine direction is its transpose, an all-gather of the experts' output
slots back to the full capacity on every token rank:
:func:`moe_combine_exchange`.

Wires of the dispatch (``moe.wire_dtype``): ``fp32`` the exact
reduce-scatter in the partial's dtype, ``bf16`` the reduce-scatter in
bf16, ``int8`` / ``fp8`` the qgZ block-quantized reduce-scatter
(``coalesced_collectives.quantized_reduce_scatter``), or its two-hop form
(``hierarchical_quantized_reduce_scatter``: the zps hop first, then dp /
fsdp on the 1/zps partials) where both the slow and the fast token axes
are live. The quantized wire has no useful gradient (the rounding), so it
is a ``torch.autograd.Function`` whose backward is the transpose of the
exact exchange, the all-gather of the shard's gradient at full width: the
straight-through estimator, as JAX's ``custom_vjp``. The fp32 and bf16
wires and the combine are differentiated through their own transposes
(``comm.reduce_scatter_to_group`` / ``gather_from_group``), bf16 gradients
crossing in bf16 as JAX's do. The combine crosses in bf16 only on the bf16
wire; the int8 protocol covers the dispatched activations alone.

Chunk order is outer-major, inner-minor over the token axes (the rank's
index over dp, fsdp, zps), so dispatch and combine invert each other.
Stochastic int8 rounding draws from ``wire_generator`` under this site's
salts, seeded by the training step (``moe/dispatch.py`` ``current_step``)
and the rank's index in the token group.
"""

from __future__ import annotations

import torch

from ...comm import comm
from .coalesced_collectives import (hierarchical_quantized_reduce_scatter,
                                    quantized_reduce_scatter, wire_generator)

MOE_WIRE_DTYPES = ("fp32", "bf16", "int8", "fp8")
# call-site salts of the dispatch wire: the one-hop wire, the two hops
MOE_SALT = 0x9C5
MOE_HOP1_SALT = 0x9C6
MOE_HOP2_SALT = 0x9C7


def _generators(step: int, rank: int, device, two_hop: bool):
    if two_hop:
        return tuple(wire_generator(step, rank, device, salt)
                     for salt in (MOE_HOP1_SALT, MOE_HOP2_SALT))
    return wire_generator(step, rank, device, MOE_SALT)


class _QuantizedDispatch(torch.autograd.Function):
    """The int8/fp8 reduce-scatter forward, the exact all-gather of the
    shard's gradient backward (straight-through)."""

    @staticmethod
    def forward(ctx, partial, group, dim, hierarchy, wire_dtype, rounding,
                step):
        ctx.group, ctx.dim = group, dim
        gen = None
        if rounding == "stochastic" and wire_dtype == "int8":
            gen = _generators(step, comm.get_rank(group), partial.device,
                              hierarchy is not None)
        if hierarchy is not None:
            return hierarchical_quantized_reduce_scatter(
                partial, dim, *hierarchy, rounding=rounding,
                generators=gen or (None, None), dtype=partial.dtype,
                wire_dtype=wire_dtype)
        return quantized_reduce_scatter(
            partial, dim, group=group, rounding=rounding, generator=gen,
            dtype=partial.dtype, wire_dtype=wire_dtype)

    @staticmethod
    def backward(ctx, grad):
        return (comm.all_gather(grad, group=ctx.group, axis=ctx.dim),
                None, None, None, None, None, None)


def moe_dispatch_exchange(partial: torch.Tensor, group, dim: int = 1,
                          wire_dtype: str = "fp32",
                          rounding: str = "stochastic", step: int = 0,
                          hierarchy=None) -> torch.Tensor:
    """Sum the token ranks' partial dispatch tables ``[E_local, C, D]``
    over ``group`` (every token rank, in the order of their index over the
    token axes) and keep this rank's ``C / world`` slice of ``dim``. ``C``
    must be a multiple of the group's size (the caller pads). ``hierarchy``
    (outer group over dp / fsdp, inner group over zps) takes the two-hop
    form on the int8 and fp8 wires; ``step`` seeds stochastic rounding."""
    if comm.get_world_size(group) == 1:
        return partial
    if wire_dtype in ("int8", "fp8"):
        return _QuantizedDispatch.apply(partial, group, dim, hierarchy,
                                        wire_dtype, rounding, int(step))
    if wire_dtype == "bf16":
        return comm.reduce_scatter_to_group(
            partial.to(torch.bfloat16), group, dim).to(partial.dtype)
    if wire_dtype != "fp32":
        raise ValueError(f"unknown moe wire_dtype {wire_dtype!r}; expected "
                         f"one of {MOE_WIRE_DTYPES}")
    return comm.reduce_scatter_to_group(partial, group, dim)


def moe_combine_exchange(shard: torch.Tensor, group, dim: int = 1,
                         wire_dtype: str = "fp32") -> torch.Tensor:
    """The combine direction: the experts' output slots all-gathered along
    ``dim`` back to the full capacity on every token rank (the transpose
    of :func:`moe_dispatch_exchange`'s chunk order; its gradient the sum
    reduce-scatter). ``"bf16"`` halves the bytes; any other wire gathers
    in the shard's dtype."""
    if comm.get_world_size(group) == 1:
        return shard
    x = shard.to(torch.bfloat16) if wire_dtype == "bf16" else shard
    return comm.gather_from_group(x, group, dim).to(shard.dtype)
