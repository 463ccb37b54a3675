"""The qgZ wire (counterpart of
``deepspeed_tpu/runtime/comm/coalesced_collectives.py``; reference:
runtime/comm/coalesced_collectives.py:31 all_to_all_quant_reduce).

- :func:`quantized_reduce_scatter` is ZeRO++'s one-hop quantized gradient
  reduce-scatter: the full-size local gradient is cut into one chunk per
  rank along the shard dim, each chunk block-quantized on its own
  (512-element blocks, one fp32 scale each; int8 with nearest or unbiased
  stochastic rounding, or fp8 e4m3), the codes and scales exchanged with
  one all-to-all each, and the received chunks dequantized and summed: a
  reduce-scatter at int8 wire width.
- :func:`hierarchical_quantized_reduce_scatter` is the two-hop form over
  an fsdp x zps shard group: hop 1 exchanges and sums the inner-minor
  chunks over the inner (zps) group, hop 2 re-quantizes the summed
  1/zps-sized partials and exchanges them over the outer (fsdp) group, so
  the outer hop carries 1/zps of the one-hop bytes and block scales never
  compound across hops.
- :func:`reduce_scatter_coalesced` and :func:`all_to_all_quant_reduce`
  are the list forms (flat, padded partitions).

Nearest int8 rounding quantizes through the hand-written kernel on CUDA
tensors (``ops/quantization.py``), and every int8 dequantize goes through
its kernel; the stochastic mode and the fp8 wire are torch ops, drawing
from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch

from ...comm import comm
from ...ops.quantization import (QBLOCK, wire_dequantize_rows,
                                 wire_quantize_rows, wire_view)

# call-site salts of the gradient wire (JAX _axis_key salts): the one-hop
# wire, and the two hops of the hierarchical wire
QGZ_SALT = 0x9C2
HOP1_SALT = 0x9C3
HOP2_SALT = 0x9C4


def _flat_padded(t: torch.Tensor, world: int, block: int = 1
                 ) -> torch.Tensor:
    """Flattened and zero-padded to a multiple of ``world * block``, so
    that every rank's chunk is a whole number of blocks."""
    flat = t.reshape(-1)
    pad = (-flat.numel()) % (int(world) * int(block))
    return torch.nn.functional.pad(flat, (0, pad)) if pad else flat


def wire_generator(step: int, rank: int, device, salt: int = QGZ_SALT
                   ) -> torch.Generator:
    """The stochastic wire's noise source on ``device``, seeded from the
    host step counter, the call-site ``salt`` and the rank, so no two ranks
    (and no two collectives of a step) share rounding noise (the JAX
    ``_axis_key``; the bits are torch's Philox, not threefry)."""
    seed = ((int(step) * 0x9E3779B1 + salt) * 0x85EBCA6B + rank) % (2 ** 63)
    return torch.Generator(device=device).manual_seed(seed)


def _quant_rows(rows: torch.Tensor, wire_dtype: str = "int8",
                rounding: str = "nearest", generator=None, use_kernel=None):
    """Each row of ``rows`` ``[n, c]`` block-quantized on its own -> (codes
    ``[n * nb, QBLOCK]``, scales ``[n * nb, 1]``): int8 (the kernel for
    nearest rounding on CUDA tensors) or fp8 (JAX ``_quant_rows``)."""
    return wire_quantize_rows(rows, wire_dtype, use_kernel, rounding,
                              generator)


def _all_to_all(codes: torch.Tensor, group) -> torch.Tensor:
    """Dim 0 exchanged over ``group``; fp8 codes cross as their bytes."""
    return comm.all_to_all_single(wire_view(codes), group=group).view(
        codes.dtype)


def _exchange_reduce(rows: torch.Tensor, group=None, rounding="nearest",
                     generator=None, use_kernel=None,
                     wire_dtype: str = "int8") -> torch.Tensor:
    """One hop: quantize ``rows`` ``[world, c]`` (row i for rank i),
    all-to-all the codes and scales, dequantize what arrived and sum it
    -> ``[c]`` fp32."""
    world, c = rows.shape
    # each row is quantized on its own (the JAX _quant_rows), so its
    # blocks are one rank's whole, equal slice of dim 0 of the codes
    q, s = _quant_rows(rows, wire_dtype, rounding, generator, use_kernel)
    qx = _all_to_all(q, group)
    sx = comm.all_to_all_single(s, group=group)
    deq = wire_dequantize_rows(qx, sx, world, c, torch.float32, use_kernel)
    return deq.sum(dim=0)


def quantized_reduce_scatter(g: torch.Tensor, dim: int, group=None,
                             rounding: str = "nearest", generator=None,
                             use_kernel=None, dtype=None,
                             wire_dtype: str = "int8") -> torch.Tensor:
    """qgZ: this rank's shard (along ``dim``) of the sum over ``group`` of
    the full-size local gradient ``g``, exchanged at int8 (or fp8) width;
    in ``dtype`` (default g's; the sum is fp32). ``rounding="stochastic"``
    needs ``generator`` (:func:`wire_generator`)."""
    world = comm.get_world_size(group)
    rows = comm.split_rows(g, world, dim)
    summed = _exchange_reduce(rows, group, rounding, generator, use_kernel,
                              wire_dtype)
    return summed.view(comm.chunk_shape(g.shape, world, dim)).to(
        dtype or g.dtype)


def hierarchical_quantized_reduce_scatter(
        g: torch.Tensor, dim: int, outer_group, inner_group,
        rounding: str = "nearest", generators=(None, None),
        use_kernel=None, dtype=None, wire_dtype: str = "int8"
        ) -> torch.Tensor:
    """Two-hop qgZ (JAX ``coalesced_collectives.py:158``): this rank's
    shard of the sum of ``g`` over the outer x inner ranks, the shard
    order outer-major, inner-minor along ``dim`` (the chunk this rank owns
    when the dim is split over fsdp x zps). Hop 1 quantizes the
    ``[outer * inner, c]`` chunks, exchanges each outer chunk's inner
    pieces over ``inner_group`` and sums them; hop 2 re-quantizes the
    ``[outer, c]`` partials and exchanges them over ``outer_group``.
    ``generators`` are the two hops' noise sources for stochastic
    rounding (:func:`wire_generator` with :data:`HOP1_SALT` and
    :data:`HOP2_SALT`)."""
    n_outer = comm.get_world_size(outer_group)
    n_inner = comm.get_world_size(inner_group)
    x = g.movedim(dim, 0)
    d, rest = x.shape[0], tuple(x.shape[1:])
    if d % (n_outer * n_inner):
        raise ValueError(f"dim {dim} of {tuple(g.shape)} does not split "
                         f"over {n_outer} x {n_inner} ranks")
    c = (d // (n_outer * n_inner)) * math.prod(rest)
    rows = x.reshape(n_outer * n_inner, c)
    q, s = _quant_rows(rows, wire_dtype, rounding, generators[0],
                       use_kernel)
    # [outer, inner, nb, QB] -> inner-major, so dim 0 is what each inner
    # rank receives: every outer chunk's piece for it
    nb = q.shape[0] // (n_outer * n_inner)
    q = q.view(n_outer, n_inner, nb, QBLOCK).transpose(0, 1).contiguous()
    s = s.view(n_outer, n_inner, nb, 1).transpose(0, 1).contiguous()
    qx = _all_to_all(q.view(-1, QBLOCK), inner_group)
    sx = comm.all_to_all_single(s.view(-1, 1), group=inner_group)
    deq = wire_dequantize_rows(qx, sx, n_inner * n_outer, c, torch.float32,
                               use_kernel)          # [inner(src) x outer, c]
    partial = deq.view(n_inner, n_outer, c).sum(dim=0)
    shard = _exchange_reduce(partial, outer_group, rounding, generators[1],
                             use_kernel, wire_dtype)
    out = shard.view((d // (n_outer * n_inner),) + rest).movedim(0, dim)
    return out.to(dtype or g.dtype)


def reduce_scatter_coalesced(tensors, group=None) -> list[torch.Tensor]:
    """Each tensor reduce-scattered over ``group``: this rank's flat
    partition of each, padded to the group size (reference:
    coalesced_collectives.py:81)."""
    world = comm.get_world_size(group)
    return [comm.reduce_scatter(_flat_padded(t, world), group=group)
            for t in tensors]


def all_to_all_quant_reduce(tensors, group=None, rounding: str = "nearest",
                            step: int = 0, use_kernel=None,
                            wire_dtype: str = "int8") -> list[torch.Tensor]:
    """qgZ over a tensor list: each tensor flat, padded to world x QBLOCK
    so every rank's partition is whole blocks, quantized-reduce-scattered;
    returns flat partitions as :func:`reduce_scatter_coalesced` (reference:
    coalesced_collectives.py:31). Stochastic rounding draws from one
    generator seeded from ``step`` and the rank."""
    world = comm.get_world_size(group)
    gen = None
    if rounding == "stochastic" and wire_dtype == "int8" and tensors:
        gen = wire_generator(step, comm.get_rank(group), tensors[0].device)
    return [quantized_reduce_scatter(_flat_padded(t, world, QBLOCK), 0,
                                     group, rounding, gen, use_kernel,
                                     wire_dtype=wire_dtype)
            for t in tensors]
