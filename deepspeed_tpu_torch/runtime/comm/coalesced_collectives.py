"""The qgZ wire (counterpart of
``deepspeed_tpu/runtime/comm/coalesced_collectives.py``; reference:
runtime/comm/coalesced_collectives.py:31 all_to_all_quant_reduce).

:func:`quantized_reduce_scatter` is ZeRO++'s one-hop quantized gradient
reduce-scatter: the full-size local gradient is cut into one chunk per
rank along the shard dim, each chunk block-quantized to int8 on its own
(512-element blocks, one fp32 scale each, nearest or unbiased stochastic
rounding), the codes and scales exchanged with one all-to-all each, and
the received chunks dequantized and summed: a reduce-scatter at int8
wire width. Nearest rounding quantizes through the hand-written kernel
on CUDA tensors (``ops/quantization.py``); the stochastic mode is torch
ops drawing from an explicit ``torch.Generator``. The hierarchical
two-hop form waits with hpZ (ROADMAP Slice D item 11).
"""

from __future__ import annotations

import torch

from ...comm import comm
from ...ops.quantization import dequantize_rows, quantize_rows

# call-site salt of the one-hop gradient wire (JAX _axis_key salt 0x9c2)
QGZ_SALT = 0x9C2


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


def _exchange_reduce(rows: torch.Tensor, group=None, rounding="nearest",
                     generator=None, use_kernel=None) -> torch.Tensor:
    """One hop: quantize ``rows`` ``[world, c]`` (row i for rank i),
    all-to-all the codes and scales, dequantize what arrived and sum it
    -> ``[c]`` fp32."""
    world, c = rows.shape
    # each row is quantized on its own (the JAX _quant_rows), so its
    # blocks are one rank's whole, equal slice of dim 0 of the codes
    q, s = quantize_rows(rows, use_kernel, rounding, generator)
    qx = comm.all_to_all_single(q, group=group)
    sx = comm.all_to_all_single(s, group=group)
    deq = dequantize_rows(qx, sx, world, c, torch.float32, use_kernel)
    return deq.sum(dim=0)


def quantized_reduce_scatter(g: torch.Tensor, dim: int, group=None,
                             rounding: str = "nearest", generator=None,
                             use_kernel=None, dtype=None) -> torch.Tensor:
    """qgZ: this rank's shard (along ``dim``) of the sum over ``group`` of
    the full-size local gradient ``g``, exchanged at int8 width; in
    ``dtype`` (default g's; the sum is fp32). ``rounding="stochastic"``
    needs ``generator`` (:func:`wire_generator`)."""
    world = comm.get_world_size(group)
    rows = comm.split_rows(g, world, dim)
    summed = _exchange_reduce(rows, group, rounding, generator, use_kernel)
    return summed.view(comm.chunk_shape(g.shape, world, dim)).to(
        dtype or g.dtype)
