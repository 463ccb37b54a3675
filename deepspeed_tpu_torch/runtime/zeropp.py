"""ZeRO-3's gathers and reductions with the ZeRO++ wire (counterpart of
``deepspeed_tpu/runtime/zeropp.py``; reference: partition_parameters.py:761
CUDAQuantizer for qwZ, coalesced_collectives.py:31 for qgZ).

The JAX package writes the step in explicit-SPMD form inside
``shard_map`` so that its weight all-gathers and gradient reduce-scatters
are its own collectives; the port's engine calls the same two halves
eagerly on ``torch.distributed``:

- :func:`gather_params`: each parameter split over the fsdp ranks is
  reassembled from the ranks' shards, at int8 width (qwZ,
  ``ops/quantization.quantized_all_gather``) for a shard of at least
  ``MIN_QUANT_SIZE`` elements when ``zero_quantized_weights`` is on, else
  exactly (``comm.all_gather``);
- :func:`reduce_grads`: each full-size local fp32 gradient with a split dim
  is reduce-scattered to this rank's shard, at int8 width (qgZ,
  ``runtime/comm/coalesced_collectives.quantized_reduce_scatter``) for a
  gradient of at least ``4 * MIN_QUANT_SIZE`` elements when
  ``zero_quantized_gradients`` is on, else exactly; a leaf with no split
  dim is all-reduced over the batch ranks. With ``mean`` every gradient is
  then divided by the number of batch ranks: on the ZeRO++ wire each
  rank's loss is the mean over its own rows, as JAX ``pmean``s the
  per-shard means there (``runtime/zeropp.py:213-236``). On the exact
  wire each rank's loss is its NLL sum over the global count of valid
  targets, JAX's mean over the global batch, and the sum is the answer.

The wire applies to the pure sharded-DP meshes (tp = sp = pp = ep = 1),
the only ones the port runs (``parallel/mesh.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..comm import comm
from ..ops.quantization import quantized_all_gather
from .comm.coalesced_collectives import (quantized_reduce_scatter,
                                         wire_generator)

# leaves smaller than this skip quantization: scales and padding are not
# worth it (JAX zeropp.py:64)
MIN_QUANT_SIZE = 2 ** 12


def _gather_param(x: torch.Tensor, dim: Optional[int], quantized: bool,
                  group=None, use_kernel=None) -> torch.Tensor:
    """The full parameter from this rank's shard ``x`` (split on ``dim``;
    None: ``x`` is the whole parameter)."""
    if dim is None:
        return x
    if quantized and x.numel() >= MIN_QUANT_SIZE:
        return quantized_all_gather(x, dim, group=group,
                                    use_kernel=use_kernel)
    return comm.all_gather(x, group=group, axis=dim)


def _reduce_grad(g: torch.Tensor, dim: Optional[int], n_batch: int,
                 quantized: bool, group=None, rounding: str = "nearest",
                 generator=None, use_kernel=None,
                 mean: bool = True) -> torch.Tensor:
    """This rank's fp32 shard (split on ``dim``) of the batch ranks' mean
    (``mean``) or sum of the full-size local gradient ``g``."""
    if dim is not None:
        if quantized and g.numel() >= MIN_QUANT_SIZE * 4:
            g = quantized_reduce_scatter(
                g, dim, group=group, rounding=rounding, generator=generator,
                use_kernel=use_kernel, dtype=torch.float32)
        else:
            g = comm.reduce_scatter(g.float(), group=group, axis=dim)
    elif n_batch > 1:
        g = comm.all_reduce(g.float().clone(), group=group)
    return g.float() / n_batch if mean else g.float()


def gather_params(shards: dict, dims: dict, *, quantize_weights: bool,
                  group=None, use_kernel=None) -> dict:
    """name -> the full parameter, from this rank's shards and the plan's
    ``dims`` (``ZeroShardingPlan.param_dims``)."""
    return {name: _gather_param(x, dims[name], quantize_weights, group,
                                use_kernel)
            for name, x in shards.items()}


def reduce_grads(grads: dict, dims: dict, *, n_batch: int,
                 quantize_gradients: bool, rounding: str = "nearest",
                 step: int = 0, group=None, use_kernel=None,
                 mean: bool = True) -> dict:
    """name -> this rank's fp32 gradient shard (``dims``:
    ``ZeroShardingPlan.grad_dims``). Stochastic rounding draws from one
    generator seeded from ``step`` and the rank, shared by the step's
    leaves in order (JAX keys one draw per leaf on the same step)."""
    gen = None
    if quantize_gradients and rounding == "stochastic":
        first = next(iter(grads.values()))
        gen = wire_generator(step, comm.get_rank(group), first.device)
    return {name: _reduce_grad(g, dims[name], n_batch, quantize_gradients,
                               group, rounding, gen, use_kernel, mean)
            for name, g in grads.items()}
