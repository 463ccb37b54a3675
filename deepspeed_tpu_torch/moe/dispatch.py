"""Expert-parallel MoE dispatch (counterpart of
``deepspeed_tpu/moe/dispatch.py``; reference: deepspeed/moe/sharded_moe.py
_AllToAll and the expert groups of utils/groups.py).

:class:`EpShardedDispatcher` is what the training engine binds to an MoE
model across ranks (``moe_dispatcher``). The ranks of one ``ep``
coordinate split the batch over the token axes (dp, fsdp, zps); the ranks
of one token coordinate hold the same rows and split the experts over
``ep``. Per MoE block, each rank:

1. gathers the router logits of every token rank (:meth:`global_logits`),
   so that routing runs once on the global ``[N, E]`` logits, identically
   on every rank: capacity from the global N, positions from the global
   token order, as JAX gates the global batch (its gradient is the sum
   reduce-scatter, the gather's transpose);
2. builds its partial dispatch table from its own rows' choices of its
   ``E / ep`` experts, ``[E_local, C_pad, D]`` with the capacity padded to
   a multiple of the token world;
3. exchanges it (``runtime/comm/moe_alltoall.py`` ``moe_dispatch_
   exchange``: a sum reduce-scatter of the capacity dim over the token
   ranks, at fp32, bf16, int8 or fp8, two hops where slow and fast token
   axes are both live), runs its experts on its ``C_pad / token_world``
   slots and gathers them back (``moe_combine_exchange``);
4. combines its rows' choices of its experts with their gate weights and
   sums the block output over the ep group.

The ranks of an ep group hold the same tokens and compute the same
attention, norms and router; only the dispatch and the combine are split
by expert. So the rows and the gate weights entering them sum their
gradients over the ep group (``comm.copy_to_group``), and the closing sum
over ep passes its gradient as it is (``comm.reduce_from_group``): every
gradient is the true one of the global loss, and a use that is not split
(the router's aux loss, the attention) is not summed.

The stochastic wire's rounding noise is seeded by the training step,
which the engine binds around each micro-batch's forward and backward
with :func:`moe_step` (a contextvar, read by :func:`current_step`).
``publish_router_metrics`` (JAX's router telemetry) belongs to ROADMAP
Slice G item 15 and is not ported.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Callable

import torch

from ..comm import comm
from ..parallel.mesh import BATCH_AXES
from ..runtime.comm.moe_alltoall import (moe_combine_exchange,
                                         moe_dispatch_exchange)
from ..utils import groups

_MOE_STEP: contextvars.ContextVar = contextvars.ContextVar(
    "moe_step", default=None)


@contextlib.contextmanager
def moe_step(step):
    """Bind the training step for the stochastic dispatch wire's noise
    while the block runs (the engine: around a micro-batch's forward and
    its backward, whose checkpoint recompute reruns the exchange)."""
    token = _MOE_STEP.set(step)
    try:
        yield
    finally:
        _MOE_STEP.reset(token)


def current_step() -> int:
    """The bound step (0 outside any :func:`moe_step`: evaluation,
    serving)."""
    s = _MOE_STEP.get()
    return 0 if s is None else int(s)


def dispatcher_unsupported_reason(topology, num_experts: int):
    """None when the ep-sharded dispatcher can run on this topology, else
    the reason (JAX's messages)."""
    sizes = topology.sizes
    if sizes.get("tp", 1) > 1:
        return ("mesh.tp > 1: expert weights are tp-sharded inside the "
                "dispatcher's expert shard; the explicit exchange only "
                "covers the token axes")
    if sizes.get("sp", 1) > 1:
        return ("mesh.sp > 1: Ulysses/ring resharding conflicts with "
                "the dispatcher's token-axis reduce-scatter layout")
    if sizes.get("pp", 1) > 1:
        return "mesh.pp > 1: pipeline stages wrap the model differently"
    ep = sizes.get("ep", 1)
    if ep > 1 and (num_experts <= 0 or num_experts % ep != 0):
        return (f"num_experts={num_experts} is not divisible by "
                f"mesh.ep={ep}")
    return None


@dataclasses.dataclass(eq=False)
class EpShardedDispatcher:
    """The dispatch/combine exchange of one rank. ``token_axes``: the live
    batch axes, split into ``slow_axes`` (dp, fsdp) and ``fast_axes``
    (zps) for the two-hop wire; ``token_world`` / ``token_index``: their
    rank count and this rank's index over them (its rows' chunk of the
    global batch); ``ep_world`` / ``ep_index``: the expert split (1 / 0
    where the experts are replicated over ep); the process groups over
    the token axes, over each hop and over ep."""

    token_axes: tuple
    slow_axes: tuple
    fast_axes: tuple
    token_world: int
    token_index: int
    ep_world: int
    ep_index: int
    token_group: Any = None
    hierarchy: Any = None
    ep_group: Any = None
    wire_dtype: str = "fp32"
    rounding: str = "stochastic"

    @classmethod
    def for_topology(cls, topology, wire_dtype: str = "fp32",
                     rounding: str = "stochastic", split_experts=True):
        """The dispatcher of this rank of ``topology``; with
        ``split_experts`` False every rank holds every expert (an ep that
        does not divide E). Makes its process groups: every rank calls
        it, in the same order."""
        sizes = topology.sizes
        live = tuple(a for a in BATCH_AXES if sizes[a] > 1)
        slow = tuple(a for a in live if a != "zps")
        fast = tuple(a for a in live if a == "zps")
        token_group = groups.axis_group(BATCH_AXES, topology)
        hierarchy = ((groups.axis_group(slow, topology),
                      groups.axis_group(fast, topology))
                     if slow and fast else None)
        ep = sizes["ep"] if split_experts else 1
        ep_group = (groups.axis_group(groups.EXPERT_PARALLEL_GROUP,
                                      topology) if ep > 1 else None)
        return cls(token_axes=live, slow_axes=slow, fast_axes=fast,
                   token_world=topology.axis_size(BATCH_AXES),
                   token_index=topology.axis_index(BATCH_AXES),
                   ep_world=ep,
                   ep_index=topology.coordinates()["ep"] if ep > 1 else 0,
                   token_group=token_group, hierarchy=hierarchy,
                   ep_group=ep_group, wire_dtype=wire_dtype,
                   rounding=rounding)

    def global_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """This rank's router logits ``[n, E]`` -> every token rank's,
        ``[N, E]`` in global token order; the gradient summed back."""
        return comm.gather_from_group(logits, self.token_group, 0)

    def local_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global ``[N, ...]`` routing tensor."""
        n = t.shape[0] // self.token_world
        return t[self.token_index * n:(self.token_index + 1) * n]

    def __call__(self, xt: torch.Tensor, routing, experts: dict,
                 expert_fn: Callable) -> torch.Tensor:
        """The MoE output ``[n, D]`` of this rank's rows ``xt``, from
        ``routing`` (``idx``, ``pos``, ``keep``, ``gate`` of these rows,
        ``[n, k]``, computed on the global batch; ``capacity`` global) and
        this rank's experts (``[E / ep_world, ...]`` each)."""
        n, d = xt.shape
        k = routing.idx.shape[1]
        e_loc = next(iter(experts.values())).shape[0]
        e0 = self.ep_index * e_loc
        t = self.token_world
        c_pad = -(-routing.capacity // t) * t
        gate = routing.gate.to(xt.dtype)
        if self.ep_world > 1:
            xt = comm.copy_to_group(xt, self.ep_group)
            gate = comm.copy_to_group(gate, self.ep_group)
        mine = routing.keep & (routing.idx >= e0) & (routing.idx < e0 + e_loc)
        # a choice of another rank's expert, or dropped, goes to the last
        # row, past this rank's slots (zero in the combine)
        row = torch.where(mine, (routing.idx - e0) * c_pad + routing.pos,
                          torch.full_like(routing.idx, e_loc * c_pad)
                          ).reshape(-1)
        table = xt.new_zeros(e_loc * c_pad + 1, d).index_put(
            (row,), xt[:, None, :].expand(n, k, d).reshape(n * k, d))
        partial = table[:e_loc * c_pad].view(e_loc, c_pad, d)
        shard = moe_dispatch_exchange(
            partial, self.token_group, 1, wire_dtype=self.wire_dtype,
            rounding=self.rounding, step=current_step(),
            hierarchy=self.hierarchy)
        h = expert_fn(shard, experts)
        full = moe_combine_exchange(
            h, self.token_group, 1,
            wire_dtype="bf16" if self.wire_dtype == "bf16" else "fp32")
        slots = torch.cat([full.reshape(e_loc * c_pad, d),
                           full.new_zeros(1, d)])
        out = torch.bmm(gate[:, None, :], slots[row].view(n, k, d))[:, 0]
        if self.ep_world == 1:
            return out
        # each ep rank combined a disjoint expert slice: their sum is the
        # block output on every rank
        return comm.reduce_from_group(out, self.ep_group)
