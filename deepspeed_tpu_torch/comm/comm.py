"""Communication facade (counterpart of ``deepspeed_tpu/comm/comm.py``;
reference: deepspeed/comm/comm.py) on ``torch.distributed``.

The JAX module names mesh axes as its groups and runs its collectives
inside ``shard_map``; here a group is a ``torch.distributed`` process
group (``None`` = the world; :func:`new_group` makes the subgroups of a
mesh's axes, ``utils/groups.py`` names them) and every collective is an
eager call that
returns a new tensor (or, for :func:`all_reduce`, reduces in place), with
the JAX module's semantics: :func:`all_gather` tiles the ranks' pieces
along an axis, :func:`reduce_scatter` splits along one, and
:func:`all_to_all_single` splits dim 0 equally. Outside a process group (world size 1) every
collective is the identity.

:func:`all_gather_async` and :func:`broadcast_async` start the
collective and return a :class:`Pending` whose ``wait()`` gives the
result: ZeRO-3's per-layer prefetch issues layer l+1's gathers before
layer l computes. On gloo the work runs on the process group's own
threads; on NCCL on the process group's stream, which ``wait()`` makes
the caller's stream wait on through an event, and the process group
records the buffers on that stream, so neither is freed while the
collective reads or writes it. Every rank must issue its collectives on a
group in the same order (gloo and NCCL match them by that order).

The backend is explicit: ``nccl`` by default where a card is present, as
in DeepSpeed, ``gloo`` on request or without a card. gloo takes CUDA
tensors for every collective here (torch 2.11 on the H100, checked on the
card) and moves them through the host itself; the backend is never
switched behind the caller's back. ``timed_op`` and the comms logger
belong to the tooling slice (ROADMAP Slice G).

Four collectives carry their transposes for autograd, as JAX
differentiates its collectives inside ``shard_map``: :func:`copy_to_group`
(the identity; its backward sums the gradient over the group: a tensor
the group holds alike whose uses the ranks split),
:func:`reduce_from_group` (a sum over the group; its backward the
identity), :func:`gather_from_group` (an all-gather along a dim; its
backward the sum reduce-scatter) and :func:`reduce_scatter_to_group` (a
sum reduce-scatter along a dim; its backward the all-gather). Each runs its
collective in the tensor's own dtype.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ..utils.logging import log_dist


class ReduceOp:
    SUM = "sum"
    AVG = "avg"
    MAX = "max"
    MIN = "min"
    PRODUCT = "prod"


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
              ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT}

def init_distributed(dist_backend: str | None = None,
                     init_method: str | None = None,
                     rank: int | None = None,
                     world_size: int | None = None,
                     timeout: float | None = None,
                     dist_init_required: bool | None = None,
                     config=None, **_unused) -> None:
    """Join the process group (reference: comm.py:619 init_distributed).

    Rank and world size come from the arguments, else from the launcher's
    environment (``RANK``/``WORLD_SIZE``, as torchrun sets them, with
    ``MASTER_ADDR``/``MASTER_PORT`` for the default ``env://`` rendezvous).
    ``init_method`` passes through (``file://...`` for a file store).
    ``dist_backend`` defaults to ``"nccl"`` where a card is present and to
    ``"gloo"`` otherwise. A second call is a no-op."""
    if is_initialized() or dist_init_required is False:
        return
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = (int(os.environ.get("WORLD_SIZE", 1)) if world_size is None
                  else world_size)
    backend = dist_backend or ("nccl" if torch.cuda.is_available()
                               else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(get_local_rank() % torch.cuda.device_count())
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size, **kwargs)
    log_dist(f"deepspeed_tpu_torch.comm initialized: backend={backend} "
             f"rank={rank} world={world_size}", ranks=[0])


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank(group=None) -> int:
    return dist.get_rank(group) if is_initialized() else 0


def get_world_size(group=None) -> int:
    return dist.get_world_size(group) if is_initialized() else 1


def get_local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def new_group(partition: list[list[int]]):
    """The process group of this rank among ``partition``, disjoint rank
    lists that cover the world (reference: comm.py new_group). Every rank
    must call it with the same partition in the same order: each list
    becomes a group on every rank, also on the ranks it does not hold,
    since gloo and NCCL name a group by the order of creation and a rank
    that skips one waits for the others forever. A list of every rank is
    the world group itself; outside a process group, None (the world of
    one)."""
    if not is_initialized():
        return None
    rank, world = dist.get_rank(), dist.get_world_size()
    if sorted(r for ranks in partition for r in ranks) != list(range(world)):
        raise ValueError(f"groups {partition} do not cover the {world} "
                         f"ranks once each")
    mine = None
    for ranks in partition:
        if len(ranks) == world:
            return dist.group.WORLD
        group = dist.new_group(sorted(ranks))
        if rank in ranks:
            mine = group
    return mine


def assemble(pieces: torch.Tensor, dim: int) -> torch.Tensor:
    """``[world, *piece]`` -> the pieces concatenated along ``dim`` in rank
    order (a view when ``dim`` is 0)."""
    world, piece = pieces.shape[0], pieces.shape[1:]
    full = list(piece)
    full[dim] *= world
    if dim == 0:
        return pieces.reshape(full)
    return pieces.movedim(0, dim).reshape(full)


def split_rows(tensor: torch.Tensor, world: int, dim: int) -> torch.Tensor:
    """``tensor`` cut into ``world`` equal chunks along ``dim`` ->
    ``[world, chunk numel]`` contiguous (a view when ``dim`` is 0), row i
    the chunk of rank i (``jnp.split(x, world, axis=dim)`` stacked)."""
    shape = tensor.shape
    if shape[dim] % world:
        raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                         f"over {world} ranks")
    split = shape[:dim] + (world, shape[dim] // world) + shape[dim + 1:]
    rows = tensor.reshape(split).movedim(dim, 0)
    return rows.contiguous().view(world, -1)


def chunk_shape(shape, world: int, dim: int) -> tuple[int, ...]:
    out = list(shape)
    out[dim] //= world
    return tuple(out)


# --- collectives (reference: comm.py / torch.py wrappers) ---------------
def all_reduce(tensor: torch.Tensor, op: str = ReduceOp.SUM, group=None
               ) -> torch.Tensor:
    """In place over ``group``; ``AVG`` is a sum divided by the world size
    (gloo has no average)."""
    world = get_world_size(group)
    if world == 1:
        return tensor
    top = _TORCH_OPS[ReduceOp.SUM if op == ReduceOp.AVG else op]
    dist.all_reduce(tensor, op=top, group=group)
    if op == ReduceOp.AVG:
        tensor.div_(world)
    return tensor


def _gather_fn():
    return getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor


def _reduce_scatter_fn():
    return getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor


def all_gather(tensor: torch.Tensor, group=None, axis: int = 0
               ) -> torch.Tensor:
    """Every rank's ``tensor`` concatenated along ``axis`` in rank order
    (``all_gather_into_tensor``; JAX ``all_gather(tiled=True)``)."""
    world = get_world_size(group)
    if world == 1:
        return tensor
    src = tensor.contiguous()
    out = torch.empty(world * src.numel(), dtype=src.dtype,
                      device=src.device)
    _gather_fn()(out, src.view(-1), group=group)
    return assemble(out.view(world, *src.shape), axis)


def reduce_scatter(tensor: torch.Tensor, group=None, axis: int = 0,
                   op: str = ReduceOp.SUM) -> torch.Tensor:
    """Sum over ``group`` of ``tensor``, and this rank's chunk of it along
    ``axis`` (``reduce_scatter_tensor``; JAX ``psum_scatter(tiled=True)``).
    ``AVG`` divides the sum by the world size."""
    world = get_world_size(group)
    if world == 1:
        return tensor
    if op not in (ReduceOp.SUM, ReduceOp.AVG):
        raise ValueError(f"reduce_scatter: unsupported op {op!r}")
    rows = split_rows(tensor, world, axis)
    out = torch.empty(rows.shape[1], dtype=rows.dtype, device=rows.device)
    _reduce_scatter_fn()(out, rows.view(-1), group=group)
    if op == ReduceOp.AVG:
        out.div_(world)
    return out.view(chunk_shape(tensor.shape, world, axis))


def all_to_all_single(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Dim 0 split into ``world`` equal chunks; chunk i goes to rank i,
    and the result stacks what every rank sent here in rank order (JAX
    ``all_to_all(split_axis=0, concat_axis=0, tiled=True)``)."""
    if get_world_size(group) == 1:
        return tensor
    src = tensor.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out


def broadcast(tensor: torch.Tensor, src: int = 0, group=None
              ) -> torch.Tensor:
    """In place from rank ``src``."""
    if get_world_size(group) == 1:
        return tensor
    dist.broadcast(tensor, src, group=group)
    return tensor


def _global_rank(group, group_rank: int) -> int:
    return (group_rank if group is None
            else dist.get_global_rank(group, group_rank))


class Pending:
    """A collective in flight: ``wait()`` waits for it (once) and returns
    its result. ``keep`` holds the buffers the collective reads until
    then."""

    def __init__(self, work, result, keep=()):
        self._work, self._result, self._keep = work, result, keep

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
            self._work = self._keep = None
        return self._result()


def all_gather_async(tensor: torch.Tensor, group=None, axis: int = 0
                     ) -> Pending:
    """:func:`all_gather`, started: ``wait()`` gives every rank's
    ``tensor`` concatenated along ``axis`` in rank order."""
    world = get_world_size(group)
    if world == 1:
        return Pending(None, lambda: tensor)
    src = tensor.contiguous()
    out = torch.empty(world * src.numel(), dtype=src.dtype,
                      device=src.device)
    work = _gather_fn()(out, src.view(-1), group=group, async_op=True)
    return Pending(work, lambda: assemble(out.view(world, *src.shape), axis),
                   keep=(src,))


def broadcast_async(tensor: torch.Tensor, src: int, group=None) -> Pending:
    """Group rank ``src``'s ``tensor`` on every rank, started: ``tensor``
    is overwritten in place on the others; ``wait()`` returns it."""
    if get_world_size(group) == 1:
        return Pending(None, lambda: tensor)
    work = dist.broadcast(tensor, _global_rank(group, src), group=group,
                          async_op=True)
    return Pending(work, lambda: tensor)


def reduce(tensor: torch.Tensor, dst: int, group=None) -> torch.Tensor:
    """Sum over ``group`` into group rank ``dst``'s ``tensor`` (in place;
    the others' are left undefined, as ``torch.distributed.reduce``)."""
    if get_world_size(group) > 1:
        dist.reduce(tensor, _global_rank(group, dst), group=group)
    return tensor


def barrier(group=None) -> None:
    if get_world_size(group) > 1:
        dist.barrier(group=group)


# --- collectives with their transposes, for autograd -------------------
class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous().clone(), group=ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group=group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group=group, axis=dim)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad, group=ctx.group, axis=ctx.dim), None, None


class _ReduceScatterToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x, group=group, axis=dim)

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad, group=ctx.group, axis=ctx.dim), None, None


def copy_to_group(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` as it is; its gradient summed over ``group``."""
    if get_world_size(group) == 1:
        return x
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over ``group``; its gradient passed as it is."""
    if get_world_size(group) == 1:
        return x
    return _ReduceFromGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, group=None, dim: int = 0
                      ) -> torch.Tensor:
    """:func:`all_gather` along ``dim``; the gradient reduce-scattered
    (summed) back."""
    if get_world_size(group) == 1:
        return x
    return _GatherFromGroup.apply(x, group, dim)


def reduce_scatter_to_group(x: torch.Tensor, group=None, dim: int = 0
                            ) -> torch.Tensor:
    """:func:`reduce_scatter` (sum) along ``dim``; the gradient
    all-gathered back."""
    if get_world_size(group) == 1:
        return x
    return _ReduceScatterToGroup.apply(x, group, dim)
