"""DeepSpeedEngine — the training engine (counterpart of
``deepspeed_tpu/runtime/engine.py``; reference: runtime/engine.py:183).

    engine, opt, _, sched = deepspeed_tpu_torch.initialize(model=m, config=cfg)
    loss = engine.train_batch((tokens, targets))
    # or DeepSpeed's own loop, one micro-batch at a time:
    loss = engine(micro); engine.backward(loss); engine.step()

``train_batch`` has the semantics of the JAX engine's compiled step
(``_build_train_step``): the loss times the loss scale; fp32 gradients,
gradient-accumulation micro-batches as contiguous slices of the batch;
grads times 1/(scale * GA); the global grad norm before clipping; clip
coefficient min(1, clip / (norm + 1e-6)); the optimizer on the fp32
master; on fp16 overflow the update is skipped and the loss scale moves;
params = master cast to the compute dtype; the step counter advances only
on a finite step. The eager ``forward``/``backward``/``step`` triple
(JAX ``engine.py:1193-1418``) runs the same two halves: ``backward``
accumulates one micro-batch's fp32 grads as each of ``train_batch``'s
micro-batches does, and ``step`` at the gradient-accumulation boundary
applies the same update. The engine runs eagerly on the model's device
and reads nothing back to the host except every ``steps_per_print``
steps, where the JAX engine also waits for the loss.

BERT (``models/bert.py``) trains as the decoder families do; a model
that is not the port's own, an ``nn.Module`` or an ``(init, apply[,
loss])`` tuple, goes through ``models/adapters.py`` (JAX ``_as_model``).
A ``linear.LoRAModel`` trains the same way: its ``params`` are the
adapters, so the master, the grads and the optimizer state hold them
alone, and the frozen base (int8 codes or float leaves) stays on the
device beside them, read a layer at a time by the forward. Across ranks
the engine first has it split its base over fsdp as JAX's
``place_frozen`` does (``LoRAModel.place_frozen``); a read of a layer's
base then gathers its blocks from the ranks that hold them.

State layout: the fp32 master, the grads and the optimizer's moments are
each one flat buffer with a view per parameter (offsets aligned to 64
elements), and in mixed precision the model's parameters become views of
one flat compute-dtype buffer, so the fused-Adam or fused-Lion kernel
updates the whole model, compute copy included, in one launch.

An MoE model (``num_experts > 0``) takes the ``moe`` block's
``capacity_factor`` / ``min_capacity`` as the JAX engine binds them
(``runtime/engine.py:144-179``). Across ranks it gates over the global
batch, as JAX does: the engine binds an ``EpShardedDispatcher``
(``moe/dispatch.py``) to it, with the ``moe`` block's wire where JAX binds
its dispatcher (``moe.enabled``, or unset with ``ep`` > 1) and the exact
fp32 wire where JAX leaves the dispatch to XLA's implicit collectives
(``enabled`` false, or ``ep`` = 1 with it unset): the same function. On a
mesh with ``ep`` > 1 the routed experts (the leaves whose partition rule
names ``ep``) are split over ep on their experts dim and everything else
is replicated over it (``runtime/zero.py`` ``ep_dims``): ZeRO splits and
reduces an expert leaf over the batch axes within its ep coordinate, as
any other leaf, and never reduces over ep, so the ep partners' other
parameters stay bit-equal. The global grad norm and the finite check add
the experts of every ep coordinate. An ``ep`` that does not divide E
keeps the experts replicated, with JAX's warning; the ZeRO++ flags on an
ep mesh warn and run the exact wire, as JAX's engine does
(``deepspeed_tpu/runtime/engine.py:626-632``). The router's aux loss is
global under global gating: on the exact wire, whose rank grads are
summed, each rank adds a 1/W share of it; on the ZeRO++ wire, whose grads
are averaged, all of it. The step seeding the stochastic dispatch wire is
bound (``moe_step``) around each micro-batch's forward and backward.

Across ranks (``torch.distributed`` with world size W > 1; the
data-parallel meshes of ``parallel/mesh.py``: dp x fsdp x zps, the zps
axis carved out of fsdp by hpZ or MiCS) the buffers hold this rank's
shards of the ZeRO plan (``runtime/zero.py``: the master and optimizer
state at stage >= 1, the grads at stage >= 2, split over the state's
group; the compute-dtype params at stage 3, over the parameters' group),
split leaves first. Micro-batch i is rows [i*mb, (i+1)*mb) of the batch
and rank r takes its contiguous 1/W of it, W the batch ranks and r its
index over them. At stage 3 the parameters are gathered from every
rank's shards:

- **On the exact wire, a layer at a time** (:class:`_LayerStream`), for
  a model that reads its layers from a weight source (the decoder
  families, BERT, a LoRAModel's adapters): as JAX's scan over the layers
  gathers layer l's slice of each split stack in the step that runs it.
  The leaves outside the stacks (the embeddings, the final norm, an
  untied head) are gathered whole once a micro-batch and held until its
  backward. Layer l's split stacked leaves are gathered when the model
  first reads layer l, with layer l+1's gathers started before layer l
  computes (the prefetch), and dropped when the forward moves on:
  autograd keeps where a saved weight came from, not the weight
  (saved-tensor hooks), and a checkpointed segment reads it again. The
  backward gathers layer l once more, for every read of its backward
  (recomputed segments and saved weights alike), starts layer l-1's,
  and reduce-scatters layer l's gradient into this rank's grad shard as
  soon as the layer's backward is done (then all-reduces it over the
  batch ranks that hold the same shard), copied for the first
  micro-batch of a step and added for the others. ``eval_batch`` gathers
  forward only. A model with no stacked layers keeps the whole gather.
- **On the ZeRO++ wires** (qwZ, qgZ, the two-hop and fp8 wires) the
  whole tree, as JAX's ``shard_map`` body gathers it before
  ``value_and_grad`` and reduces the whole gradient tree after it: their
  codes are held bit for bit to JAX's, and whether a leaf is quantized
  depends on its whole shard's size.

The whole-tree gather (``runtime/zeropp.py``) puts the full params into
temporaries that the model's parameters view until the backward, which
reduces the fp32 grads into this rank's grad shards (qgZ or exact) as
stage 2 does, and all-reduces them over the batch ranks that hold the
same shard (dp replicas, and fsdp under MiCS); ``gathered_params`` and
``save_16bit_model`` gather whole on every wire (a save-time call, as in
JAX). At stage < 2 a rank
accumulates its full local grads and reduces them once at the
gradient-accumulation boundary, as the JAX triple defers them
(``_defer_grads_ok``). The global grad norm all-reduces the split
leaves' sum of squares over the state's group alone (the replicas hold
the same shards) and counts each replicated leaf once; after the update,
a leaf whose parameters are not split as its master (stages 1-2, and
hpZ's parameters over zps alone) takes the new compute-dtype shards by
an all-gather over the state's group.

The loss across ranks follows the JAX step's wire. On the exact wire JAX
differentiates the mean over every valid target of the global
micro-batch, so each rank divides its summed NLL by the count of valid
targets over all ranks (all-reduced in the forward) and the ranks' grads
are summed. On the ZeRO++ wire (qwZ or qgZ) JAX ``pmean``s the per-shard
means (``runtime/zeropp.py:213-236``), so each rank takes the mean over
its own rows and the grads are averaged over the ranks. A model's own
``loss_fn`` cannot be split into a sum and a count: on the exact wire
every batch rank evaluates it over the whole global micro-batch (the
forward costs W times a rank's share) and keeps 1/W of its gradient; on
the ZeRO++ wire it takes the per-rank mean as above; in the triple at
stage < 2 each rank's gradient of it over its own rows, averaged, as
JAX's deferred path keeps each device's. Either way the loss a rank
returns is the global one.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
from torch.multiprocessing.reductions import StorageWeakRef

from ..comm import comm
from ..models.adapters import wrap_model
from ..models.convert import flatten_tree, materialize
from ..models.transformer import check_training_options
from ..moe.dispatch import (EpShardedDispatcher, dispatcher_unsupported_reason,
                            moe_step)
from ..parallel.mesh import BATCH_AXES, Topology, live_axes, set_topology
from ..utils import groups
from ..utils.logging import log_dist, logger
from ..utils.timer import ThroughputTimer
from .config import DeepSpeedConfig
from .loss_scaler import grads_finite, init_loss_scale, update_loss_scale
from .lr_schedules import LRSchedulerShim, build_schedule
from .optimizers import build_optimizer
from .zero import ZeroPlan, ZeroShardingPlan, ep_split_dims
from .zeropp import (gather_layers, gather_params,
                     hierarchical_allgather_unsupported_reason,
                     quantized_collectives_unsupported_reason, reduce_grads,
                     reduce_layers)

_ALIGN = 64   # elements: every parameter view starts 128-byte aligned


def _flat_layout(shapes: dict) -> tuple[dict[str, tuple[int, int, tuple]],
                                       int]:
    """name -> (offset, numel, shape) in a flat buffer, and its length."""
    layout, off = {}, 0
    for name, shape in shapes.items():
        numel = int(np.prod(shape, dtype=np.int64))
        layout[name] = (off, numel, tuple(shape))
        off += -(-numel // _ALIGN) * _ALIGN
    return layout, off


def _views(buf: torch.Tensor, layout: dict) -> dict[str, torch.Tensor]:
    return {n: buf[o:o + k].view(s) for n, (o, k, s) in layout.items()}


@dataclasses.dataclass(frozen=True)
class Split:
    """How a tree's split dims are spread: the live mesh ``axes``, their
    rank count ``world``, this rank's ``index`` over them (its chunk) and
    its process ``group`` over them."""

    axes: tuple
    world: int
    index: int
    group: object

    @classmethod
    def over(cls, topology: Topology, axes) -> "Split":
        axes = live_axes(axes, topology.sizes)
        return cls(axes, topology.axis_size(axes),
                   topology.axis_index(axes),
                   groups.axis_group(axes, topology))

    @classmethod
    def live(cls, topology: Topology, axes) -> "Split":
        """:meth:`over`, without a group where no axis is live."""
        if topology.axis_size(live_axes(axes, topology.sizes)) == 1:
            return cls((), 1, 0, None)
        return cls.over(topology, axes)

    @property
    def layout(self) -> tuple:
        return self.axes, self.world, self.index

    def own(self, full: torch.Tensor, dim) -> torch.Tensor:
        """This rank's chunk of ``full`` along ``dim`` (None: all of it)."""
        if dim is None:
            return full
        return full.chunk(self.world, dim)[self.index]


class DeepSpeedEngine:
    """Eager training engine over one device per rank."""

    def __init__(self, args=None, model=None, optimizer=None,
                 model_parameters=None, training_data=None, lr_scheduler=None,
                 mpu=None, config=None, collate_fn=None, mesh_param=None,
                 dont_change_device=False):
        if model is None:
            raise ValueError("deepspeed_tpu_torch.initialize requires a model")
        model = _as_model(model, dont_change_device)
        if mpu is not None or mesh_param is not None:
            raise NotImplementedError(
                "mpu/mesh_param are not ported yet (ROADMAP: port Queue 1, "
                "Slice D (multi-rank))")
        if training_data is not None or collate_fn is not None:
            raise NotImplementedError(
                "training_data/collate_fn (DeepSpeedDataLoader) are not "
                "ported yet (ROADMAP: port Queue 1, Slice F (dataloader.py))"
                "; pass batches to train_batch")
        self.config = DeepSpeedConfig.from_any(config)
        self.topology = Topology(self.config.topology_config(),
                                 comm.get_world_size(), comm.get_rank())
        set_topology(self.topology)
        # every batch rank: the loss all-reduces, the finite check, the
        # checkpoint's barriers
        self.group = groups.axis_group(BATCH_AXES, self.topology)
        self.dp_world = self.topology.data_parallel_size
        self.dp_rank = self.topology.axis_index(BATCH_AXES)
        # the ranks of this batch coordinate over ep (they hold the same
        # rows and split the routed experts)
        self.ep_split = Split.live(self.topology, ("ep",))
        if hasattr(model, "place_frozen"):
            # a LoRAModel's frozen base, split over fsdp as JAX places it
            model.place_frozen(self.topology)
        self.zero = ZeroPlan(self.config.zero_optimization)
        self.zero_stage = self.zero.stage
        if self.zero.hierarchical:
            why = hierarchical_allgather_unsupported_reason(
                self.topology.sizes, hpz=self.zero.hpz, mics=self.zero.mics)
            if why is not None:
                raise ValueError(why)
        why = quantized_collectives_unsupported_reason(self.topology.sizes)
        if self.zero.explicit_wire and why is not None:
            logger.warning(f"{why} Falling back to the exact collectives "
                           "for this run.")
            self.zero.exact_only()
        if self.zero.explicit_wire and self.zero.wire_dtype == "fp8" \
                and self.zero.rounding == "stochastic":
            logger.warning(
                "zero_quantized_dtype=fp8 rounds via the native float8 "
                "cast; zero_quantized_rounding=stochastic (the default) "
                "has no effect on the fp8 wire — set the int8 wire for "
                "stochastic gradient rounding")
        (self.train_batch_size_, self.micro_batch_size_,
         self.gradient_accumulation_steps_) = \
            self.config.resolve_batch_sizes(self.dp_world)

        self.module = model
        self.model_config = model.config
        self._moe_dispatcher = None
        self._ep_dims = {}
        if hasattr(model, "moe_dispatcher"):
            # the moe block's routing overrides and the dispatcher, (re)set
            # on every engine so a model reused across engines carries no
            # stale value
            moe = self.config.moe
            model.moe_dispatcher = None
            model.moe_capacity_factor = moe.capacity_factor
            model.moe_min_capacity = moe.min_capacity
            model.moe_router_telemetry = bool(moe.router_telemetry)
            self._bind_dispatcher(model, moe)
        self.device = next(iter(model.params.values())).device
        # activation_checkpointing.policy set explicitly overrides the
        # model's remat policy ("none" turns remat off), as in JAX; a
        # config without remat fields (BERT's, an adapter's) has none
        if hasattr(self.model_config, "remat_policy"):
            ac = self.config.activation_checkpointing
            if "policy" in ac.fields_set:
                self.model_config.remat = ac.policy != "none"
                if ac.policy != "none":
                    self.model_config.remat_policy = ac.policy
            check_training_options(self.model_config)
        self.compute_dtype = self.config.compute_dtype
        self._mixed = self.compute_dtype != torch.float32
        self.fp16_enabled = bool(self.config.fp16.enabled)
        self.bfloat16_enabled = bool(self.config.bf16.enabled)

        # --- optimizer & schedule ---------------------------------------
        opt_cfg = self.config.optimizer
        base_lr = opt_cfg.params.get("lr", 1e-3) if opt_cfg else 1e-3
        sched_cfg = self.config.scheduler
        if callable(lr_scheduler):
            self.lr_schedule = lr_scheduler
        else:
            self.lr_schedule = build_schedule(
                sched_cfg.type if sched_cfg else None,
                sched_cfg.params if sched_cfg else {}, base_lr)
        if optimizer is not None and not isinstance(optimizer, (str, dict)):
            self.tx = optimizer        # a client object with init/step
        else:
            self.tx = build_optimizer(
                opt_cfg.type if opt_cfg else "adamw",
                opt_cfg.params if opt_cfg else {}, self.lr_schedule)

        self._init_state(model_parameters)

        self.global_steps = 0
        self.global_samples = 0
        # fp16 overflow steps of the forward/backward/step triple (JAX
        # tallies them on its eager path only; overflow_steps reads the
        # device counter for both paths)
        self.skipped_steps = 0
        self.checkpoint_engine = None   # built by the first save or load
        self._last_metrics = None
        self._last_loss = None          # forward()'s loss, for backward()
        self._micro_losses = []         # backward()'s losses since step()
        self._micro_count = 0
        self._inside_no_sync = False
        self.tput_timer = ThroughputTimer(
            batch_size=self.train_batch_size_,
            steps_per_output=self.config.steps_per_print,
            flops_per_sample=self._flops_per_sample())
        self.lr_scheduler = (lr_scheduler if not callable(lr_scheduler)
                             and lr_scheduler is not None
                             else LRSchedulerShim(self.lr_schedule, self))
        self.optimizer = _OptimizerShim(self)
        self.training_dataloader = None
        log_dist(
            f"DeepSpeedEngine: zero_stage={self.zero_stage} "
            f"dtype={self.compute_dtype} device={self.device} "
            f"batch=({self.train_batch_size_},{self.micro_batch_size_},"
            f"ga={self.gradient_accumulation_steps_}) "
            f"optimizer={type(self.tx).__name__} "
            f"fused={getattr(self.tx, 'fused', False)} {self.topology}")

    def _bind_dispatcher(self, model, moe) -> None:
        """The dispatcher of an MoE model (JAX ``engine.py:144-179``): with
        the ``moe`` block's wire where JAX binds its dispatcher (``want``:
        ``moe.enabled``, else ``ep`` > 1), the exact fp32 exchange where
        JAX leaves the dispatch to XLA across ranks (the same function:
        global gating); none on one rank unless wanted. An ``ep`` that does
        not divide E keeps the experts replicated over ep, with JAX's
        warning (tp, sp and pp are refused by the mesh)."""
        topo = self.topology
        ep = topo.sizes["ep"]
        want = moe.enabled if moe.enabled is not None else ep > 1
        if not (want or topo.world > 1):
            return
        n_exp = int(getattr(model.config, "num_experts", 0) or 0)
        why = dispatcher_unsupported_reason(topo, n_exp)
        if why is not None:
            logger.warning(f"moe: ep-sharded dispatcher disabled ({why}); "
                           "the experts stay replicated over ep")
        wire = moe.wire_dtype if want and why is None else "fp32"
        self._moe_dispatcher = EpShardedDispatcher.for_topology(
            topo, wire_dtype=wire, rounding=moe.rounding,
            split_experts=why is None)
        model.moe_dispatcher = self._moe_dispatcher
        if why is None and ep > 1:
            self._ep_dims = ep_split_dims(
                model.partition_rules(),
                {n: tuple(p.shape) for n, p in model.params.items()}, ep)
        d = self._moe_dispatcher
        log_dist(f"moe: ep-sharded dispatch engaged (wire={wire} "
                 f"slow={d.slow_axes} fast={d.fast_axes} "
                 f"ep={d.ep_world})")

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _init_state(self, model_parameters):
        """fp32 master from ``config.seed`` (a seeded generator on the
        device, the same full weights on every rank) or from
        ``model_parameters`` (name -> full array, flat "a/b" names or a
        nested tree; a :class:`~..models.convert.Deferred` leaf, as
        ``from_pretrained`` gives, is read here), cut into this rank's shards. The model's parameters
        become views of the master (fp32) or of one compute-dtype buffer
        (mixed); stage 1-2's split leaves view a replicated full buffer
        and stage 3's the gathered temporaries of each micro-batch."""
        params = self.module.params
        dev = self.device
        topo = self.topology
        plan = ZeroShardingPlan(
            self.zero_stage, topo.fsdp_size,
            {n: tuple(p.shape) for n, p in params.items()},
            inner=topo.sizes["zps"], hpz=self.zero.hpz, mics=self.zero.mics,
            ep=self.ep_split.world, ep_dims=self._ep_dims)
        self.plan = plan
        # the groups every rank makes, in this order
        self.state_split = Split.over(topo, plan.state_axes)
        self.param_split = Split.over(topo, plan.param_axes)
        rest = [a for a in BATCH_AXES if a not in self.state_split.axes]
        self._rest_group = (groups.axis_group(rest, topo)
                            if topo.axis_size(rest) > 1 else None)
        # the two-hop wire's outer and inner hops (initialize checked that
        # the parameters split over fsdp x zps, both > 1)
        self._hierarchy = ((groups.axis_group(("fsdp",), topo),
                            groups.axis_group(("zps",), topo))
                           if self.zero.hierarchical else None)
        # the flat buffers' order: the split leaves, the experts among them
        # last, then the experts left whole, then the rest; the norm sums
        # the first part's squares over the state's group, the experts'
        # over ep, and counts the rest once
        experts = [n for n in params if n in plan.ep_dims]
        split = [n for n in params if plan.master_dims[n] is not None
                 and n not in plan.ep_dims]
        split += [n for n in experts if plan.master_dims[n] is not None]
        order = split + [n for n in experts if n not in split]
        shards = {n: plan.state_shard_shape(n)
                  for n in order + [n for n in params if n not in order]}
        layout, total = _flat_layout(shards)
        self._layout = layout

        def end(names):
            return max((layout[n][0] + layout[n][1] for n in names),
                       default=0)
        # the split leaves' part of the flat buffers (norm and finite check
        # all-reduce it; the rest is replicated)
        self._split_end = end(split)
        self._expert_bounds = (end([n for n in split
                                    if n not in plan.ep_dims]),
                               self._split_end, end(order))
        master = torch.zeros(total, dtype=torch.float32, device=dev)
        views = _views(master, layout)
        if model_parameters is None:
            gen = torch.Generator(device=dev).manual_seed(self.config.seed)
            self.module.init_params(gen)
            full = {n: p.detach() for n, p in params.items()}
        else:
            given = (flatten_tree(materialize(model_parameters))
                     if isinstance(model_parameters, dict)
                     else dict(model_parameters))
            if set(given) != set(params.keys()):
                raise ValueError(
                    f"model_parameters names differ from the model's: "
                    f"missing {sorted(set(params.keys()) - set(given))}, "
                    f"unexpected {sorted(set(given) - set(params.keys()))}")
            full = {n: (v if isinstance(v, torch.Tensor)   # a writable copy
                        else torch.from_numpy(np.array(v, np.float32)))
                    for n, v in given.items()}
        # this ep coordinate's experts
        full = {n: self.ep_split.own(v, plan.ep_dims.get(n))
                for n, v in full.items()}
        for name in params:
            views[name].copy_(self._own(full[name], plan.master_dims[name]))
        if self._mixed:
            compute = master.to(self.compute_dtype)
            cviews = _views(compute, layout)
        else:
            compute, cviews = None, views
        # parameters split as their master read its compute view; the
        # others are refreshed from it after each step: whole where the
        # parameter is not split (stages 1-2), else in the parameters'
        # own layout (hpZ: over zps alone, on a dim of its own)
        own_layout = {n for n in params if plan.param_dims[n] is not None
                      and (plan.param_dims[n], self.param_split.layout)
                      == (plan.master_dims[n], self.state_split.layout)}
        replicated = {n: plan.shapes[n] for n in split
                      if plan.param_dims[n] is None}
        resharded = {n: plan.param_shard_shape(n) for n in params
                     if plan.param_dims[n] is not None
                     and n not in own_layout}
        rlayout, rtotal = _flat_layout({**replicated, **resharded})
        self._replicas = torch.empty(rtotal, dtype=self.compute_dtype,
                                     device=dev)
        replica_views = _views(self._replicas, rlayout)
        self._replica_views = {n: replica_views[n] for n in replicated}
        self._param_shard_views = {n: replica_views[n] for n in resharded}
        for name, p in params.items():
            if name in replicated:
                self._replica_views[name].copy_(full[name])
                p.data = self._replica_views[name]
            elif plan.param_dims[name] is not None:        # stage 3
                if name in resharded:
                    self._param_shard_views[name].copy_(self.param_split.own(
                        full[name], plan.param_dims[name]))
                p.data = self._released()
            else:
                p.data = cviews[name]
            p.grad = None
        del full
        self._master = master
        self._compute = compute
        self._compute_views = cviews
        self._grads = torch.zeros_like(master)
        self._grad_views = _views(self._grads, layout)
        # stage < 2 across ranks: the full local grads, reduced at the
        # gradient-accumulation boundary
        self._defer_reduce = self.dp_world > 1 and self.zero_stage < 2
        if self._defer_reduce:
            flayout, ftotal = _flat_layout(plan.shapes)
            self._local_grads = torch.zeros(ftotal, dtype=torch.float32,
                                            device=dev)
            self._local_grad_views = _views(self._local_grads, flayout)
        else:
            self._local_grad_views = self._grad_views
        self.opt_state = self.tx.init(master)
        self._step = torch.zeros((), dtype=torch.int32, device=dev)
        self._loss_scale = init_loss_scale(self.config.fp16, device=dev)
        self._stream = self._layer_stream()

    def _layer_stream(self) -> "_LayerStream | None":
        """Stage 3's per-layer schedule on the exact wire, for a model
        that reads its layers from a weight source (``using_weights``:
        the decoder families, BERT, a LoRAModel) and has split stacked
        ``layers/*`` leaves; None where the whole gather stays (the
        ZeRO++ wires, an adapter's model, no split stack)."""
        if self.zero_stage < 3 or self.zero.explicit_wire \
                or not hasattr(self.module, "using_weights"):
            return None
        n = getattr(self.model_config, "num_layers", 0)
        plan = self.plan
        names = [name for name, dim in plan.param_dims.items()
                 if dim is not None and name.startswith("layers/")
                 and plan.shapes[name][0] == n]
        return _LayerStream(self, names, n) if names else None

    def _own(self, full: torch.Tensor, dim) -> torch.Tensor:
        """This rank's chunk of ``full`` along ``dim`` (None: all of it) in
        the master's layout."""
        return self.state_split.own(full, dim)

    def _gather_state(self, piece: torch.Tensor, dim) -> torch.Tensor:
        """A master-layout piece in full, gathered over the state's group
        (a collective: every rank calls it)."""
        if dim is None:
            return piece
        return comm.all_gather(piece, group=self.state_split.group, axis=dim)

    def _param_shards(self) -> dict[str, torch.Tensor]:
        """Stage 3's split parameters: this rank's compute-dtype shard of
        each, in the parameters' layout."""
        dims = self.plan.param_dims
        return {n: self._param_shard_views.get(n, self._compute_views[n])
                for n in dims if dims[n] is not None}

    def _released(self) -> torch.Tensor:
        return torch.empty(0, dtype=self.compute_dtype, device=self.device)

    # --- ZeRO-3 gathers, reductions ------------------------------------
    def _gathered(self, use_kernel=None, skip=()) -> dict[str, torch.Tensor]:
        """Stage 3's split parameters in full (compute dtype), gathered
        from every rank's shards over the qwZ or the exact wire (those
        named in ``skip`` left out)."""
        shards = {n: s for n, s in self._param_shards().items()
                  if n not in skip}
        if not shards:
            return {}
        return gather_params(shards, self.plan.param_dims,
                             quantize_weights=self.zero.quantize_weights,
                             group=self.param_split.group,
                             use_kernel=use_kernel,
                             wire_dtype=self.zero.wire_dtype,
                             hierarchy=self._hierarchy)

    def _gather(self) -> None:
        """Each micro-batch's whole gather: every split leaf, or with the
        per-layer schedule the leaves outside the layer stacks (the
        embeddings, the final norm, an untied head), which the model reads
        as its own parameters until the backward."""
        stream = self._stream
        full = self._gathered(skip=stream.names if stream else ())
        if stream is not None:
            stream.counts["non_layer"] += len(full)
        for name, t in full.items():
            self.module.params[name].data = t

    def _release(self) -> None:
        """Drop stage 3's gathered parameters (the autograd graph keeps
        what its backward still needs)."""
        for name, dim in self.plan.param_dims.items():
            if dim is not None:
                self.module.params[name].data = self._released()

    def _reduce(self, grads: dict, dims: dict, quantized: bool,
                use_kernel=None, rounding=None) -> dict:
        return reduce_grads(grads, dims, n_batch=self.dp_world,
                            quantize_gradients=quantized,
                            rounding=rounding or self.zero.rounding,
                            step=self.global_steps,
                            group=self.state_split.group,
                            use_kernel=use_kernel,
                            mean=self._per_rank_mean,
                            wire_dtype=self.zero.wire_dtype,
                            hierarchy=self._hierarchy,
                            batch_group=self.group,
                            rest_group=self._rest_group)

    @property
    def _per_rank_mean(self) -> bool:
        """The ZeRO++ wire (qwZ, qgZ or the two-hop collectives): each
        rank's loss is the mean over its own rows, and the grads are
        averaged over the ranks (JAX ``pmean``s the per-shard means
        there); the exact wire weights each rank by the global count of
        valid targets instead."""
        return self.zero.explicit_wire

    def _local_rows(self, batch):
        """This rank's contiguous 1/W of the rows of every array."""
        if self.dp_world == 1:
            return batch
        rows = batch_rows(batch)
        if rows % self.dp_world:
            raise ValueError(f"a micro-batch of {rows} rows does not split "
                             f"over {self.dp_world} ranks")
        k = rows // self.dp_world
        return self._micro(batch, self.dp_rank, k)

    def _micro_loss(self, micro, triple: bool = False):
        """The loss of one global micro-batch from this rank's rows, with
        stage 3's parameters gathered for its forward (whole, or a layer
        at a time). Its value is the global loss; its gradient is this
        rank's share, which the reduction sums (exact wire: the local NLL
        sum over the global count of valid targets) or averages (ZeRO++
        wire: the local mean). A model's own ``loss_fn`` is a black box:
        on the exact wire every batch rank evaluates it over the whole
        global micro-batch, as JAX differentiates it there, and keeps 1/W
        of its gradient, so the sum over the ranks is JAX's gradient (the
        forward costs W times a rank's share). In the triple at stage < 2,
        whose reduction waits for the boundary, JAX keeps each device's
        gradient of the ``loss_fn`` over its own rows and averages them
        (``local_value_and_grad``), its loss the global micro-batch's:
        so does the port. An MoE model's router aux loss is global (its
        gating is): a 1/W share of it on the exact wire, all of it on the
        per-rank mean."""
        self._gather()
        local = self._local_rows(micro)
        with self._layer_weights(), moe_step(self.global_steps):
            if self.dp_world == 1:
                return self.module.loss(local)
            share = 1.0 / self.dp_world
            if self._per_rank_mean:
                loss = self.module.loss(local)
                total = comm.all_reduce(loss.detach().clone(),
                                        comm.ReduceOp.AVG, self.group)
            elif not getattr(self.module, "loss_splits", True):
                if not (triple and self._defer_reduce):
                    return _ScaleGrad.apply(self.module.loss(micro), share)
                with torch.no_grad():
                    total = self.module.loss(micro)
                loss = _ScaleGrad.apply(self.module.loss(local), share)
            else:
                nll, count, aux = self._loss_parts(local)
                sums = comm.all_reduce(
                    torch.stack((nll.detach(), count.to(nll.dtype))),
                    group=self.group)
                loss = nll / torch.clamp(sums[1], min=1)
                total = sums[0] / torch.clamp(sums[1], min=1)
                if aux is not None:
                    aux = self.module.aux_loss_coef() * aux
                    loss = loss + aux * share
                    total = total + aux.detach()
        # the global value, with the gradient of this rank's share
        return loss + (total - loss.detach())

    def _loss_parts(self, batch):
        """(summed NLL, count of valid targets, router aux or None) of
        ``batch``; a model without ``loss_parts`` has no aux."""
        if hasattr(self.module, "loss_parts"):
            return self.module.loss_parts(batch)
        return (*self.module.loss_terms(batch), None)

    def _layer_weights(self):
        """The forward's weight source: the per-layer schedule's, else the
        model's own parameters."""
        if self._stream is None:
            return contextlib.nullcontext()
        return self._stream.forward(torch.is_grad_enabled())

    def stage3_counts(self) -> dict:
        """The per-layer schedule's counts since the last
        :meth:`reset_stage3_counts`: layer gathers in the forward
        (``layer_forward``) and again in the backward (``layer_backward``),
        one per layer each (every split stacked leaf of the layer), the
        leaves gathered whole a micro-batch (``non_layer``), the layers'
        gradient reductions (``layer_reductions``) and those made outside
        a backward (``reductions_outside_backward``), the most layers
        whose gathered tensors were alive at once (``max_live_layers``,
        the prefetched one included); None without the schedule."""
        stream = self._stream
        if stream is None:
            return None
        return dict(stream.counts, max_live_layers=stream.max_live_layers,
                    layers=stream.n_layers, streamed=list(stream.names))

    def reset_stage3_counts(self) -> None:
        if self._stream is not None:
            self._stream.reset_counts()

    def _flops_per_sample(self):
        """Training FLOPs a sample at the model's max_seq_len; None where
        the model's config gives no ``flops_per_token`` (an adapter's)."""
        c = self.model_config
        if not (hasattr(c, "flops_per_token") and hasattr(c, "max_seq_len")):
            return None
        return c.flops_per_token(c.max_seq_len) * c.max_seq_len

    def _put_batch(self, batch):
        """Every array of the batch onto the engine's device (pinned and
        asynchronous from the host)."""
        def put(x):
            x = torch.as_tensor(x)
            if x.device == self.device:
                return x
            if self.device.type == "cuda" and x.device.type == "cpu":
                return x.pin_memory().to(self.device, non_blocking=True)
            return x.to(self.device)

        if isinstance(batch, dict):
            return {k: put(v) for k, v in batch.items()}
        return type(batch)(put(x) for x in batch)

    @staticmethod
    def _micro(batch, i: int, mb: int):
        """Micro-batch i: rows [i*mb, (i+1)*mb) of every array (the JAX
        step's reshape(ga, B // ga, ...))."""
        if isinstance(batch, dict):
            return {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        return type(batch)(x[i * mb:(i + 1) * mb] for x in batch)

    def _accumulate(self, loss, first: bool, retain_graph=False) -> None:
        """Backward of one micro-batch's loss (times the fp16 loss scale)
        and its grads into the flat fp32 grad buffer: copied for the first
        micro-batch of a step, added for the others. Across ranks at stage
        >= 2 the grads are first reduced to this rank's shards; at stage <
        2 the full local grads accumulate until the boundary."""
        scale = self._loss_scale.scale
        stream = self._stream
        with (stream.backward(first) if stream is not None
              else contextlib.nullcontext()), moe_step(self.global_steps):
            (loss * scale if self.fp16_enabled else loss).backward(
                retain_graph=retain_graph)
        # the per-layer schedule reduced the stacks' grads in the backward
        grads = {n: p.grad for n, p in self.module.params.items()
                 if stream is None or n not in stream.names}
        for p in self.module.params.values():
            p.grad = None
        if not retain_graph:
            self._release()
        if self.dp_world > 1 and not self._defer_reduce:
            grads = self._reduce(grads, self.plan.grad_dims,
                                 self.zero.quantize_gradients)
        for name, g in grads.items():
            if first:
                self._local_grad_views[name].copy_(g)
            else:
                self._local_grad_views[name].add_(g)

    def _apply_step(self, losses) -> dict:
        """The update from the accumulated grads (JAX ``apply_grads``):
        unscale and average over GA, the fp16 finite check, the global
        norm and clip coefficient, the optimizer on the master, the loss
        scale; then the counters, once per step, and the report every
        ``steps_per_print`` steps."""
        ga = self.gradient_accumulation_steps_
        scale = self._loss_scale.scale
        grads = self._grads
        if self._defer_reduce:
            local = self._local_grad_views
            for name, g in self._reduce(local, self.plan.master_dims,
                                        False).items():
                self._grad_views[name].copy_(g)
        # unscale + average over GAS (reference: engine.py:2024)
        if self.fp16_enabled:
            grads.mul_(1.0 / (scale * ga))
        elif ga > 1:
            grads.mul_(1.0 / ga)
        finite = self._all_finite() if self.fp16_enabled else None
        # global grad norm + clip (reference: runtime/utils.py
        # clip_grad_norm_); the coefficient is applied inside the update
        grad_norm = self._grad_norm()
        clip = self.config.gradient_clipping
        coef = (torch.clamp(clip / (grad_norm + 1e-6), max=1.0)
                if clip > 0 else None)
        self.tx.step(self.opt_state, self._master, grads, coef=coef,
                     apply=None if finite is None else finite.float(),
                     out=self._compute)
        if self.fp16_enabled:
            fp16 = self.config.fp16
            self._loss_scale = update_loss_scale(
                self._loss_scale, ~finite, dynamic=fp16.loss_scale == 0,
                scale_window=fp16.loss_scale_window,
                min_scale=fp16.min_loss_scale, hysteresis=fp16.hysteresis)
            self._step += finite.int()
        else:
            self._step += 1
        self._refresh_replicas()
        overflow = (~finite if finite is not None
                    else torch.zeros((), dtype=torch.bool, device=self.device))
        loss = torch.stack(losses).mean()
        metrics = {"loss": loss, "grad_norm": grad_norm,
                   "loss_scale": self._loss_scale.scale, "overflow": overflow}
        self.global_steps += 1
        self.global_samples += self.train_batch_size_
        self._last_metrics = metrics
        if self.global_steps % self.config.steps_per_print == 0:
            self._report(metrics)
        return metrics

    def _grad_norm(self) -> torch.Tensor:
        """The global norm: the split leaves' squares summed over the
        state's group, whose ranks hold distinct shards (dp and MiCS
        replicas hold the same ones), each replicated leaf counted once;
        across ep the experts' squares summed over the ep group too."""
        grads, k = self._grads, self._split_end
        if self.ep_split.world > 1:
            a, b, c = self._expert_bounds
            sq = torch.stack([torch.linalg.vector_norm(p) for p in (
                grads[:a], grads[a:b], grads[b:c], grads[c:])]).square()
            if b > 0:
                sq[:2] = comm.all_reduce(sq[:2].clone(),
                                         group=self.state_split.group)
            sq[1:3] = comm.all_reduce(sq[1:3].clone(),
                                      group=self.ep_split.group)
            return sq.sum().sqrt()
        if k == 0:
            return torch.linalg.vector_norm(grads)
        sq = comm.all_reduce(torch.linalg.vector_norm(grads[:k]).square(),
                             group=self.state_split.group)
        return (sq + torch.linalg.vector_norm(grads[k:]).square()).sqrt()

    def _all_finite(self) -> torch.Tensor:
        finite = grads_finite([self._grads])
        if self.dp_world * self.ep_split.world == 1:
            return finite
        flag = comm.all_reduce(finite.int(), comm.ReduceOp.MIN, self.group)
        if self.ep_split.world > 1:     # the other experts' grads
            flag = comm.all_reduce(flag, comm.ReduceOp.MIN,
                                   self.ep_split.group)
        return flag.bool()

    def _refresh_replicas(self) -> None:
        """The parameters not split as their master, from the new
        compute-dtype master shards: stages 1-2's replicated leaves
        all-gathered over the state's group, and hpZ's parameter shards
        resharded (gathered whole, then this rank's chunk over zps)."""
        dims = self.plan.master_dims
        for name, full in self._replica_views.items():
            full.copy_(self._gather_state(self._compute_views[name],
                                          dims[name]))
        for name, shard in self._param_shard_views.items():
            shard.copy_(self.param_split.own(
                self._gather_state(self._compute_views[name], dims[name]),
                self.plan.param_dims[name]))

    # ------------------------------------------------------------------
    # public API (reference parity)
    # ------------------------------------------------------------------
    def train_batch(self, batch=None, data_iter=None):
        """One full training step (GA micro-batches included). ``batch``
        is ``(tokens, targets)`` or a dict with those keys, leading dim
        train_batch_size (the global batch, the same on every rank).
        Returns the mean loss over the global batch (a 0-d device
        tensor)."""
        if batch is None:
            if data_iter is None:
                raise ValueError("train_batch needs a batch or data_iter")
            batch = next(data_iter)
        batch = self._put_batch(batch)
        rows = batch_rows(batch)
        if rows != self.train_batch_size_:
            raise ValueError(f"batch has {rows} rows, train_batch_size is "
                             f"{self.train_batch_size_}")
        self.tput_timer.start()
        ga = self.gradient_accumulation_steps_
        mb = rows // ga
        losses = []
        for i in range(ga):
            loss = self._micro_loss(self._micro(batch, i, mb))
            self._accumulate(loss, first=i == 0)
            losses.append(loss.detach())
        metrics = self._apply_step(losses)
        printed = self.global_steps % self.config.steps_per_print == 0
        self.tput_timer.stop(sync=metrics["loss"] if printed else None,
                             report_speed=printed)
        return metrics["loss"]

    def _report(self, metrics):
        lr = float(self.lr_schedule(self._applied_steps()))
        log_dist(
            f"step={self.global_steps} loss={float(metrics['loss']):.4f} "
            f"lr={lr:.3e} grad_norm={float(metrics['grad_norm']):.3f}"
            + (f" loss_scale={float(metrics['loss_scale']):.0f}"
               if self.fp16_enabled else ""))

    def eval_batch(self, batch):
        """The mean loss over the global ``batch``, without grads."""
        with torch.no_grad():
            loss = self._micro_loss(self._put_batch(batch))
            self._release()
        return loss

    # --- forward/backward/step (JAX engine.py:1193-1418) ---------------
    def forward(self, batch):
        """The loss of one micro-batch (reference: engine.forward), with
        its autograd graph, which ``backward`` consumes. Across ranks
        ``batch`` is the global micro-batch (train_batch_size / GA rows)
        and the loss is the global micro-batch's (see the module
        docstring for the gradient each rank keeps). JAX recomputes the
        graph in ``backward``; the numbers are the same. The engine holds
        only the latest loss (for ``backward(None)``), so the graph of a
        ``forward`` that no ``backward`` consumed is freed by the next
        ``forward`` once the caller drops it."""
        self._last_loss = self._micro_loss(self._put_batch(batch),
                                           triple=True)
        return self._last_loss

    __call__ = forward

    def backward(self, loss=None, retain_graph=False):
        """Accumulate the grads of one micro-batch (reference:
        engine.backward:2007): ``loss`` (times the fp16 loss scale) runs
        its backward and the fp32 grads add into the flat grad buffer.
        ``loss=None`` takes the loss of the last ``forward``."""
        if loss is None:
            loss = self._last_loss
            if loss is None:
                raise RuntimeError("backward() without a loss needs a "
                                   "forward() first")
        self._accumulate(loss, first=self._micro_count == 0,
                         retain_graph=retain_graph)
        if loss is self._last_loss and not retain_graph:
            self._last_loss = None      # its graph is spent
        self._micro_losses.append(loss.detach())
        self._micro_count += 1

    def is_gradient_accumulation_boundary(self) -> bool:
        return self._micro_count >= self.gradient_accumulation_steps_

    def step(self):
        """Apply the update from the accumulated grads (reference:
        engine.step:2204); does nothing until the GA boundary."""
        assert not self._inside_no_sync, \
            "it is illegal to call engine.step() within the no_sync " \
            "context manager (reference engine.py:1992)"
        if not self.is_gradient_accumulation_boundary():
            return
        metrics = self._apply_step(self._micro_losses)
        self._micro_losses = []
        self._micro_count = 0
        if self.fp16_enabled and bool(metrics["overflow"]):
            self.skipped_steps += 1

    def no_sync(self):
        """Context manager (reference: engine.no_sync:1987). At stage < 2
        the reduction is deferred to the boundary anyway; the context
        keeps what the JAX engine keeps of the reference: it refuses ZeRO
        stage >= 2 (partitioned grads), ``step()`` is illegal inside it,
        and reentry is unsupported."""
        assert self.zero_stage < 2, (
            "no_sync context manager is incompatible with gradient "
            f"partitioning logic of ZeRO stage {self.zero_stage} "
            "(reference engine.py:1995)")
        assert not self._inside_no_sync, \
            "no_sync context manager reentry is unsupported"

        @contextlib.contextmanager
        def ctx():
            self._inside_no_sync = True
            try:
                yield
            finally:
                self._inside_no_sync = False
        return ctx()

    # --- accessors (reference parity) ---------------------------------
    def _applied_steps(self) -> int:
        """Optimizer steps actually applied (excludes fp16 overflow
        steps); reads the device counter, so it syncs."""
        return int(self._step)

    @property
    def overflow_steps(self) -> int:
        return max(0, self.global_steps - self._applied_steps())

    def get_global_grad_norm(self):
        """Gradient norm of the most recent step (before clipping)."""
        m = self._last_metrics
        return float(m["grad_norm"]) if m is not None else None

    def zero_optimization(self) -> bool:
        return self.zero_stage > 0

    def zero_optimization_stage(self) -> int:
        return self.zero_stage

    def train_micro_batch_size_per_gpu(self) -> int:
        return self.micro_batch_size_

    def get_lr(self):
        return [float(self.lr_schedule(self._applied_steps()))]

    @property
    def params(self):
        return self.module_state_dict()

    def module_state_dict(self):
        """The compute-dtype parameters by name (the JAX state's params);
        at ZeRO-3 across ranks a split leaf is this rank's shard."""
        shards = self._param_shards()
        return {n: shards.get(n, p.detach())
                for n, p in self.module.params.items()}

    def gathered_params(self, use_kernel=None):
        """The full compute-dtype parameters by name: stage 3's split
        leaves gathered over the configured wire and the experts over ep
        (every rank must call it), the others as the model holds them."""
        full = self._gathered(use_kernel)
        return {n: self._ep_gather(full.get(n, p.detach()), n)
                for n, p in self.module.params.items()}

    def _ep_gather(self, local: torch.Tensor, name: str) -> torch.Tensor:
        """An ep coordinate's whole leaf -> the leaf, its experts gathered
        over ep (a collective of the ep group; other leaves as they are)."""
        dim = self.plan.ep_dims.get(name)
        if dim is None:
            return local
        return comm.all_gather(local.contiguous(), group=self.ep_split.group,
                               axis=dim)

    def master_state_dict(self):
        """This rank's fp32 master by name (views of the flat buffer): the
        whole parameter, or its shard where ZeRO splits it."""
        return _views(self._master, self._layout)

    # checkpointing lives in runtime/checkpointing.py, bound here as JAX
    # binds it (deepspeed_tpu/runtime/engine.py:1626-1645)
    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True):
        from .checkpointing import save_checkpoint
        return save_checkpoint(self, save_dir, tag=tag,
                               client_state=client_state,
                               save_latest=save_latest)

    def load_checkpoint(self, load_dir, tag=None, load_optimizer_states=True,
                        load_lr_scheduler_states=True,
                        load_module_only=False):
        from .checkpointing import load_checkpoint
        return load_checkpoint(self, load_dir, tag=tag,
                               load_optimizer_states=load_optimizer_states,
                               load_module_only=load_module_only)

    def save_16bit_model(self, save_dir, checkpoint_name="model_weights.npz"):
        from .checkpointing import save_16bit_model
        return save_16bit_model(self, save_dir, checkpoint_name)

    def consolidated_master_state_dict(self):
        """The full fp32 master by name, every shard all-gathered (every
        rank must call it)."""
        dims = self.plan.master_dims
        return {n: self._ep_gather(self._gather_state(v, dims[n]), n)
                for n, v in self.master_state_dict().items()}


class _ScaleGrad(torch.autograd.Function):
    """``x`` as it is, its gradient times ``scale``."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None


class _GatherLayer(torch.autograd.Function):
    """Layer ``layer``'s split stacked leaves gathered in full (the
    outputs, in the stream's ``names`` order); its backward reduces their
    gradients into this rank's grad shards as soon as the layer's
    backward has made them. ``anchor`` only makes the outputs require
    grad."""

    @staticmethod
    def forward(ctx, stream, layer, anchor):
        ctx.stream, ctx.layer = stream, layer
        full = stream.collect(layer)
        return tuple(full[n] for n in stream.names)

    @staticmethod
    def backward(ctx, *grads):
        ctx.stream.reduce(ctx.layer, grads)
        return None, None, None


@dataclasses.dataclass(frozen=True)
class _Saved:
    """What autograd keeps of a gathered layer tensor it saves: where to
    find it again (the layer, the leaf and the view of it)."""
    layer: int
    name: str
    size: tuple
    stride: tuple
    offset: int


class _LayerParams:
    """Layer ``layer``'s parameters keyed as the model's layer ``p``
    (``"wq"``, a LoRAModel's ``"wq/a"``): a split stacked leaf from the
    stream, read where the model reads it; the others as slices of the
    model's parameters. Holds no tensor, so a checkpointed segment that
    closes over it keeps none alive."""

    def __init__(self, stream: "_LayerStream", layer: int):
        self._stream, self._layer = stream, layer

    def __getitem__(self, key: str) -> torch.Tensor:
        name = "layers/" + key
        stream = self._stream
        if name in stream.names:
            return stream.tensor(self._layer, name)
        return stream.params[name][self._layer]

    def __contains__(self, key: str) -> bool:
        return "layers/" + key in self._stream.params

    def get(self, key: str, default=None):
        return self[key] if key in self else default

    def keys(self):
        return [n[7:] for n in self._stream.params if n.startswith("layers/")]

    def items(self):
        """(key, tensor) of every leaf of the layer (an MoE FFN reads its
        experts' dict this way)."""
        return [(k, self[k]) for k in self.keys()]


class _StreamSource:
    """The weight source (``DecoderLM.using_weights``) of the per-layer
    schedule: the leaves outside the stacks are the model's parameters
    (gathered whole for the micro-batch), ``layer(i)`` layer i's."""

    def __init__(self, stream: "_LayerStream"):
        self._stream = stream

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._stream.params[name]

    def __contains__(self, name: str) -> bool:
        return name in self._stream.params

    def layer(self, layer: int) -> _LayerParams:
        return _LayerParams(self._stream, layer)


class _LayerStream:
    """Stage 3's schedule on the exact wire, a layer at a time (JAX's
    scan over the layers, in which XLA gathers layer l's slice of each
    split stack inside the step that runs it, and reduce-scatters its
    gradient inside the backward step).

    Forward: when the model first reads layer l, its split stacked leaves
    are gathered (all of them in one collective, ``gather_layers``, under
    one ``_GatherLayer``), the layer before is dropped and layer l+1's
    gather is started (the prefetch). Autograd saves no gathered tensor:
    the saved-tensor hooks keep where it came from instead, and a
    checkpointed segment reads the layer again when it recomputes. Backward: the first read of layer l (a segment's recompute
    or a saved tensor's unpack) gathers it again, once for all its reads,
    and starts layer l-1's; the ``_GatherLayer`` of layer l reduces the
    layer's gradients (``reduce_layers``: one reduce-scatter, then one
    all-reduce over the rest group) into the grad shards once the
    layer's backward is done: copied for the first micro-batch of a step,
    added for the others. So at most two layers' gathered tensors live at
    once. Every rank issues these collectives in the same order: the
    model's layer order and autograd's, the same on every rank."""

    def __init__(self, engine: "DeepSpeedEngine", names, n_layers: int):
        self.engine = engine
        self.params = engine.module.params
        self.names = tuple(names)
        self.n_layers = n_layers
        self.source = _StreamSource(self)
        self.first = True
        self._cache = {}        # layer -> {name: gathered tensor}
        self._pending = {}      # layer -> comm.Pending of its gathers
        self._saved = {}        # storage pointer -> (layer, name, weak ref)
        self._live = []         # (layer, weak ref) of gathered storages
        self._anchor = None
        self.reset_counts()

    def reset_counts(self) -> None:
        self.counts = dict(layer_forward=0, layer_backward=0, non_layer=0,
                           layer_reductions=0, reductions_outside_backward=0)
        self.max_live_layers = 0
        self.events = []        # the last micro-step's, in order

    # --- the gathers --------------------------------------------------
    def _issue(self, layer: int) -> comm.Pending:
        """Layer ``layer``'s gathers, started: one collective for the
        layer (``gather_layers``)."""
        engine = self.engine
        shards = engine._param_shards()
        return gather_layers({n: shards[n] for n in self.names},
                             engine.plan.param_dims, layer,
                             engine.param_split.group)

    def _prefetch(self, layer: int) -> None:
        if 0 <= layer < self.n_layers and layer not in self._pending:
            self._pending[layer] = self._issue(layer)
            self._note_live(layer)

    def collect(self, layer: int) -> dict:
        """Layer ``layer``'s gathered tensors (the prefetched gathers
        waited for, else gathered now)."""
        pending = self._pending.pop(layer, None) or self._issue(layer)
        full = pending.wait()
        for name, t in full.items():
            storage = t.untyped_storage()
            ref = StorageWeakRef(storage)
            self._saved[storage.data_ptr()] = (layer, name, ref)
            self._live.append((layer, ref))
        self._note_live(layer)
        return full

    def _note_live(self, layer: int) -> None:
        self._live = [(l, r) for l, r in self._live if not r.expired()]
        self._saved = {k: v for k, v in self._saved.items()
                       if not v[2].expired()}
        live = {l for l, _ in self._live} | set(self._pending) | {layer}
        self.max_live_layers = max(self.max_live_layers, len(live))

    def tensor(self, layer: int, name: str) -> torch.Tensor:
        full = self._cache.get(layer)
        if full is None:
            if torch._C._current_graph_task_id() != -1:
                full = self._backward_layer(layer)
            else:
                full = self._forward_layer(layer)
        return full[name]

    def _forward_layer(self, layer: int) -> dict:
        self._cache.clear()      # the layer before: autograd keeps no copy
        if self._anchor is not None:
            full = dict(zip(self.names, _GatherLayer.apply(
                self, layer, self._anchor)))
        else:
            full = self.collect(layer)
        self.counts["layer_forward"] += 1
        self.events.append(("forward", layer))
        self._cache[layer] = full
        self._prefetch(layer + 1)
        return full

    def _backward_layer(self, layer: int) -> dict:
        self._cache.clear()
        full = self.collect(layer)
        for t in full.values():   # as in the forward, for the recompute
            t.requires_grad_(True)
        self.counts["layer_backward"] += 1
        self.events.append(("backward", layer))
        self._cache[layer] = full
        self._prefetch(layer - 1)
        return full

    def _drain(self) -> None:
        for pending in self._pending.values():
            pending.wait()
        self._pending.clear()
        self._cache.clear()

    # --- autograd's saved tensors ---------------------------------------
    def pack(self, t: torch.Tensor):
        entry = self._saved.get(t.untyped_storage().data_ptr())
        if entry is None or entry[2].expired():
            return t
        return _Saved(entry[0], entry[1], tuple(t.size()), t.stride(),
                      t.storage_offset())

    def unpack(self, saved):
        if not isinstance(saved, _Saved):
            return saved
        full = self.tensor(saved.layer, saved.name).detach()
        return full.as_strided(saved.size, saved.stride, saved.offset)

    # --- the reductions -------------------------------------------------
    def reduce(self, layer: int, grads) -> None:
        """Layer ``layer``'s full local gradients into this rank's grad
        shards (``reduce_layers``: one reduce-scatter for the layer, then
        one all-reduce over the rest group), copied on the first
        micro-batch of a step, else added."""
        engine = self.engine
        split = engine.state_split
        dims = engine.plan.grad_dims
        grads = dict(zip(self.names, grads))
        whole = {n: g for n, g in grads.items() if dims[n] is None}
        pieces = reduce_layers({n: g for n, g in grads.items()
                                if n not in whole}, dims, layer,
                               self.n_layers, split.group,
                               engine._rest_group)
        for name, g in whole.items():    # a leaf the state does not split
            pieces[name] = comm.all_reduce(g.float().clone(),
                                           group=engine.group)
        per = self.n_layers // split.world
        for name, piece in pieces.items():
            if piece is None:             # a dim-0 layer another rank holds
                continue
            view = engine._local_grad_views[name]
            out = view[layer % per] if dims[name] == 0 else view[layer]
            if self.first:
                out.copy_(piece)
            else:
                out.add_(piece)
        self.counts["layer_reductions"] += 1
        if torch._C._current_graph_task_id() == -1:
            self.counts["reductions_outside_backward"] += 1
        self.events.append(("reduce", layer))

    # --- the passes -----------------------------------------------------
    @contextlib.contextmanager
    def forward(self, grad: bool):
        """A micro-batch's forward on the stream's weights: layer 0's
        gathers started at once; with ``grad`` the saved-tensor hooks on
        and the layers' gathers in the graph."""
        self._drain()
        self.events = []
        self._anchor = (torch.empty(0, device=self.engine.device,
                                    requires_grad=True) if grad else None)
        self._prefetch(0)
        hooks = (torch.autograd.graph.saved_tensors_hooks(self.pack,
                                                           self.unpack)
                 if grad else contextlib.nullcontext())
        try:
            with self.engine.module.using_weights(self.source), hooks:
                yield
        finally:
            self._anchor = None
            self._drain()

    @contextlib.contextmanager
    def backward(self, first: bool):
        self.first = first
        try:
            yield
        finally:
            self._drain()


def _as_model(model, dont_change_device=False):
    """The port's models (``params`` and ``loss``) as they are; an
    ``nn.Module`` or an ``(init, apply[, loss])`` tuple through
    ``models/adapters.py`` (JAX ``_as_model``), on the card, or an
    ``nn.Module`` left on its own device with ``dont_change_device`` (the
    reference engine's switch). A PipelineModule is not ported yet."""
    if type(model).__name__ == "PipelineModule":
        raise NotImplementedError(
            "PipelineModule (runtime/pipe/) is not ported yet (ROADMAP "
            "Slice D item 12)")
    if hasattr(model, "loss") and hasattr(model, "params"):
        return model
    if dont_change_device and isinstance(model, torch.nn.Module):
        return wrap_model(
            model, next(model.parameters(), torch.empty(0)).device)
    return wrap_model(model)


def batch_rows(batch) -> int:
    first = next(iter(batch.values())) if isinstance(batch, dict) else batch[0]
    return first.shape[0]


class _OptimizerShim:
    """Stands in for the wrapped optimizer object the reference returns
    (so `engine.optimizer.state_dict()`-style probes don't crash)."""

    def __init__(self, engine: DeepSpeedEngine):
        self._engine = engine

    @property
    def loss_scale(self):
        return float(self._engine._loss_scale.scale)

    def state_dict(self):
        return self._engine.opt_state

    def zero_grad(self, *a, **k):
        for p in self._engine.module.params.values():
            p.grad = None
