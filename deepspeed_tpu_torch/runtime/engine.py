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
device beside them, read a layer at a time by the forward. It runs on one
rank.

State layout: the fp32 master, the grads and the optimizer's moments are
each one flat buffer with a view per parameter (offsets aligned to 64
elements), and in mixed precision the model's parameters become views of
one flat compute-dtype buffer, so the fused-Adam or fused-Lion kernel
updates the whole model, compute copy included, in one launch.

An MoE model (``num_experts > 0``) trains on one card: the ``moe``
block's ``capacity_factor`` / ``min_capacity`` are bound to it as the JAX
engine binds them, and at W > 1 it is refused (:data:`MOE_ACROSS_RANKS`).

Across ranks (``torch.distributed`` with world size W > 1, pure
sharded-DP meshes, ``parallel/mesh.py``) the buffers hold this rank's
shards of the ZeRO plan (``runtime/zero.py``: the master and optimizer
state at stage >= 1, the grads at stage >= 2, the compute-dtype params
at stage 3), split leaves first. Micro-batch i is rows [i*mb, (i+1)*mb)
of the batch and rank r takes its contiguous 1/W of it. At stage 3 each
micro-batch gathers the full params (the ZeRO++ qwZ wire or exact,
``runtime/zeropp.py``) into temporaries that the model's parameters view
until its backward, which reduces the fp32 grads into this rank's grad
shards (qgZ or exact) as stage 2 does; at stage < 2 a rank accumulates
its full local grads and reduces them once at the gradient-accumulation
boundary, as the JAX triple defers them (``_defer_grads_ok``). The
global grad norm all-reduces the split leaves' sum of squares and counts
each replicated leaf once; after the update, stages 1-2 all-gather the
new compute-dtype shards into the replicated parameters.

The loss across ranks follows the JAX step's wire. On the exact wire JAX
differentiates the mean over every valid target of the global
micro-batch, so each rank divides its summed NLL by the count of valid
targets over all ranks (all-reduced in the forward) and the ranks' grads
are summed. On the ZeRO++ wire (qwZ or qgZ) JAX ``pmean``s the per-shard
means (``runtime/zeropp.py:213-236``), so each rank takes the mean over
its own rows and the grads are averaged over the ranks. Either way the
loss a rank returns is the global one.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..comm import comm
from ..models.adapters import LOSS_FN_ACROSS_RANKS, wrap_model
from ..models.convert import flatten_tree, materialize
from ..models.transformer import check_training_options
from ..parallel.mesh import Topology, TopologyConfig
from ..utils import groups
from ..utils.logging import log_dist
from ..utils.timer import ThroughputTimer
from .config import DeepSpeedConfig
from .loss_scaler import grads_finite, init_loss_scale, update_loss_scale
from .lr_schedules import LRSchedulerShim, build_schedule
from .optimizers import build_optimizer
from .zero import ZeroPlan, ZeroShardingPlan
from .zeropp import gather_params, reduce_grads

# JAX gates an MoE batch over the global batch (SPMD sees one array): ranks
# that each gated their own rows would size capacity on a different token
# count and drop other tokens
MOE_ACROSS_RANKS = (
    "an MoE model across ranks: JAX routes over the global batch, and "
    "ranks routing their own rows would drop other tokens; global gating "
    "comes with expert parallelism (ROADMAP Slice D item 12, expert "
    "parallelism, after item 11)")

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
        self.group = groups.get_data_parallel_group()
        self.topology = Topology(
            TopologyConfig.from_mesh_block(self.config.mesh),
            comm.get_world_size(self.group))
        self.dp_world = self.topology.data_parallel_size
        self.dp_rank = comm.get_rank(self.group)
        if hasattr(model, "frozen") and self.dp_world > 1:
            raise NotImplementedError(
                "a LoRAModel across ranks: JAX shards its frozen base over "
                "fsdp (place_frozen), the port holds it whole on one card "
                "(ROADMAP Slice D item 11)")
        if not getattr(model, "loss_splits", True) and self.dp_world > 1:
            raise NotImplementedError(LOSS_FN_ACROSS_RANKS)
        if getattr(getattr(model, "config", None), "num_experts", 0) > 0 \
                and self.dp_world > 1:
            raise NotImplementedError(MOE_ACROSS_RANKS)
        self.zero = ZeroPlan(self.config.zero_optimization)
        self.zero_stage = self.zero.stage
        (self.train_batch_size_, self.micro_batch_size_,
         self.gradient_accumulation_steps_) = \
            self.config.resolve_batch_sizes(self.dp_world)

        self.module = model
        self.model_config = model.config
        if hasattr(model, "moe_dispatcher"):
            # the moe block's routing overrides, (re)set on every engine so
            # a model reused across engines carries no stale value
            moe = self.config.moe
            model.moe_dispatcher = None
            model.moe_capacity_factor = moe.capacity_factor
            model.moe_min_capacity = moe.min_capacity
            model.moe_router_telemetry = bool(moe.router_telemetry)
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
        plan = ZeroShardingPlan(
            self.zero_stage, self.topology.fsdp_size,
            {n: tuple(p.shape) for n, p in params.items()})
        self.plan = plan
        split = [n for n in params if plan.master_dims[n] is not None]
        shards = {n: plan.shard_shape(n, plan.master_dims[n])
                  for n in split + [n for n in params if n not in split]}
        layout, total = _flat_layout(shards)
        self._layout = layout
        # the split leaves' part of the flat buffers (norm and finite check
        # all-reduce it; the rest is replicated)
        self._split_end = max((layout[n][0] + layout[n][1] for n in split),
                              default=0)
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
        for name in params:
            views[name].copy_(self._own(full[name], plan.master_dims[name]))
        if self._mixed:
            compute = master.to(self.compute_dtype)
            cviews = _views(compute, layout)
        else:
            compute, cviews = None, views
        replicated = {n: plan.shapes[n] for n in split
                      if plan.param_dims[n] is None}       # stages 1-2
        rlayout, rtotal = _flat_layout(replicated)
        self._replicas = torch.empty(rtotal, dtype=self.compute_dtype,
                                     device=dev)
        self._replica_views = _views(self._replicas, rlayout)
        for name, p in params.items():
            if name in replicated:
                self._replica_views[name].copy_(full[name])
                p.data = self._replica_views[name]
            elif plan.param_dims[name] is not None:        # stage 3
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

    def _own(self, full: torch.Tensor, dim) -> torch.Tensor:
        """This rank's chunk of ``full`` along ``dim`` (None: all of it)."""
        if dim is None:
            return full
        return full.chunk(self.topology.fsdp_size, dim)[self.dp_rank]

    def _released(self) -> torch.Tensor:
        return torch.empty(0, dtype=self.compute_dtype, device=self.device)

    # --- ZeRO-3 gathers, reductions ------------------------------------
    def _gathered(self, use_kernel=None) -> dict[str, torch.Tensor]:
        """Stage 3's split parameters in full (compute dtype), gathered
        from every rank's shards over the qwZ or the exact wire."""
        dims = self.plan.param_dims
        shards = {n: self._compute_views[n] for n in dims
                  if dims[n] is not None}
        if not shards:
            return {}
        return gather_params(shards, dims,
                             quantize_weights=self.zero.quantize_weights,
                             group=self.group, use_kernel=use_kernel)

    def _gather(self) -> None:
        for name, full in self._gathered().items():
            self.module.params[name].data = full

    def _release(self) -> None:
        """Drop stage 3's gathered parameters (the autograd graph keeps
        what its backward still needs)."""
        for name, dim in self.plan.param_dims.items():
            if dim is not None:
                self.module.params[name].data = self._released()

    def _reduce(self, grads: dict, dims: dict, quantized: bool) -> dict:
        return reduce_grads(grads, dims, n_batch=self.dp_world,
                            quantize_gradients=quantized,
                            rounding=self.zero.rounding,
                            step=self.global_steps, group=self.group,
                            mean=self._per_rank_mean)

    @property
    def _per_rank_mean(self) -> bool:
        """The ZeRO++ wire: each rank's loss is the mean over its own rows,
        and the grads are averaged over the ranks (JAX ``pmean``s the
        per-shard means there); the exact wire weights each rank by the
        global count of valid targets instead."""
        return self.zero.quantize_weights or self.zero.quantize_gradients

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

    def _micro_loss(self, micro):
        """The loss of one global micro-batch from this rank's rows, with
        stage 3's parameters gathered for its forward. Its value is the
        global loss; its gradient is this rank's share, which the
        reduction sums (exact wire: the local NLL sum over the global count
        of valid targets) or averages (ZeRO++ wire: the local mean)."""
        self._gather()
        local = self._local_rows(micro)
        if self.dp_world == 1:
            return self.module.loss(local)
        if self._per_rank_mean:
            loss = self.module.loss(local)
            total = comm.all_reduce(loss.detach().clone(),
                                    comm.ReduceOp.AVG, self.group)
        else:
            nll, count = self.module.loss_terms(local)
            sums = comm.all_reduce(
                torch.stack((nll.detach(), count.to(nll.dtype))),
                group=self.group)
            loss = nll / torch.clamp(sums[1], min=1)
            total = sums[0] / torch.clamp(sums[1], min=1)
        # the global value, with the gradient of this rank's share
        return loss + (total - loss.detach())

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
        (loss * scale if self.fp16_enabled else loss).backward(
            retain_graph=retain_graph)
        grads = {n: p.grad for n, p in self.module.params.items()}
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
        ranks, each replicated leaf counted once."""
        grads, k = self._grads, self._split_end
        if k == 0:
            return torch.linalg.vector_norm(grads)
        sq = comm.all_reduce(torch.linalg.vector_norm(grads[:k]).square(),
                             group=self.group)
        return (sq + torch.linalg.vector_norm(grads[k:]).square()).sqrt()

    def _all_finite(self) -> torch.Tensor:
        finite = grads_finite([self._grads])
        if self.dp_world == 1:
            return finite
        flag = comm.all_reduce(finite.int(), comm.ReduceOp.MIN, self.group)
        return flag.bool()

    def _refresh_replicas(self) -> None:
        """Stages 1-2: the new compute-dtype shards of the split leaves,
        all-gathered into the replicated parameters."""
        dims = self.plan.master_dims
        for name, full in self._replica_views.items():
            full.copy_(comm.all_gather(self._compute_views[name],
                                       group=self.group, axis=dims[name]))

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
        self._last_loss = self._micro_loss(self._put_batch(batch))
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
        dims = self.plan.param_dims
        return {n: (self._compute_views[n] if dims[n] is not None
                    else p.detach())
                for n, p in self.module.params.items()}

    def gathered_params(self, use_kernel=None):
        """The full compute-dtype parameters by name: stage 3's split
        leaves gathered over the configured wire (every rank must call
        it), the others as the model holds them."""
        full = self._gathered(use_kernel)
        return {n: full.get(n, p.detach())
                for n, p in self.module.params.items()}

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
        return {n: comm.all_gather(v, group=self.group, axis=dims[n])
                if dims[n] is not None else v
                for n, v in self.master_state_dict().items()}


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
