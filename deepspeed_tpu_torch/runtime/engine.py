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

State layout: the fp32 master, the grads and the optimizer's moments are
each one flat buffer with a view per parameter (offsets aligned to 64
elements), and in mixed precision the model's parameters become views of
one flat compute-dtype buffer, so the fused-Adam or fused-Lion kernel
updates the whole model, compute copy included, in one launch.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..models.convert import flatten_tree
from ..models.transformer import check_training_options
from ..utils.logging import log_dist
from ..utils.timer import ThroughputTimer
from .config import DeepSpeedConfig
from .loss_scaler import grads_finite, init_loss_scale, update_loss_scale
from .lr_schedules import LRSchedulerShim, build_schedule
from .optimizers import build_optimizer
from .zero import ZeroPlan, world_size

_ALIGN = 64   # elements: every parameter view starts 128-byte aligned


def _flat_layout(params) -> tuple[dict[str, tuple[int, int, torch.Size]],
                                  int]:
    """name -> (offset, numel, shape) in a flat buffer, and its length."""
    layout, off = {}, 0
    for name, p in params.items():
        layout[name] = (off, p.numel(), p.shape)
        off += -(-p.numel() // _ALIGN) * _ALIGN
    return layout, off


class DeepSpeedEngine:
    """Eager training engine over one device."""

    def __init__(self, args=None, model=None, optimizer=None,
                 model_parameters=None, training_data=None, lr_scheduler=None,
                 mpu=None, config=None, collate_fn=None, mesh_param=None,
                 dont_change_device=False):
        if model is None:
            raise ValueError("deepspeed_tpu_torch.initialize requires a model")
        if not (hasattr(model, "loss") and hasattr(model, "params")):
            raise NotImplementedError(
                f"the engine trains the port's DecoderLM family; "
                f"{type(model).__name__} is not one: model adapters and "
                f"PipelineModule are not ported yet (ROADMAP: port Queue 1, "
                f"Slice C (models/adapters.py), Slice D (runtime/pipe/))")
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
        self.zero = ZeroPlan(self.config.zero_optimization, world_size())
        self.zero_stage = self.zero.stage
        (self.train_batch_size_, self.micro_batch_size_,
         self.gradient_accumulation_steps_) = \
            self.config.resolve_batch_sizes(self.zero.world)

        self.module = model
        self.model_config = model.config
        self.device = next(iter(model.params.values())).device
        # activation_checkpointing.policy set explicitly overrides the
        # model's remat policy ("none" turns remat off), as in JAX
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
            f"fused={getattr(self.tx, 'fused', False)}")

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _init_state(self, model_parameters):
        """fp32 master from ``config.seed`` (a seeded generator on the
        device) or from ``model_parameters`` (name -> array, flat "a/b"
        names or a nested tree); the model's parameters become views of
        the master (fp32) or of one compute-dtype buffer (mixed)."""
        params = self.module.params
        layout, total = _flat_layout(params)
        self._layout = layout
        dev = self.device
        master = torch.zeros(total, dtype=torch.float32, device=dev)
        views = {n: master[o:o + k].view(s) for n, (o, k, s) in layout.items()}
        if model_parameters is None:
            gen = torch.Generator(device=dev).manual_seed(self.config.seed)
            self.module.init_params(gen)
            for name, p in params.items():
                views[name].copy_(p)
        else:
            given = (flatten_tree(model_parameters)
                     if isinstance(model_parameters, dict)
                     else dict(model_parameters))
            if set(given) != set(params.keys()):
                raise ValueError(
                    f"model_parameters names differ from the model's: "
                    f"missing {sorted(set(params.keys()) - set(given))}, "
                    f"unexpected {sorted(set(given) - set(params.keys()))}")
            for name, value in given.items():
                if not isinstance(value, torch.Tensor):   # a writable copy
                    value = torch.from_numpy(np.array(value, np.float32))
                views[name].copy_(value)
        if self._mixed:
            compute = master.to(self.compute_dtype)
            cviews = {n: compute[o:o + k].view(s)
                      for n, (o, k, s) in layout.items()}
        else:
            compute, cviews = None, views
        for name, p in params.items():
            p.data = cviews[name]
            p.grad = None
        self._master = master
        self._compute = compute
        self._grads = torch.zeros_like(master)
        self._grad_views = {n: self._grads[o:o + k].view(s)
                            for n, (o, k, s) in layout.items()}
        self.opt_state = self.tx.init(master)
        self._step = torch.zeros((), dtype=torch.int32, device=dev)
        self._loss_scale = init_loss_scale(self.config.fp16, device=dev)

    def _flops_per_sample(self):
        s = self.model_config.max_seq_len
        return self.model_config.flops_per_token(s) * s

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
        micro-batch of a step, added for the others."""
        scale = self._loss_scale.scale
        (loss * scale if self.fp16_enabled else loss).backward(
            retain_graph=retain_graph)
        for name, p in self.module.params.items():
            if first:
                self._grad_views[name].copy_(p.grad)
            else:
                self._grad_views[name].add_(p.grad)
            p.grad = None

    def _apply_step(self, losses) -> dict:
        """The update from the accumulated grads (JAX ``apply_grads``):
        unscale and average over GA, the fp16 finite check, the global
        norm and clip coefficient, the optimizer on the master, the loss
        scale; then the counters, once per step, and the report every
        ``steps_per_print`` steps."""
        ga = self.gradient_accumulation_steps_
        scale = self._loss_scale.scale
        grads = self._grads
        # unscale + average over GAS (reference: engine.py:2024)
        if self.fp16_enabled:
            grads.mul_(1.0 / (scale * ga))
        elif ga > 1:
            grads.mul_(1.0 / ga)
        finite = grads_finite([grads]) if self.fp16_enabled else None
        # global grad norm + clip (reference: runtime/utils.py
        # clip_grad_norm_); the coefficient is applied inside the update
        grad_norm = torch.linalg.vector_norm(grads)
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
        overflow = (~finite if finite is not None
                    else torch.zeros((), dtype=torch.bool, device=self.device))
        metrics = {"loss": torch.stack(losses).mean(), "grad_norm": grad_norm,
                   "loss_scale": self._loss_scale.scale, "overflow": overflow}
        self.global_steps += 1
        self.global_samples += self.train_batch_size_
        self._last_metrics = metrics
        if self.global_steps % self.config.steps_per_print == 0:
            self._report(metrics)
        return metrics

    # ------------------------------------------------------------------
    # public API (reference parity)
    # ------------------------------------------------------------------
    def train_batch(self, batch=None, data_iter=None):
        """One full training step (GA micro-batches included). ``batch``
        is ``(tokens, targets)`` or a dict with those keys, leading dim
        train_batch_size. Returns the mean loss (a 0-d device tensor)."""
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
            loss = self.module.loss(self._micro(batch, i, mb))
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
        with torch.no_grad():
            return self.module.loss(self._put_batch(batch))

    # --- forward/backward/step (JAX engine.py:1193-1418) ---------------
    def forward(self, batch):
        """The loss of one micro-batch (reference: engine.forward), with
        its autograd graph, which ``backward`` consumes. JAX recomputes the
        graph in ``backward``; the numbers are the same. The engine holds
        only the latest loss (for ``backward(None)``), so the graph of a
        ``forward`` that no ``backward`` consumed is freed by the next
        ``forward`` once the caller drops it."""
        self._last_loss = self.module.loss(self._put_batch(batch))
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
        self._apply_step(self._micro_losses)
        self._micro_losses = []
        self._micro_count = 0

    def no_sync(self):
        """Context manager (reference: engine.no_sync:1987). At world size
        1 there is no gradient reduction to defer; the context keeps what
        the JAX engine keeps of the reference: it refuses ZeRO stage >= 2
        (partitioned grads), ``step()`` is illegal inside it, and reentry
        is unsupported."""
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
        """The compute-dtype parameters by name (the JAX state's params)."""
        return {n: p.detach() for n, p in self.module.params.items()}

    def master_state_dict(self):
        """The fp32 master parameters by name (views of the flat buffer)."""
        return {n: self._master[o:o + k].view(s)
                for n, (o, k, s) in self._layout.items()}


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
