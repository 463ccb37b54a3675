"""Master training config (counterpart of ``deepspeed_tpu/runtime/config.py``).

Takes the same DeepSpeed JSON as the JAX ``DeepSpeedConfig``. The blocks
the training step reads are dataclasses with the JAX field names and
defaults: batch sizes, ``optimizer``, ``scheduler``, ``fp16``, ``bf16``,
``zero_optimization``, ``gradient_clipping``, ``steps_per_print``, ``seed``,
``activation_checkpointing``, ``checkpoint`` and ``moe`` (the
dispatch exchange, its wire and routing overrides; router telemetry
raises).
Every other block the JAX config declares is accepted by name at its JAX
defaults (``UNPORTED``); a key set away from its default is a feature the
port does not have yet and raises ``NotImplementedError`` naming its
ROADMAP slice. ``mesh`` also takes the
meshes over ranks (``parallel/mesh.py``: dp, fsdp, zps and ep in any
mix; :meth:`DeepSpeedConfig.topology_config` carves the zps axis of
hpZ and MiCS out of fsdp as the JAX engine does). An unknown key raises
``ValueError``, as everywhere in the port. ``prescale_gradients``,
``gradient_predivide_factor``, ``memory_breakdown``, ``dump_state`` and
``fp16.auto_cast`` are accepted and, as in the JAX engine, read by nothing.

Batch sizes resolve as in the reference: train_batch == micro_batch *
grad_accum * data_parallel_size, any one derivable from the other two.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional

import torch

from ..moe.sharded_moe import TELEMETRY_UNPORTED
from ..parallel.mesh import TopologyConfig, check_ported
from .comm.moe_alltoall import MOE_WIRE_DTYPES
from .config_utils import DeepSpeedConfigModel

_field = dataclasses.field


@dataclasses.dataclass
class FP16Config(DeepSpeedConfigModel):
    enabled: bool = False
    loss_scale: float = 0.0  # 0 -> dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    min_loss_scale: float = 1.0
    auto_cast: bool = False


@dataclasses.dataclass
class BF16Config(DeepSpeedConfigModel):
    enabled: bool = False


@dataclasses.dataclass
class OffloadOptimizerConfig(DeepSpeedConfigModel):
    device: str = "none"
    nvme_path: Optional[str] = None
    pin_memory: bool = False
    ratio: float = 1.0
    moment_dtype: str = "float32"


@dataclasses.dataclass
class OffloadParamConfig(DeepSpeedConfigModel):
    device: str = "none"
    nvme_path: Optional[str] = None
    pin_memory: bool = False
    stream: Optional[bool] = None
    stream_dtype: str = "master"


@dataclasses.dataclass
class ZeroConfig(DeepSpeedConfigModel):
    """The JAX ZeroConfig's fields. Which of them the port runs is decided
    by ``runtime/zero.py``; the bucket sizes, prefetch and overlap switches
    tune the JAX package's compiled collectives and are read by nothing
    here (the port's gathers and reductions run leaf by leaf)."""
    stage: int = 0
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = int(5e8)
    allgather_bucket_size: int = int(5e8)
    overlap_comm: bool = True
    offload_optimizer: OffloadOptimizerConfig = _field(
        default_factory=OffloadOptimizerConfig)
    offload_param: OffloadParamConfig = _field(
        default_factory=OffloadParamConfig)
    sub_group_size: int = int(1e9)
    stage3_prefetch_bucket_size: int = int(5e7)
    stage3_param_persistence_threshold: int = int(1e5)
    stage3_max_live_parameters: int = int(1e9)
    stage3_gather_16bit_weights_on_model_save: bool = False
    zero_hpz_partition_size: int = 1
    zero_quantized_weights: bool = False
    zero_quantized_gradients: bool = False
    zero_quantized_dtype: str = "int8"
    zero_hierarchical_allgather: bool = False
    zero_quantized_rounding: str = "stochastic"
    mics_shard_size: int = -1
    mics_hierarchical_params_gather: bool = False
    round_robin_gradients: bool = False
    ignore_unused_parameters: bool = True


@dataclasses.dataclass
class OptimizerConfig(DeepSpeedConfigModel):
    type: str = "adamw"
    params: dict[str, Any] = _field(default_factory=dict)


@dataclasses.dataclass
class SchedulerConfig(DeepSpeedConfigModel):
    type: Optional[str] = None
    params: dict[str, Any] = _field(default_factory=dict)


@dataclasses.dataclass
class ActivationCheckpointingConfig(DeepSpeedConfigModel):
    """The JAX block's fields. ``policy`` set explicitly overrides the
    model's ``remat_policy`` (``"none"`` turns remat off), as in the JAX
    engine; the other fields configure
    ``runtime/activation_checkpointing/checkpointing.py`` (``configure``),
    which reads ``partition_activations``, ``cpu_checkpointing``,
    ``number_checkpoints`` and ``profile`` as the JAX module does."""
    partition_activations: bool = False
    cpu_checkpointing: bool = False
    contiguous_memory_optimization: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False
    policy: str = "nothing_saveable"


_MONITOR = {"enabled": False, "output_path": "",
            "job_name": "DeepSpeedJobName"}

# block -> (JAX defaults, ROADMAP slice that ports it)
UNPORTED: dict[str, tuple[dict[str, Any], str]] = {
    "mesh": ({"pp": 1, "dp": 1, "fsdp": -1, "zps": 1, "ep": 1, "sp": 1,
              "tp": 1, "dcn": {}}, "Slice D"),
    "sequence_parallel": ({"mode": "auto"}, "Slice D (sequence/)"),
    "comms_logger": ({"enabled": False, "verbose": False, "prof_all": True,
                      "prof_ops": [], "debug": False}, "Slice G (tooling)"),
    "telemetry": ({
        "enabled": False, "span_buffer_size": 8192,
        "profiler_annotations": True, "jax_compile_events": True,
        "flush_interval_steps": 0, "executable_ledger": False,
        "hlo_collectives": True, "device_peak_flops": 0.0,
        "flight_recorder": False, "flight_recorder_size": 2048,
        "watchdog_deadline_s": 0.0,
        "watchdog_artifact_dir": "telemetry_hangdump",
        "watchdog_abort": False, "request_traces": True,
        "request_trace_size": 1024, "steptrace": True,
        "steptrace_size": 2048, "steptrace_regression_window": 32,
        "steptrace_regression_threshold": 0.5, "straggler_interval_s": 1.0,
        "fleet": False, "fleet_replica": "", "timeseries_capacity": 512,
        "timeseries_interval_s": 0.25, "burn_windows_s": []},
        "Slice G (telemetry/)"),
    "sentinels": ({"enabled": False, "mode": "raise", "recompile": True,
                   "transfer_guard": True, "warmup_steps": 1},
                  "Slice G (analysis/)"),
    "meshsan": ({"enabled": False, "mode": "raise", "axes": None,
                 "all_to_all_axes": None, "wire_min_bytes": 65536},
                "Slice G (analysis/)"),
    "numsan": ({"enabled": False, "mode": "raise", "saturation_ceiling": 0.05,
                "saturation_probe": True}, "Slice G (analysis/)"),
    "flops_profiler": ({"enabled": False, "profile_step": 1,
                        "module_depth": -1, "top_modules": 1,
                        "detailed": True, "output_file": None},
                       "Slice G (profiling/)"),
    "tensorboard": (_MONITOR, "Slice G (monitor/)"),
    "wandb": ({"enabled": False, "group": None, "team": None,
               "project": "deepspeed_tpu"}, "Slice G (monitor/)"),
    "csv_monitor": (_MONITOR, "Slice G (monitor/)"),
    "comet": ({"enabled": False, "samples_log_interval": 100,
               "project": None, "workspace": None, "api_key": None,
               "experiment_name": None, "experiment_key": None,
               "online": None, "mode": None}, "Slice G (monitor/)"),
    "pipeline": ({"stages": "auto", "partition_method": "parameters",
                  "activation_checkpoint_interval": 0, "schedule": "gpipe"},
                 "Slice D (runtime/pipe/)"),
    "data_efficiency": ({"enabled": False, "seed": 1234,
                         "data_sampling": {}, "data_routing": {}},
                        "Slice F (runtime/data_pipeline/)"),
    "curriculum_learning": ({
        "enabled": False, "curriculum_type": "seqlen", "min_difficulty": 8,
        "max_difficulty": 1024, "schedule_type": "fixed_linear",
        "schedule_config": {}}, "Slice F (runtime/data_pipeline/)"),
    "aio": ({"block_size": 1048576, "queue_depth": 8, "thread_count": 1,
             "single_submit": False, "overlap_events": True},
            "Slice E (ops/aio.py)"),
    "elasticity": ({
        "enabled": False, "max_train_batch_size": 2000,
        "micro_batch_sizes": [2, 4, 6], "min_gpus": 1, "max_gpus": 10000,
        "min_time": 0, "version": 0.2, "prefer_larger_batch": True,
        "ignore_non_elastic_batch_info": False, "model_parallel_size": 1,
        "num_gpus_per_node": 1}, "Slice G (elasticity/)"),
    "hybrid_engine": ({"enabled": False, "max_out_tokens": 512,
                       "inference_tp_size": 1,
                       "release_inference_cache": False,
                       "pin_parameters": True,
                       "tp_gather_partition_size": 8},
                      "Slice F (hybrid_engine.py)"),
    "autotuning": ({
        "enabled": False, "fast": True, "metric": "throughput",
        "start_step": 1, "end_step": 4, "tuner_type": "gridsearch",
        "tuner_early_stopping": 5, "tuner_num_trials": 50,
        "max_train_batch_size": None, "min_train_batch_size": 1,
        "max_train_micro_batch_size_per_gpu": None,
        "min_train_micro_batch_size_per_gpu": 1,
        "num_tuning_micro_batch_sizes": 3, "zero_stages": None,
        "overwrite": True, "results_dir": "autotuning_results",
        "exps_dir": "autotuning_exps", "arg_mappings": {},
        "mesh_axes": ["fsdp"], "remat_policies": ["nothing_saveable"],
        "offload_ratios": [0.0], "overlap_ratios": [0.71],
        "wire_dtypes": ["fp32"], "moe_capacity_factors": [0.0],
        "moe_wire_dtypes": ["fp32"], "analytic_wire": True,
        "include_base": True, "memory_safety_factor": 1.1,
        "calibration_steps": 3, "measure_windows": 2, "calibrate": True,
        "measure_top_k": 0, "plan_path": "", "serving_k_steps": [4, 8],
        "serving_chain_depths": [1, 2, 4], "serving_ring_modes": [False, True],
        "serving_draft_lens": [0, 3], "serving_kv_dtypes": ["fp16"],
        "serving_kv_blocks": [0], "serving_shed_depths": [0, 16],
        "serving_replicas": [1], "serving_disagg": [False],
        "serving_plan_path": ""}, "Slice G (autotuning/)"),
}
# pydantic aliases of the JAX blocks above
_UNPORTED_ALIASES = {"elasticity": {
    "max_acceptable_batch_size": "max_train_batch_size",
    "prefer_larger_batch_size": "prefer_larger_batch"}}


def _refuse_non_defaults(block: str, given: dict, defaults: dict,
                         where: str) -> None:
    """``NotImplementedError`` for the first key of ``given`` set away from
    its default (``enabled: false`` is always the default's meaning)."""
    for key, value in given.items():
        if key == "enabled" and not value:
            continue
        if value != defaults[key]:
            raise NotImplementedError(
                f"{block}.{key}={value!r} is not ported yet (ROADMAP: port "
                f"Queue 1, {where})")


def check_unported_block(name: str, block: dict) -> None:
    defaults, where = UNPORTED[name]
    if not isinstance(block, dict):
        raise ValueError(f"{name} must be a JSON object, got {block!r}")
    given = {_UNPORTED_ALIASES.get(name, {}).get(k, k): v
             for k, v in block.items()}
    unknown = sorted(set(given) - set(defaults))
    if unknown:
        raise ValueError(f"{name}: unknown config key(s) {unknown}; the JAX "
                         f"package declares {sorted(defaults)}")
    if name == "mesh":
        # the meshes over ranks: dp, fsdp (-1 absorbs the world), zps and
        # ep, every other axis 1 (parallel/mesh.py)
        if given.get("dcn"):
            raise NotImplementedError(
                f"mesh.dcn {given['dcn']} is not ported yet (ROADMAP: port "
                f"Queue 1, Slice D item 12 (multi-slice meshes))")
        check_ported({k: v for k, v in given.items() if k != "dcn"})
        return
    _refuse_non_defaults(name, given, defaults, where)


@dataclasses.dataclass
class MoEConfig(DeepSpeedConfigModel):
    """The ``moe`` block (JAX ``MoEConfig``): ``enabled`` binds the explicit
    dispatch/combine exchange (``moe/dispatch.py``; None: when the mesh's
    ``ep`` > 1), ``wire_dtype`` is its dispatch wire (fp32 exact, bf16,
    int8 or fp8 block-quantized, forward only) and ``rounding`` the int8
    wire's; ``capacity_factor`` / ``min_capacity`` override the model
    config's routing (None: its values). ``router_telemetry`` raises
    naming Slice G item 15."""
    enabled: Optional[bool] = None
    wire_dtype: str = "fp32"
    rounding: str = "stochastic"
    capacity_factor: Optional[float] = None
    min_capacity: Optional[int] = None
    router_telemetry: bool = False

    def __post_init__(self):
        super().__post_init__()
        if self.wire_dtype not in MOE_WIRE_DTYPES:
            raise ValueError(f"moe.wire_dtype {self.wire_dtype!r}: one of "
                             f"{MOE_WIRE_DTYPES}")
        if self.rounding not in ("nearest", "stochastic"):
            raise ValueError(f"moe.rounding {self.rounding!r}: 'nearest' "
                             f"or 'stochastic'")
        if self.router_telemetry:
            raise NotImplementedError(TELEMETRY_UNPORTED)


TAG_VALIDATION = ("Ignore", "Warn", "Fail")


@dataclasses.dataclass
class CheckpointConfig(DeepSpeedConfigModel):
    """The ``checkpoint`` block (JAX ``CheckpointConfig``):
    ``tag_validation`` checks that every rank saves under one tag,
    ``load_universal`` makes ``load_checkpoint`` read a universal
    directory, ``async_save`` selects the engine that writes in the
    background (``runtime/checkpoint_engine.py``)."""
    tag_validation: str = "Warn"
    load_universal: bool = False
    async_save: bool = False

    def __post_init__(self):
        super().__post_init__()
        if self.tag_validation not in TAG_VALIDATION:
            raise ValueError(f"checkpoint.tag_validation "
                             f"{self.tag_validation!r}: one of "
                             f"{TAG_VALIDATION}")


@dataclasses.dataclass
class DeepSpeedConfig(DeepSpeedConfigModel):
    train_batch_size: Optional[int] = None
    train_micro_batch_size_per_gpu: Optional[int] = None
    gradient_accumulation_steps: Optional[int] = None
    steps_per_print: int = 10
    gradient_clipping: float = 0.0
    prescale_gradients: bool = False
    gradient_predivide_factor: float = 1.0
    wall_clock_breakdown: bool = False
    memory_breakdown: bool = False
    dump_state: bool = False
    seed: int = 1234

    optimizer: Optional[OptimizerConfig] = None
    scheduler: Optional[SchedulerConfig] = None
    fp16: FP16Config = _field(default_factory=FP16Config)
    bf16: BF16Config = _field(default_factory=BF16Config)
    zero_optimization: ZeroConfig = _field(default_factory=ZeroConfig)
    activation_checkpointing: ActivationCheckpointingConfig = _field(
        default_factory=ActivationCheckpointingConfig)
    # accepted at their JAX defaults only (UNPORTED)
    mesh: dict = _field(default_factory=dict)
    sequence_parallel: dict = _field(default_factory=dict)
    comms_logger: dict = _field(default_factory=dict)
    telemetry: dict = _field(default_factory=dict)
    sentinels: dict = _field(default_factory=dict)
    meshsan: dict = _field(default_factory=dict)
    numsan: dict = _field(default_factory=dict)
    moe: MoEConfig = _field(default_factory=MoEConfig)
    flops_profiler: dict = _field(default_factory=dict)
    tensorboard: dict = _field(default_factory=dict)
    wandb: dict = _field(default_factory=dict)
    csv_monitor: dict = _field(default_factory=dict)
    comet: dict = _field(default_factory=dict)
    pipeline: dict = _field(default_factory=dict)
    data_efficiency: dict = _field(default_factory=dict)
    curriculum_learning: dict = _field(default_factory=dict)
    compression_training: dict = _field(default_factory=dict)
    aio: dict = _field(default_factory=dict)
    checkpoint: CheckpointConfig = _field(default_factory=CheckpointConfig)
    elasticity: dict = _field(default_factory=dict)
    hybrid_engine: dict = _field(default_factory=dict)
    autotuning: dict = _field(default_factory=dict)

    def __post_init__(self):
        super().__post_init__()
        for name in UNPORTED:
            check_unported_block(name, getattr(self, name))
        if self.compression_training:
            raise NotImplementedError(
                "compression_training is not ported yet (ROADMAP: port "
                "Queue 1, Slice F (compression/))")
        if self.wall_clock_breakdown:
            raise NotImplementedError(
                "wall_clock_breakdown needs the telemetry span tracer, not "
                "ported yet (ROADMAP: port Queue 1, Slice G (telemetry/))")

    @classmethod
    def from_any(cls, config: "str | dict | DeepSpeedConfig | None"
                 ) -> "DeepSpeedConfig":
        if config is None:
            return cls()
        if isinstance(config, DeepSpeedConfig):
            return config
        if isinstance(config, str):
            with open(config) as f:
                config = json.load(f)
        return cls.from_dict(config)

    # -- batch-size arithmetic (reference: runtime/config.py:893-947) -----
    def resolve_batch_sizes(self, data_parallel_size: int
                            ) -> tuple[int, int, int]:
        """Returns (train_batch, micro_batch_per_device, grad_accum)."""
        tb, mb, ga = (self.train_batch_size,
                      self.train_micro_batch_size_per_gpu,
                      self.gradient_accumulation_steps)
        dp = data_parallel_size
        have = lambda v: v is not None  # noqa: E731 — 0 must NOT read as unset
        if have(tb) and have(mb) and have(ga):
            pass
        elif have(tb) and have(mb):
            ga = tb // (mb * dp)
        elif have(tb) and have(ga):
            mb = tb // (ga * dp)
        elif have(mb) and have(ga):
            tb = mb * ga * dp
        elif have(tb):
            ga = 1
            mb = tb // dp
        elif have(mb):
            ga = 1
            tb = mb * dp
        else:
            tb, mb, ga = dp, 1, 1
        if tb != mb * ga * dp:
            raise ValueError(
                f"Check batch related parameters. train_batch_size is not "
                f"equal to micro_batch_per_gpu * gradient_acc_step * "
                f"world_size {tb} != {mb} * {ga} * {dp}")
        if min(tb, mb, ga) <= 0:
            raise ValueError(
                f"Batch sizes must be positive: train={tb} micro={mb} "
                f"accum={ga} dp={dp}")
        self.train_batch_size = tb
        self.train_micro_batch_size_per_gpu = mb
        self.gradient_accumulation_steps = ga
        return tb, mb, ga

    def topology_config(self) -> TopologyConfig:
        """The mesh block as axis degrees, with ZeRO++ hpZ's or MiCS's
        shard sub-group carved out of fsdp as the inner zps axis (JAX
        ``runtime/engine.py:93-113``): ``zero_hpz_partition_size`` or
        ``mics_shard_size`` > 1 sets zps where the block leaves it 1, and
        an explicit fsdp is divided by it. ``mics_hierarchical_params_
        gather`` is accepted and, as in JAX, changes nothing."""
        mesh = TopologyConfig.from_mesh_block(self.mesh)
        zero = self.zero_optimization
        if zero.zero_hpz_partition_size > 1 and zero.mics_shard_size > 1:
            raise ValueError(
                "zero_hpz_partition_size and mics_shard_size are mutually "
                "exclusive sharding modes; set only one")
        sub = max(zero.zero_hpz_partition_size,
                  zero.mics_shard_size if zero.mics_shard_size > 1 else 1)
        if sub > 1 and mesh.zps == 1:
            fsdp = mesh.fsdp
            if fsdp not in (-1, 1):
                if fsdp % sub != 0:
                    raise ValueError(
                        f"mesh.fsdp={fsdp} is not divisible by "
                        f"zero_hpz_partition_size/mics_shard_size={sub}")
                fsdp //= sub
            mesh = dataclasses.replace(mesh, fsdp=fsdp, zps=sub)
        return mesh

    @property
    def compute_dtype(self) -> torch.dtype:
        if self.fp16.enabled:
            return torch.float16
        if self.bf16.enabled:
            return torch.bfloat16
        return torch.float32
