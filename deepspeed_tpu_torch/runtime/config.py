"""DeepSpeed-style JSON config → typed config (port of the training subset of
``deepspeed_tpu/runtime/config.py``; ref: ``deepspeed/runtime/config.py``).

Dataclasses take the place of the JAX package's pydantic models (the port
runs where pydantic is not installed).  Keys the port implements: the batch
triangle (``train_batch_size``, ``train_micro_batch_size_per_gpu``,
``gradient_accumulation_steps``, over the data-parallel world size of the
process group), ``optimizer``, ``scheduler``, ``fp16``, ``bf16``,
``zero_optimization`` (``stage`` 0-3 at any world size, partitioned over
several ranks by ``runtime/zero``; ``mics_shard_size`` and
``zero_hpz_partition_size``, the partition group; ``zero_quantized_gradients``
and ``zeropp_loco_param``, the ZeRO++ quantized gradient wire; every other
knob of the JAX package's ``DeepSpeedZeroConfig`` is read and recorded, as
there, where the port's step has no use for it),
the offload blocks ``offload_optimizer`` and ``offload_param`` (the tiers of
``runtime/engine.py``: host Adam, the host-streamed and the NVMe tiers, and
the parameters in host memory), ``gradient_clipping``,
``gradient_predivide_factor``, ``steps_per_print``,
``wall_clock_breakdown``, ``sparse_attention`` (kept as the raw dict, as
the JAX config keeps it, for ``ops.sparse_attention.make_sparsity_config``),
``progressive_layer_drop``, ``checkpoint`` and ``nebula`` (the checkpoint
engine and retention), ``moe`` (``expert_parallel_size``: the ``expert``
axis of the mesh, ``mesh_spec``, built as JAX's engine builds it),
``tensor_parallel`` (``autotp_size``: the ``tensor`` axis; the batch
triangle is then over the world over that degree, as JAX's
``_resolve_dp_world_size``), the
monitor blocks ``tensorboard``, ``wandb``,
``csv_monitor`` and ``comet``, ``activation_checkpointing`` (onto the
model's ``remat_policy``, ``runtime/activation_checkpointing``),
``flops_profiler`` (``profiling/``) and ``comms_logger`` (``comm.configure``).
Any other key with a non-default value raises
``NotImplementedError`` naming the ROADMAP item that brings it; in
``zero_optimization`` so does qwZ (``zero_quantized_weights``, item 7), and
so does every offload field the JAX engine stores without acting on it
(``fast_init``, ``ratio`` below 1, the parameter tier's buffer and NVMe
fields, the deprecated ``cpu_offload*`` flags), naming the field.
"""

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Union

import torch

from ..comm.mesh import (ROADMAP_MULTI_DEVICE, ROADMAP_TENSOR_PARALLEL, TENSOR_AXIS, MeshSpec, mesh_from_mpu,
                         process_world_size)
from .constants import (ACTIVATION_CHECKPOINTING, BFLOAT16, BFLOAT16_OLD, CHECKPOINT, CHECKPOINT_TAG_VALIDATION_MODES,
                        COMET, COMMS_LOGGER, COMPRESSION_TRAINING, CSV_MONITOR, DATA_EFFICIENCY, EIGENVALUE, ELASTICITY,
                        FLOPS_PROFILER, FP16, GRADIENT_ACCUMULATION_STEPS, GRADIENT_CLIPPING, HYBRID_ENGINE,
                        GRADIENT_CLIPPING_DEFAULT, GRADIENT_PREDIVIDE_FACTOR, GRADIENT_PREDIVIDE_FACTOR_DEFAULT, MOE,
                        NEBULA, OPTIMIZER, PIPELINE, PROGRESSIVE_LAYER_DROP, SCHEDULER, SEQUENCE_PARALLEL_SIZE,
                        SPARSE_ATTENTION, STEPS_PER_PRINT, STEPS_PER_PRINT_DEFAULT, TENSOR_PARALLEL, TENSORBOARD,
                        TRAIN_BATCH_SIZE, TRAIN_MICRO_BATCH_SIZE_PER_GPU, WALL_CLOCK_BREAKDOWN,
                        WALL_CLOCK_BREAKDOWN_DEFAULT, WANDB, ZERO_OPTIMIZATION,
                        ZEROPP_LOCO_ERR_BETA_DEFAULT, ZEROPP_LOCO_PARAM)

ROADMAP_QWZ = "ROADMAP Queue 1 item 7, compressed comm (qwZ, the quantized weight all-gather of ZeRO-3)"
#: the training features still unported: compression and the 1-bit family
ROADMAP_TRAINING_FEATURES = ("ROADMAP Queue 1 item 7, compressed comm (compression training, the 1-bit "
                             "optimizers)")
ROADMAP_HYBRID_ENGINE = "ROADMAP Queue 1 item 5.4, the hybrid engine (it comes with item 7's linear/)"
ROADMAP_EIGENVALUE = "ROADMAP Queue 1 item 7, MoQ and the eigenvalue"
ROADMAP_AUXILIARIES = "ROADMAP Queue 1 item 8, auxiliaries (elasticity, the data pipeline, activation offload)"

#: top-level keys the port does not implement → the ROADMAP item that brings them
UNPORTED_KEYS = {
    PIPELINE: ROADMAP_MULTI_DEVICE,
    SEQUENCE_PARALLEL_SIZE: ROADMAP_MULTI_DEVICE,
    COMPRESSION_TRAINING: ROADMAP_TRAINING_FEATURES,
    HYBRID_ENGINE: ROADMAP_HYBRID_ENGINE,
    EIGENVALUE: ROADMAP_EIGENVALUE,
    ELASTICITY: ROADMAP_AUXILIARIES,
    DATA_EFFICIENCY: ROADMAP_AUXILIARIES,
}
_IMPLEMENTED_KEYS = {TRAIN_BATCH_SIZE, TRAIN_MICRO_BATCH_SIZE_PER_GPU, GRADIENT_ACCUMULATION_STEPS, OPTIMIZER,
                     SCHEDULER, FP16, BFLOAT16, BFLOAT16_OLD, ZERO_OPTIMIZATION, GRADIENT_CLIPPING,
                     GRADIENT_PREDIVIDE_FACTOR, STEPS_PER_PRINT, WALL_CLOCK_BREAKDOWN, SPARSE_ATTENTION,
                     PROGRESSIVE_LAYER_DROP, CHECKPOINT, NEBULA, TENSORBOARD, WANDB, CSV_MONITOR, COMET, MOE,
                     ACTIVATION_CHECKPOINTING, FLOPS_PROFILER, COMMS_LOGGER, TENSOR_PARALLEL}
_DISABLED = ({}, None, False, 0, 1)   # values of an unported key that leave it off


class DeepSpeedConfigError(Exception):
    pass


def _block(cls, name: str, values: Optional[Dict[str, Any]]):
    """A dataclass from a JSON block; an unknown key raises."""
    values = dict(values or {})
    known = {f.name for f in dataclasses.fields(cls)}
    extra = sorted(set(values) - known)
    if extra:
        raise DeepSpeedConfigError(f"unknown keys in {name!r}: {extra} (known: {sorted(known)})")
    return cls(**values)


@dataclasses.dataclass
class FP16Config:
    """ref: runtime/config.py get_fp16_* readers + runtime/fp16/loss_scaler.py."""
    enabled: bool = False
    auto_cast: bool = False
    loss_scale: float = 0.0  # 0 => dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    consecutive_hysteresis: bool = False
    min_loss_scale: float = 1.0
    fp16_master_weights_and_grads: bool = False


@dataclasses.dataclass
class BF16Config:
    enabled: bool = False
    immediate_grad_update: bool = True


@dataclasses.dataclass
class OptimizerConfig:
    type: Optional[str] = None
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    legacy_fusion: bool = False


@dataclasses.dataclass
class SchedulerConfig:
    type: Optional[str] = None
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


OFFLOAD_DEVICES = ("none", "cpu", "nvme")


@dataclasses.dataclass
class OffloadParamConfig:
    """``zero_optimization.offload_param`` (JAX ``DeepSpeedZeroOffloadParamConfig``,
    ``config.py:88``; ref: ``runtime/zero/offload_config.py``).  The engine
    reads ``device`` (``cpu``, or ``nvme``, which JAX keeps in host memory
    too); ``pin_memory`` is read as the port pins its host tensors on CUDA
    whatever it says.  JAX stores the other fields without acting on them:
    a non-default value raises naming it."""
    device: str = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = 5
    buffer_size: int = 100_000_000
    max_in_cpu: int = 1_000_000_000
    pin_memory: bool = False

    def __post_init__(self):
        _check_device("offload_param", self.device)
        for f in ("nvme_path", "buffer_count", "buffer_size", "max_in_cpu"):
            if getattr(self, f) != OffloadParamConfig.__dataclass_fields__[f].default:
                raise NotImplementedError(f"zero_optimization.offload_param.{f}={getattr(self, f)!r}: the JAX engine "
                                          "stores it without acting on it (its parameters stay in host memory), so "
                                          "the port refuses it")


@dataclasses.dataclass
class OffloadOptimizerConfig:
    """``zero_optimization.offload_optimizer`` (JAX
    ``DeepSpeedZeroOffloadOptimizerConfig``, ``config.py:98``).  The engine
    reads ``device``, ``nvme_path``, ``pipeline_read``/``pipeline_write``
    (the host-streamed tier) and ``buffer_count`` (its groups);
    ``pin_memory`` as ``offload_param``'s.  ``fast_init`` and a ``ratio``
    below 1 (at stage 3; below it JAX refuses the config) are stored by JAX
    without acting on them: they raise naming the field."""
    device: str = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = 4
    pin_memory: bool = False
    pipeline_read: bool = False
    pipeline_write: bool = False
    fast_init: bool = False
    ratio: float = 1.0

    def __post_init__(self):
        _check_device("offload_optimizer", self.device)
        if not isinstance(self.buffer_count, int) or self.buffer_count < 0:
            raise DeepSpeedConfigError(f"offload_optimizer.buffer_count must be >= 0, got {self.buffer_count!r}")
        if not 0.0 <= float(self.ratio) <= 1.0:
            raise DeepSpeedConfigError(f"offload_optimizer.ratio must be in [0, 1], got {self.ratio!r}")
        if self.fast_init:
            raise NotImplementedError("zero_optimization.offload_optimizer.fast_init: the JAX engine stores it "
                                      "without acting on it, so the port refuses it")


def _check_device(block: str, device) -> None:
    if device not in OFFLOAD_DEVICES:
        raise DeepSpeedConfigError(f"zero_optimization.{block}.device must be one of {OFFLOAD_DEVICES}, "
                                   f"got {device!r}")


@dataclasses.dataclass
class ZeroConfig:
    """``zero_optimization`` (JAX ``DeepSpeedZeroConfig``, ``config.py:115-151``;
    ref: ``runtime/zero/config.py``).  The engine reads ``stage``, the
    partition group (``mics_shard_size``, ``zero_hpz_partition_size``:
    ``runtime/zero/mics.py``) and the quantized gradient wire; the bucket,
    overlap, prefetch and persistence knobs are recorded, as the JAX engine
    records them, for a step that has no buckets to size (each collective of
    the port's step is one flat buffer, ``runtime/zero/partitioned.py``).
    The ``stage3_*`` names are aliases of the fields without the prefix."""
    stage: int = 0
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = 500_000_000
    use_multi_rank_bucket_allreduce: bool = True
    allgather_partitions: bool = True
    allgather_bucket_size: int = 500_000_000
    overlap_comm: Optional[bool] = None
    load_from_fp32_weights: bool = True
    elastic_checkpoint: bool = False
    offload_param: Optional[OffloadParamConfig] = None
    offload_optimizer: Optional[OffloadOptimizerConfig] = None
    sub_group_size: int = 1_000_000_000
    cpu_offload_param: Optional[bool] = None
    cpu_offload_use_pin_memory: Optional[bool] = None
    cpu_offload: Optional[bool] = None
    prefetch_bucket_size: int = 50_000_000
    param_persistence_threshold: int = 100_000
    model_persistence_threshold: int = int(1e30)
    max_live_parameters: int = 1_000_000_000
    max_reuse_distance: int = 1_000_000_000
    gather_16bit_weights_on_model_save: bool = False
    module_granularity_threshold: int = 0
    use_all_reduce_for_fetch_params: bool = False
    stage3_gather_fp16_weights_on_model_save: bool = False
    ignore_unused_parameters: bool = True
    legacy_stage1: bool = False
    round_robin_gradients: bool = False
    #: hpZ: the size of the group the stage-3 parameters shard over
    zero_hpz_partition_size: int = 1
    #: qwZ (item 7): raises when on
    zero_quantized_weights: bool = False
    zero_quantized_nontrainable_weights: bool = False
    #: ZeRO++ qgZ: gradients reduced over int8 (engine: stage 0, gas 1, no fp16, world > 1)
    zero_quantized_gradients: bool = False
    #: ZeRO++ LoCo on top of qgZ: ``{"err_beta": 0.8}``, or None
    zeropp_loco_param: Optional[Dict[str, Any]] = None
    #: MiCS: the size of the group everything shards over at stage 3 (-1: all ranks)
    mics_shard_size: int = -1
    mics_hierarchical_params_gather: bool = False
    memory_efficient_linear: bool = True
    pipeline_loading_checkpoint: bool = False
    override_module_apply: bool = True
    log_trace_cache_warnings: bool = False


#: ``stage3_*`` names → the ``ZeroConfig`` fields they alias (JAX ``Field(alias=...)``)
ZERO_ALIASES = {f"stage3_{n}": n for n in ("prefetch_bucket_size", "param_persistence_threshold",
                                            "model_persistence_threshold", "max_live_parameters",
                                            "max_reuse_distance", "gather_16bit_weights_on_model_save",
                                            "module_granularity_threshold", "use_all_reduce_for_fetch_params")}


@dataclasses.dataclass
class PLDConfig:
    """``progressive_layer_drop`` (JAX ``engine.py:191-195``)."""
    enabled: bool = False
    theta: float = 0.5
    gamma: float = 0.001


@dataclasses.dataclass
class TensorParallelConfig:
    """``tensor_parallel`` (JAX ``config.py:299-303``; ref: ``runtime/
    tensor_parallel/config.py`` ``TPTrainingConfig``): ``autotp_size`` is
    the ``tensor`` axis of the engine's mesh; ``tensor_parallel`` (the
    reference's inference block) is recorded.  The injection policy and
    the grain size, which the JAX engine reads nowhere, raise at a
    non-default value."""
    autotp_size: int = 1
    tensor_parallel: Dict[str, Any] = dataclasses.field(default_factory=dict)
    injection_policy_tuple: Optional[Any] = None
    tp_grain_size: int = 1

    def __post_init__(self):
        if not isinstance(self.autotp_size, int) or self.autotp_size < 1:
            raise DeepSpeedConfigError(f"tensor_parallel.autotp_size must be >= 1, got {self.autotp_size!r}")
        if self.injection_policy_tuple is not None or self.tp_grain_size != 1:
            raise NotImplementedError("tensor_parallel.injection_policy_tuple and tp_grain_size are not ported "
                                      f"({ROADMAP_TENSOR_PARALLEL})")


@dataclasses.dataclass
class MoEConfig:
    """``moe`` (JAX ``config.py:329``): the expert-parallel degree (the
    ``expert`` axis of the engine's mesh), and the reference's layer
    defaults.  The engine reads none of those: the layer takes them as
    arguments (``moe.MoE``, or a model's config such as ``MixtralConfig``),
    so a non-default one raises rather than being ignored."""
    enabled: bool = False
    expert_parallel_size: int = 1
    num_experts: int = 1
    top_k: int = 1
    capacity_factor: float = 1.0
    eval_capacity_factor: float = 1.0
    min_capacity: int = 4
    drop_tokens: bool = True
    use_rts: bool = True
    noisy_gate_policy: Optional[str] = None

    def __post_init__(self):
        if not isinstance(self.expert_parallel_size, int) or self.expert_parallel_size < 1:
            raise DeepSpeedConfigError(f"moe.expert_parallel_size must be >= 1, got {self.expert_parallel_size!r}")
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            if f.name not in ("enabled", "expert_parallel_size") and value != f.default:
                raise NotImplementedError(f"moe.{f.name}={value!r} is not read by the engine: the MoE layer takes "
                                          "it as an argument (deepspeed_tpu_torch.moe.MoE, or the model's config)")


@dataclasses.dataclass
class ActivationCheckpointingConfig:
    """``activation_checkpointing`` (JAX ``config.py:188``): the policy knobs
    that ``runtime/activation_checkpointing.policy_from_config`` maps onto
    the model's ``remat_policy``; ``partition_activations`` cuts the inputs
    ``checkpointing.checkpoint`` keeps over the tensor axis (a no-op at
    tensor 1).  ``cpu_checkpointing`` raises (host offload is not
    ported)."""
    partition_activations: bool = False
    contiguous_memory_optimization: bool = False
    cpu_checkpointing: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False

    def __post_init__(self):
        if self.cpu_checkpointing:
            raise NotImplementedError(f"activation_checkpointing.cpu_checkpointing: host offload of activations is "
                                      f"not ported ({ROADMAP_AUXILIARIES})")


@dataclasses.dataclass
class FlopsProfilerConfig:
    """``flops_profiler`` (JAX ``config.py:201``; ref: profiling/config.py)."""
    enabled: bool = False
    recompute_fwd_factor: float = 0.0
    profile_step: int = 1
    module_depth: int = -1
    top_modules: int = 1
    detailed: bool = True
    output_file: Optional[str] = None


@dataclasses.dataclass
class CommsLoggerConfig:
    """``comms_logger`` (JAX ``config.py:212``; ref: comm/config.py)."""
    enabled: bool = False
    verbose: bool = False
    prof_all: bool = True
    debug: bool = False
    prof_ops: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class TensorBoardConfig:
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedJobName"


@dataclasses.dataclass
class WandbConfig:
    enabled: bool = False
    group: Optional[str] = None
    team: Optional[str] = None
    project: str = "deepspeed"


@dataclasses.dataclass
class CSVConfig:
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedJobName"


@dataclasses.dataclass
class CometConfig:
    enabled: bool = False
    samples_log_interval: int = 100
    project: Optional[str] = None
    workspace: Optional[str] = None
    api_key: Optional[str] = None
    experiment_name: Optional[str] = None
    experiment_key: Optional[str] = None
    online: Optional[bool] = None
    mode: Optional[str] = None


@dataclasses.dataclass
class MonitorConfig:
    """ref: monitor/config.py DeepSpeedMonitorConfig (one top-level block
    per backend)."""
    tensorboard: TensorBoardConfig = dataclasses.field(default_factory=TensorBoardConfig)
    comet: CometConfig = dataclasses.field(default_factory=CometConfig)
    wandb: WandbConfig = dataclasses.field(default_factory=WandbConfig)
    csv_monitor: CSVConfig = dataclasses.field(default_factory=CSVConfig)
    #: MonitorMaster forwards at most this many events (0 = unbounded)
    max_events: int = 0


@dataclasses.dataclass
class CheckpointConfig:
    """The ``checkpoint`` block (JAX ``config.py:265``)."""
    tag_validation: str = "Warn"
    load_universal: bool = False
    #: "torch" (or JAX's "orbax"): synchronous; "async"/"nebula": background writer
    checkpoint_engine: str = "torch"
    #: keep-last-K retention after each publish; None/0 keeps everything
    keep_last_n: Optional[int] = None
    #: crc32-verify the whole tag (the state file included) before a load
    verify_checksums_on_load: bool = True

    def __post_init__(self):
        if str(self.tag_validation).capitalize() not in CHECKPOINT_TAG_VALIDATION_MODES:
            raise DeepSpeedConfigError(f"tag_validation must be one of {CHECKPOINT_TAG_VALIDATION_MODES}")
        if self.load_universal:
            raise NotImplementedError("checkpoint.load_universal: the JAX engine stores it without reading it; load "
                                      "a universal checkpoint with deepspeed_tpu_torch.checkpoint."
                                      "load_universal_checkpoint(engine, dir, tag)")
        if self.keep_last_n is not None:
            self.keep_last_n = int(self.keep_last_n)


def _zero_config(values: Optional[Dict[str, Any]]) -> ZeroConfig:
    values = {ZERO_ALIASES.get(k, k): v for k, v in dict(values or {}).items()}
    known = {f.name for f in dataclasses.fields(ZeroConfig)}
    extra = sorted(set(values) - known)
    if extra:
        raise DeepSpeedConfigError(f"unknown keys in {ZERO_OPTIMIZATION!r}: {extra} (known: {sorted(known)})")
    cfg = ZeroConfig(**values)
    if not isinstance(cfg.stage, int) or not 0 <= cfg.stage <= 3:
        raise DeepSpeedConfigError(f"zero_optimization.stage must be 0..3, got {cfg.stage!r}")
    if cfg.offload_param is not None:
        cfg.offload_param = _block(OffloadParamConfig, "offload_param", cfg.offload_param)
    if cfg.offload_optimizer is not None:
        cfg.offload_optimizer = _block(OffloadOptimizerConfig, "offload_optimizer", cfg.offload_optimizer)
        if cfg.offload_optimizer.ratio < 1.0:
            if cfg.stage != 3:   # JAX offload_ratio_check (config.py:159)
                raise DeepSpeedConfigError("Partial offloading only supported for ZeRO Stage 3.")
            raise NotImplementedError(f"zero_optimization.offload_optimizer.ratio={cfg.offload_optimizer.ratio}: "
                                      "the JAX engine stores it without acting on it (all of the state is "
                                      "offloaded), so the port refuses it")
    for key in ("cpu_offload_param", "cpu_offload", "cpu_offload_use_pin_memory"):
        if getattr(cfg, key):
            raise NotImplementedError(f"zero_optimization.{key}: the JAX engine stores this deprecated flag without "
                                      "acting on it, so the port refuses it; use offload_optimizer / offload_param "
                                      "with a device")
    for key in ("zero_quantized_weights", "zero_quantized_nontrainable_weights"):
        if getattr(cfg, key):
            raise NotImplementedError(f"zero_optimization.{key} is not ported ({ROADMAP_QWZ})")
    loco = cfg.zeropp_loco_param
    if loco is not None:
        if not isinstance(loco, dict) or set(loco) - {"err_beta"}:
            raise DeepSpeedConfigError(f"zero_optimization.{ZEROPP_LOCO_PARAM} takes {{'err_beta': float}}, "
                                       f"got {loco!r}")
        cfg.zeropp_loco_param = {"err_beta": float(loco.get("err_beta", ZEROPP_LOCO_ERR_BETA_DEFAULT))}
    cfg.zero_quantized_gradients = bool(cfg.zero_quantized_gradients)
    return cfg


class DeepSpeedConfig:
    """Parse and validate the training config; resolve the batch triangle
    (``train_batch_size = micro × gas × dp``, dp the process group's world
    size, 1 without one).  An outside Megatron-style ``mpu`` sets the
    tensor degree from its grid (``comm/mesh.mesh_from_mpu``); a config
    whose ``tensor_parallel.autotp_size`` names another degree raises."""

    def __init__(self, config: Union[str, Dict], mpu=None):
        if isinstance(config, str):
            if not os.path.exists(config):
                raise DeepSpeedConfigError(f"Expected a valid json file path, got {config}")
            with open(config) as f:
                config = json.load(f)
        if not isinstance(config, dict):
            raise DeepSpeedConfigError(f"Expected a string path or dict, got: {type(config)}")
        self._param_dict = pd = dict(config)
        for key, value in pd.items():
            if key in _IMPLEMENTED_KEYS:
                continue
            if key in UNPORTED_KEYS:
                if value not in _DISABLED and not (isinstance(value, dict) and not value.get("enabled", True)
                                                   and len(value) == 1):
                    raise NotImplementedError(f"config key {key!r} is not ported ({UNPORTED_KEYS[key]})")
            elif value not in _DISABLED:
                raise NotImplementedError(f"config key {key!r} is not ported to the PyTorch package "
                                          "(see ROADMAP Queue 1)")

        self.zero_config = _zero_config(pd.get(ZERO_OPTIMIZATION))
        tp_block = pd.get(TENSOR_PARALLEL)
        self.tensor_parallel_config = _block(TensorParallelConfig, TENSOR_PARALLEL,
                                             tp_block if isinstance(tp_block, dict) else None)
        tp = self.tensor_parallel_config.autotp_size
        if mpu is not None:
            grid = mesh_from_mpu(mpu).shape[TENSOR_AXIS]
            if tp not in (1, grid):
                raise ValueError(f"tensor_parallel.autotp_size {tp} but the mpu's grid has tensor {grid}")
            tp = self.tensor_parallel_config.autotp_size = grid
        #: the data-parallel degree: the process group's ranks over the
        #: tensor degree (JAX ``config.py:468-476``)
        self.dp_world_size = max(1, process_world_size() // tp)
        self.fp16_config = _block(FP16Config, FP16, pd.get(FP16))
        self.bf16_config = _block(BF16Config, BFLOAT16, pd.get(BFLOAT16, pd.get(BFLOAT16_OLD)))
        self.optimizer_config = _block(OptimizerConfig, OPTIMIZER, pd[OPTIMIZER]) if OPTIMIZER in pd else None
        self.scheduler_config = _block(SchedulerConfig, SCHEDULER, pd[SCHEDULER]) if SCHEDULER in pd else None
        self.gradient_clipping = pd.get(GRADIENT_CLIPPING, GRADIENT_CLIPPING_DEFAULT)
        self.gradient_predivide_factor = pd.get(GRADIENT_PREDIVIDE_FACTOR, GRADIENT_PREDIVIDE_FACTOR_DEFAULT)
        self.steps_per_print = pd.get(STEPS_PER_PRINT, STEPS_PER_PRINT_DEFAULT)
        self.wall_clock_breakdown = pd.get(WALL_CLOCK_BREAKDOWN, WALL_CLOCK_BREAKDOWN_DEFAULT)
        self.sparse_attention = pd.get(SPARSE_ATTENTION, None)
        self.pld_config = _block(PLDConfig, PROGRESSIVE_LAYER_DROP, pd.get(PROGRESSIVE_LAYER_DROP))
        self.checkpoint_config = _block(CheckpointConfig, CHECKPOINT, pd.get(CHECKPOINT))
        self.moe = _block(MoEConfig, MOE, pd.get(MOE))
        #: the engine's mesh (JAX ``engine.py:128-136``): data over the ranks
        #: the expert axis leaves; a world it does not divide raises JAX's error
        self.mesh_spec = MeshSpec(data=-1, expert=self.moe.expert_parallel_size, tensor=tp)
        self.mesh_spec.resolve(process_world_size())
        self.activation_checkpointing_config = _block(ActivationCheckpointingConfig, ACTIVATION_CHECKPOINTING,
                                                      pd.get(ACTIVATION_CHECKPOINTING))
        self.flops_profiler_config = _block(FlopsProfilerConfig, FLOPS_PROFILER, pd.get(FLOPS_PROFILER))
        self.comms_config = _block(CommsLoggerConfig, COMMS_LOGGER, pd.get(COMMS_LOGGER))
        self.monitor_config = MonitorConfig(tensorboard=_block(TensorBoardConfig, TENSORBOARD, pd.get(TENSORBOARD)),
                                            wandb=_block(WandbConfig, WANDB, pd.get(WANDB)),
                                            csv_monitor=_block(CSVConfig, CSV_MONITOR, pd.get(CSV_MONITOR)),
                                            comet=_block(CometConfig, COMET, pd.get(COMET)))

        self.train_batch_size = pd.get(TRAIN_BATCH_SIZE)
        self.train_micro_batch_size_per_gpu = pd.get(TRAIN_MICRO_BATCH_SIZE_PER_GPU)
        self.gradient_accumulation_steps = pd.get(GRADIENT_ACCUMULATION_STEPS)
        self._configure_train_batch_size()
        if self.fp16_config.enabled and self.bf16_config.enabled:
            raise DeepSpeedConfigError("fp16 and bf16 modes cannot both be enabled")

    def _configure_train_batch_size(self):
        """ref: runtime/config.py _configure_train_batch_size (JAX ``config.py:478-515``)."""
        dp = self.dp_world_size
        tb, mb, gas = self.train_batch_size, self.train_micro_batch_size_per_gpu, self.gradient_accumulation_steps
        if all(x is None for x in (tb, mb, gas)):
            raise DeepSpeedConfigError("At least one of train_batch_size, train_micro_batch_size_per_gpu, "
                                       "gradient_accumulation_steps must be set")
        if tb is not None and mb is not None and gas is not None:
            if tb != mb * gas * dp:
                raise DeepSpeedConfigError(
                    f"Check batch related parameters. train_batch_size is not equal to micro_batch_per_gpu * "
                    f"gradient_acc_step * world_size {tb} != {mb} * {gas} * {dp}")
        elif tb is not None and mb is not None:
            gas = tb // (mb * dp)
            if gas * mb * dp != tb:
                raise DeepSpeedConfigError(f"train_batch_size {tb} not divisible by micro_batch {mb} * dp {dp}")
        elif tb is not None and gas is not None:
            mb = tb // (gas * dp)
            if mb * gas * dp != tb:
                raise DeepSpeedConfigError(f"train_batch_size {tb} not divisible by gas {gas} * dp {dp}")
        elif tb is not None:
            gas = 1
            mb = tb // dp
            if mb * dp != tb:
                raise DeepSpeedConfigError(f"train_batch_size {tb} not divisible by dp {dp}")
        elif mb is not None:
            gas = gas if gas is not None else 1
            tb = mb * gas * dp
        else:
            raise DeepSpeedConfigError(
                "gradient_accumulation_steps alone is insufficient; also set micro or global batch size")
        self.train_batch_size = tb
        self.train_micro_batch_size_per_gpu = mb
        self.gradient_accumulation_steps = gas

    @property
    def zero_optimization_stage(self) -> int:
        return self.zero_config.stage

    @property
    def precision_dtype(self) -> torch.dtype:
        if self.fp16_config.enabled:
            return torch.float16
        if self.bf16_config.enabled:
            return torch.bfloat16
        return torch.float32
