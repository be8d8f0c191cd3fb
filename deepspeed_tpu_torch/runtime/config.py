"""DeepSpeed-style JSON config → typed config (port of the training subset of
``deepspeed_tpu/runtime/config.py``; ref: ``deepspeed/runtime/config.py``).

Dataclasses take the place of the JAX package's pydantic models (the port
runs where pydantic is not installed).  Keys the port implements: the batch
triangle (``train_batch_size``, ``train_micro_batch_size_per_gpu``,
``gradient_accumulation_steps``, over the data-parallel world size of the
process group), ``optimizer``, ``scheduler``, ``fp16``, ``bf16``,
``zero_optimization`` (``stage``; ``zero_quantized_gradients`` and
``zeropp_loco_param``, the ZeRO++ quantized gradient wire),
``gradient_clipping``, ``gradient_predivide_factor``, ``steps_per_print``,
``wall_clock_breakdown`` and ``sparse_attention`` (kept as the raw dict, as
the JAX config keeps it, for ``ops.sparse_attention.make_sparsity_config``).
Any other key with a non-default value raises
``NotImplementedError`` naming the ROADMAP item that brings it, and so does
a ZeRO stage above 0 over more than one data-parallel rank (partitioning is
not ported).
"""

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Union

import torch

from ..comm.mesh import ROADMAP_MULTI_DEVICE, dp_world_size
from .constants import (BFLOAT16, BFLOAT16_OLD, COMPRESSION_TRAINING, FP16, GRADIENT_ACCUMULATION_STEPS,
                        GRADIENT_CLIPPING, GRADIENT_CLIPPING_DEFAULT, GRADIENT_PREDIVIDE_FACTOR,
                        GRADIENT_PREDIVIDE_FACTOR_DEFAULT, MOE, OPTIMIZER, PIPELINE, PROGRESSIVE_LAYER_DROP, SCHEDULER,
                        SEQUENCE_PARALLEL_SIZE, SPARSE_ATTENTION, STEPS_PER_PRINT, STEPS_PER_PRINT_DEFAULT, TENSOR_PARALLEL,
                        TRAIN_BATCH_SIZE, TRAIN_MICRO_BATCH_SIZE_PER_GPU, WALL_CLOCK_BREAKDOWN,
                        WALL_CLOCK_BREAKDOWN_DEFAULT, ZERO_OPTIMIZATION, ZERO_QUANTIZED_GRADIENTS,
                        ZEROPP_LOCO_ERR_BETA_DEFAULT, ZEROPP_LOCO_PARAM)

ROADMAP_OFFLOAD = "ROADMAP Queue 1, ZeRO-3 and offload"
ROADMAP_TRAINING_FEATURES = "ROADMAP Queue 1, training features (compression, progressive layer drop, 1-bit)"

#: top-level keys the port does not implement → the ROADMAP item that brings them
UNPORTED_KEYS = {
    PIPELINE: ROADMAP_MULTI_DEVICE,
    TENSOR_PARALLEL: ROADMAP_MULTI_DEVICE,
    SEQUENCE_PARALLEL_SIZE: ROADMAP_MULTI_DEVICE,
    MOE: ROADMAP_MULTI_DEVICE,
    COMPRESSION_TRAINING: ROADMAP_TRAINING_FEATURES,
    PROGRESSIVE_LAYER_DROP: ROADMAP_TRAINING_FEATURES,
}
_IMPLEMENTED_KEYS = {TRAIN_BATCH_SIZE, TRAIN_MICRO_BATCH_SIZE_PER_GPU, GRADIENT_ACCUMULATION_STEPS, OPTIMIZER,
                     SCHEDULER, FP16, BFLOAT16, BFLOAT16_OLD, ZERO_OPTIMIZATION, GRADIENT_CLIPPING,
                     GRADIENT_PREDIVIDE_FACTOR, STEPS_PER_PRINT, WALL_CLOCK_BREAKDOWN, SPARSE_ATTENTION}
#: the JAX package's ZeRO knobs besides ``stage`` and the quantized gradient
#: wire, with their defaults: the port's step has nothing to bucket, overlap
#: or partition
ZERO_DEFAULTS = {
    "contiguous_gradients": True, "reduce_scatter": True, "reduce_bucket_size": 500_000_000,
    "use_multi_rank_bucket_allreduce": True, "allgather_partitions": True, "allgather_bucket_size": 500_000_000,
    "overlap_comm": None, "load_from_fp32_weights": True, "elastic_checkpoint": False, "offload_param": None,
    "offload_optimizer": None, "sub_group_size": 1_000_000_000, "round_robin_gradients": False,
    "ignore_unused_parameters": True, "zero_quantized_weights": False, "zero_hpz_partition_size": 1,
    "mics_shard_size": -1,
}
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


@dataclasses.dataclass
class ZeroConfig:
    stage: int = 0
    #: ZeRO++ qgZ: gradients reduced over int8 (engine: stage 0, gas 1, no fp16, world > 1)
    zero_quantized_gradients: bool = False
    #: ZeRO++ LoCo on top of qgZ: ``{"err_beta": 0.8}``, or None
    zeropp_loco_param: Optional[Dict[str, Any]] = None


def _zero_config(values: Optional[Dict[str, Any]]) -> ZeroConfig:
    values = dict(values or {})
    stage = values.pop("stage", 0)
    if not isinstance(stage, int) or not 0 <= stage <= 3:
        raise DeepSpeedConfigError(f"zero_optimization.stage must be 0..3, got {stage!r}")
    qgz = values.pop(ZERO_QUANTIZED_GRADIENTS, False)
    loco = values.pop(ZEROPP_LOCO_PARAM, None)
    if loco is not None:
        if not isinstance(loco, dict) or set(loco) - {"err_beta"}:
            raise DeepSpeedConfigError(f"zero_optimization.{ZEROPP_LOCO_PARAM} takes {{'err_beta': float}}, "
                                       f"got {loco!r}")
        loco = {"err_beta": float(loco.get("err_beta", ZEROPP_LOCO_ERR_BETA_DEFAULT))}
    for key, value in values.items():
        if key.startswith("offload") or key.startswith("cpu_offload"):
            if value not in _DISABLED and not (isinstance(value, dict) and value.get("device", "none") == "none"):
                raise NotImplementedError(f"zero_optimization.{key} is not ported ({ROADMAP_OFFLOAD})")
        elif key not in ZERO_DEFAULTS:
            raise NotImplementedError(f"zero_optimization.{key} is not ported ({ROADMAP_MULTI_DEVICE})")
        elif value != ZERO_DEFAULTS[key]:
            raise NotImplementedError(f"zero_optimization.{key}={value!r} is not ported: the port's step has "
                                      f"nothing to bucket, overlap or partition ({ROADMAP_MULTI_DEVICE})")
    return ZeroConfig(stage=stage, zero_quantized_gradients=bool(qgz), zeropp_loco_param=loco)


class DeepSpeedConfig:
    """Parse and validate the training config; resolve the batch triangle
    (``train_batch_size = micro × gas × dp``, dp the process group's world
    size, 1 without one)."""

    def __init__(self, config: Union[str, Dict]):
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
        self.dp_world_size = dp_world_size()
        if self.dp_world_size > 1 and self.zero_config.stage > 0:
            raise NotImplementedError(f"ZeRO stage {self.zero_config.stage} over {self.dp_world_size} data-parallel "
                                      f"ranks: partitioning is not ported, stage 0 runs ({ROADMAP_MULTI_DEVICE})")
        self.fp16_config = _block(FP16Config, FP16, pd.get(FP16))
        self.bf16_config = _block(BF16Config, BFLOAT16, pd.get(BFLOAT16, pd.get(BFLOAT16_OLD)))
        self.optimizer_config = _block(OptimizerConfig, OPTIMIZER, pd[OPTIMIZER]) if OPTIMIZER in pd else None
        self.scheduler_config = _block(SchedulerConfig, SCHEDULER, pd[SCHEDULER]) if SCHEDULER in pd else None
        self.gradient_clipping = pd.get(GRADIENT_CLIPPING, GRADIENT_CLIPPING_DEFAULT)
        self.gradient_predivide_factor = pd.get(GRADIENT_PREDIVIDE_FACTOR, GRADIENT_PREDIVIDE_FACTOR_DEFAULT)
        self.steps_per_print = pd.get(STEPS_PER_PRINT, STEPS_PER_PRINT_DEFAULT)
        self.wall_clock_breakdown = pd.get(WALL_CLOCK_BREAKDOWN, WALL_CLOCK_BREAKDOWN_DEFAULT)
        self.sparse_attention = pd.get(SPARSE_ATTENTION, None)

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
