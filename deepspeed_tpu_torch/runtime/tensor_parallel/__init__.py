"""Tensor-parallel training manager (port of
``deepspeed_tpu/runtime/tensor_parallel``; ref:
``deepspeed/runtime/tensor_parallel/``)."""

from .tp_manager import ROW_PARALLEL_PATTERNS, TpTrainingManager, TPTrainingConfig

__all__ = ["ROW_PARALLEL_PATTERNS", "TpTrainingManager", "TPTrainingConfig"]
