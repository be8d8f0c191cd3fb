"""Compressed collectives of the training runtime (port of
``deepspeed_tpu/runtime/comm``): the ZeRO++ quantized gradient wire."""

from .compressed import (GroupedQuantAllreduce, all_to_all_quant_reduce, loco_all_to_all_quant_reduce,
                         padded_quant_allreduce, quantized_all_gather)

__all__ = ["GroupedQuantAllreduce", "all_to_all_quant_reduce", "loco_all_to_all_quant_reduce",
           "padded_quant_allreduce", "quantized_all_gather"]
