"""Mixture of Experts (port of ``deepspeed_tpu/moe``): top-1/top-k gating
with capacity, the stacked expert bank and the ``MoE`` layer; over several
ranks one gating group a rank, and with expert parallelism each rank's
experts and the dispatch all-to-all."""

from .experts import ExpertsFFN, swiglu_experts
from .layer import MoE, Router
from .sharded_moe import Gating, dispatch_combine, top1_gating, topk_gating

__all__ = ["ExpertsFFN", "Gating", "MoE", "Router", "dispatch_combine", "swiglu_experts", "top1_gating",
           "topk_gating"]
