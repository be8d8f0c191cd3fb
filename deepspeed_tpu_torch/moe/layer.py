"""The MoE layer (port of ``deepspeed_tpu/moe/layer.py``; ref:
``deepspeed/moe/layer.py:17 MoE`` → ``sharded_moe.py:533 MOELayer``).

A drop-in FFN: ``[B, S, d]`` → ``(out [B, S, d], l_aux, exp_counts)``; the
caller adds ``coef · l_aux`` to its loss.  One rank is one gating group of
its B·S tokens (``tokens_per_group``): capacity = max(ceil(k·B·S/E·factor),
``min_capacity``), ``capacity_factor`` when ``train`` and
``eval_capacity_factor`` otherwise, or B·S with ``drop_tokens=False``.

Over several ranks (the training engine calls ``set_expert_parallel``):
JAX splits the global micro-batch into one group per rank of its batch
axes, the contiguous rows each rank takes, so a rank's capacity and drops
are its group's.  ``l_aux`` is this rank's group's (the model averages the
groups' through the ranks' loss shares); ``exp_counts`` is JAX's count over
every group, summed over the ranks outside the autograd graph.  With
``ep_size`` > 1 the bank holds this rank's E/ep experts and the dispatch
buffer crosses the expert group by all-to-all (``sharded_moe``).

Under tensor parallelism (the bank's ``tp``, ``tp_size`` > 1; JAX's
``expert_mlp`` over ``tensor``) the rows and the gating are replicated over
the tensor group: every rank gates the same rows the same way and runs its
slice of each expert's FFN, so its combine is a partial sum, reduced once
over the tensor group in float32 (``reduce_from_tensor_region``: one
all-reduce of ``[B, S, d]`` a layer).  The dispatched rows enter the bank
through ``copy_to_tensor_region`` and the combine weights through another
(their gradients are partial sums on each rank and are all-reduced in the
backward); the gate's own input is not copied, so its gradient, equal on
every rank, is not summed.  ``exp_counts`` sums over ``count_group``, the
data-parallel ranks of the rank's tensor coordinate, never over ``tensor``.

The gate (``Router``) computes float32 logits from float32 inputs and a
float32 weight, whatever dtype the weight is kept in: JAX's gate is a
float32 ``Dense`` with a float32 parameter (``layer.py:52-57``), and a
served checkpoint keeps it in bf16 (``build_hf_engine``), so both operands
are upcast before the product.

Every step of the forward has static shapes and no host sync (``one_hot``
with its class count, ``cumsum``, ``gather``, ``index_add_``,
``index_put``, indexing by long tensors), so the paged Mixtral twin serves
through it, with ``train=False`` and no drops (C = B·S), inside a captured
CUDA graph, as JAX's twin calls its layer.
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..comm import comm
from ..module_inject.layers import copy_to_tensor_region, reduce_from_tensor_region
from .experts import ExpertsFFN
from .sharded_moe import _capacity, dispatch_combine, top1_gating, topk_gating


class Router(nn.Module):
    """A gate ``[n_out, hidden]``: float32 logits of float32 ``x``."""

    def __init__(self, hidden_size: int, num_out: int, dtype=torch.float32, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((num_out, hidden_size), dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.float(), self.weight.float())

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        self.weight.normal_(0.0, 1.0 / math.sqrt(self.weight.shape[1]), generator=generator)


class MoE(nn.Module):
    """ref: ``MoE(hidden_size, expert, num_experts, ep_size, k,
    capacity_factor, eval_capacity_factor, min_capacity, drop_tokens,
    use_rts, noisy_gate_policy)``; ``generator`` draws the ``RSample`` noise
    of top-1 gating in training (JAX's ``gating`` rng; None: no noise).
    ``ep_size`` > 1 builds this rank's experts only (its expert coordinate
    is ``(rank // tp_size) % ep_size``, the mesh's order); ``tp_size`` > 1
    cuts each expert's FFN over the tensor axis."""

    def __init__(self, hidden_size: int, num_experts: int = 1, intermediate_size: Optional[int] = None, k: int = 1,
                 capacity_factor: float = 1.0, eval_capacity_factor: float = 1.0, min_capacity: int = 4,
                 drop_tokens: bool = True, noisy_gate_policy: Optional[str] = None, dtype=torch.bfloat16,
                 param_dtype=torch.float32, device=None, generator: Optional[torch.Generator] = None,
                 ep_size: int = 1, tp_size: int = 1):
        super().__init__()
        self.num_experts, self.k = num_experts, k
        self.capacity_factor, self.eval_capacity_factor = capacity_factor, eval_capacity_factor
        self.min_capacity, self.drop_tokens = min_capacity, drop_tokens
        self.noisy_gate_policy, self.generator = noisy_gate_policy, generator
        self.gate = Router(hidden_size, num_experts, torch.float32, device)
        self.experts = ExpertsFFN(num_experts, hidden_size, intermediate_size or 4 * hidden_size, dtype, param_dtype,
                                  device, ep_size=ep_size, ep_rank=(comm.get_rank() // tp_size) % ep_size,
                                  tp_size=tp_size)
        #: the expert group of the dispatch all-to-all (``ep_size`` > 1)
        self.ep_group = None
        #: the ranks whose groups ``exp_counts`` sums (1: this rank's alone)
        #: and their process group (None: the default group)
        self.count_ranks, self.count_group = 1, None

    def set_expert_parallel(self, ep_group, count_ranks: int, count_group=None) -> None:
        """Route through ``ep_group`` and sum ``exp_counts`` over the
        ``count_ranks`` ranks of ``count_group`` (the engine's set-up)."""
        self.ep_group, self.count_ranks, self.count_group = ep_group, count_ranks, count_group

    def capacity(self, tokens: int, train: bool) -> int:
        if not self.drop_tokens:
            return tokens
        factor = self.capacity_factor if train else self.eval_capacity_factor
        return _capacity(tokens, self.num_experts, factor, self.min_capacity, self.k)

    def forward(self, x: torch.Tensor, train: bool = True):
        b, s, d = x.shape
        tp = self.experts.tp
        tokens = x.reshape(b * s, d)
        logits = self.gate(tokens)
        capacity = self.capacity(b * s, train)
        if self.k == 1:
            noisy = self.noisy_gate_policy if train and self.generator is not None else None
            gating = top1_gating(logits, capacity, noisy, self.generator)
        else:
            gating = topk_gating(logits, self.k, capacity, self.drop_tokens)
        gating = gating._replace(weights=copy_to_tensor_region(gating.weights, tp, "moe_weights"))
        out = dispatch_combine(copy_to_tensor_region(tokens, tp, "moe_in"), gating, self.num_experts, capacity,
                               self.experts, ep_group=self.ep_group, ep_size=self.experts.ep_size)
        # the ranks' float32 partial combines summed once, then rounded
        out = reduce_from_tensor_region(out, tp, "moe").to(self.experts.dtype)
        out = out.reshape(b, s, d).to(x.dtype)
        counts = gating.exp_counts
        if self.count_ranks > 1:   # JAX's sum over the groups, which the gradient does not see
            with torch.no_grad(), comm.unrecorded():
                counts = comm.all_reduce(counts.clone(), comm.ReduceOp.SUM, group=self.count_group)
        return out, gating.l_aux, counts
