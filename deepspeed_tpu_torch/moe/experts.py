"""The expert bank (port of ``deepspeed_tpu/moe/experts.py``; ref:
``deepspeed/moe/experts.py:13 Experts``).

E SwiGLU FFNs held as three stacked weights ``[E, in, out]`` (the JAX
layout, so ``models/convert.py`` carries them across unchanged), computed
as batched products (cuBLAS), the weights cast to the compute dtype at use
as flax does.

Under expert parallelism over ``ep_size`` ranks a bank holds its rank's
E/ep experts, ``[E/ep, in, out]``, from global expert ``first_expert`` on
(expert ``e·E/ep`` at expert coordinate ``e``: JAX's shard of the
``experts`` dim over the ``expert`` axis).  Under tensor parallelism over
``tp_size`` ranks (JAX's ``expert_mlp`` over ``tensor``, ``tp_rules.py:62``)
each expert's FFN is cut as a Megatron MLP: ``w_gate``/``w_up`` column-
parallel (``[E/ep, in, m/N]``), ``w_down`` row-parallel (``[E/ep, m/N,
in]``), rank ``t`` holding units ``[t·m/N, (t+1)·m/N)``, so the bank's
output is this rank's partial sum (the MoE layer reduces it once, after the
combine).  ``init_weights_`` draws every expert of the whole bank, whole,
from the generator in turn and keeps its own experts' slices, so a rank's
weights equal that slice of a one-rank bank at the same seed.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..module_inject.layers import TensorParallel, narrow_to_rank


def swiglu_experts(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """``silu(x·w_gate) * (x·w_up) · w_down`` per expert in ``dtype``: x
    ``[E, C, d]`` (each expert its rows) or ``[1, T, d]`` (every expert on
    the same rows) → ``[E, C|T, d]``."""
    x = x.to(dtype)
    h = F.silu(torch.matmul(x, w_gate.to(dtype))) * torch.matmul(x, w_up.to(dtype))
    return torch.matmul(h, w_down.to(dtype))


class ExpertsFFN(nn.Module):
    """E parallel SwiGLU FFNs: ``[E/ep, C, d]`` → ``[E/ep, C, d]`` (JAX ``:18``);
    ``ep_rank`` is the rank's expert coordinate, ``tp_size`` the tensor
    degree its FFNs are cut over (its coordinate set by
    ``module_inject.layers.set_tensor_parallel_``)."""

    WEIGHTS = ("w_gate", "w_up", "w_down")
    #: the dim of each weight cut over the tensor axis (``expert_mlp``)
    TP_DIMS = {"w_gate": 2, "w_up": 2, "w_down": 1}

    def __init__(self, num_experts: int, hidden_size: int, intermediate_size: int, dtype=torch.bfloat16,
                 param_dtype=torch.float32, device=None, ep_size: int = 1, ep_rank: int = 0, tp_size: int = 1):
        super().__init__()
        if num_experts % ep_size:
            raise ValueError(f"{num_experts} experts do not split over {ep_size} expert-parallel ranks")
        if intermediate_size % tp_size:
            raise ValueError(f"tensor parallelism over {tp_size} ranks does not divide an expert width of "
                             f"{intermediate_size}")
        self.dtype, self.num_experts = dtype, num_experts
        self.ep_size, self.first_expert = ep_size, ep_rank * (num_experts // ep_size)
        #: this rank's place on the tensor axis
        self.tp = TensorParallel(tp_size)
        local, m = num_experts // ep_size, intermediate_size // tp_size
        self.w_gate = nn.Parameter(torch.empty((local, hidden_size, m), dtype=param_dtype, device=device))
        self.w_up = nn.Parameter(torch.empty((local, hidden_size, m), dtype=param_dtype, device=device))
        self.w_down = nn.Parameter(torch.empty((local, m, hidden_size), dtype=param_dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swiglu_experts(x, self.w_gate, self.w_up, self.w_down, self.dtype)

    @property
    def local_experts(self) -> int:
        return self.num_experts // self.ep_size

    @torch.no_grad()
    def shard_(self, ep_size: int, ep_rank: int) -> None:
        """Keep the experts of expert coordinate ``ep_rank`` of ``ep_size`` of a whole bank."""
        if self.ep_size != 1:
            raise ValueError(f"the bank is already split over {self.ep_size} expert-parallel ranks")
        if self.num_experts % ep_size:
            raise ValueError(f"{self.num_experts} experts do not split over {ep_size} expert-parallel ranks")
        local = self.num_experts // ep_size
        for name in self.WEIGHTS:
            w = getattr(self, name)
            w.data = w.data[ep_rank * local:(ep_rank + 1) * local].clone()
        self.ep_size, self.first_expert = ep_size, ep_rank * local

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        """Each expert's matrices N(0, 1/fan_in) (``llama.init_weights_``),
        drawn whole expert by expert over the whole bank; the rank keeps its
        experts' tensor slices."""
        own = range(self.first_expert, self.first_expert + self.local_experts)
        for name in self.WEIGHTS:
            w = getattr(self, name)
            dim = self.TP_DIMS[name]
            shape = list(w.shape[1:])
            shape[dim - 1] *= self.tp.size
            std = 1.0 / math.sqrt(shape[0])
            scratch = torch.empty(shape, dtype=w.dtype, device=w.device)
            for j in range(self.num_experts):
                scratch.normal_(0.0, std, generator=generator)
                if j in own:
                    w[j - self.first_expert].copy_(narrow_to_rank(scratch, dim - 1, self.tp))
