"""The expert bank (port of ``deepspeed_tpu/moe/experts.py``; ref:
``deepspeed/moe/experts.py:13 Experts``).

E SwiGLU FFNs held as three stacked weights ``[E, in, out]`` (the JAX
layout, so ``models/convert.py`` carries them across unchanged), computed
as batched products (cuBLAS), the weights cast to the compute dtype at use
as flax does.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn


def swiglu_experts(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """``silu(x·w_gate) * (x·w_up) · w_down`` per expert in ``dtype``: x
    ``[E, C, d]`` (each expert its rows) or ``[1, T, d]`` (every expert on
    the same rows) → ``[E, C|T, d]``."""
    x = x.to(dtype)
    h = F.silu(torch.matmul(x, w_gate.to(dtype))) * torch.matmul(x, w_up.to(dtype))
    return torch.matmul(h, w_down.to(dtype))


class ExpertsFFN(nn.Module):
    """E parallel SwiGLU FFNs: ``[E, C, d]`` → ``[E, C, d]`` (JAX ``:18``)."""

    def __init__(self, num_experts: int, hidden_size: int, intermediate_size: int, dtype=torch.bfloat16,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        shape = (num_experts, hidden_size, intermediate_size)
        self.w_gate = nn.Parameter(torch.empty(shape, dtype=param_dtype, device=device))
        self.w_up = nn.Parameter(torch.empty(shape, dtype=param_dtype, device=device))
        self.w_down = nn.Parameter(torch.empty((num_experts, intermediate_size, hidden_size), dtype=param_dtype,
                                               device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swiglu_experts(x, self.w_gate, self.w_up, self.w_down, self.dtype)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        """Each expert's matrices N(0, 1/fan_in) (``llama.init_weights_``)."""
        for w in (self.w_gate, self.w_up, self.w_down):
            w.normal_(0.0, 1.0 / math.sqrt(w.shape[1]), generator=generator)
