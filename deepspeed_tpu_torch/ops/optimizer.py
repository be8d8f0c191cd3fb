"""Optimizer helpers (port of ``deepspeed_tpu/ops/optimizer.py``): the global
gradient norm, weight decay folded into gradients, and learning-rate
resolution.  Lists of tensors take the place of the JAX pytrees; the
``torch._foreach_*`` ops run each step over all tensors in a few launches,
the role of the reference's multi-tensor CUDA kernels."""

from typing import Callable, List, Sequence, Union

import torch

LR = Union[float, Callable[[Union[int, torch.Tensor]], Union[float, torch.Tensor]]]


def resolve_lr(lr: LR, step: Union[int, torch.Tensor]) -> Union[float, torch.Tensor]:
    """``lr`` is a float or a schedule ``step -> lr`` (evaluated at the
    optimizer's own 1-based step, as the JAX transforms do).  A host step
    gives a float; a 0-d tensor step (the device step that an
    overflow-skipped step leaves in place) gives what the schedule returns
    for it, a 0-d tensor on its device for the schedules of
    ``runtime/lr_schedules.py``, so no host sync."""
    if not callable(lr):
        return float(lr)
    value = lr(step)
    return value if isinstance(value, torch.Tensor) else float(value)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over every tensor, in float32, as a 0-dim tensor
    on the tensors' device (no host sync)."""
    if not tensors:
        return torch.zeros((), dtype=torch.float32)
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def add_weight_decay(grads: List[torch.Tensor], params: Sequence[torch.Tensor],
                     weight_decay: float) -> List[torch.Tensor]:
    """``g + wd·p``: L2 regularisation folded into the gradients."""
    if weight_decay == 0.0:
        return list(grads)
    return torch._foreach_add(grads, [p.to(g.dtype) for g, p in zip(grads, params)], alpha=weight_decay)
