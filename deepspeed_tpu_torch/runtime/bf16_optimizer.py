"""BF16_Optimizer — bf16 parameters with a float32 master around a port
optimizer (port of ``deepspeed_tpu/runtime/bf16_optimizer.py``; ref:
``deepspeed/runtime/bf16_optimizer.py:35 BF16_Optimizer``).

The engine does this inline when ``bf16.enabled``; the standalone class is
``FP16_Optimizer`` without the loss scaler (bf16's range makes scaling
unnecessary, and the reference has none on this path): ``step()`` takes the
gradients from the parameters' ``.grad`` in float32, clips them by the
global norm when ``clip_grad > 0``, runs the inner optimizer (a factory
``master params -> MasterOptimizer``) on the float32 master and recasts the
master into the parameters.
"""

from typing import Callable, Iterable, List

import torch

from ..ops.optimizer import clip_by_global_norm


class BF16_Optimizer:

    def __init__(self, params: Iterable[torch.Tensor], optimizer: Callable, clip_grad: float = 0.0):
        self.params: List[torch.Tensor] = list(params)
        self.clip_grad = clip_grad
        self.master = [p.detach().float().clone() for p in self.params]
        self.inner = optimizer(self.master)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        grads = [(p.grad if p.grad is not None else torch.zeros_like(p)).float() for p in self.params]
        if self.clip_grad and self.clip_grad > 0:
            clip_by_global_norm(grads, self.clip_grad)
        for m, g in zip(self.master, grads):
            m.grad = g
        self.inner.step()
        for m in self.master:
            m.grad = None
        for p, m in zip(self.params, self.master):
            p.copy_(m.to(p.dtype))
