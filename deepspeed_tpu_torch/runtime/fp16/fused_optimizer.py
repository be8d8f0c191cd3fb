"""FP16_Optimizer — float32-master mixed precision around a port optimizer
(port of ``deepspeed_tpu/runtime/fp16/fused_optimizer.py``; ref:
``deepspeed/runtime/fp16/fused_optimizer.py:33 FP16_Optimizer`` and
``unfused_optimizer.py:24``; the fused/unfused split is a kernel detail
and both names map here).

The engine does the same inline in its step; this class serves client code
that writes its own loop.  It keeps float32 master copies of the
compute-dtype parameters, builds the inner optimizer over them (a factory
``master params -> MasterOptimizer``, the engine's client-optimizer
contract) and a loss scaler.  ``step()`` takes the **scaled** gradients
from the parameters' ``.grad`` and does what JAX's ``update`` does:

  1. unscale by ``1/cur_scale`` in float32, ``found_inf`` over the result;
  2. clip by the global norm (``clip_grad > 0``);
  3. the inner update on the master, skipped on overflow (the master and
     the inner state keep their values: ``step(found_inf=...)``);
  4. the master recast into the parameters (unchanged after a skip: JAX's
     zero deltas), the scaler updated, ``skipped`` counted.

Nothing syncs with the host: the overflow flag, the scale and the skip
count stay on the device.
"""

from typing import Callable, Iterable, List

import torch

from ...ops.optimizer import clip_by_global_norm
from .loss_scaler import create_loss_scaler, found_inf_or_nan


class FP16_Optimizer:

    def __init__(self, params: Iterable[torch.Tensor], optimizer: Callable, fp16_config=None,
                 compute_dtype: torch.dtype = torch.float16, clip_grad: float = 0.0):
        self.params: List[torch.Tensor] = list(params)
        self.compute_dtype = compute_dtype
        self.clip_grad = clip_grad
        device = self.params[0].device
        self.master = [p.detach().float().clone() for p in self.params]
        self.inner = optimizer(self.master)
        self.scaler = create_loss_scaler(fp16_config, compute_dtype)
        self.scaler_state = self.scaler.init_state(device)
        self.skipped = torch.zeros((), dtype=torch.int32, device=device)

    def backward(self, loss: torch.Tensor) -> None:
        """Backward of ``loss · cur_scale`` into the parameters' ``.grad``."""
        (loss.float() * self.scaler_state.cur_scale).backward()

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update from the scaled gradients; returns ``found_inf``."""
        inv = 1.0 / self.scaler_state.cur_scale
        grads = [(p.grad if p.grad is not None else torch.zeros_like(p)).float() * inv for p in self.params]
        found_inf = found_inf_or_nan(grads)
        if self.clip_grad and self.clip_grad > 0:
            clip_by_global_norm(grads, self.clip_grad)
        for m, g in zip(self.master, grads):
            m.grad = g
        self.inner.step(found_inf=found_inf)
        for m in self.master:
            m.grad = None
        for p, m in zip(self.params, self.master):
            p.copy_(m.to(p.dtype))
        self.scaler_state = self.scaler.update(self.scaler_state, found_inf)
        self.skipped += found_inf.int()
        return found_inf

    @property
    def loss_scale(self) -> float:
        return float(self.scaler_state.cur_scale)


# the reference's unfused variant differs only in CUDA kernel choice
FP16_UnfusedOptimizer = FP16_Optimizer
