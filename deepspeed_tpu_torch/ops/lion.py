"""Lion as a ``torch.optim.Optimizer`` (port of ``deepspeed_tpu/ops/lion.py``;
ref: DeepSpeed's ``FusedLion``, ``csrc/lion/fused_lion*.cu``).

The arithmetic is the JAX transform's (``lion.py:25-34``), on float32
parameters (the engine's master copy) and a float32 momentum:

    step += 1;  lr = resolve_lr(lr, step)
    u = −lr·sign(b1·m + (1 − b1)·g)      (− lr·wd·p when wd > 0: decoupled)
    m = b2·m + (1 − b2)·g
    p = p + u

Plain tensor ops, as the JAX optimizer is plain jnp.  On overflow
(``step(found_inf=...)``) the parameters, the momentum and the step keep
their values (``MasterOptimizer``).
"""

from typing import Iterable, Optional

import torch

from .optimizer import LR, MasterOptimizer, resolve_lr


class FusedLion(MasterOptimizer):

    STATE_NAMES = ("exp_avg", )

    def __init__(self, params: Iterable[torch.Tensor], lr: LR = 1e-4, betas=(0.9, 0.99), weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None, found_inf: Optional[torch.Tensor] = None):
        if closure is not None:
            raise ValueError("FusedLion.step takes no closure")
        step = self._begin_step(found_inf)
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            lr, wd = resolve_lr(group["lr"], step), group["weight_decay"]
            grads = [p.grad.float() for p in params]
            (exp_avg, ) = self._state_lists(params, ("exp_avg", ))
            upd = torch._foreach_mul(exp_avg, b1)
            torch._foreach_add_(upd, torch._foreach_mul(grads, 1 - b1))
            torch._foreach_sign_(upd)
            torch._foreach_mul_(upd, -lr)
            if wd > 0.0:
                torch._foreach_sub_(upd, torch._foreach_mul(params, lr * wd))
            skip = found_inf is not None
            m = torch._foreach_mul(exp_avg, b2) if skip else exp_avg
            if not skip:
                torch._foreach_mul_(m, b2)
            torch._foreach_add_(m, torch._foreach_mul(grads, 1 - b2))
            if not skip:
                torch._foreach_add_(params, upd)
                continue
            torch._foreach_add_(upd, params)   # upd now holds the new parameters
            self._keep_on_overflow(found_inf, ((params, upd), (exp_avg, m)))
        self._end_step(found_inf, step)
        return None
