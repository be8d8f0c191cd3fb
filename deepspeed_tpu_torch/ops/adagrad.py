"""Adagrad and SGD as ``torch.optim.Optimizer``s (port of
``deepspeed_tpu/ops/adagrad.py``; ref: ``csrc/adagrad/cpu_adagrad.cpp``,
``deepspeed/ops/adagrad``).

The arithmetic is the JAX transforms' (``adagrad.py:21-48``), on float32
parameters (the engine's master copy) and float32 state:

    Adagrad:  lr = resolve_lr(lr, step + 1);  g = g + wd·p
              a = a + g²;  p = p − lr·g / (sqrt(a) + eps)
    SGD:      lr = resolve_lr(lr, 0);  g = g + wd·p
              with momentum: b = momentum·b + g;  e = g + momentum·b (nesterov) or b
              p = p − lr·e  (− lr·g without momentum)

JAX's SGD keeps no step: its schedule is read at step 0 on every update,
and so it is here.  Plain tensor ops, as the JAX optimizers are plain jnp.
On overflow (``step(found_inf=...)``) the parameters and the state keep
their values (``MasterOptimizer``).
"""

from typing import Iterable, Optional

import torch

from .optimizer import LR, MasterOptimizer, add_weight_decay, resolve_lr


class Adagrad(MasterOptimizer):

    STATE_NAMES = ("accum", )

    def __init__(self, params: Iterable[torch.Tensor], lr: LR = 1e-2, eps: float = 1e-10, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None, found_inf: Optional[torch.Tensor] = None):
        if closure is not None:
            raise ValueError("Adagrad.step takes no closure")
        step = self._begin_step(found_inf)
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            lr, wd, eps = resolve_lr(group["lr"], step), group["weight_decay"], group["eps"]
            grads = add_weight_decay([p.grad.float() for p in params], params, wd)
            (accum, ) = self._state_lists(params, ("accum", ))
            skip = found_inf is not None
            a = torch._foreach_add(accum, torch._foreach_mul(grads, grads)) if skip else accum
            if not skip:
                torch._foreach_add_(a, torch._foreach_mul(grads, grads))
            denom = torch._foreach_sqrt(a)
            torch._foreach_add_(denom, eps)
            upd = torch._foreach_mul(grads, -lr)
            torch._foreach_div_(upd, denom)
            del denom
            if not skip:
                torch._foreach_add_(params, upd)
                continue
            torch._foreach_add_(upd, params)   # upd now holds the new parameters
            self._keep_on_overflow(found_inf, ((params, upd), (accum, a)))
        self._end_step(found_inf, step)
        return None


class SGD(MasterOptimizer):

    @property
    def STATE_NAMES(self):
        return ("momentum", ) if self.defaults["momentum"] else ()

    def __init__(self, params: Iterable[torch.Tensor], lr: LR = 1e-2, momentum: float = 0.0,
                 weight_decay: float = 0.0, nesterov: bool = False):
        super().__init__(params, dict(lr=lr, momentum=momentum, weight_decay=weight_decay, nesterov=nesterov))

    @torch.no_grad()
    def step(self, closure=None, found_inf: Optional[torch.Tensor] = None):
        if closure is not None:
            raise ValueError("SGD.step takes no closure")
        step = self._begin_step(found_inf)
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            lr, wd, mom = resolve_lr(group["lr"], 0), group["weight_decay"], group["momentum"]
            grads = add_weight_decay([p.grad.float() for p in params], params, wd)
            skip = found_inf is not None
            pairs = []
            if mom:
                (buf, ) = self._state_lists(params, ("momentum", ))
                b = torch._foreach_mul(buf, mom) if skip else buf
                if not skip:
                    torch._foreach_mul_(b, mom)
                torch._foreach_add_(b, grads)
                pairs.append((buf, b))
                eff = torch._foreach_add(grads, torch._foreach_mul(b, mom)) if group["nesterov"] else b
            else:
                eff = grads
            upd = torch._foreach_mul(eff, -lr)
            if not skip:
                torch._foreach_add_(params, upd)
                continue
            torch._foreach_add_(upd, params)   # upd now holds the new parameters
            self._keep_on_overflow(found_inf, [(params, upd)] + pairs)
        self._end_step(found_inf, step)
        return None
