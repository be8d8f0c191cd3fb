"""Adam / AdamW as a ``torch.optim.Optimizer`` (port of
``deepspeed_tpu/ops/adam.py``; ref: DeepSpeed's ``FusedAdam``).

The arithmetic is the JAX transform's (``adam.py:42-63``), on float32
parameters (the engine's master copy) and float32 moments:

    step += 1;  lr = resolve_lr(lr, step)
    g = grad                      (+ wd·p when adam_w_mode is False: L2 mode)
    m = b1·m + (1 − b1)·g;  v = b2·v + (1 − b2)·g²
    c1 = 1 − b1^step;  c2 = 1 − b2^step            (float32, as in JAX)
    u = −lr·(m/c1) / (sqrt(v/c2) + eps)   (− lr·wd·p when adam_w_mode: decoupled,
                                           on the pre-update parameter)
    p = p + u

The JAX optimizer is plain jnp, so the port runs plain tensor ops: each
line above is one ``torch._foreach_*`` launch over all parameters.  The
parameters are updated in place.

``step(found_inf=...)`` takes a device boolean: on overflow the parameters,
the moments and the step count keep their old values, selected with
``torch.where`` on the device (the JAX engine's skip, without a host sync).
The LR schedule is then evaluated at the device step + 1, as JAX evaluates
it at ``state.step + 1`` (``adam.py:43-44``): a skipped step does not
advance it.
"""

from typing import Iterable, Optional

import numpy as np
import torch

from .optimizer import LR, add_weight_decay, resolve_lr


def _bias_correction(beta: float, step):
    """``1 − beta^step`` in float32: a Python float for a host step, a 0-dim
    tensor for a device step."""
    if isinstance(step, torch.Tensor):
        return 1.0 - torch.pow(torch.tensor(beta, dtype=torch.float32, device=step.device), step.float())
    return float(np.float32(1.0) - np.float32(beta)**np.float32(step))


class FusedAdam(torch.optim.Optimizer):

    def __init__(self, params: Iterable[torch.Tensor], lr: LR = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, adam_w_mode: bool = True, bias_correction: bool = True,
                 amsgrad: bool = False):
        if amsgrad:
            raise ValueError("FusedAdam does not support the AMSGrad variant (parity with ref fused_adam.py)")
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay,
                                      adam_w_mode=adam_w_mode, bias_correction=bias_correction))
        for group in self.param_groups:
            for p in group["params"]:
                if p.dtype != torch.float32:
                    raise ValueError(f"FusedAdam updates float32 parameters (a master copy), got {p.dtype}")
        #: optimizer steps taken (host count; the device count differs only
        #: after steps skipped on overflow)
        self.step_count = 0
        self._device_step = None

    def _moments(self, group):
        for p in group["params"]:
            st = self.state[p]
            if not st:
                st["exp_avg"] = torch.zeros_like(p)
                st["exp_avg_sq"] = torch.zeros_like(p)
        return ([self.state[p]["exp_avg"] for p in group["params"]],
                [self.state[p]["exp_avg_sq"] for p in group["params"]])

    @torch.no_grad()
    def step(self, closure=None, found_inf: Optional[torch.Tensor] = None):
        if closure is not None:
            raise ValueError("FusedAdam.step takes no closure")
        self.step_count += 1
        if found_inf is None:
            step = self.step_count
        else:
            if self._device_step is None:
                dev = self.param_groups[0]["params"][0].device
                self._device_step = torch.full((), self.step_count - 1, dtype=torch.int32, device=dev)
            step = self._device_step + 1
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            lr, wd, eps = resolve_lr(group["lr"], step), group["weight_decay"], group["eps"]
            grads = [p.grad.float() for p in params]
            exp_avg, exp_avg_sq = self._moments(group)
            exp_avg = [m for p, m in zip(group["params"], exp_avg) if p.grad is not None]
            exp_avg_sq = [v for p, v in zip(group["params"], exp_avg_sq) if p.grad is not None]
            if not group["adam_w_mode"]:
                grads = add_weight_decay(grads, params, wd)
            # without a skip the moments update in place; with one the new
            # values are built beside the old ones and selected
            skip = found_inf is not None
            if skip:
                m, v = torch._foreach_mul(exp_avg, b1), torch._foreach_mul(exp_avg_sq, b2)
            else:
                m, v = exp_avg, exp_avg_sq
                torch._foreach_mul_(m, b1)
                torch._foreach_mul_(v, b2)
            torch._foreach_add_(m, torch._foreach_mul(grads, 1 - b1))
            sq = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(sq, 1 - b2)
            torch._foreach_add_(v, sq)
            del sq
            if group["bias_correction"]:
                c1, c2 = _bias_correction(b1, step), _bias_correction(b2, step)
            else:
                c1 = c2 = 1.0
            denom = torch._foreach_div(v, c2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, eps)
            upd = torch._foreach_div(m, c1)
            torch._foreach_mul_(upd, -lr)
            torch._foreach_div_(upd, denom)
            del denom
            if group["adam_w_mode"] and wd > 0.0:
                torch._foreach_add_(upd, torch._foreach_mul(params, -lr * wd))
            if not skip:
                torch._foreach_add_(params, upd)
                continue
            keep = found_inf.bool()
            torch._foreach_add_(upd, params)   # upd now holds the new parameters
            for old, new in ((params, upd), (exp_avg, m), (exp_avg_sq, v)):
                torch._foreach_copy_(old, [torch.where(keep, o, n) for o, n in zip(old, new)])
        if found_inf is not None:
            self._device_step = torch.where(found_inf.bool(), self._device_step, step)
        return None
