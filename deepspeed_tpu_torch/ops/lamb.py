"""LAMB as a ``torch.optim.Optimizer`` (port of ``deepspeed_tpu/ops/lamb.py``;
ref: DeepSpeed's ``FusedLamb``, ``csrc/lamb/fused_lamb_cuda_kernel.cu``).

The arithmetic is the JAX transform's (``lamb.py:36-58``), on float32
parameters (the engine's master copy) and float32 moments:

    step += 1;  lr = resolve_lr(lr, step)
    m = b1·m + (1 − b1)·g;  v = b2·v + (1 − b2)·g²
    c1 = 1 − b1^step;  c2 = 1 − b2^step             (float32, as in JAX)
    u = (m/c1) / (sqrt(v/c2) + eps) + wd·p           (per tensor)
    trust = ‖p‖/‖u‖ where ‖u‖ > 0 and ‖p‖ > 0, else 1; clipped to [min_coeff, max_coeff]
    p = p − lr·trust·u

The JAX optimizer is plain jnp outside any Pallas kernel, so the port runs
plain tensor ops: ``torch._foreach_*`` over all tensors, the per-tensor
norms through ``torch._foreach_norm``, and one trust ratio per tensor from
them on the device.  On overflow (``step(found_inf=...)``) the parameters,
the moments and the step keep their values (``MasterOptimizer``).

The trust ratio is per whole tensor.  When the optimizer holds slices of
the tensors (ZeRO over several ranks), the engine sets ``reduce_norms(params,
w_norm, u_norm)``, which turns the slices' norms into the whole tensors'
(``runtime/zero/partitioned.py``).
"""

from typing import Iterable, Optional

import torch

from .adam import _bias_correction
from .optimizer import LR, MasterOptimizer, resolve_lr


class FusedLamb(MasterOptimizer):

    STATE_NAMES = ("exp_avg", "exp_avg_sq")

    def __init__(self, params: Iterable[torch.Tensor], lr: LR = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, bias_correction: bool = True, max_coeff: float = 10.0,
                 min_coeff: float = 0.01):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay,
                                      bias_correction=bias_correction, max_coeff=max_coeff, min_coeff=min_coeff))
        #: the slices' norms → the whole tensors' (set by a partitioning engine)
        self.reduce_norms = None

    @torch.no_grad()
    def step(self, closure=None, found_inf: Optional[torch.Tensor] = None):
        if closure is not None:
            raise ValueError("FusedLamb.step takes no closure")
        step = self._begin_step(found_inf)
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            lr, wd, eps = resolve_lr(group["lr"], step), group["weight_decay"], group["eps"]
            grads = [p.grad.float() for p in params]
            exp_avg, exp_avg_sq = self._state_lists(params, ("exp_avg", "exp_avg_sq"))
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
            torch._foreach_div_(upd, denom)
            del denom
            if wd != 0.0:
                torch._foreach_add_(upd, torch._foreach_mul(params, wd))
            w_norm = torch.stack(torch._foreach_norm(params))
            u_norm = torch.stack(torch._foreach_norm(upd))
            if self.reduce_norms is not None:
                w_norm, u_norm = self.reduce_norms(params, w_norm, u_norm)
            one = torch.ones_like(w_norm)
            trust = torch.where(u_norm > 0, torch.where(w_norm > 0, w_norm / u_norm, one), one)
            coef = (-lr) * trust.clamp(group["min_coeff"], group["max_coeff"])
            for u, c in zip(upd, coef.unbind()):
                u.mul_(c)
            if not skip:
                torch._foreach_add_(params, upd)
                continue
            torch._foreach_add_(upd, params)   # upd now holds the new parameters
            self._keep_on_overflow(found_inf, ((params, upd), (exp_avg, m), (exp_avg_sq, v)))
        self._end_step(found_inf, step)
        return None
