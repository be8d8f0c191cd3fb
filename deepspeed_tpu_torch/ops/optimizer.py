"""Optimizer helpers (port of ``deepspeed_tpu/ops/optimizer.py``): the global
gradient norm, weight decay folded into gradients, and learning-rate
resolution, and ``MasterOptimizer``, the base of the port's optimizers.
Lists of tensors take the place of the JAX pytrees; the ``torch._foreach_*``
ops run each step over all tensors in a few launches, the role of the
reference's multi-tensor CUDA kernels."""

from typing import Callable, List, Optional, Sequence, Tuple, Union

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


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by ``min(1, max_norm/(norm + 1e-6))`` (JAX
    ``clip_by_global_norm``); returns the norm before clipping."""
    norm = global_norm(grads)
    torch._foreach_mul_(grads, torch.clamp(max_norm / (norm + 1e-6), max=1.0))
    return norm


def add_weight_decay(grads: List[torch.Tensor], params: Sequence[torch.Tensor],
                     weight_decay: float) -> List[torch.Tensor]:
    """``g + wd·p``: L2 regularisation folded into the gradients."""
    if weight_decay == 0.0:
        return list(grads)
    return torch._foreach_add(grads, [p.to(g.dtype) for g, p in zip(grads, params)], alpha=weight_decay)


class MasterOptimizer(torch.optim.Optimizer):
    """What the port's optimizers share (``FusedAdam``, ``FusedLamb``,
    ``FusedLion``, ``Adagrad``, ``SGD``): float32 parameters (the engine's
    master copy), float32 state per parameter, and the step of the JAX
    transform's state.

    ``step(found_inf=...)`` takes a device boolean: on overflow the
    parameters, the state and the step keep their old values, selected with
    ``torch.where`` on the device (the JAX engine's skip, without a host
    sync).  The step is then a device tensor (``_device_step``), and the LR
    schedule is evaluated at the device step + 1 as JAX evaluates it at
    ``state.step + 1``: a skipped step does not advance it.  Without
    ``found_inf`` the step is the host count ``step_count``.

    ``state_dict()`` is torch's with the schedule left out of the groups
    (code, not state: the engine rebuilds it) and the two step counts added,
    so that ``torch.load(..., weights_only=True)`` reads it back and
    ``load_state_dict`` restores it into the optimizer the engine built.
    """

    def __init__(self, params, defaults):
        super().__init__(params, defaults)
        for group in self.param_groups:
            for p in group["params"]:
                if p.dtype != torch.float32:
                    raise ValueError(f"{type(self).__name__} updates float32 parameters (a master copy), "
                                     f"got {p.dtype}")
        #: optimizer steps taken (host count; the device count differs only
        #: after steps skipped on overflow)
        self.step_count = 0
        self._device_step = None

    def _begin_step(self, found_inf: Optional[torch.Tensor]):
        """The 1-based step of this update: an int, or a 0-d device tensor
        when overflow may skip it."""
        self.step_count += 1
        if found_inf is None:
            return self.step_count
        if self._device_step is None:
            dev = self.param_groups[0]["params"][0].device
            self._device_step = torch.full((), self.step_count - 1, dtype=torch.int32, device=dev)
        return self._device_step + 1

    def _end_step(self, found_inf: Optional[torch.Tensor], step) -> None:
        if found_inf is not None:
            self._device_step = torch.where(found_inf.bool(), self._device_step, step)

    @staticmethod
    def _keep_on_overflow(found_inf: torch.Tensor, pairs) -> None:
        """Write each new list into its old one, except where ``found_inf``."""
        keep = found_inf.bool()
        for old, new in pairs:
            torch._foreach_copy_(old, [torch.where(keep, o, n) for o, n in zip(old, new)])

    #: the per-parameter state tensors the optimizer keeps (zeros at init)
    STATE_NAMES: Tuple[str, ...] = ()

    def init_state(self, zeros: Callable[[torch.Tensor], torch.Tensor]) -> None:
        """Create every parameter's state now, each tensor ``zeros(p)`` (the
        host offload tier puts them in its pinned arena) instead of at the
        first step."""
        for group in self.param_groups:
            for p in group["params"]:
                st = self.state[p]
                for name in self.STATE_NAMES:
                    if name not in st:
                        st[name] = zeros(p)

    def _state_lists(self, params: Sequence[torch.Tensor], names: Sequence[str]) -> List[List[torch.Tensor]]:
        """Per state name, the list of each parameter's tensor (zeros the
        first time, as the JAX transforms' ``init``)."""
        for p in params:
            st = self.state[p]
            for name in names:
                if name not in st:
                    st[name] = torch.zeros_like(p)
        return [[self.state[p][name] for p in params] for name in names]

    def state_dict(self):
        sd = super().state_dict()
        sd["param_groups"] = [{**g, "lr": None if callable(g["lr"]) else g["lr"]} for g in sd["param_groups"]]
        sd["step_count"] = self.step_count
        sd["device_step"] = self._device_step
        return sd

    def load_state_dict(self, state_dict):
        sd = dict(state_dict)
        step_count, device_step = sd.pop("step_count", 0), sd.pop("device_step", None)
        sd["param_groups"] = [{**g, "lr": own["lr"] if g["lr"] is None else g["lr"]}
                              for g, own in zip(sd["param_groups"], self.param_groups)]
        super().load_state_dict(sd)
        self.step_count = int(step_count)
        dev = self.param_groups[0]["params"][0].device
        self._device_step = None if device_step is None else device_step.to(device=dev, dtype=torch.int32)
