"""Static / dynamic loss scaling (port of
``deepspeed_tpu/runtime/fp16/loss_scaler.py``; ref:
``deepspeed/runtime/fp16/loss_scaler.py`` ``LossScaler:67``,
``DynamicLossScaler:91``).

As in the JAX design, the scaler's state is a few 0-dim device tensors,
updated with ``torch.where`` from a device overflow flag: the
scale-adjust/skip decision never syncs with the host.  The reference reads
the overflow flag on the host instead.
"""

from typing import NamedTuple, Optional, Sequence

import torch

class LossScalerState(NamedTuple):
    cur_scale: torch.Tensor  # f32 scalar
    cur_hysteresis: torch.Tensor  # i32 scalar
    last_overflow_iter: torch.Tensor  # i32 scalar
    iteration: torch.Tensor  # i32 scalar


class DynamicLossScaler:
    """Functional loss scaler: ``update(state, found_inf)`` returns the new
    state; a step is skipped exactly when ``found_inf``."""

    def __init__(self, init_scale=2**16, scale_factor=2.0, scale_window=1000, min_scale=1.0, delayed_shift=1,
                 consecutive_hysteresis=False, dynamic=True):
        self.init_scale = float(init_scale)
        self.scale_factor = float(scale_factor)
        self.scale_window = int(scale_window)
        self.min_scale = float(min_scale)
        self.delayed_shift = int(delayed_shift)
        self.consecutive_hysteresis = consecutive_hysteresis
        self.dynamic = dynamic

    def init_state(self, device=None) -> LossScalerState:
        def i32(x):
            return torch.tensor(x, dtype=torch.int32, device=device)

        return LossScalerState(cur_scale=torch.tensor(self.init_scale, dtype=torch.float32, device=device),
                               cur_hysteresis=i32(self.delayed_shift), last_overflow_iter=i32(-1),
                               iteration=i32(0))

    def update(self, state: LossScalerState, found_inf: Optional[torch.Tensor]) -> LossScalerState:
        if not self.dynamic:
            return state._replace(iteration=state.iteration + 1)
        it = state.iteration
        overflow = found_inf.bool()
        # hysteresis: only cut the scale after `delayed_shift` consecutive overflows
        hyst_exhausted = state.cur_hysteresis <= 1
        scale_on_overflow = torch.where(hyst_exhausted,
                                        torch.clamp(state.cur_scale / self.scale_factor, min=self.min_scale),
                                        state.cur_scale)
        hyst_on_overflow = torch.where(hyst_exhausted, state.cur_hysteresis, state.cur_hysteresis - 1)
        # growth: scale up after scale_window clean iterations
        window_ok = torch.remainder(it - state.last_overflow_iter, self.scale_window) == self.scale_window - 1
        scale_clean = torch.where(window_ok, state.cur_scale * self.scale_factor, state.cur_scale)
        hyst_clean = torch.full_like(state.cur_hysteresis, self.delayed_shift) if self.consecutive_hysteresis \
            else state.cur_hysteresis
        return LossScalerState(cur_scale=torch.where(overflow, scale_on_overflow, scale_clean),
                               cur_hysteresis=torch.where(overflow, hyst_on_overflow, hyst_clean),
                               last_overflow_iter=torch.where(overflow, it, state.last_overflow_iter),
                               iteration=it + 1)


class StaticLossScaler(DynamicLossScaler):

    def __init__(self, scale=1.0):
        super().__init__(init_scale=scale, dynamic=False)


def found_inf_or_nan(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """A device boolean: does any gradient hold a non-finite value."""
    if not grads:
        return torch.zeros((), dtype=torch.bool)
    return torch.stack([torch.logical_not(torch.isfinite(g)).sum() for g in grads]).sum() > 0


def create_loss_scaler(fp16_config=None, dtype=None) -> DynamicLossScaler:
    if fp16_config is None or dtype != torch.float16 or not getattr(fp16_config, "enabled", False):
        return StaticLossScaler(1.0)
    if fp16_config.loss_scale and fp16_config.loss_scale > 0:
        return StaticLossScaler(fp16_config.loss_scale)
    return DynamicLossScaler(init_scale=2.0**fp16_config.initial_scale_power,
                             scale_window=fp16_config.loss_scale_window, min_scale=fp16_config.min_loss_scale,
                             delayed_shift=fp16_config.hysteresis,
                             consecutive_hysteresis=fp16_config.consecutive_hysteresis)
