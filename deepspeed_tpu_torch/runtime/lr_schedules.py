"""LR schedules (port of ``deepspeed_tpu/runtime/lr_schedules.py``; ref:
``deepspeed/runtime/lr_schedules.py``).

Each schedule is a pure function ``step -> lr`` written with ``torch`` ops,
so it takes a host number or a 0-d tensor:

  * a host step (a Python number) is evaluated in double precision on the
    CPU and gives a Python float, as before;
  * a tensor step (``FusedAdam``'s device step under a dynamic loss scale,
    which stays put on an overflow-skipped step) is evaluated in float32 on
    its device, as JAX evaluates the schedule at ``state.step + 1``, and gives
    a 0-d tensor there: no host sync.

The formulas are the JAX package's (LRRangeTest, OneCycle, WarmupLR,
WarmupDecayLR, WarmupCosineLR).  ``LRSchedulerShim`` gives a schedule the
torch-style ``step()/get_last_lr()/state_dict()`` surface.
"""

import math
from typing import Callable

import torch

LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
WARMUP_COSINE_LR = "WarmupCosineLR"
VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR, WARMUP_COSINE_LR]


def _schedule(fn: Callable[[torch.Tensor], torch.Tensor]) -> Callable:
    """``fn`` on a floating tensor step: a tensor step in float32 on its
    device, a host step in double on the CPU and its value back as a float."""

    def schedule(step):
        if isinstance(step, torch.Tensor):
            return fn(step.float())
        return float(fn(torch.tensor(float(step), dtype=torch.float64)))

    return schedule


def lr_range_test(lr_range_test_min_lr=1e-3, lr_range_test_step_size=2000, lr_range_test_step_rate=1.0,
                  lr_range_test_staircase=False, **_) -> Callable:
    """ref: lr_schedules.py:273 LRRangeTest."""

    def schedule(step):
        interval = step / lr_range_test_step_size
        if lr_range_test_staircase:
            interval = torch.floor(interval)
        return lr_range_test_min_lr * (1.0 + interval * lr_range_test_step_rate)

    return _schedule(schedule)


def one_cycle(cycle_min_lr=0.0, cycle_max_lr=1e-3, decay_lr_rate=0.0, cycle_first_step_size=2000,
              cycle_second_step_size=None, cycle_first_stair_count=0, cycle_second_stair_count=None,
              decay_step_size=0, **_) -> Callable:
    """ref: lr_schedules.py:371 OneCycle (lr triangle then decay)."""
    second = cycle_second_step_size if cycle_second_step_size is not None else cycle_first_step_size
    total_cycle = cycle_first_step_size + second

    def schedule(step):
        up = torch.clamp(step / cycle_first_step_size, 0.0, 1.0)
        down = torch.clamp((step - cycle_first_step_size) / second, 0.0, 1.0)
        frac = torch.where(step <= cycle_first_step_size, up, 1.0 - down)
        in_cycle = cycle_min_lr + (cycle_max_lr - cycle_min_lr) * frac
        decay = torch.ones_like(step)
        if decay_step_size > 0:
            decay = (1.0 + decay_lr_rate)**(-torch.floor(torch.clamp_min(step - total_cycle, 0.0) / decay_step_size))
        return torch.where(step <= total_cycle, in_cycle, cycle_min_lr * decay)

    return _schedule(schedule)


def _warmup_gamma(step: torch.Tensor, warmup_num_steps: int, warmup_type: str) -> torch.Tensor:
    if warmup_type == "log":
        return torch.clamp(torch.log(torch.clamp_min(step, 1.0)) / math.log(warmup_num_steps), 0.0, 1.0)
    return torch.clamp(step / warmup_num_steps, 0.0, 1.0)


def warmup_lr(warmup_min_lr=0.0, warmup_max_lr=1e-3, warmup_num_steps=1000, warmup_type="log", **_) -> Callable:
    """ref: lr_schedules.py:633 WarmupLR (log or linear warmup, then flat)."""
    warmup_num_steps = max(2, warmup_num_steps)

    def schedule(step):
        return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * _warmup_gamma(step, warmup_num_steps, warmup_type)

    return _schedule(schedule)


def warmup_decay_lr(total_num_steps, warmup_min_lr=0.0, warmup_max_lr=1e-3, warmup_num_steps=1000,
                    warmup_type="log", **_) -> Callable:
    """ref: lr_schedules.py:723 WarmupDecayLR (warmup then linear decay to 0)."""
    warmup_num_steps_ = max(2, warmup_num_steps)

    def schedule(step):
        warm = warmup_min_lr + (warmup_max_lr - warmup_min_lr) * _warmup_gamma(step, warmup_num_steps_, warmup_type)
        decay = torch.clamp((total_num_steps - step) / max(float(total_num_steps - warmup_num_steps_), 1.0), 0.0,
                            1.0)
        return torch.where(step < warmup_num_steps_, warm, warmup_max_lr * decay)

    return _schedule(schedule)


def warmup_cosine_lr(total_num_steps, warmup_min_ratio=0.0, warmup_num_steps=1000, cos_min_ratio=1e-4,
                     warmup_type="log", lr=1e-3, **_) -> Callable:
    """ref: lr_schedules.py:774 WarmupCosineLR (ratios of the base optimizer lr)."""
    warmup_num_steps_ = max(2, warmup_num_steps)

    def schedule(step):
        warm = warmup_min_ratio + (1.0 - warmup_min_ratio) * _warmup_gamma(step, warmup_num_steps_, warmup_type)
        progress = torch.clamp((step - warmup_num_steps_) / max(1.0, total_num_steps - warmup_num_steps_), 0.0, 1.0)
        cos = cos_min_ratio + (1.0 - cos_min_ratio) * 0.5 * (1.0 + torch.cos(math.pi * progress))
        return lr * torch.where(step < warmup_num_steps_, warm, cos)

    return _schedule(schedule)


SCHEDULE_BUILDERS = {
    LR_RANGE_TEST: lr_range_test,
    ONE_CYCLE: one_cycle,
    WARMUP_LR: warmup_lr,
    WARMUP_DECAY_LR: warmup_decay_lr,
    WARMUP_COSINE_LR: warmup_cosine_lr,
}


def get_lr_schedule(name: str, params: dict, base_lr: float = 1e-3) -> Callable:
    if name not in SCHEDULE_BUILDERS:
        raise ValueError(f"Unknown scheduler {name}; valid: {VALID_LR_SCHEDULES}")
    params = dict(params)
    if name == WARMUP_COSINE_LR:
        params.setdefault("lr", base_lr)
    return SCHEDULE_BUILDERS[name](**params)


class LRSchedulerShim:
    """torch-style scheduler facade over a pure schedule fn (API parity with
    the reference's scheduler objects returned from deepspeed.initialize)."""

    def __init__(self, schedule_fn: Callable, optimizer=None):
        self.schedule_fn = schedule_fn
        self.optimizer = optimizer
        self.last_batch_iteration = -1

    def step(self, last_batch_iteration=None):
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration

    def get_last_lr(self):
        return [float(self.schedule_fn(max(0, self.last_batch_iteration)))]

    def get_lr(self):
        return self.get_last_lr()

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]
