"""LR schedules (port of ``deepspeed_tpu/runtime/lr_schedules.py``; ref:
``deepspeed/runtime/lr_schedules.py``).

Each schedule is a pure function ``step -> lr`` on Python floats: the
engine and ``FusedAdam`` evaluate it on the host at the optimizer's step,
so the value reaches the update as a scalar argument.  The formulas are the
JAX package's (LRRangeTest, OneCycle, WarmupLR, WarmupDecayLR,
WarmupCosineLR), evaluated in double precision where JAX uses float32.
``LRSchedulerShim`` gives a schedule the torch-style
``step()/get_last_lr()/state_dict()`` surface.
"""

import math
from typing import Callable

LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
WARMUP_COSINE_LR = "WarmupCosineLR"
VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR, WARMUP_COSINE_LR]


def _clip(x: float, lo: float, hi: float) -> float:
    return min(max(x, lo), hi)


def lr_range_test(lr_range_test_min_lr=1e-3, lr_range_test_step_size=2000, lr_range_test_step_rate=1.0,
                  lr_range_test_staircase=False, **_) -> Callable:
    """ref: lr_schedules.py:273 LRRangeTest."""

    def schedule(step):
        interval = step / lr_range_test_step_size
        if lr_range_test_staircase:
            interval = math.floor(interval)
        return lr_range_test_min_lr * (1.0 + interval * lr_range_test_step_rate)

    return schedule


def one_cycle(cycle_min_lr=0.0, cycle_max_lr=1e-3, decay_lr_rate=0.0, cycle_first_step_size=2000,
              cycle_second_step_size=None, cycle_first_stair_count=0, cycle_second_stair_count=None,
              decay_step_size=0, **_) -> Callable:
    """ref: lr_schedules.py:371 OneCycle (lr triangle then decay)."""
    second = cycle_second_step_size if cycle_second_step_size is not None else cycle_first_step_size
    total_cycle = cycle_first_step_size + second

    def schedule(step):
        step = float(step)
        if step <= cycle_first_step_size:
            frac = _clip(step / cycle_first_step_size, 0.0, 1.0)
        else:
            frac = 1.0 - _clip((step - cycle_first_step_size) / second, 0.0, 1.0)
        if step <= total_cycle:
            return cycle_min_lr + (cycle_max_lr - cycle_min_lr) * frac
        decay = 1.0
        if decay_step_size > 0:
            decay = (1.0 + decay_lr_rate)**(-math.floor(max(step - total_cycle, 0.0) / decay_step_size))
        return cycle_min_lr * decay

    return schedule


def _warmup_gamma(step: float, warmup_num_steps: int, warmup_type: str) -> float:
    if warmup_type == "log":
        return _clip(math.log(max(step, 1.0)) / math.log(warmup_num_steps), 0.0, 1.0)
    return _clip(step / warmup_num_steps, 0.0, 1.0)


def warmup_lr(warmup_min_lr=0.0, warmup_max_lr=1e-3, warmup_num_steps=1000, warmup_type="log", **_) -> Callable:
    """ref: lr_schedules.py:633 WarmupLR (log or linear warmup, then flat)."""
    warmup_num_steps = max(2, warmup_num_steps)

    def schedule(step):
        return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * _warmup_gamma(float(step), warmup_num_steps,
                                                                               warmup_type)

    return schedule


def warmup_decay_lr(total_num_steps, warmup_min_lr=0.0, warmup_max_lr=1e-3, warmup_num_steps=1000,
                    warmup_type="log", **_) -> Callable:
    """ref: lr_schedules.py:723 WarmupDecayLR (warmup then linear decay to 0)."""
    base = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type)
    warmup_num_steps_ = max(2, warmup_num_steps)

    def schedule(step):
        step = float(step)
        if step < warmup_num_steps_:
            return base(step)
        decay = _clip((total_num_steps - step) / max(float(total_num_steps - warmup_num_steps_), 1.0), 0.0, 1.0)
        return warmup_max_lr * decay

    return schedule


def warmup_cosine_lr(total_num_steps, warmup_min_ratio=0.0, warmup_num_steps=1000, cos_min_ratio=1e-4,
                     warmup_type="log", lr=1e-3, **_) -> Callable:
    """ref: lr_schedules.py:774 WarmupCosineLR (ratios of the base optimizer lr)."""
    warmup_num_steps_ = max(2, warmup_num_steps)

    def schedule(step):
        step = float(step)
        if step < warmup_num_steps_:
            g = _warmup_gamma(step, warmup_num_steps_, warmup_type)
            return lr * (warmup_min_ratio + (1.0 - warmup_min_ratio) * g)
        progress = _clip((step - warmup_num_steps_) / max(1.0, total_num_steps - warmup_num_steps_), 0.0, 1.0)
        return lr * (cos_min_ratio + (1.0 - cos_min_ratio) * 0.5 * (1.0 + math.cos(math.pi * progress)))

    return schedule


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
