"""Wall-clock timers and throughput accounting (port of
``deepspeed_tpu/utils/timer.py``; ref: ``deepspeed/utils/timer.py:44
SynchronizedWallClockTimer``, ``timer.py:199 ThroughputTimer``).

The JAX package fences its host clock reads with a value fetch of a fresh
device computation (``_device_sync``); here the fence is
``torch.cuda.synchronize`` on the device whose work is timed, and nothing
on the CPU, where every op has finished when it returns.
"""

import time
from typing import Optional

import torch

from .logging import log_dist

FORWARD_MICRO_TIMER = "fwd_microstep"
FORWARD_GLOBAL_TIMER = "fwd"
BACKWARD_MICRO_TIMER = "bwd_microstep"
BACKWARD_GLOBAL_TIMER = "bwd"
STEP_MICRO_TIMER = "step_microstep"
STEP_GLOBAL_TIMER = "step"
TRAIN_BATCH_TIMER = "train_batch"


def _device_sync(device: Optional[torch.device]) -> None:
    """Wait for the work queued on ``device`` so that a clock read covers it."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


class SynchronizedWallClockTimer:
    """Named timer group (start/stop/reset/log, elapsed, mean), each read
    fenced by a synchronize of ``device``."""

    class Timer:

        def __init__(self, name, device=None):
            self.name_ = name
            self.device = device
            self.started_ = False
            self.start_time = time.time()
            self.elapsed_records = []

        def start(self):
            assert not self.started_, f"{self.name_} timer has already been started"
            _device_sync(self.device)
            self.start_time = time.time()
            self.started_ = True

        def stop(self, reset=False, record=True):
            assert self.started_, "timer is not started"
            _device_sync(self.device)
            elapsed = time.time() - self.start_time
            if record:
                self.elapsed_records.append(elapsed)
            self.started_ = False

        def reset(self):
            self.started_ = False
            self.elapsed_records = []

        def elapsed(self, reset=True):
            """Total elapsed seconds recorded (optionally reset)."""
            total = sum(self.elapsed_records)
            if self.started_:
                total += time.time() - self.start_time
            if reset:
                self.elapsed_records = []
            return total

        def mean(self):
            if not self.elapsed_records:
                return 0.0
            return sum(self.elapsed_records) / len(self.elapsed_records)

    def __init__(self, device: Optional[torch.device] = None):
        self.device = None if device is None else torch.device(device)
        self.timers = {}

    def get_timers(self):
        return self.timers

    def __call__(self, name):
        if name not in self.timers:
            self.timers[name] = self.Timer(name, self.device)
        return self.timers[name]

    def has_timer(self, name):
        return name in self.timers

    def memory_usage(self):
        if self.device is None or self.device.type != "cuda":
            return "mem stats unavailable"
        in_use = torch.cuda.memory_allocated(self.device)
        peak = torch.cuda.max_memory_allocated(self.device)
        return f"mem in-use {in_use / 2**30:.2f} GB | peak {peak / 2**30:.2f} GB"

    def log(self, names, normalizer=1.0, reset=True, memory_breakdown=False, ranks=None):
        assert normalizer > 0.0
        string = "time (ms)"
        for name in names:
            if name in self.timers:
                elapsed_time = self.timers[name].elapsed(reset=reset) * 1000.0 / normalizer
                string += " | {}: {:.2f}".format(name, elapsed_time)
        if memory_breakdown:
            string += " | " + self.memory_usage()
        log_dist(string, ranks=ranks or [0])


class NoopTimer:
    """Disabled-timer stand-in (``wall_clock_breakdown=false``)."""

    class Timer:

        def start(self):
            ...

        def reset(self):
            ...

        def stop(self, **kwargs):
            ...

        def elapsed(self, **kwargs):
            return 0.0

        def mean(self):
            return 0.0

    def __init__(self):
        self.timer = self.Timer()

    def __call__(self, name):
        return self.timer

    def get_timers(self):
        return {}

    def log(self, names, normalizer=1.0, reset=True, memory_breakdown=False, ranks=None):
        ...


class ThroughputTimer:
    """Tokens/samples-per-second accounting (ref: timer.py:199).  Only the
    steps whose speed is reported are fenced; the running average reads the
    host clock unfenced (the dispatch error amortises over the run)."""

    def __init__(self, batch_size, start_step=2, steps_per_output=None, logging_fn=None,
                 device: Optional[torch.device] = None):
        self.start_time = 0
        self.end_time = 0
        self.started = False
        self.batch_size = max(1, batch_size)
        self.start_step = start_step
        self.epoch_count = 0
        self.micro_step_count = 0
        self.global_step_count = 0
        self.total_elapsed_time = 0
        self.step_elapsed_time = 0
        self.steps_per_output = steps_per_output
        self.logging = logging_fn or log_dist
        self.device = None if device is None else torch.device(device)
        self._wall_start = None

    def update_epoch_count(self):
        self.epoch_count += 1
        self.micro_step_count = 0

    def _will_report(self):
        return bool(self.steps_per_output) and \
            (self.global_step_count + 1) % self.steps_per_output == 0

    def start(self):
        self.started = True
        if self.global_step_count >= self.start_step:
            if self._wall_start is None:
                self._wall_start = time.time()  # long-run average anchor
            if self._will_report():
                _device_sync(self.device)
                self.start_time = time.time()

    def stop(self, global_step=False, report_speed=True):
        if not self.started:
            return
        self.started = False
        self.micro_step_count += 1
        if global_step:
            self.global_step_count += 1
        if self.start_time > 0:
            _device_sync(self.device)
            self.end_time = time.time()
            self.step_elapsed_time += self.end_time - self.start_time
            self.start_time = 0
        if self._wall_start is not None:
            self.total_elapsed_time = time.time() - self._wall_start
            if global_step:
                if report_speed and self.steps_per_output and self.global_step_count % self.steps_per_output == 0:
                    self.logging("epoch={}/micro_step={}/global_step={}, RunningAvgSamplesPerSec={:.3f}, "
                                 "CurrSamplesPerSec={:.3f}".format(self.epoch_count, self.micro_step_count,
                                                                   self.global_step_count, self.avg_samples_per_sec(),
                                                                   self.batch_size / self.step_elapsed_time))
                self.step_elapsed_time = 0

    def avg_samples_per_sec(self):
        if self.global_step_count > self.start_step and self.total_elapsed_time > 0:
            samples = self.batch_size * (self.global_step_count - self.start_step)
            return samples / self.total_elapsed_time
        return float("-inf")
