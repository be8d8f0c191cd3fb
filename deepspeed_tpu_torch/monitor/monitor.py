"""Experiment monitoring (port of ``deepspeed_tpu/monitor/monitor.py``; ref:
``deepspeed/monitor/monitor.py:30 MonitorMaster``).

Fans out ``write_events([(tag, value, step)])`` to the enabled backends:
TensorBoard (ref: monitor/tensorboard.py), WandB (monitor/wandb.py), CSV
(monitor/csv_monitor.py), Comet (monitor/comet.py).  Only rank 0 writes.
The optional backends import their package when enabled and disable
themselves with a warning when it is absent; the CSV writer needs nothing.
"""

import csv
import os
from typing import List, Tuple

from ..utils.logging import logger


class Monitor:

    def __init__(self, monitor_config):
        self.monitor_config = monitor_config
        self.enabled = False

    def write_events(self, event_list: List[Tuple]):
        raise NotImplementedError


class TensorBoardMonitor(Monitor):

    def __init__(self, tensorboard_config):
        super().__init__(tensorboard_config)
        self.summary_writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter
            out = os.path.join(tensorboard_config.output_path or "./runs", tensorboard_config.job_name)
            self.summary_writer = SummaryWriter(log_dir=out)
            self.enabled = True
        except Exception as e:
            logger.warning(f"TensorBoard monitor disabled: {e}")

    def write_events(self, event_list):
        if self.summary_writer is None:
            return
        for name, value, step in event_list:
            self.summary_writer.add_scalar(name, value, step)
        self.summary_writer.flush()


class WandbMonitor(Monitor):

    def __init__(self, wandb_config):
        super().__init__(wandb_config)
        try:
            import wandb
            wandb.init(project=wandb_config.project, group=wandb_config.group, entity=wandb_config.team)
            self.wandb = wandb
            self.enabled = True
        except Exception as e:
            logger.warning(f"WandB monitor disabled: {e}")
            self.wandb = None

    def write_events(self, event_list):
        if self.wandb is None:
            return
        for name, value, step in event_list:
            self.wandb.log({name: value}, step=step)


class CometMonitor(Monitor):
    """ref: monitor/comet.py:23 CometMonitor — lazy comet_ml import, one
    experiment per run, per-sample throttling via samples_log_interval."""

    def __init__(self, comet_config):
        super().__init__(comet_config)
        self.sample_idx = 0
        self.interval = getattr(comet_config, "samples_log_interval", 100)
        if getattr(comet_config, "mode", None) == "disabled":
            # 'disabled' means OFF — not an offline experiment archive
            self.experiment = None
            return
        try:
            import comet_ml
            kwargs = {}
            if comet_config.api_key:
                kwargs["api_key"] = comet_config.api_key
            if comet_config.project:
                kwargs["project_name"] = comet_config.project
            if comet_config.workspace:
                kwargs["workspace"] = comet_config.workspace
            if comet_config.mode == "offline":
                kwargs["online"] = False
            elif comet_config.online is not None:
                kwargs["online"] = comet_config.online
            if comet_config.experiment_key:
                self.experiment = comet_ml.ExistingExperiment(
                    previous_experiment=comet_config.experiment_key, **kwargs)
            else:
                self.experiment = comet_ml.Experiment(**kwargs)
            if comet_config.experiment_name:
                self.experiment.set_name(comet_config.experiment_name)
            self.enabled = True
        except Exception as e:  # comet_ml not installed / auth failure
            logger.warning(f"Comet monitor disabled: {e}")
            self.experiment = None

    def write_events(self, event_list):
        if self.experiment is None:
            return
        self.sample_idx += 1
        if self.interval and (self.sample_idx - 1) % self.interval != 0:
            return
        for name, value, step in event_list:
            self.experiment.log_metric(name, value, step=step)


class csvMonitor(Monitor):
    """One ``<tag with / as _>.csv`` per event name under
    ``<output_path>/<job_name>``: a ``step,<tag>`` header, then a
    ``step,value`` row per event."""

    def __init__(self, csv_config):
        super().__init__(csv_config)
        self.output_path = os.path.join(csv_config.output_path or "./csv_logs", csv_config.job_name)
        os.makedirs(self.output_path, exist_ok=True)
        self.enabled = True

    def write_events(self, event_list):
        for name, value, step in event_list:
            safe = name.replace("/", "_")
            path = os.path.join(self.output_path, f"{safe}.csv")
            new = not os.path.exists(path)
            with open(path, "a", newline="") as f:
                w = csv.writer(f)
                if new:
                    w.writerow(["step", name])
                w.writerow([step, value])


def _is_rank0() -> bool:
    import torch.distributed as dist
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


class MonitorMaster(Monitor):
    """ref: monitor/monitor.py:30 — routes events to every enabled writer.

    Event volume is bounded: past ``monitor_config.max_events`` forwarded
    events (0 = unbounded), further events are dropped and counted in
    ``dropped_events``.  Each time the drop count crosses a power of two,
    one ``monitor/dropped_events`` summary event is forwarded (O(log drops)
    overhead) so the loss is visible on the same surface."""

    def __init__(self, monitor_config):
        super().__init__(monitor_config)
        self.max_events = int(getattr(monitor_config, "max_events", 0) or 0)
        self.events_written = 0
        self.dropped_events = 0
        self._next_drop_notice = 1
        self.monitors = []
        if not _is_rank0():
            return
        if monitor_config.tensorboard.enabled:
            m = TensorBoardMonitor(monitor_config.tensorboard)
            if m.enabled:
                self.monitors.append(m)
        if monitor_config.wandb.enabled:
            m = WandbMonitor(monitor_config.wandb)
            if m.enabled:
                self.monitors.append(m)
        if monitor_config.csv_monitor.enabled:
            m = csvMonitor(monitor_config.csv_monitor)
            if m.enabled:
                self.monitors.append(m)
        if monitor_config.comet.enabled:
            m = CometMonitor(monitor_config.comet)
            if m.enabled:
                self.monitors.append(m)
        self.enabled = bool(self.monitors)

    def write_events(self, event_list):
        if self.max_events > 0:
            room = self.max_events - self.events_written
            if room <= 0:
                self._drop(len(event_list))
                return
            if len(event_list) > room:
                self._drop(len(event_list) - room)
                event_list = event_list[:room]
        self.events_written += len(event_list)
        for m in self.monitors:
            m.write_events(event_list)

    def _drop(self, n: int) -> None:
        self.dropped_events += n
        if self.dropped_events >= self._next_drop_notice:
            while self._next_drop_notice <= self.dropped_events:
                self._next_drop_notice *= 2
            notice = [("monitor/dropped_events", float(self.dropped_events),
                       self.events_written + self.dropped_events)]
            for m in self.monitors:
                m.write_events(notice)
