"""Experiment monitors (port of ``deepspeed_tpu/monitor/``)."""

from .monitor import CometMonitor, Monitor, MonitorMaster, TensorBoardMonitor, WandbMonitor, csvMonitor

__all__ = ["CometMonitor", "Monitor", "MonitorMaster", "TensorBoardMonitor", "WandbMonitor", "csvMonitor"]
