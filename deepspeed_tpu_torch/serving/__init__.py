"""SLA-aware serving frontend over the FastGen-v2 engine.

Turns ``InferenceEngineV2`` (sequences, ``put()``/``step()``) into a
servable endpoint (requests, deadlines, admission, preemption, latency
percentiles).  See docs/SERVING.md for the state machine, policies, and
metric definitions.
"""

from .admission import AdmissionConfig, AdmissionController
from .clock import ReplicaClockView, VirtualClock, WallClock
from .engine import ServingConfig, ServingEngine
from .kv_pressure import KVPressureManager
from .kvtransfer import (KVExporter, KVImportError, KVSnapshot,
                         SnapshotAborted, SnapshotError,
                         SnapshotIntegrityError, import_snapshot)
from .metrics import ServingStats, percentile_summary
from .request import RequestState, ServingRequest

__all__ = [
    "AdmissionConfig", "AdmissionController", "ReplicaClockView",
    "VirtualClock", "WallClock",
    "ServingConfig", "ServingEngine", "KVPressureManager", "ServingStats",
    "percentile_summary", "RequestState", "ServingRequest",
    "KVExporter", "KVImportError", "KVSnapshot", "SnapshotAborted",
    "SnapshotError", "SnapshotIntegrityError", "import_snapshot",
]
