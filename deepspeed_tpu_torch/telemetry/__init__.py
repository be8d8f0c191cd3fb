"""Telemetry for the serving stack and the fleet: the span :mod:`tracer
<.trace>` whose timestamps come from the pluggable serving clock
(bit-reproducible traces under ``VirtualClock``), Chrome-trace/Perfetto +
JSONL :mod:`exporters <.export>` with atomic writes, the :mod:`metrics
<.metrics>` registry (counters / gauges / fixed-log-bucket histograms),
the multi-window SLO :mod:`burn monitor <.slo>`, the fleet's :mod:`flight
recorder <.flight_recorder>`, the per-step :mod:`anatomy <.step_anatomy>`
recorder, the request-lifecycle :mod:`spans <.spans>` and the :mod:`event
registry <.event_registry>` of every event name — the port's own copies of
the JAX package's ``telemetry/`` modules (numpy and the stdlib only).
"""

from .export import load_chrome_trace, spans_to_jsonl, to_chrome_trace, write_chrome_trace, write_jsonl
from .flight_recorder import FlightRecorder
from .metrics import Counter, Gauge, Histogram, HistogramWindow, MetricsRegistry
from .slo import BurnRateConfig, SLOBurnMonitor
from .spans import PHASE_OF_STATE, emit_attempt_spans, phase_intervals
from .step_anatomy import HOST_SEGMENTS, NULL_ANATOMY, NullStepAnatomy, StepAnatomy
from .trace import NULL_SPAN, NULL_TRACER, NullTracer, PerfClock, Span, Tracer

__all__ = [
    "load_chrome_trace", "spans_to_jsonl", "to_chrome_trace",
    "write_chrome_trace", "write_jsonl",
    "FlightRecorder",
    "Counter", "Gauge", "Histogram", "HistogramWindow", "MetricsRegistry",
    "BurnRateConfig", "SLOBurnMonitor",
    "PHASE_OF_STATE", "emit_attempt_spans", "phase_intervals",
    "HOST_SEGMENTS", "NULL_ANATOMY", "NullStepAnatomy", "StepAnatomy",
    "NULL_SPAN", "NULL_TRACER", "NullTracer", "PerfClock", "Span", "Tracer",
]
