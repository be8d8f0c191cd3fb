"""Telemetry for the serving stack: the span :mod:`tracer <.trace>` whose
timestamps come from the pluggable serving clock (bit-reproducible traces
under ``VirtualClock``), the per-step :mod:`anatomy <.step_anatomy>`
recorder, and the request-lifecycle :mod:`spans <.spans>` — the port's
own copies of the JAX package's ``telemetry/{trace,step_anatomy,spans}.py``
(stdlib only).  Export, the flight recorder, metrics, SLO burn and the
event registry come with the fleet (ROADMAP.md Queue 1).
"""

from .spans import PHASE_OF_STATE, emit_attempt_spans, phase_intervals
from .step_anatomy import HOST_SEGMENTS, NULL_ANATOMY, NullStepAnatomy, StepAnatomy
from .trace import NULL_SPAN, NULL_TRACER, NullTracer, PerfClock, Span, Tracer

__all__ = [
    "PHASE_OF_STATE", "emit_attempt_spans", "phase_intervals",
    "HOST_SEGMENTS", "NULL_ANATOMY", "NullStepAnatomy", "StepAnatomy",
    "NULL_SPAN", "NULL_TRACER", "NullTracer", "PerfClock", "Span", "Tracer",
]
