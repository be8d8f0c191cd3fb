"""Measured overlap for the streamed-optimizer group pipelines (port of
``deepspeed_tpu/runtime/swap_tensor/overlap_instrumentation.py``).

The streamed tiers (``HostStreamedOptimizer``, ``PipelinedNVMeOptimizer``)
claim that group *g+1*'s state transfer hides behind group *g*'s Adam on the
device.  Each pipeline records timestamped per-group phase events here, plus
two kinds of timing sweeps —

* **serialized probe** (``set_probe``): one update sweep run with a hard
  fence after every phase, yielding per-group ``upload_s`` / ``compute_s``
  / ``download_s`` durations (no overlap possible, so the phase attribution
  is exact);
* **pipelined step** (``set_step``): the normal double-buffered sweep,
  fenced only at entry (gradients ready) and exit (all outputs and host
  write-backs ready), yielding the achieved wall time and per-group
  compute-completion timestamps.

``report()`` combines the two:

  serialized_s     = sum(upload + compute + download)     -- no-overlap cost
  transfer_s       = sum(upload + download)
  ideal_pipelined_s= max(compute_s, transfer_s)           -- perfect-overlap
                     floor, conservatively assuming one copy engine serves
                     both directions
  overlap_fraction = (serialized_s - pipelined_wall_s)
                     / (serialized_s - ideal_pipelined_s)   in [0, 1]
  bound            = "transfer" | "compute" -- which floor binds.

Per-group device-idle gaps come from the pipelined step's compute completion
timestamps minus the probe's compute durations at the same shapes.

Timestamps are the telemetry ``PerfClock``'s (``telemetry/trace.py``), one
clock for the module; the engine maps them into its tracer's clock by an
offset (``lift_spans``).
"""

from collections import deque
from typing import Any, Dict, List, Optional

from ...telemetry.trace import PerfClock

PHASES = ("upload", "compute", "download")

_CLOCK = PerfClock()


def now() -> float:
    """Seconds on the module's ``PerfClock``: the domain of every event."""
    return _CLOCK.now()


class OverlapInstrumentation:
    """Timestamped event ring + probe/step records for one pipeline."""

    def __init__(self, maxlen: int = 4096):
        self.events = deque(maxlen=maxlen)
        self.probe: Optional[Dict[str, Any]] = None
        self.last_step: Optional[Dict[str, Any]] = None
        # bumped on every probe/step record so consumers (monitor) can emit
        # a report once per fresh measurement instead of every step
        self.version = 0

    # ------------------------------------------------------------- events

    def record(self, kind: str, group: int) -> float:
        t = now()
        self.events.append((kind, group, t))
        return t

    def events_of(self, kind: str) -> Dict[int, float]:
        """Latest timestamp per group for ``kind``."""
        out: Dict[int, float] = {}
        for k, g, t in self.events:
            if k == kind:
                out[g] = t
        return out

    # ------------------------------------------------------------- sweeps

    def set_probe(self, per_group: List[Dict[str, float]], wall_s: float):
        totals = {f"{ph}_s": sum(g[f"{ph}_s"] for g in per_group) for ph in PHASES}
        self.probe = {
            "per_group": per_group,
            "wall_s": wall_s,
            "serialized_s": sum(totals.values()),
            **totals,
        }
        self.version += 1

    def set_step(self, wall_s: float, bwd_wait_s: Optional[float] = None,
                 prefetch_wait_s: Optional[float] = None,
                 compute_done_ts: Optional[List[float]] = None):
        self.last_step = {
            "pipelined_wall_s": wall_s,
            "bwd_wait_s": bwd_wait_s,
            "prefetch_wait_s": prefetch_wait_s,
            "compute_done_ts": compute_done_ts,
        }
        self.version += 1

    # ----------------------------------------------------------- telemetry

    def lift_spans(self, tracer, parent, track: str = "stream",
                   since_ts: float = 0.0, offset: float = 0.0) -> int:
        """Lift the phase events recorded since ``since_ts`` (perf-counter
        domain) into trace spans under ``parent`` (a telemetry Span).

        Paired ``<phase>_issue``/``<phase>_done`` events for a group
        become a real child span ``<phase> g<N>``; an unpaired issue (an
        async transfer left in flight by the pipelined sweep — by design)
        becomes a point event on ``parent``, so the trace never claims a
        duration nobody measured.  ``offset`` maps perf-counter timestamps
        into the tracer's clock domain.  Returns how many spans were
        materialized."""
        pairs: Dict[tuple, float] = {}   # (phase, group) -> issue ts
        made = 0
        for kind, g, t in self.events:
            if t < since_ts or "_" not in kind:
                continue
            phase, _, edge = kind.rpartition("_")
            if phase not in PHASES:
                continue
            if edge == "issue":
                pairs[(phase, g)] = t
            elif edge == "done":
                t0 = pairs.pop((phase, g), None)
                if t0 is None:
                    parent.event(f"{phase}_done g{g}", t + offset)
                    continue
                tracer.add_span(f"{phase} g{g}", parent.trace_id,
                                t0 + offset, t + offset,
                                parent_id=parent.span_id, track=track,
                                attrs={"group": g, "phase": phase})
                made += 1
        for (phase, g), t0 in sorted(pairs.items()):
            parent.event(f"{phase}_issue g{g}", t0 + offset, {"in_flight": True})
        return made

    # ------------------------------------------------------------- report

    def report(self) -> Optional[Dict[str, Any]]:
        """Combine the latest serialized probe and pipelined step into the
        overlap artifact.  None until a probe has run."""
        if self.probe is None:
            return None
        p = self.probe
        transfer_s = p["upload_s"] + p["download_s"]
        ideal = max(p["compute_s"], transfer_s)
        rep: Dict[str, Any] = {
            "n_groups": len(p["per_group"]),
            "per_group": [dict(g) for g in p["per_group"]],
            "upload_s": round(p["upload_s"], 6),
            "compute_s": round(p["compute_s"], 6),
            "download_s": round(p["download_s"], 6),
            "serialized_s": round(p["serialized_s"], 6),
            "transfer_s": round(transfer_s, 6),
            "ideal_pipelined_s": round(ideal, 6),
            "bound": "transfer" if transfer_s > p["compute_s"] else "compute",
        }
        step = self.last_step
        if step is not None:
            wall = step["pipelined_wall_s"]
            rep["pipelined_wall_s"] = round(wall, 6)
            hideable = p["serialized_s"] - ideal
            if hideable > 1e-9:
                frac = (p["serialized_s"] - wall) / hideable
            else:
                # nothing to hide (e.g. CPU fallback: zero-copy transfers)
                frac = 1.0
            rep["overlap_fraction"] = round(min(1.0, max(0.0, frac)), 4)
            rep["speedup_vs_serialized"] = round(p["serialized_s"] / max(wall, 1e-9), 4)
            if step.get("bwd_wait_s") is not None:
                rep["bwd_wait_s"] = round(step["bwd_wait_s"], 6)
            if step.get("prefetch_wait_s") is not None:
                # ~0 when the backward-phase prefetch really hid the first
                # uploads behind the fwd/bwd program
                rep["prefetch_wait_after_bwd_s"] = round(step["prefetch_wait_s"], 6)
            ts = step.get("compute_done_ts")
            if ts and len(ts) >= 2:
                gaps = []
                for g in range(1, len(ts)):
                    span = ts[g] - ts[g - 1]
                    comp = p["per_group"][g]["compute_s"] if g < len(p["per_group"]) else 0.0
                    gaps.append(max(0.0, span - comp))
                rep["device_idle_gap_s_per_group"] = [round(x, 6) for x in gaps]
                rep["device_idle_gap_s"] = round(sum(gaps), 6)
        return rep
