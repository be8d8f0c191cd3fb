"""Fleet flight recorder: a bounded, always-on span/event ring with
crash-scoped Chrome-trace dumps.

The r10 tracer answers "what did this REQUEST do" — one trace per unit of
work, exported at end of run.  The flight recorder answers the question an
operator has at 3am: "what was the whole CONTROL PLANE doing in the
seconds before replica 3 got fenced?"  Its design constraints are the
opposite of the tracer's:

* **bounded, always-on** — a per-track ring (``deque(maxlen=...)``) keeps
  only the last N finished spans per track, so it can run forever on a
  wall-clock server at O(tracks x N) memory; evictions are counted per
  track in :attr:`dropped`, never hidden;
* **crash-scoped dumps** — :meth:`maybe_dump` atomically writes a
  Chrome-trace snapshot of the rings (open state intervals closed at the
  dump instant *in the export only*) when something went wrong: a replica
  death, a fencing episode, an output divergence.  The dump is the black
  box an operator pulls after the incident — hence "flight recorder";
* **clock-pluggable and deterministic** — timestamps come from the caller
  (or the attached serving clock), so under ``VirtualClock`` dumps are
  byte-identical across runs, exactly like the r10 trace artifacts.

What lands in the rings (docs/OBSERVABILITY.md "Flight recorder"):

* every finished span of an attached :class:`~.trace.Tracer` (the
  recorder is a retention *sink*: ``Tracer(recorder=...)`` mirrors spans
  into the ring as they finish, so request phase spans survive in the
  ring even after the tracer's own retention drops them);
* control-plane message spans from
  :class:`~..serving.fleet.transport.ControlTransport` — one
  ``ctrl/<kind>`` span per DELIVERED message spanning send→deliver (the
  causal pair), one ``ctrl/drop`` instant per message the fabric ate
  (cause: loss / partition / fault), on per-link ``ctrl/link/...``
  tracks;
* lease-lifecycle intervals (``ctrl/lease/<state>`` per replica), brownout
  rung occupancy (``ctrl/overload/<rung>``), and autoscaler decision
  instants (``ctrl/autoscale/<action>``) via :meth:`note_state` /
  :meth:`instant`.
"""

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Tuple

from .trace import Span

__all__ = ["FlightRecorder"]


@dataclasses.dataclass
class _OpenState:
    """One track's currently-open interval (note_state)."""
    name: str
    since: float
    attrs: Optional[dict]


class FlightRecorder:
    """Bounded per-track ring of finished spans + interval/instant intake.

    ``clock`` is any ``now()`` provider (the fleet's shared clock) used
    when a caller passes no timestamp; ``max_per_track`` bounds every
    ring; ``dump_dir`` enables :meth:`maybe_dump` (None = ring only, no
    files — the always-on default costs no I/O)."""

    def __init__(self, clock=None, max_per_track: int = 256,
                 dump_dir: Optional[str] = None):
        if max_per_track < 1:
            raise ValueError(f"max_per_track must be >= 1, got {max_per_track}")
        self.clock = clock
        self.max_per_track = int(max_per_track)
        self.dump_dir = dump_dir
        self._tracks: Dict[str, deque] = {}
        #: per-track count of spans the ring evicted (bounded-memory receipt)
        self.dropped: Dict[str, int] = {}
        self._open: Dict[str, _OpenState] = {}
        #: recorder-local monotonic span ids (disjoint id space from any
        #: attached tracer is fine: dumps carry whole spans, not id refs)
        self._next_id = 1
        self.dumps = 0
        self.dump_log: List[Tuple[str, float, str]] = []  # (reason, ts, path)

    # --------------------------------------------------------------- intake

    def _now(self, ts: Optional[float]) -> float:
        if ts is not None:
            return ts
        if self.clock is None:
            raise ValueError("FlightRecorder needs an explicit ts when "
                             "constructed without a clock")
        return self.clock.now()

    def _ring(self, track: str) -> deque:
        ring = self._tracks.get(track)
        if ring is None:
            ring = self._tracks[track] = deque(maxlen=self.max_per_track)
            self.dropped[track] = 0
        return ring

    def _retain(self, span: Span) -> None:
        ring = self._ring(span.track)
        if len(ring) == ring.maxlen:
            self.dropped[span.track] += 1  # the deque evicts the oldest
        ring.append(span)

    def observe(self, span: Span) -> None:
        """Tracer retention sink: mirror one FINISHED span into the ring
        (``Tracer(recorder=...)`` calls this from ``_retain``)."""
        self._retain(span)

    def span(self, name: str, track: str, start_ts: float, end_ts: float,
             attrs: Optional[dict] = None) -> Span:
        """Record one finished span directly (control-plane message pairs)."""
        s = Span(name, 0, self._next_id, None, track, start_ts, attrs)
        self._next_id += 1
        s.end_ts = max(end_ts, start_ts)
        self._retain(s)
        return s

    def instant(self, name: str, track: str, ts: Optional[float] = None,
                attrs: Optional[dict] = None) -> Span:
        """Record a point event (zero-width span: renders as a Perfetto
        zero-duration slice, keeps the exporter/validator contract)."""
        t = self._now(ts)
        return self.span(name, track, t, t, attrs)

    def note_state(self, track: str, name: str, ts: Optional[float] = None,
                   attrs: Optional[dict] = None) -> None:
        """Interval intake for state machines: close the track's currently
        open interval at ``ts`` (materializing it into the ring) and open
        ``name``.  The first call on a track only opens.  Lease states,
        brownout rungs and SLO alert windows all land through here."""
        t = self._now(ts)
        cur = self._open.get(track)
        if cur is not None:
            if cur.name == name:
                return  # no transition: the open interval keeps running
            self.span(cur.name, track, cur.since, t, cur.attrs)
        self._open[track] = _OpenState(name=name, since=t, attrs=dict(attrs) if attrs else None)

    # ----------------------------------------------------------------- dump

    def snapshot_spans(self, now: Optional[float] = None) -> List[Span]:
        """Every retained span plus the open intervals closed at ``now``
        (export-only: the open state itself is not mutated).  Ordered by
        (track, start_ts, id) for deterministic export."""
        t = self._now(now)
        spans: List[Span] = []
        for track in sorted(self._tracks):
            spans.extend(self._tracks[track])
        for track in sorted(self._open):
            cur = self._open[track]
            s = Span(cur.name, 0, 0, None, track, cur.since,
                     dict(cur.attrs) if cur.attrs else {"open": True})
            s.attrs.setdefault("open", True)
            s.end_ts = max(t, cur.since)
            spans.append(s)
        return spans

    def maybe_dump(self, reason: str, now: Optional[float] = None,
                   meta: Optional[dict] = None) -> Optional[str]:
        """Atomically write a crash-scoped Chrome trace of the rings; the
        file is ``flight_<seq>_<reason>.json`` under ``dump_dir``.  Returns
        the path, or None when no ``dump_dir`` is configured (ring-only
        mode) — callers emit the ``recorder/dump`` event only on a real
        dump.  Never raises into the caller's failure path by design
        CHOICE of the caller (the router guards it): a failed black-box
        write must not turn a replica death into a driver death."""
        t = self._now(now)
        if self.dump_dir is None:
            return None
        import os

        from ..resilience.atomic_io import atomic_write_bytes
        from .export import _dump, to_chrome_trace
        # a black box that silently can't write is worse than none: make
        # the dump dir on first use so a not-yet-created path still dumps
        os.makedirs(self.dump_dir, exist_ok=True)
        seq = self.dumps + 1
        safe = "".join(c if c.isalnum() or c in "-_" else "_" for c in reason)
        path = os.path.join(self.dump_dir, f"flight_{seq:03d}_{safe}.json")
        doc = to_chrome_trace(
            self.snapshot_spans(t),
            dropped_spans=sum(self.dropped.values()),
            meta={"recorder": "flight", "reason": reason,
                  "dump_ts": round(t, 9), "dump_seq": seq,
                  "dropped_per_track": ", ".join(
                      f"{k}={v}" for k, v in sorted(self.dropped.items()) if v),
                  **(meta or {})})
        atomic_write_bytes(path, _dump(doc))
        # counted only once the file exists: a failed write must not
        # desync the cumulative recorder/dump event from the files on disk
        self.dumps = seq
        self.dump_log.append((reason, t, path))
        return path

    # -------------------------------------------------------------- queries

    @property
    def n_spans(self) -> int:
        return sum(len(r) for r in self._tracks.values())

    def track(self, name: str) -> List[Span]:
        return list(self._tracks.get(name, ()))

    def summary(self) -> dict:
        return {
            "tracks": {k: len(r) for k, r in sorted(self._tracks.items())},
            "dropped": {k: v for k, v in sorted(self.dropped.items()) if v},
            "open": {k: self._open[k].name for k in sorted(self._open)},
            "max_per_track": self.max_per_track,
            "dumps": self.dumps,
        }
