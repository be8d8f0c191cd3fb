"""Trace exporters: Chrome-trace/Perfetto JSON and JSONL, atomically written.

``to_chrome_trace`` renders finished spans as the Trace Event Format
(``ph:"X"`` complete events, µs timestamps) that chrome://tracing and
Perfetto load directly; span events become ``ph:"i"`` instants and each
track gets a ``thread_name`` metadata record.  Everything about the
output is deterministic: tracks are numbered in sorted-name order,
events are sorted by (track, ts, span_id), keys are sorted, and
timestamps are exact float µs of the clock readings — so a VirtualClock
trace serializes byte-identically across runs (the property the fleet
determinism test and the committed ``BENCH_ROUTER_TRACE.json`` artifact
pin).

Writers go through ``resilience.atomic_io`` — a trace artifact is a
bench receipt and must never be observable half-written.
"""

import json
from typing import Dict, Iterable, List, Optional

from ..resilience.atomic_io import atomic_write_bytes
from .trace import Span

__all__ = ["to_chrome_trace", "write_chrome_trace", "spans_to_jsonl",
           "write_jsonl", "load_chrome_trace"]

_US = 1e6  # clock seconds (or virtual steps) -> Chrome µs


def _clean(attrs: Optional[dict]) -> dict:
    """JSON-safe attribute dict (deterministic: sorted at dump time)."""
    if not attrs:
        return {}
    out = {}
    for k, v in attrs.items():
        if v is None or isinstance(v, (bool, int, float, str)):
            out[str(k)] = v
        elif isinstance(v, (list, tuple)):
            out[str(k)] = [x if isinstance(x, (bool, int, float, str)) else str(x)
                           for x in v]
        else:
            out[str(k)] = str(v)
    return out


def to_chrome_trace(spans: Iterable[Span], dropped_spans: int = 0,
                    meta: Optional[dict] = None) -> dict:
    """Render finished spans as a Chrome-trace document (dict)."""
    spans = [s for s in spans if s.end_ts is not None]
    tracks = sorted({s.track for s in spans})
    tids = {t: i for i, t in enumerate(tracks)}
    events: List[dict] = []
    for t in tracks:
        events.append({"ph": "M", "pid": 0, "tid": tids[t], "ts": 0,
                       "name": "thread_name", "args": {"name": t}})
    # deterministic render order; within a track, X events sorted by start
    # ts (then id) — the schema checker's per-track monotonicity invariant
    for s in sorted(spans, key=lambda s: (tids[s.track], s.start_ts, s.span_id)):
        args = _clean(s.attrs)
        args["trace_id"] = s.trace_id
        args["span_id"] = s.span_id
        if s.parent_id is not None:
            args["parent_id"] = s.parent_id
        events.append({"ph": "X", "pid": 0, "tid": tids[s.track],
                       "ts": round(s.start_ts * _US, 3),
                       "dur": round((s.end_ts - s.start_ts) * _US, 3),
                       "name": s.name, "args": args})
        for ename, ets, eattrs in s.events:
            ea = _clean(eattrs)
            ea["trace_id"] = s.trace_id
            ea["span_id"] = s.span_id
            events.append({"ph": "i", "pid": 0, "tid": tids[s.track],
                           "ts": round(ets * _US, 3), "s": "t",
                           "name": ename, "args": ea})
    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "format": "deepspeed_tpu.telemetry", "version": 1,
            "clock_unit_us": _US, "n_spans": len(spans),
            "dropped_spans": int(dropped_spans),
            "tracks": tracks,
        },
    }
    if meta:
        doc["otherData"].update(_clean(meta))
    return doc


def _dump(doc) -> bytes:
    return json.dumps(doc, sort_keys=True, separators=(",", ":")).encode("utf-8")


def write_chrome_trace(path: str, spans: Iterable[Span], dropped_spans: int = 0,
                       meta: Optional[dict] = None, site: Optional[str] = None) -> str:
    """Atomically write the Chrome-trace JSON; byte-identical for
    identical span streams."""
    return atomic_write_bytes(path, _dump(to_chrome_trace(
        spans, dropped_spans=dropped_spans, meta=meta)), site=site)


def span_to_record(s: Span) -> dict:
    return {
        "name": s.name, "trace_id": s.trace_id, "span_id": s.span_id,
        "parent_id": s.parent_id, "track": s.track,
        "start_ts": s.start_ts, "end_ts": s.end_ts,
        "attrs": _clean(s.attrs),
        "events": [{"name": n, "ts": t, "attrs": _clean(a)} for n, t, a in s.events],
    }


def spans_to_jsonl(spans: Iterable[Span]) -> str:
    """One JSON object per finished span, materialization order (the
    stream shape log pipelines ingest)."""
    lines = [json.dumps(span_to_record(s), sort_keys=True, separators=(",", ":"))
             for s in spans if s.end_ts is not None]
    return "\n".join(lines) + ("\n" if lines else "")


def write_jsonl(path: str, spans: Iterable[Span], site: Optional[str] = None) -> str:
    return atomic_write_bytes(path, spans_to_jsonl(spans).encode("utf-8"), site=site)


def load_chrome_trace(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
