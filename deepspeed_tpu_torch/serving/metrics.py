"""Serving metric aggregation: latency percentiles, goodput, rates.

Definitions (docs/SERVING.md):
  TTFT      — first generated token ts minus ARRIVAL ts (queue wait included).
  TPOT      — (finish ts - first token ts) / (n_tokens - 1).
  goodput   — requests that finished WITHIN their deadline, per second of
              clock time (the FastGen blog's effective-throughput quantity:
              work that missed its SLA earns nothing).
  rejection_rate / preemption_rate / timeout_rate are per SUBMITTED request.
"""

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from .request import RequestState, ServingRequest


def percentile_summary(xs: List[float]) -> Dict[str, Optional[float]]:
    """p50/p95/p99 of a sample (None-filled when empty)."""
    if not xs:
        return {"p50": None, "p95": None, "p99": None, "mean": None, "n": 0}
    arr = np.asarray(xs, np.float64)
    return {"p50": round(float(np.percentile(arr, 50)), 6),
            "p95": round(float(np.percentile(arr, 95)), 6),
            "p99": round(float(np.percentile(arr, 99)), 6),
            "mean": round(float(arr.mean()), 6),
            "n": int(arr.size)}


@dataclasses.dataclass
class ServingStats:
    """Counters + completed-request log the frontend maintains.

    ``finished`` retains every terminal request (full prompt + tokens) so
    ``summary()`` can compute exact percentiles over a bench run's lifetime.
    A long-lived WallClock server should periodically swap in a fresh
    ``ServingStats`` (``engine.stats = ServingStats()``) after reporting a
    window, or memory grows linearly with request count."""
    submitted: int = 0
    rejected: int = 0
    timed_out: int = 0
    preemptions: int = 0       # events, not requests (one request can be evicted twice)
    migrated: int = 0          # requests handed off with their KV (kvtransfer)
    kv_imports: int = 0        # KV-import fast-path resumes on THIS replica
    kv_import_fallbacks: int = 0   # snapshot rejected -> recompute-on-resume
    parks: int = 0             # sessions parked to the host KV tier (kvtier)
    resumes: int = 0           # parked sessions re-enqueued for promotion
    prefix_imports: int = 0        # hot-prefix page imports adopted here
    prefix_import_pages: int = 0   # pages those imports scattered in
    reject_reasons: Dict[str, int] = dataclasses.field(default_factory=dict)
    finished: List[ServingRequest] = dataclasses.field(default_factory=list)

    def record_reject(self, reason: str) -> None:
        self.rejected += 1
        self.reject_reasons[reason] = self.reject_reasons.get(reason, 0) + 1

    def record_terminal(self, req: ServingRequest) -> None:
        if req.state is RequestState.TIMED_OUT:  # dslint-ok(state-machine): only the timed_out/migrated tallies live here — DONE is derived from `finished` and REJECTED is counted in record_reject
            self.timed_out += 1
        elif req.state is RequestState.MIGRATED:
            self.migrated += 1
        self.finished.append(req)

    @property
    def completed(self) -> List[ServingRequest]:
        return [r for r in self.finished if r.state is RequestState.DONE]

    def summary(self, elapsed: float) -> dict:
        """Aggregate record over ``elapsed`` seconds of clock time."""
        done = self.completed
        met = [r for r in done if r.met_deadline]
        n_sub = max(1, self.submitted)
        elapsed = max(elapsed, 1e-9)
        return {
            "submitted": self.submitted,
            "completed": len(done),
            "rejected": self.rejected,
            "timed_out": self.timed_out,
            "preemptions": self.preemptions,
            "preempted_requests": sum(1 for r in self.finished if r.preemptions),
            "migrated": self.migrated,
            "kv_imports": self.kv_imports,
            "kv_import_fallbacks": self.kv_import_fallbacks,
            "parks": self.parks,
            "resumes": self.resumes,
            "prefix_imports": self.prefix_imports,
            "prefix_import_pages": self.prefix_import_pages,
            "deadline_met": len(met),
            "rejection_rate": round(self.rejected / n_sub, 4),
            "preemption_rate": round(self.preemptions / n_sub, 4),
            "timeout_rate": round(self.timed_out / n_sub, 4),
            "goodput_rps": round(len(met) / elapsed, 6),
            "completed_rps": round(len(done) / elapsed, 6),
            "tokens_generated": sum(len(r.tokens) for r in self.finished),
            "elapsed": round(elapsed, 6),
            "ttft": percentile_summary([r.ttft for r in done if r.ttft is not None]),
            "tpot": percentile_summary([r.tpot for r in done if r.tpot is not None]),
            "queue_wait": percentile_summary(
                [r.queue_wait for r in done if r.queue_wait is not None]),
            "reject_reasons": dict(self.reject_reasons),
        }
