"""Always-on metrics: counters, gauges, and fixed-log-bucket histograms.

The serving layer already computes exact percentiles in
``serving/metrics.py`` — by RETAINING every finished request, which is
the right call for a bench run and the wrong one for a long-lived
server.  This registry is the cheap always-on complement: a histogram is
a fixed array of log-spaced bucket counts (O(1) record, O(buckets)
memory forever), and p50/p95/p99 are read from the bucket boundaries
with geometric interpolation — bounded relative error (one bucket's
growth factor), zero sample retention.

Bridged into the existing monitor surface by :meth:`MetricsRegistry.
flush_to_monitor`: every metric becomes a ``telemetry/<name>`` event
tuple through ``MonitorMaster.write_events`` — same backends, same
``max_events`` cap, same ``dropped_events`` accounting as the rest of
the stack.
"""

import bisect
import math
from typing import Dict, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "HistogramWindow",
           "MetricsRegistry"]


class Counter:
    """Monotonic count (requests served, tokens generated, spans dropped)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: inc({n}) — counters only go up")
        self.value += n


class Gauge:
    """Last-write-wins value (queue depth, flops/step, free KV pages)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Optional[float] = None

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed log-bucket histogram: p50/p95/p99 without sample retention.

    Buckets are ``lo * growth**k`` for k in [0, n); a sample lands in the
    bucket whose upper bound first reaches it.  Two overflow cells catch
    samples below ``lo`` (index 0 territory is [0, lo]) and above the top
    bound.  Negative samples are clamped to 0 and counted in
    ``clamped_negative`` — latencies cannot be negative; a negative
    sample is a clock bug upstream and hiding it entirely would mask
    that, while crashing the metrics path would take serving down with
    it.

    Default geometry: lo=1e-6, growth=2**0.5, n=64 spans 1µs..~4.3e3s
    with ≤ ~19% relative quantile error (half-octave buckets) in 64
    ints — always-on cheap.
    """

    __slots__ = ("name", "bounds", "counts", "count", "total", "min", "max",
                 "clamped_negative")

    def __init__(self, name: str, lo: float = 1e-6, growth: float = 2 ** 0.5,
                 n_buckets: int = 64):
        if not (lo > 0 and growth > 1 and n_buckets >= 2):
            raise ValueError(f"histogram {name}: need lo>0, growth>1, n_buckets>=2 "
                             f"(got lo={lo}, growth={growth}, n={n_buckets})")
        self.name = name
        self.bounds: List[float] = [lo * growth ** k for k in range(n_buckets)]
        self.counts: List[int] = [0] * (n_buckets + 1)  # +1 overflow cell
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.clamped_negative = 0

    def record(self, x: float) -> None:
        if x != x:  # NaN: refuse loudly — a NaN latency is a real bug
            raise ValueError(f"histogram {self.name}: NaN sample")
        if x < 0:
            self.clamped_negative += 1
            x = 0.0
        i = bisect.bisect_left(self.bounds, x)
        self.counts[i] += 1
        self.count += 1
        self.total += x
        self.min = x if self.min is None else min(self.min, x)
        self.max = x if self.max is None else max(self.max, x)

    def quantile(self, q: float) -> Optional[float]:
        """Value at quantile ``q`` in [0, 1], from bucket boundaries with
        geometric interpolation inside the landing bucket; clamped to the
        observed min/max so tail quantiles never exceed reality."""
        return _bucket_quantile(self.bounds, self.counts, self.count,
                                self.min, self.max, q)

    def summary(self) -> dict:
        return {
            "count": self.count,
            "sum": round(self.total, 9),
            "mean": round(self.total / self.count, 9) if self.count else None,
            "min": self.min, "max": self.max,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }

    # ------------------------------------------------------------- windows

    def window(self) -> "HistogramWindow":
        """Snapshot this histogram's cumulative state for later windowed
        reads: ``hist.since(win)`` summarizes only the samples recorded
        AFTER the snapshot — the burn-rate primitive (telemetry/slo.py,
        docs/OBSERVABILITY.md "Burn-rate windows") without any sample
        retention.  The snapshot is O(buckets) at *snapshot* time; the
        ``record()`` hot path is untouched (the no-allocation disabled
        path stays pinned by the existing tracemalloc tests)."""
        return HistogramWindow(counts=tuple(self.counts), count=self.count,
                               total=self.total)

    def since(self, win: "HistogramWindow") -> dict:
        """Summary (count/sum/mean/p50/p95/p99) over the samples recorded
        since ``win`` was taken, by cumulative-count subtraction — the
        standard Prometheus-style windowed read of a cumulative histogram.
        Window quantiles interpolate within bucket bounds (the exact
        window min/max are unknowable without retention); the LIFETIME
        max bounds the overflow bucket, so a window whose samples exceed
        the top bound still reads a real tail instead of silently
        truncating at ``bounds[-1]``."""
        if len(win.counts) != len(self.counts):
            raise ValueError("window snapshot geometry mismatch")
        d_counts = [c - w for c, w in zip(self.counts, win.counts)]
        if any(d < 0 for d in d_counts):
            raise ValueError(f"histogram {self.name}: window snapshot is "
                             "newer than the histogram (counts went down)")
        d_count = self.count - win.count
        d_total = self.total - win.total
        return {
            "count": d_count,
            "sum": round(d_total, 9),
            "mean": round(d_total / d_count, 9) if d_count else None,
            "p50": _bucket_quantile(self.bounds, d_counts, d_count, None, self.max, 0.50),
            "p95": _bucket_quantile(self.bounds, d_counts, d_count, None, self.max, 0.95),
            "p99": _bucket_quantile(self.bounds, d_counts, d_count, None, self.max, 0.99),
        }


def _bucket_quantile(bounds: List[float], counts: List[int], count: int,
                     lo_clamp: Optional[float], hi_clamp: Optional[float],
                     q: float) -> Optional[float]:
    """Shared quantile core over a bucket-count vector (live histograms
    pass their cumulative counts + observed min/max clamps; windowed reads
    pass delta counts with only the lifetime max bounding the overflow
    bucket)."""
    if count == 0:
        return None
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile {q} outside [0, 1]")
    rank = q * count
    cum = 0
    est = None
    for i, c in enumerate(counts):
        cum += c
        if cum >= rank and c > 0:
            if i == 0:
                lo, hi = 0.0, bounds[0]
            elif i >= len(bounds):
                lo = bounds[-1]
                hi = hi_clamp if hi_clamp is not None else bounds[-1]
            else:
                lo, hi = bounds[i - 1], bounds[i]
            # geometric midpoint-ish: interpolate by the rank's position
            # inside this bucket's count, in log space when possible
            frac = (rank - (cum - c)) / c
            if lo > 0 and hi > lo:
                est = lo * (hi / lo) ** frac
            else:
                est = lo + (hi - lo) * frac
            break
    if est is None:
        est = hi_clamp if hi_clamp is not None else bounds[-1]
    if lo_clamp is not None:
        est = max(lo_clamp, est)
    if hi_clamp is not None:
        est = min(hi_clamp, est)
    return est


class HistogramWindow:
    """Immutable cumulative-state snapshot of one :class:`Histogram` (see
    :meth:`Histogram.window`)."""

    __slots__ = ("counts", "count", "total")

    def __init__(self, counts: Tuple[int, ...], count: int, total: float):
        self.counts = counts
        self.count = count
        self.total = total


class MetricsRegistry:
    """Get-or-create registry; names are flat (``serving/ttft_s``).  A
    name registered as one kind cannot be re-registered as another."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls, *args, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, *args, **kw)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, requested {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, **kw) -> Histogram:
        return self._get(name, Histogram, **kw)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def snapshot(self) -> dict:
        """Flat point-in-time dict: counters/gauges as scalars, histograms
        as their summary dicts.  Deterministic key order."""
        out = {}
        for name in self.names():
            m = self._metrics[name]
            out[name] = m.summary() if isinstance(m, Histogram) else m.value
        return out

    def window(self) -> dict:
        """Cumulative-state snapshot of every metric, for
        :meth:`snapshot_since` — counters snapshot their value, histograms
        their bucket state (:meth:`Histogram.window`); gauges are
        last-write-wins and carry no window state."""
        out = {}
        for name, m in self._metrics.items():
            if isinstance(m, Histogram):
                out[name] = m.window()
            elif isinstance(m, Counter):
                out[name] = m.value
        return out

    def snapshot_since(self, win: dict) -> dict:
        """Windowed read: counters as deltas since ``win``, histograms as
        windowed summaries (``Histogram.since``), gauges as their current
        value.  Metrics created after the snapshot window from zero.
        Deterministic key order, no sample retention anywhere — the
        burn-rate monitors' input shape."""
        out = {}
        for name in self.names():
            m = self._metrics[name]
            if isinstance(m, Histogram):
                prev = win.get(name)
                out[name] = m.since(prev) if prev is not None \
                    else m.since(HistogramWindow(
                        counts=(0,) * len(m.counts), count=0, total=0.0))
            elif isinstance(m, Counter):
                out[name] = m.value - win.get(name, 0.0)
            else:
                out[name] = m.value
        return out

    def flush_to_monitor(self, monitor, step: int = 0) -> int:
        """Bridge every metric into ``MonitorMaster.write_events`` as
        ``telemetry/<name>`` tuples (histograms fan out to ``_p50/_p95/
        _p99/_count``).  Returns how many events were offered; unset
        gauges and empty histograms are skipped."""
        if monitor is None or not getattr(monitor, "enabled", False):
            return 0
        events = []
        for name in self.names():
            m = self._metrics[name]
            if isinstance(m, Histogram):
                if m.count == 0:
                    continue
                s = m.summary()
                for k in ("p50", "p95", "p99"):
                    events.append((f"telemetry/{name}_{k}", float(s[k]), step))
                events.append((f"telemetry/{name}_count", float(m.count), step))
            elif m.value is not None:
                events.append((f"telemetry/{name}", float(m.value), step))
        if events:
            monitor.write_events(events)
        return len(events)
