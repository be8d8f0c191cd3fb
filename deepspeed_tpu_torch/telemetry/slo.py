"""Windowed SLO burn-rate monitoring over per-tenant TTFT budgets.

A single violation counter cannot tell "we are burning the error budget
NOW" from "we burned it at 9am"; classic multi-window burn-rate alerting
(the SRE-workbook shape) fixes that with two windows: a FAST window that
reacts to onset and a SLOW window that confirms persistence — the alert
fires only when BOTH burn hot (one spike cannot page) and clears on the
fast window cooling (recovery is visible within one fast window).

``burn rate = (violating fraction in window) / error budget`` — 1.0 means
the tenant is consuming its budget exactly at the allowed rate; 10 means
ten times too fast.  The per-tenant SLO (``TenantSpec.ttft_slo``) and
budget (``TenantSpec.error_budget``) come straight from the tenancy
contract the router already enforces.

Mechanics: per (tenant, window) a rotating ring of ``sub_buckets`` time
buckets holding ``(n, bad)`` counts — O(sub_buckets) memory forever, no
sample retention (the same stance as the log-bucket histograms; the
coarser cousin :meth:`~.metrics.Histogram.window` exists for quantile
windows).  Everything is driven by the caller's clock: under
``VirtualClock`` the alert timeline — ``slo/alert_fired/<tenant>`` /
``slo/alert_cleared/<tenant>`` events, the :attr:`alerts` audit log, and
the flight-recorder ``ctrl/slo/<tenant>`` interval track — is
bit-reproducible across runs (the ``BENCH_ROUTER_ATTRIB.json`` receipt).
"""

import dataclasses
from typing import Dict, List, Optional

__all__ = ["BurnRateConfig", "SLOBurnMonitor"]


@dataclasses.dataclass(frozen=True)
class BurnRateConfig:
    #: fast window: reacts to onset (clock-seconds)
    fast_window: float = 8.0
    #: slow window: confirms persistence; must exceed the fast window
    slow_window: float = 32.0
    #: burn rate at/above which (on BOTH windows) the alert fires
    fire_threshold: float = 1.0
    #: fast-window burn rate at/below which an active alert clears
    #: (hysteresis: clear < fire, so a boundary burn cannot flap)
    clear_threshold: float = 0.5
    #: minimum requests in a window before its burn rate counts as
    #: evidence (an empty fleet must not alert on its first slow request)
    min_requests: int = 4
    #: time buckets per window (rotation granularity)
    sub_buckets: int = 8

    def __post_init__(self):
        if not 0 < self.fast_window < self.slow_window:
            raise ValueError(f"windows need 0 < fast < slow "
                             f"(got {self.fast_window}, {self.slow_window})")
        if not 0 <= self.clear_threshold < self.fire_threshold:
            raise ValueError(f"hysteresis needs clear < fire (got "
                             f"{self.clear_threshold}, {self.fire_threshold})")
        if self.sub_buckets < 2 or self.min_requests < 1:
            raise ValueError(f"sub_buckets >= 2 and min_requests >= 1 required "
                             f"(got {self.sub_buckets}, {self.min_requests})")


class _WindowRing:
    """Rotating (n, bad) time buckets covering one window."""

    __slots__ = ("span", "n", "bad", "idx", "start")

    def __init__(self, window: float, sub_buckets: int, t0: float):
        self.span = window / sub_buckets
        self.n = [0] * sub_buckets
        self.bad = [0] * sub_buckets
        self.idx = 0
        self.start = t0  # start time of the CURRENT bucket

    def advance(self, now: float) -> None:
        # rotate whole buckets; a jump past the entire window zeroes it in
        # at most len(n) steps (cheap and allocation-free)
        steps = 0
        while now >= self.start + self.span and steps < 2 * len(self.n):
            self.idx = (self.idx + 1) % len(self.n)
            self.n[self.idx] = 0
            self.bad[self.idx] = 0
            self.start += self.span
            steps += 1
        if now >= self.start + self.span:  # still behind: clamp the anchor
            for i in range(len(self.n)):
                self.n[i] = self.bad[i] = 0
            self.start = now

    def observe(self, now: float, bad: bool) -> None:
        self.advance(now)
        self.n[self.idx] += 1
        if bad:
            self.bad[self.idx] += 1

    def totals(self) -> (int, int):
        return sum(self.n), sum(self.bad)


class SLOBurnMonitor:
    """Multi-window burn-rate alerting over ``TenantSpec.ttft_slo``.

    ``tenants`` is the router's :class:`~..serving.fleet.tenancy.
    TenantRegistry`; only tenants with a ``ttft_slo`` are monitored.
    ``emit(name, value)`` is the router's monitor emitter; ``metrics`` an
    optional MetricsRegistry for the ``slo/burn_fast/<tenant>`` gauges;
    ``recorder`` an optional flight recorder for the alert-window
    intervals.  Call :meth:`observe` per DONE request and :meth:`tick`
    once per fleet round."""

    def __init__(self, tenants, config: BurnRateConfig = None, clock=None,
                 emit=None, metrics=None, recorder=None):
        self.tenants = tenants
        self.config = config or BurnRateConfig()
        self.clock = clock
        self._emit_cb = emit
        self.metrics = metrics
        self.recorder = recorder
        self._fast: Dict[str, _WindowRing] = {}
        self._slow: Dict[str, _WindowRing] = {}
        self._active: Dict[str, bool] = {}
        #: the audit log: one dict per alert episode —
        #: {"tenant", "fired_ts", "cleared_ts" (None while active),
        #:  "fired_fast", "fired_slow"} in firing order
        self.alerts: List[dict] = []
        self.observed = 0

    # ------------------------------------------------------------- plumbing

    def bind(self, emit=None, metrics=None, recorder=None) -> None:
        """Late wiring (the router attaches its own emitter/registry)."""
        if emit is not None:
            self._emit_cb = emit
        if metrics is not None:
            self.metrics = metrics
        if recorder is not None:
            self.recorder = recorder

    def _now(self, ts: Optional[float]) -> float:
        if ts is not None:
            return ts
        if self.clock is None:
            raise ValueError("SLOBurnMonitor needs a clock or explicit ts")
        return self.clock.now()

    def _rings(self, tenant: str, now: float):
        fast = self._fast.get(tenant)
        if fast is None:
            cfg = self.config
            fast = self._fast[tenant] = _WindowRing(cfg.fast_window,
                                                    cfg.sub_buckets, now)
            self._slow[tenant] = _WindowRing(cfg.slow_window,
                                             cfg.sub_buckets, now)
            self._active[tenant] = False
            if self.recorder is not None:
                self.recorder.note_state(f"ctrl/slo/{tenant}", "ok", now)
        return fast, self._slow[tenant]

    # --------------------------------------------------------------- intake

    def observe(self, tenant: str, ttft: Optional[float],
                now: Optional[float] = None) -> None:
        """Fold one completed request's TTFT against its tenant's SLO.
        Tenants without a ``ttft_slo`` (and requests without a TTFT) are
        ignored — deadline accounting already covers them."""
        spec = self.tenants.spec(tenant)
        if spec.ttft_slo is None or ttft is None:
            return
        t = self._now(now)
        fast, slow = self._rings(tenant, t)
        bad = ttft > spec.ttft_slo
        fast.observe(t, bad)
        slow.observe(t, bad)
        self.observed += 1

    # ----------------------------------------------------------------- tick

    def burn_rates(self, tenant: str, now: Optional[float] = None):
        """``(fast, slow)`` burn rates right now; windows with fewer than
        ``min_requests`` observations read 0.0 (insufficient evidence)."""
        t = self._now(now)
        if tenant not in self._fast:
            return 0.0, 0.0
        spec = self.tenants.spec(tenant)
        budget = max(1e-9, spec.error_budget)
        out = []
        for ring in (self._fast[tenant], self._slow[tenant]):
            ring.advance(t)
            n, bad = ring.totals()
            out.append(0.0 if n < self.config.min_requests
                       else (bad / n) / budget)
        return out[0], out[1]

    def tick(self, now: Optional[float] = None) -> None:
        """One control round: advance every tenant's windows, publish the
        burn gauges, and run the hysteresis-gated alert transitions."""
        t = self._now(now)
        cfg = self.config
        for tenant in sorted(self._fast):
            fast, slow = self.burn_rates(tenant, t)
            if self.metrics is not None:
                self.metrics.gauge(f"slo/burn_fast/{tenant}").set(round(fast, 9))
                self.metrics.gauge(f"slo/burn_slow/{tenant}").set(round(slow, 9))
            active = self._active[tenant]
            if not active and fast >= cfg.fire_threshold \
                    and slow >= cfg.fire_threshold:
                self._active[tenant] = True
                self.alerts.append({"tenant": tenant, "fired_ts": round(t, 9),
                                    "cleared_ts": None,
                                    "fired_fast": round(fast, 9),
                                    "fired_slow": round(slow, 9)})
                if self._emit_cb is not None:
                    self._emit_cb(f"slo/alert_fired/{tenant}", fast)
                if self.recorder is not None:
                    self.recorder.note_state(f"ctrl/slo/{tenant}", "alert", t,
                                             attrs={"fast": round(fast, 9),
                                                    "slow": round(slow, 9)})
            elif active and fast <= cfg.clear_threshold:
                self._active[tenant] = False
                for a in reversed(self.alerts):
                    if a["tenant"] == tenant and a["cleared_ts"] is None:
                        a["cleared_ts"] = round(t, 9)
                        break
                if self._emit_cb is not None:
                    self._emit_cb(f"slo/alert_cleared/{tenant}", fast)
                if self.recorder is not None:
                    self.recorder.note_state(f"ctrl/slo/{tenant}", "ok", t)

    # -------------------------------------------------------------- queries

    def active(self, tenant: str) -> bool:
        return self._active.get(tenant, False)

    def summary(self) -> dict:
        return {
            "config": {
                "fast_window": self.config.fast_window,
                "slow_window": self.config.slow_window,
                "fire_threshold": self.config.fire_threshold,
                "clear_threshold": self.config.clear_threshold,
                "min_requests": self.config.min_requests,
            },
            "observed": self.observed,
            "tenants": sorted(self._fast),
            "active": sorted(t for t, a in self._active.items() if a),
            "alerts": [dict(a) for a in self.alerts],
        }
