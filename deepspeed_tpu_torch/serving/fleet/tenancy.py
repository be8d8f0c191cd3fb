"""Multi-tenant QoS: per-tenant SLA budgets and weighted-fair ordering.

A fleet serving "millions of users" is never one user: traffic arrives
from TENANTS (products, API tiers, internal batch jobs) with different
contracts — a premium tier that pays for tight TTFT, a standard tier, and
best-effort bulk work that takes whatever is left.  This module is the
policy vocabulary the router threads through admission and dispatch:

* :class:`TenantSpec` — one tenant's contract: weighted-fair ``weight``
  (share of dispatch order under contention), ``max_outstanding``
  (concurrent dispatched requests — a heavy tenant's burst cannot occupy
  every replica slot), an optional ``ttft_slo`` (per-tenant violation
  accounting), and ``best_effort`` (eligible for the overload ladder's
  brownout caps and shedding — see :mod:`.autoscale`).
* :class:`TenantRegistry` — the spec table plus STRIDE-SCHEDULING state:
  each admitted request takes the tenant's current *pass* value and
  advances it by ``1 / weight``, so sorting pending requests by pass
  interleaves tenants in weight proportion.  A tenant with weight 4 gets
  ~4 dispatch slots for every 1 a weight-1 tenant gets while both are
  backlogged — and an idle tenant accumulates no credit: its pass is
  clamped up to the router's virtual-time floor (the minimum pass among
  pending requests) on (re)join, so a burst can neither bank unused share
  nor jump ahead of a backlog it sat out.

Everything here is plain deterministic arithmetic — no clocks, no RNG —
so the fleet's weighted-fair order is bit-identical across runs, which is
what lets the autoscale bench and the chaos suites pin byte-equal
dispatch sequences.
"""

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's QoS contract (see module docstring)."""
    name: str
    #: weighted-fair share under contention (higher = more dispatch slots);
    #: stride scheduling advances the tenant's pass by 1/weight per request
    weight: float = 1.0
    #: max concurrently DISPATCHED requests fleet-wide; <= 0 = unbounded
    max_outstanding: int = 0
    #: per-tenant TTFT budget for violation accounting (None = deadline-only)
    ttft_slo: Optional[float] = None
    #: eligible for brownout token caps and overload shedding
    best_effort: bool = False
    #: SLO error budget: the fraction of requests allowed to miss
    #: ``ttft_slo`` before the burn rate reads 1.0 — the denominator of
    #: the multi-window burn-rate monitor (telemetry/slo.py); unused when
    #: ``ttft_slo`` is None
    error_budget: float = 0.1
    #: fleet-wide KV arena budget in PAGES, metered by the exactly-once
    #: ``kv/tenant_pages/<tenant>`` attribution (Router.tenant_kv_pages):
    #: admission rejects a request whose projected page need would push
    #: the tenant past this bound (``fleet/kv_quota_reject`` + retry_after
    #: hint), and prefix-directory imports charge the importing tenant's
    #: budget before adopting remote pages; <= 0 = unbounded
    kv_page_quota: int = 0

    def __post_init__(self):
        if not self.weight > 0:
            raise ValueError(f"tenant {self.name!r}: weight must be > 0, "
                             f"got {self.weight}")
        if not self.name:
            raise ValueError("tenant name must be non-empty")
        if not 0.0 < self.error_budget <= 1.0:
            raise ValueError(f"tenant {self.name!r}: error_budget must be in "
                             f"(0, 1], got {self.error_budget}")
        if self.kv_page_quota < 0:
            raise ValueError(f"tenant {self.name!r}: kv_page_quota must be "
                             f">= 0 (0 = unbounded), got {self.kv_page_quota}")


#: the implicit tenant of untagged requests — weight 1, unbounded, not
#: best-effort: a tenant-less fleet behaves exactly like the pre-tenancy
#: router (pure FCFS within the single tenant)
DEFAULT_TENANT = TenantSpec(name="default")


class TenantRegistry:
    """Spec table + deterministic stride-scheduling pass state."""

    def __init__(self, specs: Iterable[TenantSpec] = ()):
        self._specs: Dict[str, TenantSpec] = {}
        #: tenant -> next stride pass (advanced by 1/weight per request)
        self._pass: Dict[str, float] = {}
        for s in specs:
            self.register(s)

    def register(self, spec: TenantSpec) -> TenantSpec:
        if spec.name in self._specs:
            raise ValueError(f"tenant {spec.name!r} already registered")
        self._specs[spec.name] = spec
        return spec

    def spec(self, name: str) -> TenantSpec:
        """Spec for ``name``; unknown tenants get an auto-created default
        contract (weight 1) — an unconfigured tenant is still served, just
        without privileges."""
        s = self._specs.get(name)
        if s is None:
            s = TenantSpec(name=name) if name != DEFAULT_TENANT.name \
                else DEFAULT_TENANT
            self._specs[name] = s
        return s

    def names(self) -> List[str]:
        return sorted(self._specs)

    def next_pass(self, name: str, floor: float = 0.0) -> float:
        """Take the tenant's current stride pass and advance it by
        ``1 / weight``.  ``floor`` is the caller's WFQ virtual time — the
        router passes the minimum pass among currently-pending requests —
        and the tenant's pass is clamped UP to it: a tenant joining (or
        rejoining after idling) competes from *now*, neither replaying the
        backlog it sat out nor spending banked credit to starve it."""
        spec = self.spec(name)
        p = max(self._pass.get(name, 0.0), floor)
        self._pass[name] = p + 1.0 / spec.weight
        return p

    def reset_passes(self) -> None:
        """Re-zero every tenant's stride state.  The router calls this when
        the fleet goes fully idle (no pending, no dispatched): with no
        backlog there is no share to arbitrate, and carrying old pass
        values into the next busy period would penalize past heavy users
        forever."""
        self._pass.clear()


def order_key(priority: float, wfq_pass: float, arrival_ts: float,
              fid: int) -> Tuple[float, float, float, int]:
    """The fleet pending-queue sort key: explicit priority class first
    (unchanged contract), then the weighted-fair stride pass, then FCFS.
    With a single tenant the pass is a submit-order counter, so the order
    degenerates to exactly the pre-tenancy (priority, arrival, fid)."""
    return (priority, wfq_pass, arrival_ts, fid)
