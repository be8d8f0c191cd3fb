"""Fleet router: cache-affinity multi-replica serving with health-driven
failover (docs/SERVING.md "Fleet router").

One ``ServingEngine`` serves one mesh; the fleet layer is the data plane
above N of them: a :class:`ReplicaPool` (shared clock, health tracking,
kill/recover/drain lifecycle, per-replica :class:`ReplicaRole`\\ s for
prefill/decode disaggregation), a :class:`Router` with pluggable policies
(round-robin, least-outstanding-tokens, prefix-affinity with least-loaded
fallback, directory-resident ``prefix_directory`` with cold-replica
hot-prefix KV import, role-aware ``disaggregated`` with host-staged KV
migration — ``serving/kvtransfer``), a fleet-global
:class:`PrefixDirectory` replicas publish their prefix-chain digests
into, and a deterministic :class:`FleetSimulator` that
replays arrivals plus a scripted fault schedule bit-reproducibly on CPU
(``scripts/bench_router.py`` is the load harness; the seeded workload
generators live in :mod:`.sim`).
"""

from .autoscale import (RUNGS, AutoscaleConfig, Autoscaler, OverloadConfig,
                        OverloadController)
from .health import (FleetHealthView, HealthConfig, HealthTracker, LeaseConfig,
                     LeaseState, ReplicaState, classify_fatal)
from .policies import (POLICIES, DisaggregatedPolicy, LeastOutstandingPolicy,
                       PrefixAffinityPolicy, PrefixDirectoryPolicy,
                       RoundRobinPolicy, RoutingPolicy, SessionAffinityPolicy,
                       make_policy)
from .pool import Replica, ReplicaPool, ReplicaRole
from .prefix_directory import PrefixDirectory
from .router import FleetRequest, FleetState, Router
from .sim import (FleetEvent, FleetSimulator, diurnal_arrivals,
                  flash_crowd_arrivals, heavy_tail_arrivals,
                  poisson_mixed_arrivals, session_arrivals)
from .tenancy import DEFAULT_TENANT, TenantRegistry, TenantSpec
from .transport import (MESSAGE_KINDS, MESSAGE_VERSION, ControlTransport,
                        LinkFaults, Message, PartitionWindow)

__all__ = [
    "RUNGS", "AutoscaleConfig", "Autoscaler", "OverloadConfig",
    "OverloadController",
    "ControlTransport", "LinkFaults", "Message", "PartitionWindow",
    "MESSAGE_KINDS", "MESSAGE_VERSION",
    "FleetHealthView", "LeaseConfig", "LeaseState",
    "HealthConfig", "HealthTracker", "ReplicaState", "classify_fatal",
    "POLICIES", "DisaggregatedPolicy", "LeastOutstandingPolicy",
    "PrefixAffinityPolicy", "PrefixDirectoryPolicy", "PrefixDirectory",
    "RoundRobinPolicy", "RoutingPolicy", "SessionAffinityPolicy",
    "make_policy",
    "Replica", "ReplicaPool", "ReplicaRole", "FleetRequest", "FleetState",
    "Router", "FleetEvent", "FleetSimulator", "diurnal_arrivals",
    "flash_crowd_arrivals", "heavy_tail_arrivals", "poisson_mixed_arrivals",
    "session_arrivals",
    "DEFAULT_TENANT", "TenantRegistry", "TenantSpec",
]
