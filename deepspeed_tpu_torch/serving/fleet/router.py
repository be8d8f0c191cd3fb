"""Fleet router: the data plane above N ServingEngine replicas.

One client-facing request (:class:`FleetRequest`) maps to one-or-more
per-replica ``ServingRequest`` *attempts*: the router picks a replica via
its :mod:`policy <.policies>`, submits, and streams delivered tokens into
the fleet-level record.  When a replica dies (scripted kill, health
tracker, or an injected ``device_loss`` at the ``router.dispatch`` fault
site), its in-flight requests are re-queued and re-dispatched onto
survivors with ``resume_tokens`` — the per-replica recompute-on-resume
contract, lifted across replicas — so a failed-over request's final token
output is IDENTICAL to an unperturbed run's.

The router is driver-agnostic: :class:`~.sim.FleetSimulator` drives it
deterministically on a shared ``VirtualClock`` (tests, ``--dryrun``
benches); a real deployment would run the same ``dispatch_pending`` /
``poll`` surface from a wall-clock loop with replicas ticking in threads.

Fleet request lifecycle::

    PENDING → DISPATCHED → DONE
       ▲          │ (replica died: failover, tokens preserved)
       └──────────┘
    PENDING | DISPATCHED → TIMED_OUT     (deadline)
    PENDING → REJECTED                   (structurally infeasible everywhere)

Terminal states are reached exactly once — ``_finish`` enforces it — which
is the property the fleet chaos/property tests pin: no request lost,
duplicated, or served twice through any kill/recover/drain schedule.
"""

import dataclasses
import enum
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

from ...resilience import fault_injection as _fi
from ...telemetry.spans import emit_attempt_spans
from ...telemetry.trace import NULL_TRACER
from ...utils.logging import logger
from ..metrics import percentile_summary
from ..request import RequestState, ServingRequest
from ..kvtier import HostKVHandle
from ..kvtransfer import SnapshotAborted
from .health import FleetHealthView, LeaseConfig, LeaseState, ReplicaState
from .policies import RoutingPolicy
from .pool import ReplicaPool, ReplicaRole
from .tenancy import TenantRegistry, order_key as _tenant_order_key


class FleetState(enum.Enum):
    PENDING = "pending"        # in the router queue (new, or displaced)
    DISPATCHED = "dispatched"  # live on a replica
    DONE = "done"
    TIMED_OUT = "timed_out"
    REJECTED = "rejected"

    @property
    def terminal(self) -> bool:
        return self in (FleetState.DONE, FleetState.TIMED_OUT, FleetState.REJECTED)


#: validated fleet transitions (dslint state-machine table; rendered into
#: docs/STATE_MACHINES.md).  PENDING -> DONE covers the one legitimate
#: shortcut: a failover victim displaced with its output already complete
#: is closed out at its next dispatch attempt without re-serving a token.
_FLEET_ALLOWED = {
    FleetState.PENDING: {FleetState.DISPATCHED, FleetState.DONE,
                         FleetState.TIMED_OUT, FleetState.REJECTED},
    FleetState.DISPATCHED: {FleetState.PENDING, FleetState.DONE,
                            FleetState.TIMED_OUT},
    FleetState.DONE: set(),
    FleetState.TIMED_OUT: set(),
    FleetState.REJECTED: set(),
}


@dataclasses.dataclass
class FleetRequest:
    """One client request as the FLEET sees it.  ``tokens`` accumulates
    across replica attempts (stream deliveries + failover resumes) and is
    the client-visible output; per-attempt ``ServingRequest`` objects are
    bookkeeping."""
    fid: int
    prompt: List[int]
    max_new_tokens: int
    arrival_ts: float
    deadline: Optional[float] = None
    priority: float = 0.0
    state: FleetState = FleetState.PENDING
    tokens: List[int] = dataclasses.field(default_factory=list)
    first_token_ts: Optional[float] = None
    finish_ts: Optional[float] = None
    failovers: int = 0
    affinity_hits: int = 0
    migrations: int = 0          # KV handoffs between replicas (kvtransfer)
    reject_reason: Optional[str] = None
    #: when to retry a REJECTED request (clock-seconds from rejection) —
    #: set on transient rejections (overload shed, tenant-admission
    #: fault); None on structural rejections, where retrying cannot help
    #: (replica-level queue_full never rejects at the FLEET level — the
    #: request just stays pending for the next dispatch round)
    retry_after: Optional[float] = None
    #: QoS: the submitting tenant and its weighted-fair stride pass
    tenant: str = "default"
    _wfq: float = 0.0
    #: agentic-session identity (serving/sessions): set when this request
    #: is one TURN of a multi-turn session — the ``session_affinity``
    #: routing policy keys its sticky replica map on it, so turn N+1 lands
    #: where turn N left its warm transcript pages
    session_id: Optional[object] = None
    #: True when a brownout rung capped this request's max_new_tokens
    brownout_capped: bool = False
    #: host-staged KV carried between attempts: set when a migration's
    #: export completed (or harvested from a dead replica — failover
    #: reuse), consumed by the next dispatch's KV-import fast path
    _kv_snapshot: Optional[object] = None
    #: (replica rid, dispatch ts) per attempt
    dispatches: List[Tuple[int, float]] = dataclasses.field(default_factory=list)
    history: List[Tuple[FleetState, float]] = dataclasses.field(default_factory=list)
    _current: Optional[Tuple[int, ServingRequest, int]] = None  # (rid, sr, generation)
    #: telemetry context when the router traces: {"trace_id", "root_id",
    #: "attempts": [per-attempt dicts], "last_dead": span id of the most
    #: recently displaced attempt (the next attempt links to it)}
    trace: Optional[dict] = None

    def __post_init__(self):
        self.prompt = list(self.prompt)
        self.history.append((self.state, self.arrival_ts))

    def to(self, state: FleetState, ts: float) -> None:
        """The ONLY sanctioned way to move a fleet request: validates the
        hop against ``_FLEET_ALLOWED`` (an illegal one is a router bug and
        raises — the exactly-once-terminal property the chaos suite pins
        is enforced here, not merely asserted at ``_finish``) and appends
        the auditable history entry in the same step."""
        if state not in _FLEET_ALLOWED[self.state]:
            raise ValueError(f"fleet request {self.fid}: illegal transition "
                             f"{self.state.value} -> {state.value}")
        self.state = state
        self.history.append((state, ts))

    @property
    def ttft(self) -> Optional[float]:
        return None if self.first_token_ts is None else self.first_token_ts - self.arrival_ts

    @property
    def tpot(self) -> Optional[float]:
        if self.first_token_ts is None or self.finish_ts is None or len(self.tokens) < 2:
            return None
        return (self.finish_ts - self.first_token_ts) / (len(self.tokens) - 1)

    @property
    def e2e(self) -> Optional[float]:
        return None if self.finish_ts is None else self.finish_ts - self.arrival_ts

    @property
    def met_deadline(self) -> bool:
        if self.state is not FleetState.DONE:
            return False
        return self.deadline is None or self.finish_ts <= self.deadline


#: retry-after stamped on a TRANSIENT tenant-admission fault when no
#: overload episode is in progress: a bookkeeping blip, not backpressure —
#: retry soon (an active brownout substitutes the ladder's own hint)
TENANT_FAULT_RETRY_S = 1.0

#: retry-after stamped on a KV-quota rejection: pages free as the
#: tenant's own requests complete, so the hint is a serving-timescale
#: backoff, not the overload ladder's episode-scale one
KV_QUOTA_RETRY_S = 2.0


@dataclasses.dataclass
class _DirFeed:
    """Router-side receiver state for ONE replica's sequence-numbered
    prefix-publish stream (docs/SERVING.md "Control-plane transport").

    In-order messages apply immediately; out-of-order ones buffer inside a
    small reorder window; a gap that outlives the window (or the timeout)
    is a LOST publish — detected, not absorbed: ``prefix/publish_gap``
    fires and the router pulls a targeted full-digest resync from the
    replica.  ``expect = None`` means the stream is broken (gap declared,
    or the replica's lease expired) and every delivery is dropped until a
    resync snapshot re-anchors the sequence at its barrier."""
    expect: Optional[int] = 1          # next seq to apply; None = broken
    buffer: Dict[int, Tuple[str, int]] = dataclasses.field(default_factory=dict)
    gap_since: Optional[float] = None
    resync_since: Optional[float] = None   # outstanding resync request ts


class LifecycleCmdState(enum.Enum):
    """Router-side delivery state of ONE transported lifecycle command
    (docs/SERVING.md "Closed-loop control")."""
    PENDING = "pending"   # recorded; the first send has not left yet
    SENT = "sent"         # on the wire, awaiting the replica's ack
    ACKED = "acked"       # the replica reported an outcome (applied/rejected)
    ABORTED = "aborted"   # overtaken: the target's lease epoch advanced
    #                       mid-flight — retrying would carry a pre-fencing
    #                       decision into the post-fence world


#: validated lifecycle-command transitions (dslint state-machine table;
#: rendered into docs/STATE_MACHINES.md).  PENDING -> ABORTED covers a
#: command whose target's epoch advanced before its first send ever left
#: (an injected send fault kept it queued across the expiry).
_LIFECYCLE_ALLOWED = {
    LifecycleCmdState.PENDING: {LifecycleCmdState.SENT,
                                LifecycleCmdState.ABORTED},
    LifecycleCmdState.SENT: {LifecycleCmdState.ACKED,
                             LifecycleCmdState.ABORTED},
    LifecycleCmdState.ACKED: set(),
    LifecycleCmdState.ABORTED: set(),
}


@dataclasses.dataclass
class _LifecycleCmd:
    """One transported lifecycle command: typed op + monotone seq (the
    replica-side dedup key) + the target's lease epoch at dispatch (the
    fencing token — a zombie replica, or a command that outlived a lease
    expiry, can never act on or double-apply stale intent).  Delivery is
    stop-and-wait with ack/retry, the same discipline as fences and
    migration chunks."""
    seq: int
    rid: int
    op: str
    payload: dict
    epoch: int                      # lease epoch of rid when issued
    issued_ts: float
    state: LifecycleCmdState = LifecycleCmdState.PENDING
    sent_ts: Optional[float] = None
    status: Optional[str] = None    # the replica's ack outcome

    def to(self, state: LifecycleCmdState) -> None:
        if state not in _LIFECYCLE_ALLOWED[self.state]:
            raise ValueError(f"lifecycle cmd {self.seq}: illegal transition "
                             f"{self.state.value} -> {state.value}")
        self.state = state


class Router:
    """Cache-affinity, health-aware request router over a ReplicaPool."""

    def __init__(self, pool: ReplicaPool, policy: RoutingPolicy, monitor=None,
                 tracer=None, migration_chunk_pages: int = 4,
                 migration_chunk_cost: float = 0.0,
                 prefill_handoff: bool = False,
                 tenants: Optional[TenantRegistry] = None,
                 overload=None, prefix_import_cost: float = 0.0,
                 transport=None, lease_config: Optional[LeaseConfig] = None,
                 warmup_chains: int = 4, recorder=None, slo=None):
        self.pool = pool
        self.policy = policy
        self.monitor = monitor
        # fleet flight recorder (telemetry/flight_recorder.py): the
        # bounded always-on control-plane ring.  Attaching it here fans it
        # out to every producer — transport message spans, lease-state
        # intervals, overload-rung occupancy, autoscaler instants, and
        # (via the pool tracer's retention sink) the request phase spans —
        # and the router drives the crash-scoped dumps: replica death,
        # lease expiry, a completed fencing episode.  None = off, zero
        # overhead, byte-identical pre-r18 behavior.
        self.recorder = recorder
        if recorder is not None:
            # replica frontends record their side of control episodes
            # (ctrl/fence) directly — tracer or no tracer; pool.recorder
            # makes recover()/restart() replacements inherit it
            pool.recorder = recorder
            for rid in pool.rids:
                pool.replica(rid).serve.recorder = recorder
        if recorder is not None and transport is not None \
                and transport.recorder is None:
            transport.recorder = recorder
        # control-plane transport (docs/SERVING.md "Control-plane
        # transport"): with one attached, the router stops observing
        # replicas perfectly — health is heartbeat leases with fencing,
        # load_stats are last-known-good + age, prefix publishes are a
        # seq-numbered feed with gap-resync, migration chunks flow
        # ack/retry.  None (default) keeps every pre-r16 direct path.
        self.transport = transport
        if pool.transport is not transport:
            # BOTH directions are misconfigurations: a router-only
            # transport would read a fabric nobody heartbeats into, and a
            # pool-only one would send every heartbeat/publish into a
            # fabric nobody drains — silent 100% cold routing plus an
            # unboundedly growing in-flight queue, not an error anyone
            # would see
            raise ValueError(
                "the Router's ControlTransport must be the ReplicaPool's: "
                "pass the SAME transport= to both ReplicaPool(...) and "
                "Router(...) (or to neither) so replicas heartbeat and "
                "publish into the fabric the router reads")
        self.lease: Optional[FleetHealthView] = None
        #: fid -> assembling router-side migration snapshot
        #: {"next": chunk idx expected, "snap": KVSnapshot}
        self._mig_rx: Dict[int, dict] = {}
        #: rid -> [(fid, displaced ServingRequest)] at the last lease
        #: expiry — audited at fence time for late (fenced) completions
        self._lease_displaced: Dict[int, list] = {}
        self._dir_feeds: Dict[int, _DirFeed] = {}
        #: out-of-order publishes buffered before a gap is declared lost
        self.dir_reorder_window = 4
        #: clock time a seq gap may wait for the missing message before the
        #: router declares it lost and pulls a resync
        self.dir_gap_timeout = 2.0
        #: clock time before an unanswered resync request is re-sent
        self.dir_resync_retry = 4.0
        #: min clock time between retransmits of an unacked migration chunk
        self.mig_retry = 1.0
        #: min clock time between retransmits of an unacked lifecycle command
        self.lifecycle_retry = 1.0
        # transported lifecycle commands (docs/SERVING.md "Closed-loop
        # control"): with a transport attached, every control-plane
        # mutation of a replica — autoscaler recover/drain/park/restart,
        # role changes, migration completion — crosses the same lossy
        # fabric as everything else as a typed, seq-numbered, epoch-fenced
        # ``lifecycle_cmd`` with stop-and-wait ack/retry; without one,
        # ``lifecycle_command`` degenerates to the pre-r21 direct calls
        self._lifecycle_seq = itertools.count(1)
        #: cmd seq -> _LifecycleCmd (the full auditable command log)
        self._lifecycle: Dict[int, _LifecycleCmd] = {}
        #: hottest directory chains pre-imported onto a recovering replica
        self.warmup_chains = int(warmup_chains)
        if transport is not None:
            self.lease = FleetHealthView(
                pool.rids, config=lease_config, clock=pool.clock,
                emit=lambda name, value: self._emit(
                    [(name, value, self._next_event_step())]),
                recorder=recorder)
            self._dir_feeds = {rid: _DirFeed() for rid in pool.rids}
        # fleet prefix directory (docs/SERVING.md "Prefix directory"): a
        # directory-routing policy carries the directory it reads; the
        # POOL must carry the same one, or no replica would ever publish
        # into it and every dispatch would read an empty table — silent
        # 100% cold routing, not an error anyone would see
        self.directory = getattr(policy, "directory", None)
        if self.directory is not None \
                and pool.prefix_directory is not self.directory:
            raise ValueError(
                "the routing policy's PrefixDirectory must be the "
                "ReplicaPool's: pass prefix_directory= to ReplicaPool(...) "
                "so replicas publish their digests into the table the "
                "policy routes on (the pool re-wires it across "
                "recover()/restart() engine swaps)")
        # per-page clock charge of a hot-prefix import (d2h on the donor's
        # view + h2d on the target's, max-combined with their step costs —
        # overlapped staging, not a stall), mirroring migration_chunk_cost
        self.prefix_import_cost = float(prefix_import_cost)
        # multi-tenant QoS (docs/SERVING.md "Overload control plane"):
        # weighted-fair ordering + per-tenant outstanding bounds come from
        # the registry; with no registry every request rides the implicit
        # "default" tenant and ordering degenerates to the pre-tenancy
        # (priority, arrival, fid) FCFS — zero behavioral change
        self.tenants = tenants if tenants is not None else TenantRegistry()
        #: per-tenant terminal accounting, keyed by tenant name
        self.tenant_stats: Dict[str, dict] = {}
        # graceful-degradation ladder (fleet/autoscale.py): consulted at
        # admission (shed/cap) and dispatch (spec off, migration pause)
        self.overload = overload
        if overload is not None:
            overload.bind(lambda name, value: self._emit(
                [(name, value, self._next_event_step())]))
            if recorder is not None and overload.recorder is None:
                overload.recorder = recorder
        # SLO burn-rate monitor (telemetry/slo.py): observes every DONE
        # request's TTFT against its tenant's ttft_slo, ticked once per
        # fleet round from export_replica_gauges; None = off
        self.slo = slo
        if slo is not None:
            if slo.clock is None:
                slo.clock = pool.clock
            slo.bind(emit=lambda name, value: self._emit(
                [(name, value, self._next_event_step())]),
                metrics=pool.metrics, recorder=recorder)
        #: DONE-request TTFTs in completion order — the autoscaler's EWMA
        #: input (appended in _finish; never truncated mid-run)
        self.ttft_log: List[float] = []
        # prefill/decode disaggregation (docs/SERVING.md "Disaggregated
        # serving"): policies that declare ``migrates = True`` turn on the
        # two-phase dispatch — requests that reach DECODE on a PREFILL-role
        # replica are paused, their KV exported chunk-by-chunk (overlapping
        # the source's other work), and resumed on a decode replica via the
        # KV-import fast path.  ``migration_chunk_cost`` > 0 charges each
        # export chunk's d2h staging on the source replica's clock view
        # (max-combined with its step cost — the overlap, not a stall).
        self.migrate = bool(getattr(policy, "migrates", False))
        self.migration_chunk_pages = int(migration_chunk_pages)
        self.migration_chunk_cost = float(migration_chunk_cost)
        # prefill_handoff=True migrates at the LATE-PREFILL boundary too
        # (DistServe semantics: the decode replica runs the final chunk +
        # first-token sampling, so the staging pause lands in TTFT);
        # False (default) migrates only after the first decode token —
        # prompt processing finishes at full speed on the prefill replica
        self.prefill_handoff = bool(prefill_handoff)
        #: fid -> in-flight export record {"rid", "sr", "generation",
        #: "exporter", "started_ts"}
        self._migrations: Dict[int, dict] = {}
        # one trace per CLIENT request: the trace_id allocated at submit
        # propagates through every per-replica attempt and survives
        # failover (the resumed attempt links to the dead replica's span).
        # The tracer MUST be the pool's: a router-only tracer would emit
        # attempt spans whose phase children the (untraced) replica
        # frontends never produce — a half-instrumented trace that fails
        # trace_report's tiling invariant by construction.
        if tracer is not None and getattr(tracer, "enabled", True) \
                and tracer is not pool.tracer:
            # a DISABLED tracer (NULL_TRACER) is the documented way to say
            # "tracing off" and is equivalent to None, not a mismatch
            raise ValueError(
                "Router tracer must be the ReplicaPool's: pass tracer= to "
                "ReplicaPool(...) so the replica frontends emit the phase "
                "spans (the pool propagates it to every attached engine, "
                "including recover()/restart() replacements)")
        self.tracer = pool.tracer if pool.tracer is not None else NULL_TRACER
        if recorder is not None and self.tracer.enabled \
                and self.tracer.recorder is None:
            # retention sink: request/phase spans mirror into the bounded
            # ring as they finish, so a crash dump shows the recent
            # requests NEXT TO the control-plane timeline that hurt them
            self.tracer.recorder = recorder
        self.clock = pool.clock
        self._fids = itertools.count()
        self._pending: List[FleetRequest] = []
        self._dispatched: Dict[int, FleetRequest] = {}
        self.requests: List[FleetRequest] = []       # every request ever submitted
        self._t0 = self.clock.now()
        self._events_step = 0
        # failover bookkeeping: one record per replica death, closed when
        # every displaced request has been re-dispatched (or terminated)
        self.kill_records: List[dict] = []
        self.stats = {
            "submitted": 0, "dispatches": 0, "failovers": 0,
            "affinity_hits": 0, "affinity_misses": 0,
            "dispatch_faults": 0, "saturated_dispatches": 0,
            "migrations_started": 0, "migration_chunks": 0,
            "migrations_completed": 0, "migration_fallbacks": 0,
            "migration_failover_reuse": 0,
            "prefix_imports": 0, "prefix_import_pages": 0,
            "prefix_import_fallbacks": 0, "prefix_imports_paused": 0,
            "prefix_imports_noop": 0,
            "shed": 0, "brownout_capped": 0, "tenant_admission_faults": 0,
            "tenant_deferrals": 0,
            "lease_expirations": 0, "fenced_replicas": 0,
            "fenced_completions": 0, "fenced_requests": 0,
            "publish_gaps": 0, "dir_resyncs": 0,
            "warmup_imports": 0, "warmup_fallbacks": 0,
            "partition_dispatch_skips": 0,
            "kv_quota_rejects": 0,
            "lifecycle_cmds": 0, "lifecycle_applied": 0,
            "lifecycle_acked": 0, "lifecycle_stale_acks": 0,
            "lifecycle_aborted": 0, "lifecycle_send_faults": 0,
            "session_sticky_hits": 0, "session_failovers": 0,
            "session_parks": 0, "session_resumes": 0,
        }
        self.recovery_times: List[float] = []
        # arrival-rate telemetry (ROADMAP's predictive-scale-up input):
        # submissions counted at submit(), folded into a rate EWMA + its
        # derivative once per fleet round by export_replica_gauges —
        # deterministic under VirtualClock like every gauge here.  The
        # fold is TIME-constant based (alpha = 1 - exp(-dt/tau)), not
        # per-sample: round lengths vary, and in sparse traffic a single
        # arrival inside a short round reads as a huge instantaneous rate
        # — a fixed per-sample alpha would let that noise (times the
        # forecast horizon, via the slope) conjure phantom demand
        self.arrival_rate_tau = 2.5
        self._arrival_count = 0
        self._arr_last: Optional[Tuple[float, int, Optional[float],
                                       float]] = None
        #: (rate EWMA, slope) as of the last fold — kept unrounded; the
        #: gauges round at export, the predictive autoscaler reads it raw
        self._arr_rate: Tuple[float, float] = (0.0, 0.0)
        #: tenants that ever carried a kv/tenant_pages gauge — a tenant
        #: whose pages drop to zero must READ zero, not freeze its last
        #: non-zero sample forever
        self._kv_tenants_seen: set = set()

    # -------------------------------------------------------------- submit

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               deadline: Optional[float] = None, arrival_ts: Optional[float] = None,
               priority: float = 0.0, tenant: str = "default",
               session: Optional[object] = None) -> FleetRequest:
        now = self.clock.now() if arrival_ts is None else float(arrival_ts)
        self._arrival_count += 1   # demand signal: sheds/rejects included
        spec = self.tenants.spec(tenant)
        max_new_tokens = int(max_new_tokens)
        capped = False
        if self.overload is not None and self.overload.token_cap_active \
                and spec.best_effort:
            # brownout rung 1: best-effort output budgets shrink.  Greedy
            # decode makes the capped output an exact PREFIX of the uncapped
            # one, so degradation never changes a token, only truncates.
            cap = self.overload.config.token_cap
            if max_new_tokens > cap:
                max_new_tokens, capped = cap, True
        fr = FleetRequest(fid=next(self._fids), prompt=list(prompt),
                          max_new_tokens=max_new_tokens, arrival_ts=now,
                          deadline=deadline, priority=priority, tenant=tenant,
                          session_id=session)
        if self.tracer.enabled:
            # reserve the root span id now: attempt/phase children parent
            # to it long before the root's extent (terminal ts) is known
            fr.trace = {"trace_id": self.tracer.new_trace_id(),
                        "root_id": self.tracer.reserve_span_id(),
                        "attempts": [], "last_dead": None}
        self.requests.append(fr)
        self.stats["submitted"] += 1
        self._taccount(tenant)["submitted"] += 1
        try:
            # chaos site: per-tenant admission bookkeeping is a control-
            # plane edge of its own (quota lookups, accounting stores)
            _fi.check("admission.tenant")
        except _fi.InjectedCrash:
            raise  # simulated death of THIS driver process
        except OSError as e:
            # transient tenant-admission fault: the client sees a REJECTED
            # request with a reason and a retry-after hint, never a crash
            self.stats["tenant_admission_faults"] += 1
            fr.reject_reason = "tenant_admission_fault"
            fr.retry_after = self.overload.config.retry_after \
                if (self.overload is not None and self.overload.rung >= 1) \
                else TENANT_FAULT_RETRY_S
            logger.warning(f"admission.tenant transient fault for "
                           f"fid={fr.fid}: {e}")
            self._finish(fr, FleetState.REJECTED, now)
            return fr
        if self.overload is not None and self.overload.shed(spec):
            # brownout rung 4: best-effort admissions are shed outright —
            # an explicit REJECTED with a retry-after beats queueing work
            # the fleet cannot serve inside anyone's deadline
            self.stats["shed"] += 1
            self._taccount(tenant)["shed"] += 1
            self.overload.record_shed()
            fr.reject_reason = "shed_overload"
            fr.retry_after = self.overload.config.retry_after
            self._emit([("fleet/overload_shed", float(self.overload.rung),
                         self._next_event_step())])
            self._finish(fr, FleetState.REJECTED, now)
            return fr
        if spec.kv_page_quota > 0:
            # per-tenant KV quota (docs/SERVING.md "Closed-loop control"):
            # admission charges the request's PROJECTED page need against
            # the tenant's exactly-once fleet-wide tally — one tenant's
            # long-context burst cannot occupy every arena's pages.  A
            # rejection is transient (pages free as the tenant's own work
            # completes), so it carries a retry-after hint.
            need = self._kv_page_need(len(fr.prompt), max_new_tokens)
            if need is not None and \
                    self.tenant_kv_pages().get(tenant, 0) + need \
                    > spec.kv_page_quota:
                self.stats["kv_quota_rejects"] += 1
                fr.reject_reason = "kv_quota"
                fr.retry_after = KV_QUOTA_RETRY_S
                self._emit([("fleet/kv_quota_reject", float(need),
                             self._next_event_step())])
                self._finish(fr, FleetState.REJECTED, now)
                return fr
        if capped:
            # flagged/counted only for requests that will actually be
            # SERVED with the truncated budget — a shed/fault-rejected
            # request never ran and must not inflate the brownout receipt
            fr.brownout_capped = True
            self.stats["brownout_capped"] += 1
            self._taccount(tenant)["brownout_capped"] += 1
        if not self._pending and not self._dispatched:
            # fully idle fleet: no backlog to arbitrate — reset the stride
            # state so the next busy period starts fair for everyone
            self.tenants.reset_passes()
        # the WFQ virtual-time floor tracks ALL outstanding work, not just
        # the queue: under steady uncontended load the queue drains between
        # arrivals, and a pending-only floor (stuck at 0) would let passes
        # earned while nobody waited become permanent scheduling debt —
        # and let a newly-joining tenant jump ahead of every incumbent
        floor = min((r._wfq for r in self._pending), default=None)
        if floor is None:
            floor = min((r._wfq for r in self._dispatched.values()),
                        default=0.0)
        fr._wfq = self.tenants.next_pass(tenant, floor=floor)
        self._pending.append(fr)
        return fr

    def _kv_page_need(self, prompt_len: int, max_new_tokens: int) -> Optional[int]:
        """Projected KV page demand of one request at full generation —
        the admission-time charge against a tenant's ``kv_page_quota``.
        Reads the arena geometry off the first live engine (every replica
        shares it); None when no engine is attached to read from, in
        which case the quota cannot be metered and admission proceeds."""
        for rid in self.pool.rids:
            rep = self.pool.replica(rid)
            if rep.serve is not None:
                ps = rep.serve.engine.kv.page_size
                return -(-(prompt_len + max_new_tokens) // ps)
        return None

    def _taccount(self, tenant: str) -> dict:
        t = self.tenant_stats.get(tenant)
        if t is None:
            t = self.tenant_stats[tenant] = {
                "submitted": 0, "completed": 0, "deadline_met": 0,
                "timed_out": 0, "rejected": 0, "shed": 0,
                "brownout_capped": 0, "failovers": 0, "dispatches": 0,
                "tokens": 0}
        return t

    # ------------------------------------------------------------ dispatch

    def _candidates(self):
        if self.transport is not None:
            # partition-tolerant view: dispatchability comes from the
            # heartbeat LEASE (a replica the router cannot hear from takes
            # no new work), and the load snapshot is LAST-KNOWN-GOOD from
            # its newest heartbeat, annotated with its age — stale routing
            # signals place work suboptimally (slower), never wrongly
            out = []
            for rid in self.pool.rids:
                if not self.lease.dispatchable(rid):
                    continue
                rep = self.pool.replica(rid)
                if rep.serve is None:
                    continue
                stats, age = self.lease.stats(rid)
                if stats is None:
                    continue   # never heard from it: nothing to go on yet
                out.append((rid, rep, {**stats, "age": round(age, 9)}))
            return out
        out = []
        for rid in self.pool.rids:
            if not self.pool.health.dispatchable(rid):
                continue
            rep = self.pool.replica(rid)
            if rep.serve is None:
                continue
            out.append((rid, rep, rep.serve.load_stats()))
        return out

    def dispatch_pending(self, now: Optional[float] = None) -> int:
        """Try to place every pending request on a replica (FCFS by
        arrival).  Returns how many dispatched.  Saturation (per-replica
        ``queue_full`` rejection) leaves a request pending for the next
        round; a structural rejection (infeasible on this engine geometry —
        identical across replicas) is terminal."""
        now = self.clock.now() if now is None else now
        if self.migrate:
            # pre-charge each in-flight export's next chunk on its source's
            # clock view HERE — the dispatch phase runs before this round's
            # replica ticks advance the clock, so the staging cost lands
            # INSIDE the MIGRATING window (the phase span the telemetry
            # materializes per migrated request has real width) and is
            # max-combined with the source's own step cost: overlapped,
            # not serial.  The chunks themselves are pumped in poll().
            self._precharge_migrations()
        # priority class (lower = more urgent) first, then WEIGHTED-FAIR
        # order within the class (tenancy.py stride pass; single-tenant
        # fleets degenerate to pure FCFS), then FCFS tie-break — the fleet
        # queue must honor both the priority submit() accepts and the
        # tenant weights, or one heavy tenant's burst starves everyone
        # exactly when every replica is saturated; anti-starvation aging
        # applies per replica once dispatched
        self._pending.sort(key=lambda r: _tenant_order_key(
            r.priority, r._wfq, r.arrival_ts, r.fid))
        # expire FIRST, for every pending request — expiry must not depend
        # on dispatchable capacity existing (with all replicas dead, expired
        # work still has to reach TIMED_OUT or the driver would stall on a
        # deadline that already passed)
        for fr in list(self._pending):
            if fr.deadline is not None and now > fr.deadline:
                self._pending.remove(fr)
                self._finish(fr, FleetState.TIMED_OUT, now)
        placed = 0
        # one candidate snapshot per round, refreshed incrementally: a full
        # rebuild (load_stats on every replica) per pending request would be
        # O(pending x replicas) per round for state that only changes where
        # a request just landed (or a replica just died)
        candidates = self._candidates()
        # per-tenant concurrency bound: a tenant at max_outstanding keeps
        # its requests PENDING (deferred, not rejected) until completions
        # free slots — the cap is what stops one tenant's burst from
        # occupying every replica's batch at once
        outstanding_by_tenant: Dict[str, int] = {}
        for d in self._dispatched.values():
            outstanding_by_tenant[d.tenant] = \
                outstanding_by_tenant.get(d.tenant, 0) + 1
        for fr in list(self._pending):
            if not candidates:
                break
            tspec = self.tenants.spec(fr.tenant)
            if tspec.max_outstanding > 0 and \
                    outstanding_by_tenant.get(fr.tenant, 0) >= tspec.max_outstanding:
                self.stats["tenant_deferrals"] += 1
                continue
            rid, info = self.policy.select(fr, candidates)
            if rid is None:
                continue
            try:
                _fi.check("router.dispatch")
            except _fi.DeviceLossError as e:
                # the dispatch found its target's device gone — the fleet
                # treats that exactly like a scripted kill of that replica
                self.on_replica_dead(rid, now, reason=str(e))
                self.stats["dispatch_faults"] += 1
                candidates = self._candidates()
                continue   # fr stays pending
            except OSError as e:
                # transient dispatch-path failure (RPC hiccup): the request
                # stays pending and the next round retries
                self.stats["dispatch_faults"] += 1
                logger.warning(f"router.dispatch transient fault for fid={fr.fid}: {e}")
                continue
            if info.get("prefix_import") is not None:
                # cluster-wide warmth: adopt the hot prefix's KV onto the
                # cold target before the dispatch (docs/SERVING.md "Prefix
                # directory").  A replica death during staging is handled
                # like a dispatch-time device loss: refresh candidates,
                # and retry the request next round if its target died.
                if self._prefix_import(fr, rid, info, now) == "dead":
                    candidates = self._candidates()
                    if not any(c[0] == rid for c in candidates):
                        continue   # fr stays pending
            if self._dispatch_to(fr, rid, info, now):
                placed += 1
                outstanding_by_tenant[fr.tenant] = \
                    outstanding_by_tenant.get(fr.tenant, 0) + 1
                if self.transport is None:
                    candidates = [(r, rp, rp.serve.load_stats() if r == rid else st)
                                  for r, rp, st in candidates]
                else:
                    # no fresh probe exists under the transport: fold the
                    # router's OWN dispatch into its stale estimate (the
                    # one state change it knows about without a heartbeat)
                    candidates = [
                        (r, rp,
                         {**st, "queue_depth": st["queue_depth"] + 1,
                          "outstanding_tokens": st["outstanding_tokens"]
                          + max(0, fr.max_new_tokens - len(fr.tokens))}
                         if r == rid else st)
                        for r, rp, st in candidates]
        return placed

    def _dispatch_to(self, fr: FleetRequest, rid: int, info: dict, now: float) -> bool:
        rep = self.pool.replica(rid)
        if len(fr.tokens) >= fr.max_new_tokens:
            # a victim displaced with its output already complete (killed in
            # the same tick it finished): nothing to resume — close it out
            self._pending.remove(fr)
            fr.finish_ts = fr.finish_ts if fr.finish_ts is not None else now
            self._finish(fr, FleetState.DONE, now)
            return False
        if self.transport is not None and \
                not self.transport.connected("router", rid, now):
            # the dispatch RPC vanished into a partition the lease has not
            # yet diagnosed: to the router it is a timeout — the request
            # stays pending and the replica goes SUSPECT before this can
            # loop for long (the same shape as a transient dispatch fault)
            self.stats["partition_dispatch_skips"] += 1
            self.stats["dispatch_faults"] += 1
            return False
        att = None
        if fr.trace is not None:
            # the attempt span id is reserved BEFORE submit so the replica
            # frontend can parent this attempt's phase spans to it; the
            # span itself is materialized when the attempt ends
            att = {"rid": rid, "span_id": self.tracer.reserve_span_id(),
                   "dispatch_ts": now, "generation": rep.generation,
                   "resumed_from": fr.trace["last_dead"],
                   "resume_tokens": len(fr.tokens), "end_ts": None}
        # brownout rung 2: speculative decoding off for NEW dispatches —
        # verify dispatches are k+1-wide model work the overloaded fleet
        # can spend on plain decode instead; greedy parity means outputs
        # do not change, only the speed strategy does
        spec_flag = False if (self.overload is not None
                              and self.overload.spec_disabled) else None
        sr = rep.serve.submit(
            fr.prompt, max_new_tokens=fr.max_new_tokens, deadline=fr.deadline,
            arrival_ts=fr.arrival_ts, priority=fr.priority,
            # under the transport, token deliveries are observed by POLL
            # re-sync (sequence = len(tokens)) instead of push callbacks —
            # a stream delivered into a partition would either vanish or
            # double; the re-sync is idempotent by construction
            stream=None if self.transport is not None
            else self._make_stream(fr, rep.generation),
            resume_tokens=list(fr.tokens) or None,
            trace_id=fr.trace["trace_id"] if fr.trace is not None else None,
            parent_span_id=att["span_id"] if att is not None else None,
            spec=spec_flag,
            kv_snapshot=fr._kv_snapshot)
        if sr.state is RequestState.REJECTED:
            if sr.reject_reason == "queue_full":
                self.stats["saturated_dispatches"] += 1
                return False            # transient: stays pending (the
                # snapshot, if any, stays on fr for the retry)
            self._pending.remove(fr)
            fr.reject_reason = sr.reject_reason
            if att is not None:
                fr.trace["attempts"].append(att)
                self._close_attempt(fr, "rejected", now)
            self._finish(fr, FleetState.REJECTED, now)
            return False
        self._pending.remove(fr)
        # the ServingRequest owns the snapshot now (consumed — or rejected
        # into the recompute fallback — at its admission on the replica)
        fr._kv_snapshot = None
        if att is not None:
            fr.trace["attempts"].append(att)
            fr.trace["last_dead"] = None
        fr._current = (rid, sr, rep.generation)
        fr.dispatches.append((rid, now))
        fr.to(FleetState.DISPATCHED, now)
        self._dispatched[fr.fid] = fr
        self.stats["dispatches"] += 1
        self._taccount(fr.tenant)["dispatches"] += 1
        if "affinity_hit" in info:
            key = "affinity_hits" if info["affinity_hit"] else "affinity_misses"
            self.stats[key] += 1
            if info["affinity_hit"]:
                fr.affinity_hits += 1
        if info.get("session_sticky"):
            self.stats["session_sticky_hits"] += 1
        if info.get("session_failover"):
            # the session's sticky replica was gone/saturated and the turn
            # re-homed — distinct from fr.failovers (mid-attempt displacement)
            self.stats["session_failovers"] += 1
        self._emit([("fleet/dispatch", float(rid), self._next_event_step())])
        return True

    # -------------------------------------------------------- prefix import

    def _prefix_import(self, fr: FleetRequest, rid: int, info: dict,
                       now: float) -> str:
        """Hot-prefix KV import ahead of a cold dispatch: export the
        directory-promised prefix pages once from the warmest donor
        (host-staged, crc-tagged — the PR-8 ``kvtransfer`` path) and adopt
        them into ``rid``'s prefix cache, so the request prefills warm on
        the replica load balancing picked.  Returns ``"ok"``,
        ``"fallback"`` (any ordinary rejection: the dispatch proceeds cold
        and the prefill recomputes — slower, never wrong) or ``"dead"`` (a
        replica died mid-staging; the caller refreshes its candidates).
        The fleet-level accounting lands on ``stats["prefix_*"]`` and the
        ``fleet/prefix_import[_fallback]`` events."""
        from ..kvtransfer import SnapshotError, export_prefix
        from ...resilience.fault_injection import DeviceLossError
        plan = info.pop("prefix_import")
        if self.overload is not None and self.overload.migrations_paused:
            # brownout rung 3 shares one switch with migration: no NEW
            # staging under overload — the h2d/d2h bandwidth (and the
            # target's pages) go to serving (docs/SERVING.md ladder table)
            self.stats["prefix_imports_paused"] += 1
            return "fallback"
        donor_rid = plan["donor"]
        donor = self.pool.replica(donor_rid)
        target = self.pool.replica(rid)
        if donor.serve is None or target.serve is None:
            return self._prefix_import_fallback(fr, "replica gone before staging")
        tspec = self.tenants.spec(fr.tenant)
        if tspec.kv_page_quota > 0 and \
                self.tenant_kv_pages().get(fr.tenant, 0) \
                + plan["donor_depth"] > tspec.kv_page_quota:
            # the import charges the IMPORTING tenant's quota: adopting
            # remote pages it has no budget for would launder arena
            # occupancy through the prefix cache.  Checked BEFORE the d2h
            # export against the directory's promised depth, so a
            # quota-bound tenant costs no staging bandwidth — the dispatch
            # proceeds cold instead (slower, never wrong).
            self.stats["kv_quota_rejects"] += 1
            self._emit([("fleet/kv_quota_reject", float(plan["donor_depth"]),
                         self._next_event_step())])
            return self._prefix_import_fallback(
                fr, f"tenant {fr.tenant!r} kv quota "
                f"({tspec.kv_page_quota} pages)")
        tokens = list(fr.prompt) + list(fr.tokens)
        try:
            snapshot = export_prefix(donor.serve.engine, tokens,
                                     source=f"replica{donor_rid}")
        except _fi.InjectedCrash:
            raise  # simulated death of THIS driver process
        except DeviceLossError as e:
            # the d2h staging found the DONOR device gone: replica death,
            # ordinary failover path; the target is untouched
            self.on_replica_dead(donor_rid, now, reason=str(e))
            self._prefix_import_fallback(fr, f"donor died mid-export: {e}")
            return "dead"
        except (SnapshotError, OSError) as e:
            return self._prefix_import_fallback(fr, f"export fault: {e}")
        if snapshot is None:
            # evict-after-publish staleness: the donor no longer holds what
            # it published — recompute owns the request (the retraction
            # that should have fixed the directory was lost or raced)
            return self._prefix_import_fallback(fr, "donor cold (stale directory)")
        try:
            n_imported = target.serve.import_prefix(snapshot)
        except _fi.InjectedCrash:
            raise
        except DeviceLossError as e:
            # the h2d scatter found the TARGET device gone — the caller
            # must re-pick a replica for this request
            self.on_replica_dead(rid, now, reason=str(e))
            self._prefix_import_fallback(fr, f"target died mid-import: {e}")
            return "dead"
        except (SnapshotError, OSError) as e:
            # torn staging (crc verify), geometry drift, no page room, a
            # transient import fault: cold dispatch + recompute
            return self._prefix_import_fallback(fr, f"import rejected: {e}")
        if n_imported == 0:
            # directory stale-COLD about the TARGET (a dropped publish):
            # it already held the whole chain, nothing was installed — the
            # request lands warm, but no import is counted or charged
            self.stats["prefix_imports_noop"] += 1
            info["affinity_hit"] = True
            info["warm_pages"] = snapshot.n_pages
            return "ok"
        if self.prefix_import_cost > 0:
            # charge the staging on both clock views, max-combined with
            # each side's own step cost (overlap, not a stall) — the same
            # accounting stance as migration chunk pre-charges.  The donor
            # staged the WHOLE snapshot d2h; the target scattered only the
            # pages it was missing.
            donor.clock.on_step(self.prefix_import_cost * snapshot.n_pages)
            target.clock.on_step(self.prefix_import_cost * n_imported)
        self.stats["prefix_imports"] += 1
        self.stats["prefix_import_pages"] += n_imported
        # the request now LANDS warm: the hit label reports where it landed
        info["affinity_hit"] = True
        info["warm_pages"] = snapshot.n_pages
        info["prefix_imported"] = True
        # (the per-replica "prefix/import" counter is incremented by the
        # target frontend's import_prefix — one registry, counted once)
        self._emit([("fleet/prefix_import", float(rid),
                     self._next_event_step())])
        return "ok"

    def _prefix_import_fallback(self, fr: FleetRequest, reason: str) -> str:
        self.stats["prefix_import_fallbacks"] += 1
        logger.warning(f"fleet: prefix import for fid={fr.fid} fell back "
                       f"({reason})")
        if self.pool.metrics is not None:
            self.pool.metrics.counter("prefix/import_fallback").inc()
        self._emit([("fleet/prefix_import_fallback", 1.0,
                     self._next_event_step())])
        return "fallback"

    def _make_stream(self, fr: FleetRequest, generation: int):
        def on_tokens(sr: ServingRequest, toks: List[int], ts: float) -> None:
            cur = fr._current
            if cur is None or cur[1] is not sr or cur[2] != generation:
                return  # stale attempt (replica since failed over) — drop
            if fr.first_token_ts is None and toks:
                fr.first_token_ts = ts
            fr.tokens.extend(toks)
        return on_tokens

    # ----------------------------------------------------- session parking

    def _current_attempt(self, fr: FleetRequest):
        """``(replica, sr)`` when ``fr``'s current attempt is live on a
        healthy replica of the generation it was dispatched to; None when
        the request has no attempt (pending/terminal) or the replica died
        or restarted since — callers degrade gracefully (a park that can't
        happen just means the stall holds its device pages; a resume that
        can't happen means failover already re-queued the request)."""
        cur = fr._current
        if cur is None:
            return None
        rid, sr, gen = cur
        rep = self.pool.replica(rid)
        if rep.serve is None or rep.generation != gen:
            return None
        return rep, sr

    def request_decoding(self, fr: FleetRequest) -> bool:
        """True when ``fr``'s current attempt is actively DECODING on a
        live replica — the only window :meth:`park_request` can use.  A
        session coordinator polls this after a failover re-dispatch to
        re-park a request whose tool stall the death interrupted."""
        live = self._current_attempt(fr)
        return live is not None and live[1].state is RequestState.DECODE

    def park_request(self, fr: FleetRequest, phase: str = "tool_stall") -> bool:
        """Park ``fr``'s in-flight attempt through its replica's host KV
        tier (serving/sessions tool stall): partial generation demoted
        host-side, device pages freed, the fleet request stays DISPATCHED
        (the attempt is PARKED, not displaced).  False when the attempt
        isn't in a parkable window — the stall then simply rides out
        on-device, slower for neighbors but never wrong."""
        live = self._current_attempt(fr)
        if live is None:
            return False
        rep, sr = live
        if not rep.serve.park(sr.uid, phase=phase):
            return False
        self.stats["session_parks"] += 1
        self._emit([("fleet/session_park", 1.0, self._next_event_step())])
        return True

    def prefetch_resume_request(self, fr: FleetRequest) -> bool:
        """Prefetch hint for a parked attempt's h2d promotion (the session
        coordinator calls this ``prefetch_lead_s`` ahead of the tool
        result's ETA, so the transfer hides under intervening steps)."""
        live = self._current_attempt(fr)
        if live is None:
            return False
        rep, sr = live
        return rep.serve.prefetch_resume(sr.uid)

    def resume_request(self, fr: FleetRequest) -> bool:
        """Resume ``fr``'s parked attempt in place (tool result arrived):
        re-enqueued on the SAME replica, admission promotes the staged KV
        back (or recomputes on any host-tier miss).  False when the
        attempt is gone — replica death displaced it and the normal
        failover path owns it now."""
        live = self._current_attempt(fr)
        if live is None:
            return False
        rep, sr = live
        if sr.state is not RequestState.PARKED:
            return False
        if not rep.serve.resume(sr.uid):
            return False
        self.stats["session_resumes"] += 1
        self._emit([("fleet/session_resume", 1.0, self._next_event_step())])
        return True

    # ---------------------------------------------------------------- poll

    def poll(self, now: Optional[float] = None) -> None:
        """Fold per-replica terminal states up into fleet terminal states.
        Under a migrating policy this is also the migration pump: one
        export chunk per in-flight migration per round, completions handed
        off to a decode replica."""
        now = self.clock.now() if now is None else now
        if self.migrate:
            # pump BEFORE starting new exports: a fresh export's first
            # chunk waits for the next poll, after its pre-charged staging
            # cost has landed on the clock — so even a single-chunk
            # migration's MIGRATING window spans a real clock advance
            self._pump_migrations(now)
            self._start_migrations(now)
        for fr in list(self._dispatched.values()):
            rid, sr, _gen = fr._current
            if self.transport is not None:
                if not self.transport.connected(rid, "router", now):
                    # partitioned: the router cannot observe this attempt —
                    # its tokens and terminal state wait for the heal (or
                    # for the lease to expire and re-home the request)
                    continue
                self._sync_tokens(fr, sr, now)
            if sr.state is RequestState.DONE:  # dslint-ok(state-machine): poll folds only replica-TERMINAL outcomes; every other state means the attempt is still live and stays dispatched (MIGRATED/EVICTED are resolved by the migration pump and the replica's own requeue)
                del self._dispatched[fr.fid]
                fr._current = None
                fr.finish_ts = sr.finish_ts if sr.finish_ts is not None else now
                self._close_attempt(fr, "done", fr.finish_ts)
                self._finish(fr, FleetState.DONE, now)
            elif sr.state is RequestState.TIMED_OUT:
                del self._dispatched[fr.fid]
                fr._current = None
                # close at the REPLICA-side timeout instant, not poll-time
                # now (the shared clock advanced by a round in between):
                # the root span must end where the phase spans do or the
                # trace_report tiling invariant breaks by one round
                t_out = sr.history[-1][1]
                self._close_attempt(fr, "timed_out", t_out)
                self._finish(fr, FleetState.TIMED_OUT, t_out)

    # ------------------------------------------------------- control plane

    def _sync_tokens(self, fr: FleetRequest, sr: ServingRequest,
                     now: float) -> None:
        """Sequence-numbered token sync: ``sr.tokens`` always EXTENDS the
        resume seed the router dispatched with, so ``len(tokens)`` is the
        stream's sequence number and catch-up after a healed partition is
        one idempotent list copy — no delivery can be lost or applied
        twice.  First-token time is the router's OBSERVATION instant (the
        client cannot see a token before the router does)."""
        toks = sr.tokens
        have = len(fr.tokens)
        if len(toks) > have:
            if fr.first_token_ts is None:
                fr.first_token_ts = now
            # append only the unseen suffix: a full-list rebuild per poll
            # round would be O(T^2) over a T-token generation
            fr.tokens.extend(int(t) for t in toks[have:])

    def transport_poll(self, now: Optional[float] = None) -> None:
        """One control-plane round: drain due message deliveries, sweep the
        heartbeat leases (expiry re-homes work and bumps fencing epochs),
        (re)send unacked fences, and fire gap-timeout directory resyncs.
        The fleet driver calls this once per round, before dispatch; no-op
        without a transport."""
        if self.transport is None:
            return
        now = self.clock.now() if now is None else now
        for msg in self.transport.deliver(now):
            self._on_message(msg, now)
        # generation fencing: a replica that died and came back INSIDE its
        # lease window renews the lease, but its heartbeat's bumped engine
        # generation betrays the restart — attempts dispatched to the old
        # generation died with it and must re-home now, not at an expiry
        # that will never come
        for fr in list(self._dispatched.values()):
            if fr._current is None:
                continue
            rid, _sr, gen = fr._current
            g = self.lease.generation(rid)
            if g is not None and g > gen:
                self._requeue_attempt(fr, now, "replica_restarted")
                self._emit([("fleet/failover_requeued", 1.0,
                             self._next_event_step())])
        if self.lease.config.adaptive:
            # feed the adaptive-lease loop its link-quality inputs before
            # the expiry sweep, so a lossy fabric widens the band BEFORE
            # it can false-fence (docs/SERVING.md "Closed-loop control")
            for rid in self.pool.rids:
                feed = self._dir_feeds.get(rid)
                age = 0.0 if feed is None or feed.gap_since is None \
                    else max(0.0, now - feed.gap_since)
                self.lease.note_link_quality(
                    rid, self.transport.link_loss_ewma("router", rid),
                    age, now)
        for rid in self.lease.tick(now):
            self.on_lease_expired(rid, now)
        for rid in self.lease.fence_pending(now):
            self._send_fence(rid, now)
        self._sweep_lifecycle(now)
        for rid, feed in self._dir_feeds.items():
            self._check_dir_feed(rid, feed, now)

    def _on_message(self, msg, now: float) -> None:
        """Route one delivered message to its handler.  ``dst == "router"``
        is the router's inbox; an integer dst is a replica's (the replicas
        are in-process, so their inbox handling lives here too)."""
        kind, p = msg.kind, msg.payload
        if msg.dst == "router":
            if kind == "heartbeat":
                # a "zombie" verdict flips the view to FENCING; the fence
                # itself goes out in this same transport_poll round via the
                # fence_pending sweep (and retries on its timer)
                self.lease.observe_heartbeat(
                    msg.src, msg.seq, p["state"], p["stats"], msg.send_ts, now,
                    generation=p.get("generation"))
            elif kind == "dir_publish":
                self._on_dir_publish(msg.src, msg.seq, p, now)
            elif kind == "dir_resync":
                self._on_dir_resync(msg.src, p, now)
            elif kind == "fence_ack":
                self._on_fence_ack(msg.src, p, now)
            elif kind == "mig_chunk":
                self._on_mig_chunk(msg.src, p, now)
            elif kind == "lifecycle_ack":
                self._on_lifecycle_ack(msg.src, p, now)
            return
        rid = msg.dst
        if kind == "fence":
            # replica-side fence execution: cancel ALL in-flight work (every
            # dispatch on this replica predates the epoch bump) and ack.
            # Idempotent per epoch — a duplicated/late fence copy delivered
            # after the rejoin must NOT cancel re-dispatched work.
            counts = self.pool.fence_replica(rid, epoch=p["epoch"])
            n = counts["queued"] + counts["active"]
            if n:
                self.stats["fenced_requests"] += n
                self._emit([("fleet/fenced_request", float(n),
                             self._next_event_step())])
            self.transport.send("fence_ack", rid, "router",
                                {"epoch": p["epoch"], **counts})
        elif kind == "dir_resync_req":
            snap = self.pool.dir_snapshot(rid)
            if snap is not None:   # dead replicas answer nothing; retry finds
                self.transport.send("dir_resync", rid, "router", snap)
        elif kind == "mig_ack":
            m = self._migrations.get(p["fid"])
            if m is not None and m["rid"] == rid:
                ch = m["chan"]
                if p["next"] > ch["base"]:
                    ch["base"] = p["next"]
                    ch["sent_idx"], ch["sent_ts"] = None, None
        elif kind == "lifecycle_cmd":
            self._apply_lifecycle(rid, p, now)

    # -------------------------------------------------- lease expiry + fence

    def on_lease_expired(self, rid: int, now: float) -> None:
        """Fleet-declared death of ``rid``: the router has not heard a
        heartbeat for a full lease window.  Unlike :meth:`on_replica_dead`
        this does NOT touch the replica's engine — the replica may be a
        perfectly healthy zombie on the far side of a partition.  Its
        in-flight fleet requests are re-homed (tokens preserved up to the
        last connected sync; recompute-on-resume keeps outputs
        byte-identical), its dispatch epoch was bumped by the lease sweep
        (fencing every outstanding attempt), and its directory entries and
        publish feed are invalidated pending a post-rejoin resync."""
        self.stats["lease_expirations"] += 1
        displaced = []
        victims = []
        for fr in list(self._dispatched.values()):
            if fr._current is None or fr._current[0] != rid:
                continue
            sr = self._requeue_attempt(fr, now, "lease_expired")
            displaced.append((fr.fid, sr))
            victims.append(fr)
        #: audited when the fence completes: any of these that reached DONE
        #: on the zombie is a LATE COMPLETION the fencing discarded
        self._lease_displaced[rid] = displaced
        # surviving export records anchored on the lease-dead source are
        # unpumpable (and its chunks unackable) — drop them
        for fid in [f for f, m in self._migrations.items() if m["rid"] == rid]:
            self._migrations.pop(fid)
            self._mig_rx.pop(fid, None)
        if self.directory is not None:
            self.directory.purge(rid)
        feed = self._dir_feeds.get(rid)
        if feed is not None:
            feed.expect = None
            feed.buffer.clear()
            feed.gap_since = feed.resync_since = None
        record = {"rid": rid, "ts": now, "reason": "lease expired",
                  "victims": {fr.fid for fr in victims},
                  "n_victims": len(victims), "recovered_ts": None}
        if not victims:
            record["recovered_ts"] = now
            self.recovery_times.append(0.0)
        self.kill_records.append(record)
        self._emit([("fleet/failover_requeued", float(len(victims)),
                     self._next_event_step())])
        self._recorder_dump("lease_expired", now)

    def _requeue_attempt(self, fr: FleetRequest, now: float,
                         outcome: str) -> ServingRequest:
        """Displace one DISPATCHED attempt back to PENDING (lease expiry or
        an in-lease restart): tokens preserved up to the last connected
        sync, a COMPLETE router-side migration snapshot harvested for the
        KV-import fast path, the attempt span closed with the replica-side
        phase history folded and its open tail attributed to
        ``phase/fenced`` — on BOTH outcomes: an expired lease's work is
        discarded by the fence proper, and an in-lease restart's old-
        generation work is discarded by the epoch/generation fencing
        (transport_poll) — so transport-mode traces still tile
        [arrival, terminal] (scripts/trace_report.py).  Returns the
        displaced ServingRequest for the fencing audit."""
        del self._dispatched[fr.fid]
        rid, sr, gen = fr._current
        fr._current = None
        if fr.trace is not None:
            # the zombie frontend must not ALSO emit this attempt's phase
            # spans at its own (fenced, discarded) terminal — the tracer
            # is fleet-shared state, exactly like the request record the
            # fence audit reads, so dropping the ctx is bookkeeping on
            # this side of the partition, not a message through it.
            # Generation-gated: after an in-lease restart the frontend is
            # a NEW engine whose uids restart at 0 — a blind drop by uid
            # could discard a live new-generation request's trace ctx
            # (the old frontend died with the old generation; there is
            # nothing to drop there)
            rep = self.pool.replica(rid)
            if rep.serve is not None and rep.generation == gen:
                rep.serve.drop_trace(sr.uid)
        self._migrations.pop(fr.fid, None)
        rx = self._mig_rx.pop(fr.fid, None)
        if rx is not None and rx["snap"].complete and fr._kv_snapshot is None:
            fr._kv_snapshot = rx["snap"]
            self.stats["migration_failover_reuse"] += 1
        fr.failovers += 1
        self._taccount(fr.tenant)["failovers"] += 1
        fr.to(FleetState.PENDING, now)
        self._close_attempt(fr, outcome, now, displaced_sr=sr,
                            tail_phase="fenced")
        if fr.trace is not None and fr.trace["attempts"]:
            fr.trace["last_dead"] = fr.trace["attempts"][-1]["span_id"]
        self._pending.append(fr)
        self.stats["failovers"] += 1
        return sr

    def _send_fence(self, rid: int, now: float) -> None:
        epoch = self.lease.epoch[rid]
        first = self.lease.note_fence_sent(rid, now)
        if first:
            self.stats["fenced_replicas"] += 1
            self._emit([("fleet/fenced_replica", float(rid),
                         self._next_event_step())])
        else:
            self.transport.note_retransmit()
        self.transport.send("fence", "router", rid, {"epoch": epoch})

    def _on_fence_ack(self, rid: int, p: dict, now: float) -> None:
        if not self.lease.on_fence_ack(rid, p["epoch"], now):
            return   # stale/duplicate ack from an earlier episode
        # the late-completion audit: displaced attempts that reached DONE
        # on the zombie are exactly the completions fencing discarded —
        # each is an auditable event, never a second serve
        late = [fid for fid, sr in self._lease_displaced.pop(rid, [])
                if sr.state is RequestState.DONE]
        if late:
            self.stats["fenced_completions"] += len(late)
            self._emit([("fleet/fenced_completion", float(len(late)),
                         self._next_event_step())])
            logger.warning(f"fleet: discarded {len(late)} fenced late "
                           f"completion(s) from replica {rid}: fids {late}")
        # the zombie's cache may still be warm, but the router purged its
        # entries at expiry: pull a fresh full-digest snapshot
        self._request_dir_resync(rid, now)
        # the fencing episode is complete (zombie cancelled + re-admitted):
        # dump the black box while the whole story is still in the ring
        self._recorder_dump("fence", now)

    # ---------------------------------------------- lifecycle command plane

    def lifecycle_command(self, rid: int, op: str,
                          payload: Optional[dict] = None,
                          now: Optional[float] = None) -> Optional[int]:
        """Issue one lifecycle mutation against replica ``rid`` — the
        single entry point the autoscaler (and the migration pump) drives
        replica state through (docs/SERVING.md "Closed-loop control").

        Without a transport this IS the pre-r21 direct call, synchronous
        and unlosable.  With one, the mutation becomes a typed
        ``lifecycle_cmd`` message: seq-numbered (the replica's dedup key),
        stamped with the target's CURRENT lease epoch (the fencing token),
        re-sent stop-and-wait until acked.  An identical (rid, op) command
        already in flight is not duplicated — the retry timer owns it.
        Returns the command seq under a transport, else None."""
        now = self.clock.now() if now is None else now
        payload = dict(payload or {})
        if self.transport is None:
            self._lifecycle_direct(rid, op, payload)
            return None
        for cmd in self._lifecycle.values():
            if cmd.rid == rid and cmd.op == op and \
                    cmd.state in (LifecycleCmdState.PENDING,
                                  LifecycleCmdState.SENT):
                return cmd.seq   # already in flight: idempotent issue
        seq = next(self._lifecycle_seq)
        cmd = _LifecycleCmd(seq=seq, rid=rid, op=op, payload=payload,
                            epoch=self.lease.epoch[rid], issued_ts=now)
        self._lifecycle[seq] = cmd
        self.stats["lifecycle_cmds"] += 1
        self._emit([("fleet/lifecycle_cmd", float(rid),
                     self._next_event_step())])
        if self.recorder is not None:
            self.recorder.instant("ctrl/lifecycle", "ctrl/autoscale", now,
                                  attrs={"rid": rid, "op": op, "seq": seq,
                                         "epoch": cmd.epoch})
        self._send_lifecycle(cmd, now)
        return seq

    def _lifecycle_direct(self, rid: int, op: str, payload: dict) -> None:
        """The transportless path: exactly the synchronous calls the
        autoscaler made before lifecycle traffic was transported —
        byte-identical behavior with ``transport=None``."""
        if op == "recover":
            self.pool.recover(rid)
            self.warmup_replica(rid)
        elif op == "drain":
            self.pool.drain(rid)
        elif op == "park":
            victims = self.pool.kill(
                rid, reason=payload.get("reason", "parked (lifecycle)"))
            assert not victims, \
                f"lifecycle park of replica {rid} displaced in-flight " \
                f"work: {victims}"
        elif op == "restart":
            self.pool.restart(rid)
            self.warmup_replica(rid)
        elif op == "role_change":
            self.pool.set_role(rid, payload["role"])
            self.pool.restart(rid)
            self.warmup_replica(rid)
            self._emit([("fleet/role_change", float(rid),
                         self._next_event_step())])
        else:
            raise ValueError(f"unknown lifecycle op {op!r}")

    def _send_lifecycle(self, cmd: _LifecycleCmd, now: float) -> None:
        """(Re)send one command over the fabric.  A transient send-path
        fault leaves the record PENDING for the retry sweep; the fabric
        eating the message (loss/partition) is indistinguishable from a
        lost ack and the same timer recovers both."""
        try:
            # chaos site: the router's lifecycle send edge
            _fi.check("lifecycle.cmd.send")
        except _fi.InjectedCrash:
            raise  # simulated death of THIS driver process
        except OSError as e:
            self.stats["lifecycle_send_faults"] += 1
            logger.warning(f"lifecycle.cmd.send transient fault for "
                           f"seq={cmd.seq} ({cmd.op} -> replica "
                           f"{cmd.rid}): {e}")
            return
        if cmd.state is LifecycleCmdState.PENDING:
            cmd.to(LifecycleCmdState.SENT)
        else:
            self.transport.note_retransmit()
        cmd.sent_ts = now
        self.transport.send("lifecycle_cmd", "router", cmd.rid,
                            {"seq": cmd.seq, "op": cmd.op,
                             "epoch": cmd.epoch, "payload": cmd.payload},
                            seq=cmd.seq)

    def _sweep_lifecycle(self, now: float) -> None:
        """One retry round: abort commands whose target's epoch advanced
        mid-flight (stale intent must not be retried into the post-fence
        world), then (re)send everything unacked whose timer is due."""
        for seq in sorted(self._lifecycle):
            cmd = self._lifecycle[seq]
            if cmd.state not in (LifecycleCmdState.PENDING,
                                 LifecycleCmdState.SENT):
                continue
            if self.lease.epoch[cmd.rid] > cmd.epoch:
                cmd.to(LifecycleCmdState.ABORTED)
                self.stats["lifecycle_aborted"] += 1
                logger.warning(f"lifecycle cmd {seq} ({cmd.op} -> replica "
                               f"{cmd.rid}) aborted: epoch advanced "
                               f"{cmd.epoch} -> {self.lease.epoch[cmd.rid]}")
                continue
            if cmd.state is LifecycleCmdState.SENT and \
                    cmd.sent_ts is not None and \
                    now - cmd.sent_ts < self.lifecycle_retry:
                continue   # in flight, not yet timed out
            self._send_lifecycle(cmd, now)

    def _apply_lifecycle(self, rid: int, p: dict, now: float) -> None:
        """Replica-side command application: exactly-once effects under
        at-least-once delivery.  The pool-level seq ledger (it survives
        engine swaps, like the fencing epoch) re-acks the recorded outcome
        for duplicated/retried copies without re-applying; a command
        stamped with a pre-fencing epoch is rejected (``stale_epoch``) —
        a partitioned router's zombie command can never mutate a replica
        that was fenced after the command was issued."""
        seq, op = p["seq"], p["op"]
        seen = self.pool.lifecycle_seen(rid)
        status = seen.get(seq)
        if status is None:
            try:
                # chaos site: the replica's lifecycle apply edge
                _fi.check("lifecycle.cmd.apply")
            except _fi.InjectedCrash:
                raise  # simulated death of THIS driver process
            except OSError as e:
                # transient apply fault: nothing changed, nothing acked —
                # the router's retry timer re-delivers
                logger.warning(f"lifecycle.cmd.apply transient fault on "
                               f"replica {rid} (seq={seq} {op}): {e}")
                return
            if p["epoch"] < self.pool.fenced_epoch(rid):
                status = "stale_epoch"
                logger.warning(f"replica {rid}: rejected lifecycle cmd "
                               f"{seq} ({op}) from epoch {p['epoch']} "
                               f"(fenced at {self.pool.fenced_epoch(rid)})")
            else:
                status = self._lifecycle_apply_op(rid, op,
                                                  p.get("payload") or {})
            seen[seq] = status
            if status == "applied":
                self.stats["lifecycle_applied"] += 1
        self.transport.send("lifecycle_ack", rid, "router",
                            {"seq": seq, "op": op, "epoch": p["epoch"],
                             "status": status}, seq=seq)

    def _lifecycle_apply_op(self, rid: int, op: str, payload: dict) -> str:
        """Execute one op against the replica-LOCAL truth, state-guarded:
        a late or duplicated command the replica's state no longer fits is
        REJECTED with an auditable status instead of tripping the pool's
        transition asserts (e.g. a retried recover landing after the
        replica already recovered and died again)."""
        health = self.pool.health.state(rid)
        if op == "recover":
            if health is not ReplicaState.DEAD:
                return f"rejected:{health.value}"
            self.pool.recover(rid)
            return "applied"
        if op == "drain":
            if health not in (ReplicaState.HEALTHY, ReplicaState.DEGRADED):
                return f"rejected:{health.value}"
            self.pool.drain(rid)
            return "applied"
        if op in ("park", "restart", "role_change"):
            if health is not ReplicaState.DRAINING or not self.pool.is_idle(rid):
                return f"rejected:{health.value}"
            if op == "park":
                victims = self.pool.kill(
                    rid, reason=payload.get("reason", "parked (lifecycle)"))
                assert not victims, \
                    f"lifecycle park of replica {rid} displaced in-flight " \
                    f"work: {victims}"
            else:
                if op == "role_change":
                    self.pool.set_role(rid, payload["role"])
                self.pool.restart(rid)
            return "applied"
        if op == "mig_complete":
            rep = self.pool.replica(rid)
            uid = payload["uid"]
            if rep.serve is None:
                return "rejected:no_engine"
            sr = rep.serve._active.get(uid)
            if sr is None or sr.state is not RequestState.MIGRATING:
                # the source's copy already left MIGRATING (preempted,
                # restarted, or a duplicate raced the first apply): there
                # is nothing to close — the router-side handoff owns the
                # request either way
                return "rejected:not_migrating"
            rep.serve.complete_migration(uid)
            return "applied"
        return f"rejected:unknown_op:{op}"

    def _on_lifecycle_ack(self, rid: int, p: dict, now: float) -> None:
        """Fold one ack.  A fenced zombie's late ack — the target's epoch
        advanced after the command was stamped — is DISCARDED: whatever
        the zombie claims to have applied predates the fence and must not
        drive follow-up actions on this side."""
        cmd = self._lifecycle.get(p["seq"])
        if cmd is None or cmd.state is not LifecycleCmdState.SENT:
            return   # unknown seq, duplicate ack, or an aborted record
        if self.lease.epoch[cmd.rid] > cmd.epoch:
            self.stats["lifecycle_stale_acks"] += 1
            cmd.to(LifecycleCmdState.ABORTED)
            self.stats["lifecycle_aborted"] += 1
            logger.warning(f"fleet: discarded stale lifecycle ack seq="
                           f"{cmd.seq} ({cmd.op}) from fenced replica {rid}")
            return
        cmd.to(LifecycleCmdState.ACKED)
        cmd.status = p["status"]
        self.stats["lifecycle_acked"] += 1
        if p["status"] != "applied":
            return
        # router-side follow-ups the direct path ran synchronously
        if cmd.op in ("recover", "restart", "role_change"):
            self.warmup_replica(cmd.rid)
        if cmd.op == "role_change":
            self._emit([("fleet/role_change", float(cmd.rid),
                         self._next_event_step())])
        elif cmd.op == "park":
            # a deliberate park must never read as a failure: fold it into
            # the lease view NOW (epoch bump included) so the coming
            # heartbeat silence cannot expire a lease over it
            self.lease.declare_dead(cmd.rid, now, reason="parked (lifecycle)")

    def lifecycle_pending(self, rid: int, op: Optional[str] = None) -> bool:
        """Any lifecycle command still in flight for ``rid`` (optionally a
        specific op)?  The autoscaler gates follow-up decisions on this so
        it never stacks a second mutation on an unacked first.  Always
        False without a transport (direct calls complete synchronously)."""
        return any(c.rid == rid and (op is None or c.op == op)
                   and c.state in (LifecycleCmdState.PENDING,
                                   LifecycleCmdState.SENT)
                   for c in self._lifecycle.values())

    def replica_idle(self, rid: int) -> bool:
        """Is ``rid`` idle by the router's best evidence?  A direct pool
        probe without a transport; the last-known-good heartbeat payload
        under one — safe for drain gating, because a DRAINING replica
        takes no new dispatches, so its idleness only ever becomes MORE
        true after the observation."""
        if self.transport is None:
            return self.pool.is_idle(rid)
        stats, _age = self.lease.stats(rid)
        if stats is None:
            return self.pool.is_idle(rid)
        return stats["queue_depth"] == 0 and stats["active"] == 0

    # --------------------------------------------- directory feed + resync

    def _dir_apply(self, rid: int, op: str, digest: int) -> None:
        try:
            if op == "publish":
                self.directory.publish(rid, digest)
            elif op == "host_publish":
                # replica's kvtier staged the page host-side (serving/kvtier)
                self.directory.publish_host(rid, digest)
            elif op == "host_evict":
                self.directory.retract_host(rid, digest)
            else:
                self.directory.retract(rid, digest)
        except _fi.InjectedCrash:
            raise  # simulated death of THIS driver process
        except OSError as e:
            # a transient table-write fault drops THIS update (stale —
            # absorbed by the routing staleness ladder, never wrong)
            logger.warning(f"fleet: prefix directory {op} dropped for "
                           f"replica {rid}: {e}")

    def _on_dir_publish(self, rid: int, seq: int, p: dict, now: float) -> None:
        if self.directory is None:
            return
        feed = self._dir_feeds[rid]
        if feed.expect is None:
            return   # stream broken: awaiting resync, deliveries dropped
        if seq < feed.expect:
            return   # duplicate of an already-applied message
        if seq > feed.expect:
            feed.buffer[seq] = (p["op"], p["digest"])
            if feed.gap_since is None:
                feed.gap_since = now
            return
        self._dir_apply(rid, p["op"], p["digest"])
        feed.expect += 1
        while feed.expect in feed.buffer:
            op, digest = feed.buffer.pop(feed.expect)
            self._dir_apply(rid, op, digest)
            feed.expect += 1
        # a drain that exposes a FURTHER gap (buffer still non-empty)
        # restarts that gap's clock: it just formed, and inheriting the
        # old stamp would declare it lost dir_gap_timeout too early
        feed.gap_since = now if feed.buffer else None

    def _check_dir_feed(self, rid: int, feed: _DirFeed, now: float) -> None:
        """Declare a lost publish (gap outlived the reorder window or its
        timeout) and drive the resync request/retry timers."""
        if self.directory is None:
            return
        if feed.resync_since is not None:
            if now - feed.resync_since >= self.dir_resync_retry:
                self.transport.note_retransmit()
                self._request_dir_resync(rid, now)
            return
        if feed.expect is None:
            # broken stream with no outstanding request (the resync send
            # itself was eaten, or the break predates the rejoin)
            if self.lease.state(rid) is LeaseState.ALIVE:
                self._request_dir_resync(rid, now)
            return
        if feed.gap_since is None:
            return
        if len(feed.buffer) >= self.dir_reorder_window or \
                now - feed.gap_since >= self.dir_gap_timeout:
            # the missing publish is LOST, not late: detected, not absorbed
            self.stats["publish_gaps"] += 1
            self._emit([("prefix/publish_gap", float(rid),
                         self._next_event_step())])
            logger.warning(f"fleet: publish gap on replica {rid}'s prefix "
                           f"stream at seq {feed.expect} — pulling resync")
            feed.expect = None
            feed.buffer.clear()
            feed.gap_since = None
            self._request_dir_resync(rid, now)

    def _request_dir_resync(self, rid: int, now: float) -> None:
        if self.directory is None:
            return
        feed = self._dir_feeds[rid]
        feed.resync_since = now
        self.transport.send("dir_resync_req", "router", rid, {})

    def _on_dir_resync(self, rid: int, p: dict, now: float) -> None:
        if self.directory is None:
            return
        feed = self._dir_feeds[rid]
        if feed.resync_since is None or \
                (feed.expect is not None and p["barrier"] + 1 < feed.expect):
            # a duplicated (or badly reordered) resync reply: the first
            # copy already applied and the feed has moved on — applying
            # this one would purge live state, resurrect retracted digests
            # as ghost holders, and REWIND the sequence past messages
            # already consumed
            return
        feed.resync_since = None
        # the snapshot REPLACES this replica's view wholesale and
        # re-anchors the stream at its barrier; buffered ops past the
        # barrier (published while the snapshot traveled) apply on top
        self.directory.purge(rid)
        for digest in p["digests"]:
            self._dir_apply(rid, "publish", digest)
        for digest in p.get("host_digests", ()):
            self._dir_apply(rid, "host_publish", digest)
        feed.expect = p["barrier"] + 1
        feed.buffer = {s: v for s, v in feed.buffer.items() if s >= feed.expect}
        feed.gap_since = now if feed.buffer else None
        while feed.expect in feed.buffer:
            op, digest = feed.buffer.pop(feed.expect)
            self._dir_apply(rid, op, digest)
            feed.expect += 1
        if not feed.buffer:
            feed.gap_since = None
        self.stats["dir_resyncs"] += 1
        self._emit([("prefix/resync", float(rid), self._next_event_step())])

    # ----------------------------------------------------- migration chunks

    def _on_mig_chunk(self, rid: int, p: dict, now: float) -> None:
        """Idempotent chunk import on the router-side assembly: only the
        exactly-expected index appends (duplicates and reordered copies
        re-ack without touching the snapshot), so loss costs retransmits,
        never torn or double-applied chunks."""
        fid = p["fid"]
        rx = self._mig_rx.get(fid)
        if rx is None:
            return   # migration gone (fallback/lease harvest): no ack —
            # the source's exporter record died with it
        if p["idx"] == rx["next"]:
            rx["snap"].chunks.append(p["chunk"])
            rx["snap"].crcs.append(p["crc"])
            rx["next"] += 1
            if p["last"]:
                rx["snap"].complete = True
            self.stats["migration_chunks"] += 1
        self.transport.send("mig_ack", "router", rid,
                            {"fid": fid, "next": rx["next"]})

    # ----------------------------------------------------------- staleness

    def fleet_load_stats(self) -> Dict[int, dict]:
        """Per-replica load snapshot with a staleness ``age`` annotation —
        the autoscaler's (and any control consumer's) input.  Without a
        transport this is a live probe at age 0; with one it is each
        replica's LAST-KNOWN-GOOD heartbeat payload, however old (the
        consumer sees the age and can discount accordingly)."""
        if self.transport is None:
            return {rid: {**st, "age": 0.0}
                    for rid, st in self.pool.load_stats().items()}
        out = {}
        for rid in self.pool.rids:
            if self.lease.state(rid) is LeaseState.DEAD:
                continue
            stats, age = self.lease.stats(rid)
            if stats is not None:
                out[rid] = {**stats, "age": round(age, 9)}
        return out

    def dispatchable_rids(self) -> List[int]:
        if self.transport is None:
            return [r for r in self.pool.rids if self.pool.health.dispatchable(r)]
        return [r for r in self.pool.rids
                if self.lease.dispatchable(r)
                and self.pool.replica(r).serve is not None]

    # -------------------------------------------------------------- warm-up

    def warmup_replica(self, rid: int, max_chains: Optional[int] = None) -> int:
        """Directory-driven warm-up: pre-import the directory's hottest
        prefix chains onto replica ``rid`` (typically RECOVERING — a fresh
        engine with a stone-cold cache) from live donors, so its first
        dispatches land warm instead of eating cold-start recomputes.
        Every failure rung falls back to skipping the chain (the replica
        merely joins colder); returns chains imported."""
        if self.directory is None:
            return 0
        max_chains = self.warmup_chains if max_chains is None else max_chains
        if max_chains <= 0:
            return 0
        target = self.pool.replica(rid)
        if target.serve is None:
            return 0
        from ...resilience.fault_injection import DeviceLossError
        from ..kvtransfer import SnapshotError, export_prefix
        imported = 0
        for digest, holders in self.directory.hottest(4 * max_chains):
            if imported >= max_chains:
                break
            donor_rid = next((h for h in holders if h != rid
                              and self.pool.replica(h).serve is not None), None)
            if donor_rid is None:
                continue
            donor = self.pool.replica(donor_rid)
            pc = donor.serve.engine.kv.prefix_cache
            tokens = pc.chain_tokens(digest) if pc is not None else None
            if not tokens:
                continue   # evict-after-publish staleness: chain gone
            try:
                # one sentinel token past the chain: the export walk shares
                # match()'s last-token cap (a prompt of EXACTLY the chain
                # could only reuse all-but-one page, since the engine must
                # still compute >= 1 token) — warm-up wants the WHOLE
                # chain, and real matching prompts will be longer anyway
                snapshot = export_prefix(donor.serve.engine, tokens + [0],
                                         source=f"replica{donor_rid}")
                if snapshot is None:
                    continue
                n = target.serve.import_prefix(snapshot)
            except _fi.InjectedCrash:
                raise  # simulated death of THIS driver process
            except (DeviceLossError, SnapshotError, OSError) as e:
                # warm-up is strictly best-effort: any staging fault means
                # the replica joins colder, never later or wrong
                self.stats["warmup_fallbacks"] += 1
                logger.warning(f"fleet: warm-up import onto replica {rid} "
                               f"fell back ({e})")
                continue
            if n == 0:
                continue   # already held (a deeper chain covered it)
            if self.prefix_import_cost > 0:
                donor.clock.on_step(self.prefix_import_cost * snapshot.n_pages)
                target.clock.on_step(self.prefix_import_cost * n)
            imported += 1
        if imported:
            self.stats["warmup_imports"] += imported
            self._emit([("fleet/prefix_warmup", float(rid),
                         self._next_event_step())])
        return imported

    # ------------------------------------------------------------- schedule

    def control_timestamps(self, now: float) -> List[float]:
        """Future instants at which the CONTROL plane can make progress on
        its own — in-flight deliveries, partition boundaries, lease
        deadlines, fence/resync retry timers.  The simulator folds these
        into its idle-jump waits so a quiet fleet still wakes to expire a
        lease or heal a partition."""
        if self.transport is None:
            return []
        out = self.transport.next_wake(now) + self.lease.deadlines(now)
        for feed in self._dir_feeds.values():
            if feed.resync_since is not None:
                out.append(feed.resync_since + self.dir_resync_retry)
            if feed.gap_since is not None:
                out.append(feed.gap_since + self.dir_gap_timeout)
        for m in self._migrations.values():
            ch = m.get("chan")
            if ch is not None and ch["sent_ts"] is not None:
                out.append(ch["sent_ts"] + self.mig_retry)
        for cmd in self._lifecycle.values():
            if cmd.state is LifecycleCmdState.SENT and cmd.sent_ts is not None:
                out.append(cmd.sent_ts + self.lifecycle_retry)
            elif cmd.state is LifecycleCmdState.PENDING:
                out.append(now)   # a send-faulted command retries next poll
        # already-due wake-ups clamp to ``now`` (a zero-width jump: the
        # next round's transport_poll resolves them) rather than being
        # dropped — dropping one would let the idle-jump leap PAST a due
        # delivery and, e.g., suspect a replica whose heartbeat was
        # sitting undelivered in the inbox
        return [max(t, now) for t in out]

    def control_marker(self):
        """Discrete control-plane transitions for the simulator's stall
        detector (deliberately EXCLUDES raw send/deliver counters: a
        heartbeat per round is traffic, not progress — counting it would
        disable the idle-jump and spin the simulator through quiet
        stretches one round at a time)."""
        if self.transport is None:
            return None
        return (self.stats["lease_expirations"], self.stats["fenced_replicas"],
                self.stats["fenced_completions"], self.stats["fenced_requests"],
                self.stats["publish_gaps"], self.stats["dir_resyncs"],
                self.stats["lifecycle_applied"], self.stats["lifecycle_acked"],
                self.stats["lifecycle_aborted"],
                tuple(s.value for _, s in sorted(self.lease.states().items())))

    # ----------------------------------------------------------- migration

    def _decode_candidates(self, exclude_rid: int):
        """Dispatchable DECODE/MIXED-role replicas other than the source —
        the pool a completed export can hand off to."""
        return [(rid, rep, st) for rid, rep, st in self._candidates()
                if rid != exclude_rid
                and rep.role in (ReplicaRole.DECODE, ReplicaRole.MIXED)]

    def _precharge_migrations(self) -> None:
        """Charge each in-flight export's next chunk on its source's clock
        view (see dispatch_pending: runs before the round's ticks so the
        cost advances the clock inside the MIGRATING window)."""
        if self.migration_chunk_cost <= 0:
            return
        for m in self._migrations.values():
            if not m["exporter"].snapshot.complete \
                    and m["sr"].state is RequestState.MIGRATING:
                self.pool.replica(m["rid"]).clock.on_step(
                    self.migration_chunk_cost)

    def _start_migrations(self, now: float) -> None:
        """Begin exports for requests that reached DECODE on a PREFILL-role
        replica — only when a decode replica exists to take the handoff."""
        if self.overload is not None and self.overload.migrations_paused:
            # brownout rung 3: no NEW exports/prefix imports under overload
            # — the d2h/h2d staging bandwidth (and the decode pool's page
            # headroom) goes to serving; in-flight exports still complete
            return
        ok_states = (RequestState.PREFILL, RequestState.DECODE) \
            if self.prefill_handoff else (RequestState.DECODE, )
        # ONE candidate snapshot per round (same stance as
        # dispatch_pending): a per-request rebuild would run load_stats on
        # every replica for every dispatched request.  Only existence per
        # source rid matters here; the handoff picks its target later.
        decode_rids = {rid for rid, rep, _ in self._candidates()
                       if rep.role in (ReplicaRole.DECODE, ReplicaRole.MIXED)}
        if not decode_rids:
            return
        for fr in list(self._dispatched.values()):
            if fr.fid in self._migrations or fr._current is None:
                continue
            rid, sr, gen = fr._current
            rep = self.pool.replica(rid)
            if rep.role is not ReplicaRole.PREFILL or rep.serve is None:
                continue
            if sr.state not in ok_states:
                continue  # begin_migration arbitrates the exact window
            if not (decode_rids - {rid}):
                continue  # no handoff target: keep prefilling/decoding here
            exporter = rep.serve.begin_migration(
                sr.uid, chunk_pages=self.migration_chunk_pages,
                source=f"replica{rid}")
            if exporter is None:
                continue
            m = {"rid": rid, "sr": sr, "generation": gen,
                 "exporter": exporter, "started_ts": now}
            if self.transport is not None:
                # the chunks will cross the lossy fabric stop-and-wait; the
                # ROUTER assembles its own snapshot copy from delivered
                # chunks (idempotent by index) — the handoff uses THAT, so
                # a lost/duplicated chunk costs retransmits, never tearing
                from ..kvtransfer import KVSnapshot
                src = exporter.snapshot
                m["chan"] = {"base": 0, "sent_idx": None, "sent_ts": None}
                self._mig_rx[fr.fid] = {
                    "next": 0,
                    "snap": KVSnapshot(tokens=list(src.tokens),
                                       seen_tokens=src.seen_tokens,
                                       page_size=src.page_size,
                                       block_shape=src.block_shape,
                                       dtype=src.dtype, source=src.source)}
            self._migrations[fr.fid] = m
            fr.migrations += 1
            self.stats["migrations_started"] += 1
            self._emit([("fleet/migration_start", float(rid),
                         self._next_event_step())])

    def _pump_migrations(self, now: float) -> None:
        """One poll round of the two-phase dispatch (DistServe-style
        prefill→decode handoff; docs/SERVING.md "Disaggregated serving"):
        every in-flight export stages ONE chunk — the d2h copies overlap
        the source replica's ongoing steps for everything else it serves —
        and a completed snapshot is handed off: the source closes the
        request as MIGRATED, and the router re-dispatches it onto the
        least-loaded decode replica carrying the snapshot, where the
        KV-import fast path resumes decode without recomputing the prompt.

        Fallback ladder (never wrong, only slower): a transient export
        fault or a vanished handoff target resumes decode IN PLACE
        (``abort_migration``); a source-side preemption/timeout mid-export
        already moved the request back to the recompute path; an import
        rejection on the target falls back to recompute-on-resume inside
        the replica's admission.  Outputs are byte-identical on every rung."""
        from ...resilience.fault_injection import DeviceLossError
        for fid, m in list(self._migrations.items()):
            fr = self._dispatched.get(fid)
            if fr is None or fr._current is None or fr._current[1] is not m["sr"]:
                # displaced (replica death harvested the record) or terminal
                self._migrations.pop(fid, None)
                self._mig_rx.pop(fid, None)
                continue
            sr, rid = m["sr"], m["rid"]
            if sr.state is not RequestState.MIGRATING:
                # preempted (EVICTED→QUEUED) or expired on the source mid-
                # export: the recompute path owns the request again
                self._migration_fallback(fid, "source left MIGRATING")
                continue
            rep = self.pool.replica(rid)
            exporter = m["exporter"]
            if self.transport is not None and \
                    not self.transport.connected("router", rid, now):
                # partitioned source: chunks could neither deliver nor ack
                # — the pump waits for the heal (or the lease harvest)
                continue
            if not exporter.snapshot.complete:
                try:
                    done = exporter.step_chunk()
                except _fi.InjectedCrash:
                    raise  # simulated death of THIS driver process
                except DeviceLossError as e:
                    # the d2h staging found the source device gone — replica
                    # death; on_replica_dead harvests the migration record
                    self.on_replica_dead(rid, now, reason=str(e))
                    continue
                except SnapshotAborted as e:
                    self._migration_fallback(fid, str(e))
                    continue
                except OSError as e:
                    # transient staging fault: resume decode in place
                    if rep.serve is not None:
                        rep.serve.abort_migration(sr.uid)
                    self._migration_fallback(fid, f"export fault: {e}")
                    continue
                if self.transport is None:
                    self.stats["migration_chunks"] += 1
            else:
                done = True
            if self.transport is not None:
                # ack/retry delivery: one unacked chunk in flight at a time
                # (stop-and-wait), receiver-side assembly idempotent by
                # index; migration_chunks counts RECEIPTS, and completion
                # is the ROUTER-side snapshot's, not the exporter's
                self._pump_chunk_channel(fid, m, rid, now)
                rx = self._mig_rx.get(fid)
                if rx is None or not rx["snap"].complete:
                    continue
                snapshot = rx["snap"]
            else:
                if not done:
                    continue
                snapshot = exporter.snapshot
            targets = self._decode_candidates(rid)
            if not targets:
                # the decode pool vanished mid-export: decode continues on
                # the source exactly where it paused
                if rep.serve is not None:
                    rep.serve.abort_migration(sr.uid)
                self._migration_fallback(fid, "no decode replica for handoff")
                continue
            if self.transport is None:
                rep.serve.complete_migration(sr.uid)
            else:
                # the source-side close becomes a transported lifecycle
                # command (retried, epoch-fenced, idempotent per seq); the
                # handoff itself proceeds NOW on the router-side assembled
                # snapshot — the command only releases the source's copy
                self.lifecycle_command(rid, "mig_complete",
                                       {"uid": sr.uid}, now)
            self._migrations.pop(fid)
            self._mig_rx.pop(fid, None)
            del self._dispatched[fid]
            fr._current = None
            fr.to(FleetState.PENDING, now)
            fr._kv_snapshot = snapshot
            self._close_attempt(fr, "migrated", now)
            if fr.trace is not None and fr.trace["attempts"]:
                # the decode-side attempt links back to the prefill attempt
                fr.trace["last_dead"] = fr.trace["attempts"][-1]["span_id"]
            self._pending.append(fr)
            self.stats["migrations_completed"] += 1
            self._emit([("fleet/migration_complete", float(rid),
                         self._next_event_step())])
            # place on the least-outstanding decode replica NOW (a round of
            # pending latency saved); queue_full leaves it pending with the
            # snapshot for the next dispatch round
            tid, _, _ = min(targets,
                            key=lambda c: (c[2]["outstanding_tokens"],
                                           c[2]["queue_depth"], c[0]))
            self._dispatch_to(fr, tid, {"phase": "decode", "role_match": True,
                                        "migration": True}, now)

    def _pump_chunk_channel(self, fid: int, m: dict, rid: int,
                            now: float) -> None:
        """Send (or retransmit) the next unacked staged chunk of one
        migration over the transport — stop-and-wait with cumulative acks
        (``mig_ack.next``); the retransmit timer, not delivery failure
        notices, paces recovery from loss."""
        ch = m["chan"]
        exporter = m["exporter"]
        chunks = exporter.snapshot.chunks
        idx = ch["base"]
        if idx >= len(chunks):
            return   # every staged chunk acked; the exporter still staging
        if ch["sent_idx"] == idx and ch["sent_ts"] is not None:
            if now < ch["sent_ts"] + self.mig_retry:
                return   # in flight, not yet timed out
            self.transport.note_retransmit()
        last = exporter.snapshot.complete and idx == len(chunks) - 1
        self.transport.send("mig_chunk", rid, "router",
                            {"fid": fid, "idx": idx, "chunk": chunks[idx],
                             "crc": exporter.snapshot.crcs[idx],
                             "last": last}, seq=idx)
        ch["sent_idx"], ch["sent_ts"] = idx, now

    def _migration_fallback(self, fid: int, reason: str) -> None:
        self._migrations.pop(fid, None)
        self._mig_rx.pop(fid, None)
        self.stats["migration_fallbacks"] += 1
        logger.warning(f"fleet: migration of fid={fid} fell back ({reason})")
        self._emit([("fleet/migration_fallback", 1.0, self._next_event_step())])

    # ------------------------------------------------------------ failover

    def on_replica_dead(self, rid: int, now: Optional[float] = None,
                        reason: str = "killed") -> List[FleetRequest]:
        """Replica loss entry point (scripted kill, health-declared death,
        or an injected dispatch-time device loss): discards the replica's
        engine and moves every displaced fleet request back to PENDING with
        its delivered tokens preserved.  Idempotent per death."""
        now = self.clock.now() if now is None else now
        # pool.tick's health path may have killed the replica already (engine
        # discarded) — the fleet-side victims still need requeuing; only a
        # death with neither an engine to kill NOR displaced requests is a
        # true duplicate notification
        was_dead = self.pool.health.state(rid) is ReplicaState.DEAD \
            and self.pool.replica(rid).serve is None
        if not was_dead:
            self.pool.kill(rid, reason=reason)
        if self.transport is not None:
            # the router OBSERVED this death directly (a device loss on a
            # synchronous dispatch/staging RPC) — fold it into the lease
            # view now, with the epoch bump, so the eventual heartbeat
            # silence does not declare and account the same death twice
            self.lease.declare_dead(rid, now, reason=f"router-observed: {reason}")
        victims: List[FleetRequest] = []
        for fr in list(self._dispatched.values()):
            if fr._current is not None and fr._current[0] == rid:
                del self._dispatched[fr.fid]
                displaced_sr = fr._current[1]
                fr._current = None
                if displaced_sr.state.terminal:
                    # the request reached its terminal state on the replica
                    # BEFORE the death notice (a wall-clock driver can kill
                    # between the finishing tick and poll): nothing was
                    # displaced — resolve exactly as poll() would, with no
                    # failover charged and the replica-side finish time kept
                    if displaced_sr.state is RequestState.DONE:
                        fr.finish_ts = displaced_sr.finish_ts \
                            if displaced_sr.finish_ts is not None else now
                        self._close_attempt(fr, "done", fr.finish_ts)
                        self._finish(fr, FleetState.DONE, now)
                    else:
                        t_out = displaced_sr.history[-1][1]
                        self._close_attempt(fr, displaced_sr.state.value, t_out)
                        self._finish(fr, FleetState.TIMED_OUT, t_out)
                    continue
                # failover KV reuse: host-staged snapshots survive the
                # replica's death.  Either the SOURCE died with the export
                # already complete (migration record), or the TARGET died
                # before admitting a handed-off request (unconsumed
                # req.kv_snapshot) — both resume the survivor through the
                # KV-import fast path instead of a full recompute.
                m = self._migrations.pop(fr.fid, None)
                rx = self._mig_rx.pop(fr.fid, None)
                # under the transport only chunks that actually DELIVERED
                # count: the router-side assembly must be complete, not
                # merely the dead source's local staging
                snap = None
                if self.transport is not None:
                    if rx is not None and rx["snap"].complete:
                        snap = rx["snap"]
                elif m is not None and m["exporter"].snapshot.complete:
                    snap = m["exporter"].snapshot
                if snap is not None and fr._kv_snapshot is None:
                    fr._kv_snapshot = snap
                    self.stats["migration_failover_reuse"] += 1
                elif getattr(displaced_sr, "kv_snapshot", None) is not None:
                    dsnap = displaced_sr.kv_snapshot
                    displaced_sr.kv_snapshot = None
                    if isinstance(dsnap, HostKVHandle):
                        # a PARKED attempt (session tool stall) died with
                        # its KV in the dead replica's HOST tier — host
                        # memory survives the device loss, so resolve the
                        # handle to the raw snapshot NOW and carry it to a
                        # survivor's import path (the survivor needs no
                        # tier of its own).  A None resolution (the entry
                        # was LRU-evicted first) leaves _kv_snapshot unset:
                        # recompute-on-resume, the ladder's never-wrong rung.
                        dsnap = dsnap.tier.host.take_seq(dsnap.uid)
                    if dsnap is not None:
                        fr._kv_snapshot = dsnap
                        self.stats["migration_failover_reuse"] += 1
                fr.failovers += 1
                self._taccount(fr.tenant)["failovers"] += 1
                fr.to(FleetState.PENDING, now)
                # the dead attempt's spans close NOW (its frontend is
                # discarded, so the router folds the partial history); the
                # resumed attempt on a survivor will link back to this
                # span id — the client trace is continuous across the kill
                self._close_attempt(fr, "displaced", now, displaced_sr=displaced_sr)
                self._pending.append(fr)
                victims.append(fr)
                self.stats["failovers"] += 1
        # drop any remaining export records anchored on the dead replica
        # (e.g. a terminal-at-death request): their exporters' source
        # engine is gone and the next step_chunk would abort anyway
        for fid in [f for f, m in self._migrations.items() if m["rid"] == rid]:
            self._migrations.pop(fid)
            self._mig_rx.pop(fid, None)
        if was_dead and not victims:
            return []
        record = {"rid": rid, "ts": now, "reason": reason,
                  "victims": {fr.fid for fr in victims},
                  "n_victims": len(victims), "recovered_ts": None}
        if not victims:
            record["recovered_ts"] = now   # nothing displaced: recovery is free
            self.recovery_times.append(0.0)
        self.kill_records.append(record)
        self._emit([("fleet/replica_dead", float(rid), self._next_event_step()),
                    ("fleet/failover_requeued", float(len(victims)),
                     self._next_event_step())])
        self._recorder_dump("replica_dead", now)
        return victims

    def _note_victim_resolved(self, fr: FleetRequest, now: float) -> None:
        """Failover recovery time: a kill record closes when the LAST
        displaced request reaches a terminal state — the displaced work is
        fully re-served (or definitively expired), not merely back in a
        queue.  Re-dispatch alone would read ~0 whenever survivors have
        queue capacity and hide the recompute cost failover actually pays."""
        for rec in self.kill_records:
            if rec["recovered_ts"] is None and fr.fid in rec["victims"]:
                rec["victims"].discard(fr.fid)
                if not rec["victims"]:
                    rec["recovered_ts"] = now
                    self.recovery_times.append(now - rec["ts"])

    def _finish(self, fr: FleetRequest, state: FleetState, now: float) -> None:
        assert not fr.state.terminal, \
            f"fleet request {fr.fid} reached a second terminal state " \
            f"({fr.state.value} then {state.value})"
        if not state.terminal:
            # checked BEFORE the transition commits: _finish is the
            # terminal edge and nothing else — a PENDING/DISPATCHED
            # target would corrupt the conservation receipt (submitted ==
            # completed + timed_out + rejected), and it must fail with
            # the request record unmutated (no bogus history entry)
            raise ValueError(f"_finish called with non-terminal state "
                             f"{state.value} for fid={fr.fid}")
        fr.to(state, now)
        t = self._taccount(fr.tenant)
        if state is FleetState.DONE:
            t["completed"] += 1
            t["tokens"] += len(fr.tokens)
            if fr.met_deadline:
                t["deadline_met"] += 1
            if fr.ttft is not None:
                self.ttft_log.append(fr.ttft)
                if self.slo is not None:
                    self.slo.observe(fr.tenant, fr.ttft, now)
        elif state is FleetState.TIMED_OUT:
            t["timed_out"] += 1
        elif state is FleetState.REJECTED:
            t["rejected"] += 1
        else:
            raise AssertionError(f"unreachable: {state} passed the "
                                 "terminal precheck")  # guard above
        self._note_victim_resolved(fr, now)
        if fr.trace is not None:
            self._trace_finish(fr, state, now)
        self._emit([(f"fleet/{state.value}", 1.0, self._next_event_step())])

    # ----------------------------------------------------------- telemetry

    def _close_attempt(self, fr: FleetRequest, outcome: str, end_ts: float,
                       displaced_sr: Optional[ServingRequest] = None,
                       tail_phase: Optional[str] = None) -> None:
        """Materialize the current (last) attempt span.  For a displaced
        attempt the replica frontend is already discarded (kill) or no
        longer trusted (lease expiry), so its partial phase spans are
        folded here from the ServingRequest history, clamped to the
        dispatch instant; ``tail_phase="fenced"`` attributes the open
        tail past the last observed transition to ``phase/fenced``."""
        tr = fr.trace
        if tr is None or not tr["attempts"]:
            return
        att = tr["attempts"][-1]
        if att["end_ts"] is not None:  # already closed (duplicate death notice)
            return
        att["end_ts"] = end_ts
        track = f"replica{att['rid']}"
        if displaced_sr is not None:
            # fold the dead attempt's PARTIAL history — unless the request
            # already reached a terminal state on the replica (killed in
            # the window between its finishing tick and the router's
            # poll): its frontend emitted the phase spans at _finish, and
            # re-folding here would double every phase and break the
            # trace_report tiling invariant
            if not displaced_sr.state.terminal:
                emit_attempt_spans(self.tracer, displaced_sr, tr["trace_id"],
                                   att["span_id"], track, end_ts=end_ts,
                                   clamp_start=att["dispatch_ts"],
                                   tail_phase=tail_phase)
            elif tail_phase is not None:
                # the zombie finished BEFORE the lease expired (its own
                # frontend already emitted phases up to its terminal); the
                # stretch from that discarded terminal to the displacement
                # is fenced time, or the attempt window under-tiles
                t_term = displaced_sr.history[-1][1]
                if end_ts > t_term:
                    self.tracer.add_span(f"phase/{tail_phase}",
                                         tr["trace_id"], t_term, end_ts,
                                         parent_id=att["span_id"],
                                         track=track)
            tr["last_dead"] = att["span_id"]
        attrs = {"rid": att["rid"], "generation": att["generation"],
                 "outcome": outcome, "resume_tokens": att["resume_tokens"]}
        if att["resumed_from"] is not None:
            attrs["resumed_from"] = att["resumed_from"]
        self.tracer.add_span("attempt", tr["trace_id"], att["dispatch_ts"],
                             end_ts, parent_id=tr["root_id"],
                             span_id=att["span_id"], track=track, attrs=attrs)

    def _trace_finish(self, fr: FleetRequest, state: FleetState, now: float) -> None:
        """Materialize the client-request root span plus the router-queue
        ``phase/pending`` gaps (before first dispatch, between failover
        displacement and re-dispatch, after the last attempt) so the
        trace's phase spans tile [arrival, terminal] exactly — the
        invariant scripts/trace_report.py checks against TTFT/TPOT."""
        tr = fr.trace
        trace_id, root_id = tr["trace_id"], tr["root_id"]
        end = fr.finish_ts if state is FleetState.DONE and fr.finish_ts is not None \
            else now
        t = fr.arrival_ts
        for att in tr["attempts"]:
            if att["dispatch_ts"] > t:
                self.tracer.add_span("phase/pending", trace_id, t,
                                     att["dispatch_ts"], parent_id=root_id,
                                     track="router")
            att_end = att["end_ts"] if att["end_ts"] is not None else att["dispatch_ts"]
            t = max(t, att_end)
        if end > t:
            self.tracer.add_span("phase/pending", trace_id, t, end,
                                 parent_id=root_id, track="router")
        events = [("dispatch", ts, {"rid": rid}) for rid, ts in fr.dispatches]
        events += [("failover", ts, None) for st, ts in fr.history[1:]
                   if st is FleetState.PENDING]
        events.sort(key=lambda e: e[1])
        self.tracer.add_span(
            "request", trace_id, fr.arrival_ts, end, span_id=root_id,
            track="router", events=events,
            attrs={"fid": fr.fid, "state": state.value,
                   "prompt_len": len(fr.prompt), "n_tokens": len(fr.tokens),
                   "failovers": fr.failovers, "affinity_hits": fr.affinity_hits,
                   "reject_reason": fr.reject_reason,
                   "ttft": fr.ttft, "tpot": fr.tpot, "e2e": end - fr.arrival_ts,
                   "deadline_met": fr.met_deadline,
                   # the slowdown-attribution inputs (scripts/why_slow.py):
                   # which tenant's SLO this counts against, and whether a
                   # brownout rung truncated the output budget
                   "tenant": fr.tenant,
                   "brownout_capped": fr.brownout_capped})

    # ----------------------------------------------------------- lifecycle

    def kill_replica(self, rid: int, reason: str = "scripted kill") -> List[FleetRequest]:
        return self.on_replica_dead(rid, reason=reason)

    def recover_replica(self, rid: int) -> None:
        """Attach a fresh engine to a parked/dead replica and — when a
        prefix directory is attached — pre-import the directory's hottest
        chains so the replica joins the fleet WARM (directory-driven
        autoscale warm-up): its first post-recovery dispatches hit cache
        instead of paying the cold-start recompute."""
        self.pool.recover(rid)
        self.warmup_replica(rid)

    def drain(self, rid: int) -> None:
        """Rolling-restart entry: no NEW dispatches to ``rid``; its
        in-flight work runs to completion (``pool.is_idle`` then gates
        ``pool.restart``)."""
        self.pool.drain(rid)

    # ------------------------------------------------------------- metrics

    @property
    def outstanding(self) -> int:
        return len(self._pending) + len(self._dispatched)

    @property
    def queue_depth(self) -> int:
        """Requests waiting in the ROUTER queue (not yet on a replica) —
        a primary autoscaler/overload signal."""
        return len(self._pending)

    def export_replica_gauges(self) -> None:
        """The once-per-fleet-round observability sweep: publish each live
        replica's ``load_stats()`` snapshot as ``fleet/replica_*`` gauges
        on the pool's MetricsRegistry, the fleet-level serving-replica
        count, the brownout rung (when an overload controller is
        attached), and — under a control transport — the per-link health
        gauges (``transport/link_loss_ewma/<rid>``, retransmit depth,
        feed-gap age: ROADMAP's adaptive-lease-sizing input signal).  Also
        ticks the SLO burn-rate monitor.  The fleet driver calls this once
        per round; gauges are a no-op without a registry."""
        now = self.clock.now()
        if self.slo is not None:
            self.slo.tick(now)
        # the rate fold runs even without a registry: the predictive
        # autoscaler reads the raw (ewma, slope) pair via arrival_rate()
        self._fold_arrival_rate(now)
        metrics = self.pool.metrics
        if metrics is None:
            return
        if self.transport is not None:
            for rid in self.pool.rids:
                metrics.gauge(f"transport/link_loss_ewma/{rid}").set(
                    round(self.transport.link_loss_ewma("router", rid), 9))
                feed = self._dir_feeds.get(rid)
                age = 0.0 if feed is None or feed.gap_since is None \
                    else max(0.0, now - feed.gap_since)
                metrics.gauge(f"transport/feed_gap_age/{rid}").set(
                    round(age, 9))
            metrics.gauge("transport/retransmit_depth").set(
                self._retransmit_depth())
        stats = self.pool.load_stats()
        for rid in self.pool.rids:
            # DEAD/parked replicas are absent from load_stats — their
            # gauges read 0, not their last pre-kill values frozen forever
            st = stats.get(rid) or {"queue_depth": 0, "free_kv_pages": 0,
                                    "outstanding_tokens": 0, "active": 0}
            metrics.gauge(f"fleet/replica_queue_depth/{rid}").set(
                st["queue_depth"])
            metrics.gauge(f"fleet/replica_free_kv_pages/{rid}").set(
                st["free_kv_pages"])
            metrics.gauge(f"fleet/replica_outstanding_tokens/{rid}").set(
                st["outstanding_tokens"])
            metrics.gauge(f"fleet/replica_active/{rid}").set(st["active"])
        metrics.gauge("fleet/serving_replicas").set(sum(
            1 for rid in self.pool.rids if self.pool.health.serving(rid)))
        if self.overload is not None:
            metrics.gauge("fleet/overload_rung").set(self.overload.rung)
        if self.directory is not None:
            metrics.gauge("fleet/prefix_directory_entries").set(
                self.directory.entries)
        self._export_arrival_gauges(now, metrics)
        self._export_kv_gauges(metrics)

    def _fold_arrival_rate(self, now: float) -> None:
        """Fold the arrival-rate EWMA + derivative: the demand signal
        predictive scale-up provisions on — scale BEFORE the queue grows
        by reading the rate's slope, not the queue's depth.  One fold per
        fleet round; zero-advance rounds carry no new rate information
        and are skipped (the fold keeps its last value)."""
        if self._arr_last is None:
            self._arr_last = (now, self._arrival_count, None, 0.0)
            self._arr_rate = (0.0, 0.0)
            return
        t0, c0, ewma0, slope0 = self._arr_last
        dt = now - t0
        if dt <= 0:
            return
        inst = (self._arrival_count - c0) / dt
        alpha = 1.0 - math.exp(-dt / self.arrival_rate_tau)
        if ewma0 is None:
            ewma, slope = inst, 0.0
        else:
            ewma = ewma0 + alpha * (inst - ewma0)
            # the slope is smoothed with the SAME time constant: the raw
            # per-fold derivative of an EWMA is exactly the noise the EWMA
            # removed, scaled back up by 1/dt
            slope = slope0 + alpha * ((ewma - ewma0) / dt - slope0)
        self._arr_rate = (ewma, slope)
        self._arr_last = (now, self._arrival_count, ewma, slope)

    def arrival_rate(self) -> Tuple[float, float]:
        """The last-folded (rate EWMA, slope) pair, UNROUNDED — the
        predictive autoscaler's demand input (``fleet/arrival_rate_*``
        gauges publish the rounded rendering of the same fold)."""
        return self._arr_rate

    def _export_arrival_gauges(self, now: float, metrics) -> None:
        """Publish the current arrival-rate fold as the
        ``fleet/arrival_rate_ewma`` / ``fleet/arrival_rate_slope`` gauges
        (rounded at the export boundary like every gauge here)."""
        ewma, slope = self._arr_rate
        metrics.gauge("fleet/arrival_rate_ewma").set(round(ewma, 9))
        metrics.gauge("fleet/arrival_rate_slope").set(round(slope, 9))

    def _export_kv_gauges(self, metrics) -> None:
        """Per-replica KV-arena occupancy (``kv/<stat>/<rid>``), the
        per-replica step-anatomy host-gap fraction
        (``anatomy/host_gap_fraction/<rid>``), and the per-tenant page
        tallies (``kv/tenant_pages/<tenant>`` — the missing input for the
        ROADMAP per-tenant KV-quota item).  Tenant tallies attribute every
        in-use page exactly once, so they SUM to the fleet's pages in use
        (tested); a tenant that dropped to zero pages reads zero."""
        for rid in self.pool.rids:
            rep = self.pool.replica(rid)
            if rep.serve is None:
                # DEAD/parked: the arena died with the engine — gauges
                # must READ zero, not freeze their pre-death samples
                # (same stance as the fleet/replica_* gauges above)
                st = {"occupancy": 0.0, "free_run_fragmentation": 0.0,
                      "prefix_cache_share": 0.0}
            else:
                st = rep.serve.engine.kv.arena_stats()
            metrics.gauge(f"kv/page_occupancy/{rid}").set(st["occupancy"])
            metrics.gauge(f"kv/free_run_fragmentation/{rid}").set(
                st["free_run_fragmentation"])
            metrics.gauge(f"kv/prefix_cache_share/{rid}").set(
                st["prefix_cache_share"])
            if getattr(self.pool, "anatomy_enabled", False):
                # ALWAYS re-set from the current recorder: a replacement
                # engine's fresh recorder reads None (-> 0.0) until its
                # first step — the gauge must not keep attributing the
                # dead engine's loop tax to the new one
                anat = self.pool.anatomy(rid)
                frac = anat.host_gap_fraction() if anat is not None else None
                metrics.gauge(f"anatomy/host_gap_fraction/{rid}").set(
                    round(frac, 6) if frac is not None else 0.0)
        pages = self.tenant_kv_pages()
        for tenant in sorted(self._kv_tenants_seen | set(pages)):
            metrics.gauge(f"kv/tenant_pages/{tenant}").set(
                pages.get(tenant, 0))
        self._kv_tenants_seen |= set(pages)

    def tenant_kv_pages(self) -> Dict[str, int]:
        """KV pages currently held per tenant, fleet-wide.  Each in-use
        page is attributed EXACTLY ONCE: to the tenant of the first
        (uid-ordered) live sequence holding it — a prefix-shared page
        counts toward whoever admitted first, never twice — with two
        reserved keys: ``prefix_cache`` for pages only the prefix cache
        pins, and ``unattributed`` for sequences no fleet request owns
        (direct engine users).  The tallies therefore sum to the fleet's
        total pages in use — the conservation law the per-tenant KV-quota
        item needs to trust before it can enforce anything."""
        owner: Dict[Tuple[int, int], str] = {}
        for fr in self._dispatched.values():
            if fr._current is not None:
                rid, sr, _gen = fr._current
                owner[(rid, sr.uid)] = fr.tenant
        out: Dict[str, int] = {}
        for rid in self.pool.rids:
            rep = self.pool.replica(rid)
            if rep.serve is None:
                continue
            eng = rep.serve.engine
            seen = set()
            for uid in sorted(eng.state.seqs):
                seq = eng.state.seqs[uid]
                tenant = owner.get((rid, uid), "unattributed")
                n = 0
                for p in seq.pages:
                    if p not in seen:
                        seen.add(p)
                        n += 1
                if n:
                    out[tenant] = out.get(tenant, 0) + n
            # in_use straight from the allocator (arena_stats would pay
            # its O(free log free) fragmentation scan just for this field)
            in_use = (eng.kv.num_pages - 1) - eng.kv.allocator.free_pages
            cache_only = in_use - len(seen)
            if cache_only:
                out["prefix_cache"] = out.get("prefix_cache", 0) + cache_only
        return out

    def _retransmit_depth(self) -> int:
        """How many reliable-stream sends are currently awaiting an ack —
        unacked fences (FENCING leases), unacked migration chunks, and
        outstanding directory-resync requests.  A depth that stays high is
        the 'this link is sick' signal loss counters alone cannot give."""
        depth = sum(1 for rid in self.pool.rids
                    if self.lease.state(rid) is LeaseState.FENCING)
        depth += sum(1 for m in self._migrations.values()
                     if m.get("chan") is not None
                     and m["chan"]["sent_idx"] is not None)
        depth += sum(1 for feed in self._dir_feeds.values()
                     if feed.resync_since is not None)
        depth += sum(1 for c in self._lifecycle.values()
                     if c.state is LifecycleCmdState.SENT)
        return depth

    def _recorder_dump(self, reason: str, now: float) -> None:
        """Crash-scoped flight-recorder dump + its ``recorder/dump`` event.
        Guarded: a failed black-box write must never escalate a replica
        death into a driver death."""
        if self.recorder is None:
            return
        try:
            path = self.recorder.maybe_dump(reason, now)
        except _fi.InjectedCrash:
            raise  # simulated death of THIS driver process
        except Exception as e:
            logger.warning(f"flight-recorder dump failed ({reason}): {e}")
            return
        if path is not None:
            logger.warning(f"flight recorder: dumped {path} ({reason})")
            self._emit([("recorder/dump", float(self.recorder.dumps),
                         self._next_event_step())])

    def pending_timestamps(self) -> List[float]:
        """Future timestamps that could unblock progress (pending
        deadlines) — the simulator's idle-jump input."""
        return [fr.deadline for fr in self._pending if fr.deadline is not None] + \
               [fr.deadline for fr in self._dispatched.values() if fr.deadline is not None]

    def summary(self) -> dict:
        done = [r for r in self.requests if r.state is FleetState.DONE]
        met = [r for r in done if r.met_deadline]
        elapsed = max(self.clock.now() - self._t0, 1e-9)
        hits, misses = self.stats["affinity_hits"], self.stats["affinity_misses"]
        return {
            "policy": self.policy.name,
            "n_replicas": len(self.pool.replicas),
            "submitted": self.stats["submitted"],
            "completed": len(done),
            "timed_out": sum(1 for r in self.requests if r.state is FleetState.TIMED_OUT),
            "rejected": sum(1 for r in self.requests if r.state is FleetState.REJECTED),
            "dispatches": self.stats["dispatches"],
            "failovers": self.stats["failovers"],
            "dispatch_faults": self.stats["dispatch_faults"],
            "saturated_dispatches": self.stats["saturated_dispatches"],
            "deadline_met": len(met),
            "goodput_rps": round(len(met) / elapsed, 6),
            "completed_rps": round(len(done) / elapsed, 6),
            "tokens_generated": sum(len(r.tokens) for r in self.requests),
            "elapsed": round(elapsed, 6),
            "affinity": {
                "hits": hits, "misses": misses,
                "hit_rate": round(hits / (hits + misses), 4) if hits + misses else None,
            },
            "migration": {
                "started": self.stats["migrations_started"],
                "chunks": self.stats["migration_chunks"],
                "completed": self.stats["migrations_completed"],
                "fallbacks": self.stats["migration_fallbacks"],
                "failover_reuse": self.stats["migration_failover_reuse"],
                "migrated_requests": sum(1 for r in self.requests if r.migrations),
                # live-replica import accounting (engines discarded by kills
                # take their counters with them — same stance as load_stats)
                "kv_imports": sum(rep.serve.stats.kv_imports
                                  for rep in self.pool.replicas.values()
                                  if rep.serve is not None),
                "import_fallbacks": sum(rep.serve.stats.kv_import_fallbacks
                                        for rep in self.pool.replicas.values()
                                        if rep.serve is not None),
            },
            "prefix": None if self.directory is None else {
                "imports": self.stats["prefix_imports"],
                "import_pages": self.stats["prefix_import_pages"],
                "import_fallbacks": self.stats["prefix_import_fallbacks"],
                "imports_paused": self.stats["prefix_imports_paused"],
                "directory": self.directory.summary(),
            },
            "failover": {
                "kills": len(self.kill_records),
                "requeued": self.stats["failovers"],
                "recovery_times": [round(t, 6) for t in self.recovery_times],
                "unrecovered": sum(1 for r in self.kill_records
                                   if r["recovered_ts"] is None),
            },
            "ttft": percentile_summary([r.ttft for r in done if r.ttft is not None]),
            "tpot": percentile_summary([r.tpot for r in done if r.tpot is not None]),
            "e2e": percentile_summary([r.e2e for r in done if r.e2e is not None]),
            "tenants": self._tenant_summary(done),
            "control_plane": None if self.transport is None else {
                "transport": self.transport.summary(),
                "lease": self.lease.summary(),
                "lease_expirations": self.stats["lease_expirations"],
                "fenced_replicas": self.stats["fenced_replicas"],
                "fenced_completions": self.stats["fenced_completions"],
                "fenced_requests": self.stats["fenced_requests"],
                "publish_gaps": self.stats["publish_gaps"],
                "dir_resyncs": self.stats["dir_resyncs"],
                "warmup_imports": self.stats["warmup_imports"],
                "warmup_fallbacks": self.stats["warmup_fallbacks"],
                "partition_dispatch_skips":
                    self.stats["partition_dispatch_skips"],
                "lifecycle": {
                    "cmds": self.stats["lifecycle_cmds"],
                    "applied": self.stats["lifecycle_applied"],
                    "acked": self.stats["lifecycle_acked"],
                    "stale_acks": self.stats["lifecycle_stale_acks"],
                    "aborted": self.stats["lifecycle_aborted"],
                    "send_faults": self.stats["lifecycle_send_faults"],
                },
            },
            "overload": None if self.overload is None else self.overload.summary(),
            "slo": None if self.slo is None else self.slo.summary(),
            "recorder": None if self.recorder is None
            else self.recorder.summary(),
            "shed": self.stats["shed"],
            "brownout_capped": self.stats["brownout_capped"],
            "kv_quota_rejects": self.stats["kv_quota_rejects"],
            "health_transitions": len(self.pool.health.history),
        }

    def _tenant_summary(self, done: List[FleetRequest]) -> dict:
        """Per-tenant goodput/violation record.  ``sla_violations`` counts
        timeouts plus DONE-but-late completions plus (when the tenant has a
        ``ttft_slo``) on-time completions whose TTFT still blew the
        per-tenant budget; ``closed`` is the conservation receipt the
        property audit pins: submitted == completed+timed_out+rejected."""
        out = {}
        for name in sorted(self.tenant_stats):
            t = dict(self.tenant_stats[name])
            spec = self.tenants.spec(name)
            mine = [r for r in done if r.tenant == name]
            late = sum(1 for r in mine if not r.met_deadline)
            slo_miss = 0
            if spec.ttft_slo is not None:
                slo_miss = sum(1 for r in mine
                               if r.met_deadline and r.ttft is not None
                               and r.ttft > spec.ttft_slo)
            t["sla_violations"] = t["timed_out"] + late + slo_miss
            t["weight"] = spec.weight
            t["best_effort"] = spec.best_effort
            t["ttft"] = percentile_summary(
                [r.ttft for r in mine if r.ttft is not None])
            t["closed"] = (t["submitted"] ==
                           t["completed"] + t["timed_out"] + t["rejected"])
            out[name] = t
        return out

    def _next_event_step(self) -> int:
        self._events_step += 1
        return self._events_step

    def _emit(self, events) -> None:
        if self.monitor is None or not getattr(self.monitor, "enabled", True):
            return
        try:
            self.monitor.write_events(events)
        except _fi.InjectedCrash:
            raise  # simulated process death; chaos tests must see it
        except Exception as e:  # monitoring must never take down routing
            logger.warning(f"fleet monitor write failed: {e}")
