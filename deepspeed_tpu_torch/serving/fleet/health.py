"""Replica health state machine: HEALTHY → DEGRADED → DEAD → RECOVERING.

The fleet router must keep dispatching while individual replicas misbehave,
so every replica carries an explicit health state the router's policies
consult (``dispatchable``) and the pool's failover path keys off
(``serving``).  Signals come from the resilience layer the training side
already uses: transient ``OSError``\\ s degrade, repeated ones (or a
device-loss classification — :class:`~..resilience.watchdog.StepHungError`,
:class:`~..resilience.fault_injection.DeviceLossError`, any error whose
message carries the ``DEVICE_LOST`` marker, or
:class:`~..resilience.fault_injection.InjectedCrash`) kill.

::

    HEALTHY ──errors──▶ DEGRADED ──more errors──▶ DEAD
       ▲  ▲              │    │                    │
       │  └──successes───┘    └───────fatal────────┤
       │                                           ▼
       └───────── probe ticks ────────────── RECOVERING
                                                   │ (probe failure)
                                                   ▼
                                                  DEAD

    HEALTHY | DEGRADED ──drain()──▶ DRAINING ──restart──▶ RECOVERING
    (DRAINING keeps serving its in-flight work but receives no new
     dispatches; a kill during DRAINING still goes to DEAD)

Transitions are validated — an illegal one is a tracker bug and raises —
and every transition is recorded in ``history`` and emitted as a
``fleet/health/<state>`` monitor event, so a fleet sim's failover timeline
is auditable on the surface operators already watch.
"""

import dataclasses
import enum
from typing import Callable, Dict, List, Optional, Tuple

from ...utils.logging import logger


class LeaseState(enum.Enum):
    """The ROUTER's partition-tolerant belief about one replica, derived
    purely from heartbeats over the control transport (docs/SERVING.md
    "Control-plane transport").  Distinct from :class:`ReplicaState`,
    which is the replica-LOCAL truth the pool tracks from tick outcomes:
    under a partition the two legitimately disagree — a perfectly healthy
    replica the router cannot hear from is lease-DEAD at the router while
    staying HEALTHY at the pool, and fencing is what reconciles them."""
    ALIVE = "alive"        # lease fresh: heartbeats arriving inside the window
    SUSPECT = "suspect"    # lease expiring: no new dispatches, work stays put
    DEAD = "dead"          # lease expired: fleet-declared death, work re-dispatched
    FENCING = "fencing"    # heartbeats resumed from a fleet-dead replica (a
    #                        zombie, or a legit recovery): a FENCE is in
    #                        flight; the replica rejoins only after the ack


#: validated lease transitions (dslint state-machine table; the generated
#: docs/STATE_MACHINES.md renders it).  ALIVE can expire straight to DEAD:
#: a long idle jump may land past the whole suspect window in one tick.
#: DEAD leaves only through FENCING — a fleet-dead replica's first
#: heartbeat starts a fencing episode, never a silent rejoin.
_LEASE_ALLOWED = {
    LeaseState.ALIVE: {LeaseState.SUSPECT, LeaseState.DEAD},
    LeaseState.SUSPECT: {LeaseState.ALIVE, LeaseState.DEAD},
    LeaseState.DEAD: {LeaseState.FENCING},
    LeaseState.FENCING: {LeaseState.ALIVE},
}


@dataclasses.dataclass(frozen=True)
class LeaseConfig:
    #: heartbeat silence (seconds of clock time since the newest heartbeat's
    #: SEND timestamp) after which a replica turns SUSPECT — dispatchable no
    #: more, but its in-flight work is left alone
    suspect_after: float = 2.0
    #: silence after which the lease expires: the router declares the
    #: replica fleet-dead, re-dispatches its work, and bumps its dispatch
    #: epoch so any surviving zombie's late completions are fenced off
    lease: float = 6.0
    #: minimum clock time between FENCE (re)sends to an unacked zombie
    fence_retry: float = 2.0
    #: ADAPTIVE LEASE SIZING (r21, docs/SERVING.md "Closed-loop control").
    #: Off by default: the fixed constants above hold and behavior is
    #: byte-identical to r20.  When on, each replica's effective
    #: suspect_after/lease is the base value times a per-replica scale in
    #: [1, max_scale], derived from the heartbeat interarrival EWMA, the
    #: per-link ``transport/link_loss_ewma``, and the standing
    #: ``transport/feed_gap_age`` — a fleet whose steps legitimately slow
    #: widens its leases instead of fencing healthy replicas, and
    #: tightens back when the links recover.
    adaptive: bool = False
    #: ceiling of the per-replica scale band: the effective lease never
    #: exceeds ``lease * max_scale`` — a real death is still detected
    #: within a bounded window (the BENCH receipt pins this)
    max_scale: float = 4.0
    #: silence tolerance in heartbeat interarrivals: the effective
    #: suspect_after targets ``miss_budget`` consecutive missed beats
    #: (loss-inflated: /(1 - link_loss_ewma)) before suspecting
    miss_budget: float = 3.0
    #: EWMA alpha for the heartbeat interarrival estimate
    interarrival_alpha: float = 0.3
    #: weight of the standing directory-feed gap age in the target
    #: (a stalling feed is fabric delay evidence, not death evidence)
    feed_gap_weight: float = 0.5
    #: hysteresis deadband: widen only when the target scale exceeds the
    #: current by this fraction ...
    widen_frac: float = 0.1
    #: ... and tighten only when it falls below by this (tighten > widen:
    #: widening is the false-fence guard, so it reacts faster)
    tighten_frac: float = 0.25

    def __post_init__(self):
        if not 0 < self.suspect_after < self.lease:
            raise ValueError(f"lease needs 0 < suspect_after < lease "
                             f"(got {self.suspect_after}, {self.lease})")
        if self.fence_retry <= 0:
            raise ValueError(f"fence_retry must be > 0, got {self.fence_retry}")
        if self.max_scale < 1.0:
            raise ValueError(f"max_scale must be >= 1, got {self.max_scale}")
        if self.miss_budget <= 0:
            raise ValueError(f"miss_budget must be > 0, got {self.miss_budget}")
        if not 0.0 < self.interarrival_alpha <= 1.0:
            raise ValueError(f"interarrival_alpha must be in (0, 1], got "
                             f"{self.interarrival_alpha}")
        if self.feed_gap_weight < 0:
            raise ValueError(f"feed_gap_weight must be >= 0, got "
                             f"{self.feed_gap_weight}")
        if self.widen_frac < 0 or not 0.0 <= self.tighten_frac < 1.0:
            raise ValueError(f"hysteresis fracs out of range (widen "
                             f"{self.widen_frac}, tighten {self.tighten_frac})")


class FleetHealthView:
    """Heartbeat-lease health: what the router can DEFENSIBLY believe
    about each replica when its only evidence is messages that may be
    lost, late, duplicated or partitioned away.

    Per replica it tracks the newest heartbeat (by sequence number — a
    reordered older heartbeat never rewinds the view), the last-known-good
    ``load_stats`` snapshot with its age (the staleness annotation routing
    and autoscaling read), the replica's self-reported local health state,
    and a monotonically increasing **dispatch epoch** that bumps on every
    lease expiry — the fencing token that makes a zombie's late
    completions discardable."""

    def __init__(self, replica_ids, config: LeaseConfig = None, clock=None,
                 emit: Optional[Callable[[str, float], None]] = None,
                 recorder=None):
        self.config = config or LeaseConfig()
        self._clock = clock
        self._emit_cb = emit
        #: optional flight recorder: lease lifecycles become first-class
        #: interval tracks — one ``ctrl/lease/replica/<rid>`` track per
        #: replica whose ``ctrl/lease/<state>`` intervals tile the run
        #: (ALIVE→SUSPECT→DEAD→FENCING→ALIVE visible at a glance in the
        #: crash dump, docs/OBSERVABILITY.md "Flight recorder")
        self.recorder = recorder
        t0 = clock.now() if clock is not None else 0.0
        rids = list(replica_ids)
        if recorder is not None:
            for rid in rids:
                recorder.note_state(f"ctrl/lease/replica/{rid}",
                                    f"ctrl/lease/{LeaseState.ALIVE.value}", t0)
        # the initial lease is granted at construction: a replica that
        # never heartbeats at all still expires on schedule
        self._last_hb: Dict[int, float] = {r: t0 for r in rids}
        self._last_seq: Dict[int, int] = {r: 0 for r in rids}
        self._reported: Dict[int, str] = {r: ReplicaState.HEALTHY.value for r in rids}
        self._stats: Dict[int, Optional[dict]] = {r: None for r in rids}
        self._stats_ts: Dict[int, float] = {r: t0 for r in rids}
        self._state: Dict[int, LeaseState] = {r: LeaseState.ALIVE for r in rids}
        #: newest self-reported engine generation — a restart INSIDE the
        #: lease window renews the lease but bumps this, which is how the
        #: router learns its old attempts died with the old engine
        self._generation: Dict[int, Optional[int]] = {r: None for r in rids}
        self._fence_sent_ts: Dict[int, Optional[float]] = {r: None for r in rids}
        #: per-replica dispatch epoch; bumped at every lease expiry
        self.epoch: Dict[int, int] = {r: 0 for r in rids}
        #: (rid, from, to, ts, reason) — the auditable lease timeline
        self.history: List[Tuple[int, LeaseState, LeaseState, float, str]] = []
        # --- adaptive lease sizing state (inert while config.adaptive is
        # off: every scale stays 1.0 and the fixed constants hold) ---
        #: per-replica lease scale in [1, max_scale]; effective
        #: suspect_after/lease are the base values times this
        self._scale: Dict[int, float] = {r: 1.0 for r in rids}
        #: heartbeat interarrival EWMA (send-timestamp gaps; None until
        #: the first gap is observed)
        self._hb_gap_ewma: Dict[int, Optional[float]] = {r: None for r in rids}
        #: freshest router-fed link-quality signals (note_link_quality)
        self._link_loss: Dict[int, float] = {r: 0.0 for r in rids}
        self._feed_gap_age: Dict[int, float] = {r: 0.0 for r in rids}
        #: (rid, ts, old_scale, new_scale, direction) — the auditable
        #: resize timeline behind every ``fleet/lease_resize`` event
        self.resizes: List[Tuple[int, float, float, float, str]] = []

    # ------------------------------------------------------------- queries

    def state(self, rid: int) -> LeaseState:
        return self._state[rid]

    def states(self) -> Dict[int, LeaseState]:
        return dict(self._state)

    def dispatchable(self, rid: int) -> bool:
        """May the router hand this replica NEW work?  Requires a fresh
        lease AND a self-reported dispatchable local state (a DRAINING or
        RECOVERING replica heartbeats, but takes no new dispatches)."""
        if self._state[rid] is not LeaseState.ALIVE:
            return False
        try:
            return ReplicaState(self._reported[rid]).dispatchable
        except ValueError:
            return False

    def stats(self, rid: int):
        """``(last_known_good_load_stats, age_seconds)`` — the staleness-
        annotated routing signal.  ``(None, age)`` before any heartbeat."""
        now = self._clock.now() if self._clock is not None else 0.0
        return self._stats[rid], max(0.0, now - self._stats_ts[rid])

    def generation(self, rid: int) -> Optional[int]:
        """Newest self-reported engine generation (None before any
        heartbeat)."""
        return self._generation[rid]

    def effective_lease(self, rid: int) -> Tuple[float, float]:
        """``(suspect_after, lease)`` currently in force for ``rid`` —
        the configured base times the replica's adaptive scale (exactly
        the base values while the scale sits at 1.0, so the static
        configuration stays byte-identical)."""
        s = self._scale[rid]
        if s == 1.0:
            return self.config.suspect_after, self.config.lease
        return (round(self.config.suspect_after * s, 9),
                round(self.config.lease * s, 9))

    # ------------------------------------------------- adaptive lease sizing

    def note_link_quality(self, rid: int, loss_ewma: float,
                          feed_gap_age: float, now: float) -> None:
        """Fold the router's per-link fabric evidence — the r18
        ``transport/link_loss_ewma`` and ``transport/feed_gap_age``
        signals — and re-derive the replica's lease scale.  No-op unless
        ``config.adaptive``; called once per control round from
        ``Router.transport_poll`` in sorted-rid order, so the resize
        timeline is deterministic."""
        if not self.config.adaptive:
            return
        self._link_loss[rid] = loss_ewma
        self._feed_gap_age[rid] = feed_gap_age
        self._resize(rid, now)

    def _resize(self, rid: int, now: float) -> None:
        """Recompute ``rid``'s lease scale from the closed-loop inputs,
        with hysteresis (widen fast — it is the false-fence guard —
        tighten slow) and the [1, max_scale] clamp that keeps real-death
        detection bounded.  Every applied adjustment is an auditable
        ``fleet/lease_resize`` event."""
        cfg = self.config
        gap = self._hb_gap_ewma[rid]
        if gap is None:
            return  # no interarrival evidence yet: the configured base holds
        # target silence tolerance: miss_budget interarrivals, inflated by
        # the link's observed loss (p lost => 1/(1-p) expected sends per
        # arrival), plus the standing feed gap (fabric delay, not death)
        loss = min(self._link_loss[rid], 0.75)
        target_suspect = cfg.miss_budget * gap / (1.0 - loss) \
            + cfg.feed_gap_weight * self._feed_gap_age[rid]
        target = min(max(target_suspect / cfg.suspect_after, 1.0),
                     cfg.max_scale)
        target = round(target, 9)
        cur = self._scale[rid]
        if target > cur * (1.0 + cfg.widen_frac):
            direction = "widen"
        elif target < cur * (1.0 - cfg.tighten_frac):
            direction = "tighten"
        else:
            return  # inside the hysteresis deadband: hold
        self._scale[rid] = target
        ts = round(now, 9)
        self.resizes.append((rid, ts, cur, target, direction))
        self._emit("fleet/lease_resize", float(rid))
        if self.recorder is not None:
            self.recorder.instant(
                "ctrl/lease_resize", f"ctrl/lease/replica/{rid}", now,
                attrs={"direction": direction, "scale": target,
                       "gap_ewma": round(gap, 9), "loss": round(loss, 9)})
        logger.info(f"fleet lease: replica {rid} {direction} scale "
                    f"{cur:.3f} -> {target:.3f}")

    # --------------------------------------------------------- transitions

    def _to(self, rid: int, state: LeaseState, ts: float, reason: str) -> None:
        cur = self._state[rid]
        if state is cur:
            return
        if state not in _LEASE_ALLOWED[cur]:
            raise ValueError(f"replica {rid}: illegal lease transition "
                             f"{cur.value} -> {state.value} ({reason})")
        self._state[rid] = state
        self.history.append((rid, cur, state, ts, reason))
        if self.recorder is not None:
            self.recorder.note_state(f"ctrl/lease/replica/{rid}",
                                     f"ctrl/lease/{state.value}", ts,
                                     attrs={"reason": reason,
                                            "epoch": self.epoch[rid]})
        logger.info(f"fleet lease: replica {rid} {cur.value} -> {state.value} "
                    f"({reason})")

    def _emit(self, name: str, value: float) -> None:
        if self._emit_cb is not None:
            self._emit_cb(name, value)

    # ------------------------------------------------------------- signals

    def observe_heartbeat(self, rid: int, seq: int, state: str, stats: dict,
                          sent_ts: float, now: float,
                          generation: Optional[int] = None) -> str:
        """Fold one delivered heartbeat.  Returns what the router must do:

        * ``"ok"``         — lease renewed (SUSPECT heals back to ALIVE);
        * ``"stale"``      — an old/duplicate heartbeat (seq not newer):
          lease extended no further than its send time, view unchanged;
        * ``"zombie"``     — the heartbeat came from a replica the router
          declared fleet-dead: it must be FENCED before it may rejoin
          (``"zombie"`` is returned again for every further heartbeat
          until the fence acks — the router's retry timer, not this
          return value, paces the resends).
        """
        if seq <= self._last_seq[rid]:
            return "stale"
        self._last_seq[rid] = seq
        if generation is not None:
            self._generation[rid] = generation
        cur = self._state[rid]
        if cur in (LeaseState.DEAD, LeaseState.FENCING):
            # a fleet-dead replica is heartbeating again: either the
            # partition healed (zombie — its fenced work must be cancelled)
            # or a replacement engine attached (nothing to cancel; the
            # fence is a cheap no-op).  Either way it rejoins via the ack.
            if cur is LeaseState.DEAD:
                self._to(rid, LeaseState.FENCING, now, "heartbeat from the fleet-dead")
            # keep the freshest report visible for the eventual rejoin
            self._reported[rid] = state
            self._stats[rid] = stats
            self._stats_ts[rid] = now
            return "zombie"
        # the lease is measured from the heartbeat's SEND time: a delayed
        # heartbeat proves the replica was alive when it SENT, nothing more
        if sent_ts > self._last_hb[rid]:
            gap = sent_ts - self._last_hb[rid]
            a = self.config.interarrival_alpha
            prev = self._hb_gap_ewma[rid]
            self._hb_gap_ewma[rid] = round(gap if prev is None
                                           else (1.0 - a) * prev + a * gap, 9)
        self._last_hb[rid] = max(self._last_hb[rid], sent_ts)
        self._reported[rid] = state
        self._stats[rid] = stats
        self._stats_ts[rid] = now
        if cur is LeaseState.SUSPECT:
            self._to(rid, LeaseState.ALIVE, now, "heartbeat resumed")
            self._emit("fleet/lease_renewed", float(rid))
        return "ok"

    def tick(self, now: float) -> List[int]:
        """Advance the lease clocks: ALIVE -> SUSPECT at ``suspect_after``
        of silence, SUSPECT -> DEAD at ``lease``.  Returns the rids whose
        lease EXPIRED this tick — the router must re-dispatch their work
        (``Router.on_lease_expired``).  Epochs bump here: every dispatch
        made before this instant is fenced."""
        expired = []
        for rid in sorted(self._state):
            cur = self._state[rid]
            if cur not in (LeaseState.ALIVE, LeaseState.SUSPECT):
                continue
            suspect_after, lease = self.effective_lease(rid)
            silence = now - self._last_hb[rid]
            if silence >= lease:
                self._to(rid, LeaseState.DEAD, now,
                         f"lease expired ({silence:.3f}s of silence)")
                self.epoch[rid] += 1
                self._fence_sent_ts[rid] = None
                self._emit("fleet/lease_expired", float(rid))
                expired.append(rid)
            elif cur is LeaseState.ALIVE and silence >= suspect_after:
                self._to(rid, LeaseState.SUSPECT, now,
                         f"lease expiring ({silence:.3f}s of silence)")
                self._emit("fleet/lease_suspect", float(rid))
        return expired

    def declare_dead(self, rid: int, now: float,
                     reason: str = "router-observed death") -> None:
        """Direct death evidence — a device loss surfaced through a
        SYNCHRONOUS dispatch/staging RPC the router itself made — is as
        conclusive as a lease expiry and is recorded immediately, so the
        lease sweep does not declare (and double-account) the same death
        again when the silence catches up."""
        if self._state[rid] in (LeaseState.ALIVE, LeaseState.SUSPECT):
            self._to(rid, LeaseState.DEAD, now, reason)
            self.epoch[rid] += 1
            self._fence_sent_ts[rid] = None

    # -------------------------------------------------------------- fencing

    def fence_pending(self, now: float) -> List[int]:
        """Rids in FENCING whose fence must be (re)sent now — never sent,
        or the last send aged past ``fence_retry`` unacked (the fence/ack
        pair crosses the same lossy fabric as everything else)."""
        out = []
        for rid in sorted(self._state):
            if self._state[rid] is not LeaseState.FENCING:
                continue
            sent = self._fence_sent_ts[rid]
            if sent is None or now - sent >= self.config.fence_retry:
                out.append(rid)
        return out

    def note_fence_sent(self, rid: int, now: float) -> bool:
        """Record a fence send; returns True when it was the FIRST send of
        this fencing episode (the caller counts/emits once per episode)."""
        first = self._fence_sent_ts[rid] is None
        self._fence_sent_ts[rid] = now
        return first

    def on_fence_ack(self, rid: int, epoch: int, now: float) -> bool:
        """A replica acknowledged the fence for ``epoch``.  Stale-epoch
        acks (a reordered ack from a previous episode) are ignored.
        Returns True when the replica rejoined the fleet (ALIVE, lease
        re-granted from now)."""
        if self._state[rid] is not LeaseState.FENCING or epoch != self.epoch[rid]:
            return False
        self._last_hb[rid] = now
        self._fence_sent_ts[rid] = None
        self._to(rid, LeaseState.ALIVE, now, f"fence acked (epoch {epoch})")
        self._emit("fleet/lease_renewed", float(rid))
        return True

    # ------------------------------------------------------------- schedule

    def deadlines(self, now: float) -> List[float]:
        """Future instants at which this view can change by itself —
        suspect/expiry boundaries and fence-retry timers; the simulator's
        idle-jump input (a quiet fleet must still wake to expire a
        lease)."""
        out = []
        for rid, cur in self._state.items():
            suspect_after, lease = self.effective_lease(rid)
            if cur is LeaseState.ALIVE:
                out.append(self._last_hb[rid] + suspect_after)
                out.append(self._last_hb[rid] + lease)
            elif cur is LeaseState.SUSPECT:
                out.append(self._last_hb[rid] + lease)
            elif cur is LeaseState.FENCING:
                sent = self._fence_sent_ts[rid]
                out.append(now if sent is None
                           else sent + self.config.fence_retry)
            elif cur is LeaseState.DEAD:
                pass  # no self-scheduled wake-up: a rejoin is driven by the
                # zombie's own heartbeat, which is a delivery, not a timer
        return [t for t in out if t > now]

    def summary(self) -> dict:
        return {
            "states": {r: s.value for r, s in sorted(self._state.items())},
            "epochs": dict(sorted(self.epoch.items())),
            "transitions": len(self.history),
            "lease_resizes": len(self.resizes),
            "scales": {r: s for r, s in sorted(self._scale.items())
                       if s != 1.0},
        }


class ReplicaState(enum.Enum):
    HEALTHY = "healthy"
    DEGRADED = "degraded"     # serving, but deprioritized for new dispatch
    DRAINING = "draining"     # serving in-flight work only (rolling restart)
    DEAD = "dead"             # gone: in-flight requests must fail over
    RECOVERING = "recovering" # fresh engine warming; probe ticks decide

    @property
    def serving(self) -> bool:
        """May this replica run ticks (in-flight work keeps moving)?"""
        return self in (ReplicaState.HEALTHY, ReplicaState.DEGRADED,
                        ReplicaState.DRAINING, ReplicaState.RECOVERING)

    @property
    def dispatchable(self) -> bool:
        """May the router hand this replica NEW work?"""
        return self in (ReplicaState.HEALTHY, ReplicaState.DEGRADED)


_ALLOWED = {
    ReplicaState.HEALTHY: {ReplicaState.DEGRADED, ReplicaState.DRAINING, ReplicaState.DEAD},
    ReplicaState.DEGRADED: {ReplicaState.HEALTHY, ReplicaState.DRAINING, ReplicaState.DEAD},
    ReplicaState.DRAINING: {ReplicaState.RECOVERING, ReplicaState.DEAD},
    ReplicaState.DEAD: {ReplicaState.RECOVERING},
    ReplicaState.RECOVERING: {ReplicaState.HEALTHY, ReplicaState.DEAD},
}


def classify_fatal(exc: BaseException) -> bool:
    """Device-loss classification, mirroring ``DSElasticAgent``'s: hung
    steps, injected/real device losses and simulated process death are
    fatal to the replica; plain transient ``OSError``\\ s are not."""
    from ...resilience.fault_injection import DeviceLossError, InjectedCrash
    from ...resilience.watchdog import StepHungError
    if isinstance(exc, (DeviceLossError, StepHungError, InjectedCrash)):
        return True
    return "DEVICE_LOST" in str(exc)


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    # consecutive transient errors before HEALTHY degrades
    degrade_after: int = 1
    # consecutive transient errors before a (degraded) replica is declared
    # dead — repeated I/O failure on every tick is indistinguishable from a
    # lost host to the fleet
    dead_after: int = 3
    # consecutive successful ticks for DEGRADED to heal back to HEALTHY
    heal_after: int = 2
    # successful probe ticks for RECOVERING to graduate to HEALTHY
    recover_probe_ticks: int = 1


class HealthTracker:
    """Per-replica health states + validated transitions for one fleet."""

    def __init__(self, replica_ids, config: HealthConfig = None,
                 emit: Optional[Callable[[str, float], None]] = None,
                 clock=None):
        self.config = config or HealthConfig()
        self._emit = emit
        self._clock = clock
        self._state: Dict[int, ReplicaState] = {r: ReplicaState.HEALTHY for r in replica_ids}
        self._errors: Dict[int, int] = {r: 0 for r in replica_ids}      # consecutive
        self._successes: Dict[int, int] = {r: 0 for r in replica_ids}   # consecutive
        #: (rid, from, to, ts, reason) — the auditable failover timeline
        self.history: List[Tuple[int, ReplicaState, ReplicaState, float, str]] = []

    # ------------------------------------------------------------- queries

    def state(self, rid: int) -> ReplicaState:
        return self._state[rid]

    def serving(self, rid: int) -> bool:
        return self._state[rid].serving

    def dispatchable(self, rid: int) -> bool:
        return self._state[rid].dispatchable

    def replicas_in(self, *states: ReplicaState) -> List[int]:
        return sorted(r for r, s in self._state.items() if s in states)

    # --------------------------------------------------------- transitions

    def _now(self) -> float:
        return self._clock.now() if self._clock is not None else 0.0

    def _to(self, rid: int, state: ReplicaState, reason: str) -> None:
        cur = self._state[rid]
        if state is cur:
            return
        if state not in _ALLOWED[cur]:
            raise ValueError(f"replica {rid}: illegal health transition "
                             f"{cur.value} -> {state.value} ({reason})")
        ts = self._now()
        self._state[rid] = state
        self._errors[rid] = 0
        self._successes[rid] = 0
        self.history.append((rid, cur, state, ts, reason))
        logger.info(f"fleet health: replica {rid} {cur.value} -> {state.value} ({reason})")
        if self._emit is not None:
            self._emit(f"fleet/health/{state.value}", float(rid))

    # ------------------------------------------------------------- signals

    def record_success(self, rid: int) -> None:
        """One successful tick: heals DEGRADED after a streak, graduates
        RECOVERING after its probe quota."""
        self._errors[rid] = 0
        self._successes[rid] += 1
        cur = self._state[rid]
        if cur is ReplicaState.DEGRADED and self._successes[rid] >= self.config.heal_after:
            self._to(rid, ReplicaState.HEALTHY, "success streak")
        elif cur is ReplicaState.RECOVERING and \
                self._successes[rid] >= self.config.recover_probe_ticks:
            self._to(rid, ReplicaState.HEALTHY, "probe ticks passed")

    def record_error(self, rid: int, exc: BaseException) -> ReplicaState:
        """Classify one tick failure; returns the resulting state (the pool
        checks for DEAD to trigger failover)."""
        if classify_fatal(exc):
            if self._state[rid] is ReplicaState.RECOVERING:
                self._to(rid, ReplicaState.DEAD, f"probe failure: {exc}")
            else:
                self._to(rid, ReplicaState.DEAD, f"device loss: {exc}")
            return self._state[rid]
        self._successes[rid] = 0
        self._errors[rid] += 1
        cur = self._state[rid]
        if cur is ReplicaState.RECOVERING:
            # transient errors during the probe: the fresh engine cannot even
            # tick — treat as a failed recovery, don't oscillate
            self._to(rid, ReplicaState.DEAD, f"probe failure: {exc}")
        elif self._errors[rid] >= self.config.dead_after:
            self._to(rid, ReplicaState.DEAD,
                     f"{self._errors[rid]} consecutive transient errors")
        elif cur is ReplicaState.HEALTHY and self._errors[rid] >= self.config.degrade_after:
            self._to(rid, ReplicaState.DEGRADED, f"transient error: {exc}")
        return self._state[rid]

    def kill(self, rid: int, reason: str = "killed") -> None:
        """Operator/simulator-declared replica loss."""
        self._to(rid, ReplicaState.DEAD, reason)

    def drain(self, rid: int) -> None:
        """Stop new dispatches; in-flight work finishes (rolling restart)."""
        self._to(rid, ReplicaState.DRAINING, "drain requested")

    def recovering(self, rid: int, reason: str = "fresh engine attached") -> None:
        """A replacement engine is attached (from DEAD, or from a drained
        DRAINING replica being restarted)."""
        self._to(rid, ReplicaState.RECOVERING, reason)
