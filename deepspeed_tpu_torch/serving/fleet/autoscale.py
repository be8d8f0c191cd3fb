"""Overload control plane: SLA autoscaler + graceful-degradation ladder.

The fleet so far was a fixed N with scripted kills: under a flash crowd
it could only reject at the front door.  This module closes the loop the
DeepSpeed blueprint's elasticity layer (``DSElasticAgent``) implies for
serving — a deterministic policy loop that reads the signals the stack
already exposes (per-replica ``load_stats()``, fleet queue depth, a TTFT
EWMA folded from completions) and acts through the EXISTING replica
lifecycle, so no new failure modes are invented:

* **scale up** — a ``recover`` lifecycle command on a parked (DEAD)
  replica: the fresh engine warms through the RECOVERING probe path
  before it takes dispatches, exactly like a replacement host joining;
* **scale down** — a ``drain`` command then, only once the replica is
  IDLE, a ``park``.  In-flight work is NEVER killed by a scale decision;
  a device loss *during* the drain fails the victims over through the
  ordinary recompute-on-resume path with byte-identical outputs
  (chaos-tested).
* **hysteresis + cooldown** — separate up/down thresholds, a consecutive
  low-streak requirement, and per-direction cooldowns, so the fleet does
  not flap between sizes on a noisy boundary.
* **predictive scale-up** (``predictive=True``) — provision from the
  demand FORECAST: the router's arrival-rate EWMA projected along its
  slope to the replica warm-up horizon, plus premium-tenant SLO
  fast-burn; the reactive thresholds above stay armed as the safety net.
* **role-aware rebalancing** (``role_aware=True``) — when one serving
  phase's pressure dwarfs the other's, drain one replica of the
  over-provisioned phase and re-role it toward the starved one
  (MIXED <-> PREFILL/DECODE), through the same drain-gated path.

Every mutation flows through ``Router.lifecycle_command``: the direct
pool calls without a control transport (byte-identical to the pre-r21
autoscaler), typed + seq-numbered + epoch-fenced + retried-until-acked
``lifecycle_cmd`` messages under one — a partitioned or fenced replica
can never act on (or double-apply) a stale scale decision.

Alongside it the :class:`OverloadController` runs the graceful-
degradation ladder: when shedding capacity is not enough, the fleet
BROWNS OUT in explicit, auditable rungs rather than falling over —

    rung 1  cap max_new_tokens for best-effort tenants
    rung 2  disable speculative decoding (greedy parity: outputs identical)
    rung 3  pause starting KV migrations / prefix imports
    rung 4  shed best-effort admissions with a retry-after hint

and steps back DOWN the same rungs symmetrically as pressure clears.
Every move emits a ``fleet/overload_step_up``/``_step_down`` event and is
recorded with per-rung occupancy time, so a bench can assert that every
rung entered was also exited.

Determinism: decisions are pure functions of clock time and fleet state,
probed through the ``autoscaler.decide`` fault-injection site — the same
flash crowd replays the same decision sequence byte-for-byte on every
run and machine (the ``BENCH_ROUTER.json`` ``autoscale`` receipt).
"""

import dataclasses
from typing import Dict, List, Optional, Tuple

from ...resilience import fault_injection as _fi
from ...utils.logging import logger
from .health import ReplicaState
from .pool import ReplicaRole
from .tenancy import TenantSpec

# ---------------------------------------------------------------- overload


#: the graceful-degradation ladder, rung 0 = normal service.  Order is the
#: escalation order; stepping down retraces it symmetrically.
RUNGS = ("normal", "cap_tokens", "no_spec", "pause_migration",
         "shed_best_effort")


@dataclasses.dataclass(frozen=True)
class OverloadConfig:
    #: pressure at/above which the ladder steps UP one rung
    hi: float = 1.0
    #: pressure at/below which it steps back DOWN (hysteresis band)
    lo: float = 0.6
    #: min clock time between rung moves (no flapping)
    cooldown: float = 3.0
    #: rung >= 1: max_new_tokens cap applied to best-effort admissions
    token_cap: int = 8
    #: retry-after hint stamped on rung-4 shed rejections
    retry_after: float = 8.0

    def __post_init__(self):
        if not self.lo < self.hi:
            raise ValueError(f"overload hysteresis needs lo < hi "
                             f"(got lo={self.lo}, hi={self.hi})")
        if self.token_cap < 1:
            raise ValueError(f"token_cap must be >= 1, got {self.token_cap}")


class OverloadController:
    """Explicit brownout ladder; see module docstring for the rungs."""

    def __init__(self, config: OverloadConfig = None, emit=None,
                 recorder=None):
        self.config = config or OverloadConfig()
        self._emit = emit            # emit(name, value) or None
        #: optional flight recorder: rung occupancy becomes a first-class
        #: interval track (``ctrl/overload/<rung>`` on track
        #: ``ctrl/overload``) — how long the fleet sat on each brownout
        #: rung is readable straight off the crash dump
        self.recorder = recorder
        self.rung = 0
        self.shed_count = 0
        #: (ts, "up"/"down", new_rung, pressure) per move — the audit log
        self.moves: List[Tuple[float, str, int, float]] = []
        self.entered: Dict[int, int] = {}    # rung -> times entered
        self.exited: Dict[int, int] = {}     # rung -> times exited
        self.occupancy: Dict[int, float] = {r: 0.0 for r in range(len(RUNGS))}
        self._last_move: Optional[float] = None
        self._last_ts: Optional[float] = None

    def bind(self, emit) -> None:
        """Attach the event sink (the router's monitor emitter)."""
        self._emit = emit

    # ------------------------------------------------------------- queries

    @property
    def token_cap_active(self) -> bool:
        return self.rung >= 1

    @property
    def spec_disabled(self) -> bool:
        return self.rung >= 2

    @property
    def migrations_paused(self) -> bool:
        return self.rung >= 3

    def shed(self, spec: TenantSpec) -> bool:
        """Should this tenant's admission be shed right now?  Only
        best-effort tenants are ever shed — premium/standard traffic rides
        the ladder's milder rungs and the autoscaler's added capacity."""
        return self.rung >= 4 and spec.best_effort

    # ------------------------------------------------------------- updates

    def update(self, now: float, pressure: float) -> None:
        """Fold elapsed occupancy and move at most ONE rung, respecting
        the hysteresis band and cooldown.  ``pressure`` is the control
        plane's scalar overload signal (1.0 = at the SLO boundary)."""
        if self._last_ts is None and self.recorder is not None:
            # first observation: open the current (normal) rung's interval
            self._note_rung(now)
        if self._last_ts is not None and now > self._last_ts:
            self.occupancy[self.rung] += now - self._last_ts
        self._last_ts = now
        if self._last_move is not None and \
                now - self._last_move < self.config.cooldown:
            return
        if pressure >= self.config.hi and self.rung < len(RUNGS) - 1:
            self.rung += 1
            self.entered[self.rung] = self.entered.get(self.rung, 0) + 1
            self.moves.append((round(now, 9), "up", self.rung,
                               round(pressure, 9)))
            self._last_move = now
            self._note_rung(now, pressure)
            logger.warning(f"overload ladder UP -> rung {self.rung} "
                           f"({RUNGS[self.rung]}) at pressure {pressure:.3f}")
            if self._emit is not None:
                self._emit("fleet/overload_step_up", float(self.rung))
        elif pressure <= self.config.lo and self.rung > 0:
            self.exited[self.rung] = self.exited.get(self.rung, 0) + 1
            self.rung -= 1
            self.moves.append((round(now, 9), "down", self.rung,
                               round(pressure, 9)))
            self._last_move = now
            self._note_rung(now, pressure)
            logger.info(f"overload ladder DOWN -> rung {self.rung} "
                        f"({RUNGS[self.rung]}) at pressure {pressure:.3f}")
            if self._emit is not None:
                self._emit("fleet/overload_step_down", float(self.rung))

    def _note_rung(self, now: float, pressure: Optional[float] = None) -> None:
        if self.recorder is None:
            return
        attrs = {"rung": self.rung}
        if pressure is not None:
            attrs["pressure"] = round(pressure, 9)
        self.recorder.note_state("ctrl/overload",
                                 f"ctrl/overload/{RUNGS[self.rung]}", now,
                                 attrs=attrs)

    def record_shed(self) -> None:
        self.shed_count += 1

    def finalize(self, now: float) -> None:
        """Close the occupancy accounting at end of run."""
        if self._last_ts is not None and now > self._last_ts:
            self.occupancy[self.rung] += now - self._last_ts
        self._last_ts = now

    def summary(self) -> dict:
        """The auditable ladder record: every rung entered must also have
        been exited for ``balanced`` to hold (equivalently: final rung 0)."""
        balanced = self.rung == 0 and all(
            self.entered.get(r, 0) == self.exited.get(r, 0)
            for r in range(1, len(RUNGS)))
        return {
            "rung": self.rung,
            "rungs": list(RUNGS),
            "moves": [list(m) for m in self.moves],
            "entered": {RUNGS[r]: n for r, n in sorted(self.entered.items())},
            "exited": {RUNGS[r]: n for r, n in sorted(self.exited.items())},
            "occupancy": {RUNGS[r]: round(t, 6)
                          for r, t in sorted(self.occupancy.items()) if t > 0
                          or r == 0},
            "shed": self.shed_count,
            "balanced": balanced,
        }


# -------------------------------------------------------------- autoscaler


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    #: availability floor: the autoscaler recovers parked replicas to keep
    #: at least this many provisioned, load or no load
    min_replicas: int = 1
    #: provisioning ceiling (defaults to the pool size)
    max_replicas: Optional[int] = None
    #: the fleet TTFT budget the pressure signal is normalized against
    ttft_slo: float = 40.0
    #: TTFT-EWMA fraction of the SLO at/above which pressure reads 1.0
    up_frac: float = 0.8
    #: queued-requests-per-dispatchable-replica at which pressure reads 1.0
    queue_hi: float = 3.0
    #: scale DOWN only while outstanding-per-dispatchable stays at/below this
    queue_lo: float = 0.5
    #: consecutive low evaluations required before a scale-down drain starts
    down_streak: int = 3
    #: min time between scale-ups / between scale-downs (anti-flap)
    cooldown_up: float = 2.0
    cooldown_down: float = 8.0
    #: min time between decision evaluations
    decide_interval: float = 1.0
    #: TTFT EWMA smoothing (weight of each new completion)
    ewma_alpha: float = 0.3
    #: provision from the demand FORECAST — the router's arrival-rate
    #: EWMA projected along its slope to ``warmup_horizon``, plus
    #: premium-tenant SLO fast-burn — instead of waiting for queue/TTFT
    #: pressure to confirm the crowd already arrived (reactive thresholds
    #: stay armed underneath as the safety net)
    predictive: bool = False
    #: seconds a recovered replica needs before it takes dispatches — the
    #: horizon the demand forecast is projected to: capacity ordered NOW
    #: is only useful against the demand arriving THEN
    warmup_horizon: float = 4.0
    #: requests/second one dispatchable replica absorbs inside SLO — the
    #: capacity yardstick the forecast is compared against
    per_replica_rate: float = 1.0
    #: reassign replica roles (MIXED <-> PREFILL/DECODE) from phase
    #: imbalance, drain-gated so no in-flight work is lost
    role_aware: bool = False
    #: the starved phase's per-capable-replica pressure must exceed the
    #: other phase's by this factor before a role moves (hysteresis)
    role_imbalance: float = 1.5
    #: min time between role reassignments (a role change costs a drain
    #: plus a restart — it must not flap)
    role_cooldown: float = 8.0

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError(f"min_replicas must be >= 1, got {self.min_replicas}")
        if not self.queue_lo < self.queue_hi:
            raise ValueError(f"autoscale hysteresis needs queue_lo < queue_hi "
                             f"(got {self.queue_lo}, {self.queue_hi})")
        if self.warmup_horizon < 0:
            raise ValueError(f"warmup_horizon must be >= 0, "
                             f"got {self.warmup_horizon}")
        if not self.per_replica_rate > 0:
            raise ValueError(f"per_replica_rate must be > 0, "
                             f"got {self.per_replica_rate}")
        if not self.role_imbalance > 1.0:
            raise ValueError(f"role_imbalance must be > 1.0 (a factor), "
                             f"got {self.role_imbalance}")


class Autoscaler:
    """Deterministic SLA autoscaler over one Router's ReplicaPool.

    Drive it once per fleet round (``FleetSimulator(router,
    autoscaler=...)`` does) — ``step(now)`` folds new completion TTFTs
    into the EWMA, advances any in-progress scale-down drain, updates the
    overload ladder, and evaluates at most one scale decision per
    ``decide_interval``.  Decisions land in :attr:`decisions` —
    ``(ts, action, rid, reason)`` — the byte-reproducibility receipt.
    """

    def __init__(self, router, config: AutoscaleConfig = None,
                 overload: Optional[OverloadController] = None):
        self.router = router
        self.pool = router.pool
        self.config = config or AutoscaleConfig()
        if self.config.max_replicas is not None and \
                self.config.max_replicas > len(self.pool.replicas):
            raise ValueError(
                f"max_replicas {self.config.max_replicas} exceeds the pool "
                f"size {len(self.pool.replicas)} — the pool is the ceiling")
        # the ladder is shared with the router (admission-time consults);
        # adopt the router's controller when one is already attached
        self.overload = overload if overload is not None \
            else getattr(router, "overload", None)
        if self.overload is not None and router.overload is None:
            router.overload = self.overload
        if self.overload is not None:
            self.overload.bind(self._emit_event)
        #: (ts, action, rid, reason) — byte-identical across same-seed runs
        self.decisions: List[Tuple[float, str, int, str]] = []
        self._ttft_ewma: Optional[float] = None
        self._folded = 0                 # index into router.ttft_log
        self._draining: Optional[int] = None
        self._drain_mode: Optional[str] = None   # "park" | "restart"
        self._last_eval: Optional[float] = None
        self._last_up: Optional[float] = None
        self._last_down: Optional[float] = None
        self._last_role: Optional[float] = None
        self._low_streak = 0

    # ----------------------------------------------------------- telemetry

    def _emit_event(self, name: str, value: float) -> None:
        r = self.router
        r._emit([(name, value, r._next_event_step())])

    def _decide(self, now: float, action: str, rid: int, reason: str) -> None:
        self.decisions.append((round(now, 9), action, rid, reason))
        recorder = getattr(self.router, "recorder", None)
        if recorder is not None:
            # annotated instants on the dedicated control track: WHY the
            # fleet changed size is part of the flight-recorder story
            recorder.instant(f"ctrl/autoscale/{action}", "ctrl/autoscale",
                             now, attrs={"rid": rid, "reason": reason})
        logger.info(f"autoscaler: {action} replica {rid} at t={now:.3f} ({reason})")

    # ------------------------------------------------------------- signals

    @property
    def ttft_ewma(self) -> Optional[float]:
        return self._ttft_ewma

    def _fold_ttft(self) -> None:
        log = self.router.ttft_log
        a = self.config.ewma_alpha
        while self._folded < len(log):
            x = log[self._folded]
            self._folded += 1
            self._ttft_ewma = x if self._ttft_ewma is None \
                else (1 - a) * self._ttft_ewma + a * x

    def signals(self) -> dict:
        """Point-in-time control inputs — router queue depth, the TTFT
        EWMA, and per-replica load snapshots via
        ``Router.fleet_load_stats()``: a live probe without a control
        transport, LAST-KNOWN-GOOD heartbeat payloads with an ``age``
        annotation under one.  Stale inputs make the autoscaler react
        late (slower), never wrongly — and ``stats_age_max`` surfaces how
        stale its view was when it decided."""
        pool = self.pool
        stats = self.router.fleet_load_stats()
        dispatchable = self.router.dispatchable_rids()
        provisioned = [r for r in pool.rids
                       if pool.health.state(r) is not ReplicaState.DEAD]
        queued = self.router.queue_depth + \
            sum(s["queue_depth"] for s in stats.values())
        outstanding = self.router.outstanding
        free_pages = min((stats[r]["free_kv_pages"] for r in dispatchable
                          if r in stats), default=0)
        n_disp = max(1, len(dispatchable))
        ttft_pressure = 0.0
        if self._ttft_ewma is not None:
            ttft_pressure = self._ttft_ewma / max(
                1e-9, self.config.up_frac * self.config.ttft_slo)
        queue_pressure = (queued / n_disp) / max(1e-9, self.config.queue_hi)
        return {
            "dispatchable": dispatchable,
            "provisioned": provisioned,
            "queued": queued,
            "outstanding": outstanding,
            "free_kv_pages": free_pages,
            "ttft_ewma": self._ttft_ewma,
            "pressure": max(ttft_pressure, queue_pressure),
            # staleness receipt: the oldest load snapshot this decision
            # rests on (0.0 under perfect in-process observation)
            "stats_age_max": max((s.get("age", 0.0) for s in stats.values()),
                                 default=0.0),
        }

    # ---------------------------------------------------------------- step

    def step(self, now: Optional[float] = None) -> None:
        now = self.router.clock.now() if now is None else now
        self._fold_ttft()
        self._advance_drain(now)
        if self._last_eval is not None and \
                now - self._last_eval < self.config.decide_interval:
            return
        self._last_eval = now
        try:
            # chaos site: the control plane's probe of the fleet is where a
            # device loss on the replica it is draining/watching surfaces
            _fi.check("autoscaler.decide")
        except _fi.DeviceLossError as e:
            rid = self._draining
            if rid is None:
                live = [r for r in self.pool.rids
                        if self.pool.health.dispatchable(r)]
                rid = live[-1] if live else None
            if rid is None:
                raise
            self._draining, self._drain_mode = None, None
            self._decide(now, "device_loss", rid, str(e))
            self.router.on_replica_dead(rid, now, reason=str(e))
            return
        except OSError as e:
            # transient control-plane fault: skip this evaluation, the next
            # round re-reads the same deterministic signals
            logger.warning(f"autoscaler.decide transient fault: {e}")
            return
        sig = self.signals()
        if self.overload is not None:
            self.overload.update(now, sig["pressure"])
        self._evaluate(now, sig)

    def _advance_drain(self, now: float) -> None:
        """Progress an in-flight scale-down (or role change): park /
        restart / re-role the drained replica once — and only once — it
        is idle.  Runs every step, not just on decide ticks, so a drain
        never outlives its work.  Every mutation goes through
        ``Router.lifecycle_command`` — the direct pool calls without a
        transport, typed+retried+epoch-fenced commands under one."""
        rid = self._draining
        if rid is None:
            return
        if self.router.lifecycle_pending(rid, "drain"):
            # the drain COMMAND is still in flight on the fabric: the pool
            # state has not moved yet and must not read as an abort
            return
        state = self.pool.health.state(rid)
        if state is not ReplicaState.DRAINING:
            # killed (chaos) or otherwise transitioned out from under us:
            # the drain is moot, recovery/failover owns the replica now
            self._decide(now, "drain_aborted", rid, f"state {state.value}")
            self._draining, self._drain_mode = None, None
            return
        if not self.router.replica_idle(rid):
            return
        mode = self._drain_mode
        self._draining, self._drain_mode = None, None
        if mode == "restart":
            # scale-up arrived mid-drain: give the replica straight back
            # through the rolling-restart path instead of parking it
            self.router.lifecycle_command(rid, "restart", now=now)
            self._decide(now, "drain_cancelled", rid, "scale-up during drain")
            self._emit_event("fleet/scale_up", float(rid))
            self._last_up = now
            return
        if mode is not None and mode.startswith("role:"):
            role = mode.split(":", 1)[1]
            self.router.lifecycle_command(rid, "role_change",
                                          {"role": role}, now=now)
            self._decide(now, "role_change", rid,
                         f"drained idle; role -> {role}")
            return
        self.router.lifecycle_command(
            rid, "park", {"reason": "autoscale: scale-down (drained)"},
            now=now)
        self._decide(now, "down", rid, "drained idle; parked")
        self._emit_event("fleet/scale_down", float(rid))

    def _evaluate(self, now: float, sig: dict) -> None:
        cfg = self.config
        pool = self.pool
        n_prov = len(sig["provisioned"])
        n_disp = len(sig["dispatchable"])
        ceiling = cfg.max_replicas if cfg.max_replicas is not None \
            else len(pool.replicas)
        # a DEAD replica with a lifecycle command still in flight is
        # already being acted on — issuing a second mutation would race it
        dead = [r for r in pool.rids
                if pool.health.state(r) is ReplicaState.DEAD
                and not self.router.lifecycle_pending(r)]
        # availability floor first: below min_replicas we provision
        # unconditionally (no cooldown — this is repair, not reaction)
        if n_prov < cfg.min_replicas and dead:
            rid = dead[0]
            # via the router: a prefix directory pre-imports its hottest
            # chains while the replica is still RECOVERING (warm join)
            self.router.lifecycle_command(rid, "recover", now=now)
            self._decide(now, "up", rid, f"below min_replicas ({n_prov} < "
                         f"{cfg.min_replicas})")
            self._emit_event("fleet/scale_up", float(rid))
            self._last_up = now
            self._low_streak = 0
            return
        if cfg.role_aware and self._draining is None \
                and self._maybe_rebalance_roles(now, sig):
            return
        work = sig["queued"] + sig["outstanding"]
        kv_starved = sig["free_kv_pages"] == 0 and sig["queued"] > 0
        reactive_up = work > 0 and (sig["pressure"] >= 1.0 or kv_starved)
        predict_up, predict_reason, projected = False, "", 0.0
        if cfg.predictive:
            predict_up, predict_reason, projected = \
                self._predict_demand(now, sig)
        want_up = reactive_up or predict_up
        if want_up:
            self._low_streak = 0
            if self._last_up is not None and now - self._last_up < cfg.cooldown_up:
                return
            if self._draining is not None and self._drain_mode == "park":
                # cheapest capacity: cancel the in-flight scale-down — the
                # replica returns via restart the moment it is idle
                self._drain_mode = "restart"
                self._decide(now, "cancel_drain", self._draining,
                             "pressure while draining")
                self._last_up = now
                return
            if dead and n_prov < ceiling:
                rid = dead[0]
                self.router.lifecycle_command(rid, "recover", now=now)
                reason = predict_reason if (predict_up and not reactive_up) \
                    else (f"pressure {sig['pressure']:.3f}"
                          + (" (kv starved)" if kv_starved else ""))
                self._decide(now, "up", rid, reason)
                self._emit_event("fleet/scale_up", float(rid))
                self._last_up = now
            return
        low = sig["outstanding"] <= cfg.queue_lo * max(1, n_disp) \
            and sig["queued"] == 0
        if not low:
            self._low_streak = 0
            return
        if cfg.predictive and \
                projected > max(0, n_disp - 1) * cfg.per_replica_rate:
            # the queue is momentarily empty but the FORECAST still needs
            # today's capacity: do not start shrinking into a ramp
            self._low_streak = 0
            return
        self._low_streak += 1
        if self._low_streak < cfg.down_streak or self._draining is not None \
                or n_disp <= cfg.min_replicas:
            return
        if self._last_down is not None and now - self._last_down < cfg.cooldown_down:
            return
        rid = sig["dispatchable"][-1]
        self.router.lifecycle_command(rid, "drain", now=now)
        self._draining, self._drain_mode = rid, "park"
        self._decide(now, "drain", rid,
                     f"low occupancy x{self._low_streak}")
        self._emit_event("fleet/scale_drain", float(rid))
        self._last_down = now
        self._low_streak = 0

    def _predict_demand(self, now: float,
                        sig: dict) -> Tuple[bool, str, float]:
        """The predictive loop's forecast: project the arrival-rate EWMA
        along its slope to the warm-up horizon (capacity ordered NOW only
        serves demand arriving THEN) and compare against dispatchable
        capacity; independently, a premium tenant burning its SLO error
        budget at >= 1x on the fast window is demand the rate fold has
        not caught up to yet.  Returns ``(scale_up, reason, projected)``;
        the projected rate also guards scale-DOWN during a ramp."""
        cfg = self.config
        rate, slope = self.router.arrival_rate()
        projected = max(0.0, rate + slope * cfg.warmup_horizon)
        capacity = len(sig["dispatchable"]) * cfg.per_replica_rate
        if projected > capacity:
            return True, (f"projected {projected:.3f} req/s > capacity "
                          f"{capacity:.3f} at +{cfg.warmup_horizon:g}s"), \
                projected
        slo = getattr(self.router, "slo", None)
        if slo is not None:
            for name in self.router.tenants.names():
                spec = self.router.tenants.spec(name)
                if spec.ttft_slo is None or spec.best_effort:
                    continue
                fast, _slow = slo.burn_rates(name, now)
                if fast >= 1.0:
                    return True, (f"tenant {name!r} fast burn rate "
                                  f"{fast:.3f} >= 1.0"), projected
        return False, "", projected

    def _maybe_rebalance_roles(self, now: float, sig: dict) -> bool:
        """Phase-aware role reassignment (docs/SERVING.md "Disaggregated
        serving"): when one phase's per-capable-replica pressure dwarfs
        the other's by ``role_imbalance``, drain one replica of the
        over-provisioned phase and re-role it toward the starved one.
        The change rides the ordinary drain -> restart path, so no
        in-flight work is ever lost to a role decision.  Returns True
        when a role drain was started (the evaluation stops there: a
        role move IS this tick's decision)."""
        cfg = self.config
        if self._last_role is not None and \
                now - self._last_role < cfg.role_cooldown:
            return False
        disp = sig["dispatchable"]
        if len(disp) < 2:
            return False
        stats = self.router.fleet_load_stats()
        roles = {r: self.pool.replica(r).role for r in disp}
        prefill_caps = [r for r in disp if roles[r] is not ReplicaRole.DECODE]
        decode_caps = [r for r in disp if roles[r] is not ReplicaRole.PREFILL]
        prefill_demand = self.router.queue_depth + sum(
            stats[r]["queue_depth"] for r in prefill_caps if r in stats)
        decode_demand = sum(
            stats[r]["active"] for r in decode_caps if r in stats)
        p_press = prefill_demand / max(1, len(prefill_caps))
        d_press = decode_demand / max(1, len(decode_caps))
        rid, role = None, ""
        if p_press >= cfg.role_imbalance * max(d_press, 1e-9) and p_press > 0:
            # prefill starved: a pure-DECODE replica broadens to MIXED
            # (never below one decode-capable replica — migrated KV must
            # always have somewhere to land)
            pure_decode = [r for r in disp if roles[r] is ReplicaRole.DECODE]
            if pure_decode and len(decode_caps) > 1:
                rid, role = pure_decode[-1], "mixed"
        elif d_press >= cfg.role_imbalance * max(p_press, 1e-9) and d_press > 0:
            # decode starved: narrow a pure-PREFILL to MIXED first; with
            # no pure prefill left, specialize a MIXED toward DECODE —
            # only while another prefill-capable replica remains to admit
            pure_prefill = [r for r in disp if roles[r] is ReplicaRole.PREFILL]
            if pure_prefill and len(prefill_caps) > 1:
                rid, role = pure_prefill[-1], "mixed"
            else:
                mixed = [r for r in disp if roles[r] is ReplicaRole.MIXED]
                if mixed and len(prefill_caps) > 1:
                    rid, role = mixed[-1], "decode"
        if rid is None:
            return False
        self.router.lifecycle_command(rid, "drain", now=now)
        self._draining, self._drain_mode = rid, f"role:{role}"
        self._decide(now, "role_drain", rid,
                     f"phase imbalance prefill {p_press:.3f} vs decode "
                     f"{d_press:.3f}; role -> {role}")
        self._last_role = now
        return True

    # ------------------------------------------------------------- surface

    def marker(self) -> tuple:
        """Progress marker folded into the FleetSimulator's stall detector:
        scale decisions and ladder moves are progress even when no token
        moved this round."""
        rung = self.overload.rung if self.overload is not None else -1
        shed = self.overload.shed_count if self.overload is not None else 0
        return (len(self.decisions), rung, shed, self._draining,
                self._drain_mode)

    def wake_ts(self, now: float) -> Optional[float]:
        """Next instant a decision could possibly change — the simulator's
        idle-jump input while work is pending or a drain is in flight."""
        if self.router.outstanding == 0 and self._draining is None:
            return None
        base = self._last_eval if self._last_eval is not None else now
        return max(now, base + self.config.decide_interval)

    def finalize(self, now: float) -> None:
        if self.overload is not None:
            self.overload.finalize(now)

    def summary(self) -> dict:
        pool = self.pool
        return {
            "decisions": [list(d) for d in self.decisions],
            # a cancelled drain IS an up-capacity action (it emits
            # fleet/scale_up): capacity returned via restart, not recover
            "n_up": sum(1 for d in self.decisions
                        if d[1] in ("up", "drain_cancelled")),
            "n_down": sum(1 for d in self.decisions if d[1] == "down"),
            "ttft_ewma": None if self._ttft_ewma is None
            else round(self._ttft_ewma, 6),
            "provisioned_end": sum(
                1 for r in pool.rids
                if pool.health.state(r) is not ReplicaState.DEAD),
            "overload": None if self.overload is None
            else self.overload.summary(),
        }
