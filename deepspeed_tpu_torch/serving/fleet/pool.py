"""ReplicaPool: N ServingEngine replicas behind one fleet clock.

Each replica owns a FULL serving stack — its own ``InferenceEngineV2``
(weights, KV arena, prefix cache, scheduler) wrapped by its own
``ServingEngine`` — exactly the unit a real deployment replicates per
mesh/host.  The pool adds what a fleet needs around them:

* a shared clock: one ``VirtualClock`` fans out through per-replica
  :class:`~..clock.ReplicaClockView`\\ s so a deterministic CPU simulation
  models replicas stepping CONCURRENTLY (the fleet driver advances time
  once per round by the slowest replica's cost); a ``WallClock`` is shared
  directly (real time needs no view);
* a :class:`~.health.HealthTracker` fed from tick outcomes;
* ``kill()`` — abrupt replica loss: the engine object is dropped and every
  in-flight ``ServingRequest`` is returned to the caller (the router) for
  failover re-dispatch onto survivors; on the card the dropped engine's KV
  arena, step graphs and graph pool are returned at once (``_release``);
* ``recover()``/``restart()`` — attach a FRESH engine from the factory
  (state RECOVERING until its probe ticks pass), modelling a replacement
  host joining the fleet or a drained replica rebooting.
"""

import dataclasses
import enum
import gc
from typing import Callable, Dict, List, Optional, Sequence, Union

from ...resilience.fault_injection import InjectedCrash
from ...utils.logging import logger
from ..clock import ReplicaClockView, VirtualClock
from ..engine import ServingConfig, ServingEngine
from ..request import ServingRequest
from .health import HealthConfig, HealthTracker, ReplicaState


class ReplicaRole(enum.Enum):
    """Disaggregation role of one replica (DistServe prefill–decode
    disaggregation / Splitwise phase splitting — docs/SERVING.md
    "Disaggregated serving").  The role is a ROUTING preference, not a
    capability bound: every replica runs the full serving stack, so a
    decode replica can absorb a whole request when the prefill pool is
    gone (availability beats specialization) and vice versa."""
    PREFILL = "prefill"   # admission + prompt processing; requests migrate out
    DECODE = "decode"     # resumes migrated KV; token generation
    MIXED = "mixed"       # the classic monolithic replica (default)


@dataclasses.dataclass
class Replica:
    rid: int
    serve: Optional[ServingEngine]      # None while DEAD (engine discarded)
    clock: object                       # ReplicaClockView or the shared clock
    generation: int = 0                 # bumps on every fresh engine attach
    role: ReplicaRole = ReplicaRole.MIXED  # survives kill/recover/restart


class ReplicaPool:

    def __init__(self, engine_factory: Callable[[], object], n_replicas: int,
                 clock=None, serving_config: ServingConfig = None, monitor=None,
                 health_config: HealthConfig = None, tracer=None, metrics=None,
                 roles: Optional[Sequence[Union[str, ReplicaRole]]] = None,
                 role_factories: Optional[Dict] = None,
                 prefix_directory=None, transport=None,
                 hb_interval: float = 0.5, anatomy: bool = False,
                 anatomy_max_steps: int = 4096, kv_tier=None):
        assert n_replicas >= 1, n_replicas
        if roles is not None and len(roles) != n_replicas:
            raise ValueError(f"roles ({len(roles)}) must cover every replica "
                             f"({n_replicas})")
        self.engine_factory = engine_factory
        # phase-specialized engine configs (Splitwise-style pool tuning):
        # a PREFILL pool might run smaller prefill chunks and a lean KV
        # arena (it holds prompts only transiently), a DECODE pool a large
        # arena for the fleet's whole resident decode set.  KV migration
        # only requires the PER-PAGE geometry (layers, page_size, kv heads,
        # head_dim, dtype) to match across pools — arena page COUNTS may
        # differ freely.  Factories are keyed by role and survive
        # kill/recover/restart (the role does).
        self.role_factories = {ReplicaRole(k): v
                               for k, v in (role_factories or {}).items()}
        self.serving_config = serving_config or ServingConfig()
        self.monitor = monitor
        # telemetry: ONE tracer/metrics registry spans the whole fleet —
        # every replica frontend traces onto its own track (replica<rid>)
        # of the same span stream, and a fresh engine attached by
        # recover()/restart() inherits them (observability survives the
        # replica, like the clock does)
        self.tracer = tracer
        self.metrics = metrics
        #: fleet flight recorder — back-filled by Router(recorder=...) so
        #: replacement engines from recover()/restart() inherit it exactly
        #: like the tracer (the replica-side ctrl/fence instant must not
        #: depend on a tracer being attached)
        self.recorder = None
        # fleet prefix directory (docs/SERVING.md "Prefix directory"): the
        # pool is its ONE publish edge — every attached engine's prefix
        # cache streams its chain digests through the listener bus, and
        # death/restart purge the replica's entries, so the router-side
        # table can never outlive the cache it mirrors by more than the
        # documented staleness ladder
        self.prefix_directory = prefix_directory
        if prefix_directory is not None and metrics is not None \
                and prefix_directory.metrics is None:
            prefix_directory.metrics = metrics
        # host KV tier (serving/kvtier): a TierConfig (or True for the
        # defaults) gives every attached engine its own TieredKVManager —
        # park/resume, demotion-first preemption, warm-on-host prefix
        # pages.  Per-replica like the engine itself: a kill drops the
        # host tier with the arena (same failure domain), and the
        # directory purge on death/attach forgets its host publishes too.
        self.kv_tier = kv_tier
        # control-plane transport (docs/SERVING.md "Control-plane
        # transport"): when attached, the replica-side control flows stop
        # being perfect in-process calls — each tick sends a
        # sequence-numbered HEARTBEAT (local health state + load_stats)
        # and prefix-cache publishes become a per-replica seq-numbered
        # DIR_PUBLISH stream the router gap-detects; None keeps every
        # pre-r16 direct path byte-for-byte unchanged
        self.transport = transport
        #: heartbeats are TIME-paced, not round-paced: at most one per
        #: replica per ``hb_interval`` of clock time (a real lease protocol
        #: beats on a timer, and a round-paced beat would flood the fabric
        #: on zero-advance simulator rounds).  Must sit well under the
        #: router's ``LeaseConfig.suspect_after`` or the fleet suspects
        #: itself between beats.
        self.hb_interval = float(hb_interval)
        self._hb_last: Dict[int, Optional[float]] = {r: None for r in range(n_replicas)}
        #: per-replica heartbeat / directory-publish sequence counters —
        #: POOL-level so they survive engine swaps (a recovered replica's
        #: stream continues, it does not restart at 1 and look reordered)
        self._hb_seq: Dict[int, int] = {r: 0 for r in range(n_replicas)}
        self._dir_seq: Dict[int, int] = {r: 0 for r in range(n_replicas)}
        #: highest fencing epoch each replica has EXECUTED — fences are
        #: idempotent per epoch, so a duplicated/retried FENCE delivered
        #: after the replica rejoined re-acks without cancelling the
        #: legitimately re-dispatched post-rejoin work
        self._fenced_epoch: Dict[int, int] = {r: 0 for r in range(n_replicas)}
        #: lifecycle-command dedup ledger: cmd seq -> ack status for every
        #: command this replica already applied — POOL-level so it survives
        #: engine swaps (the point: a retried/duplicated ``lifecycle_cmd``
        #: delivered after a recover/restart must RE-ACK its recorded
        #: outcome, never re-apply the mutation)
        self._lifecycle_seen: Dict[int, Dict[int, str]] = \
            {r: {} for r in range(n_replicas)}
        # per-replica step anatomy (telemetry/step_anatomy.py): each
        # attached engine gets its OWN recorder on the replica's clock
        # view (one time domain with the serving charges), recreated
        # across kill/recover/restart like the engine itself; the
        # steady-state boundary stays PER-RECORDER: a replacement engine
        # from recover()/restart() starts un-steady, because a fresh
        # replica MUST compile its step set — that is recovery, not a
        # regression (mark_anatomy_steady() re-declares after warm-up)
        self.anatomy_enabled = bool(anatomy)
        self.anatomy_max_steps = int(anatomy_max_steps)
        self.clock = clock if clock is not None else VirtualClock()
        self._virtual = isinstance(self.clock, VirtualClock)
        self.replicas: Dict[int, Replica] = {}
        self.health = HealthTracker(range(n_replicas), config=health_config,
                                    emit=self._emit, clock=self.clock)
        for rid in range(n_replicas):
            role = ReplicaRole(roles[rid]) if roles is not None else ReplicaRole.MIXED
            self.replicas[rid] = Replica(rid=rid, serve=None,
                                         clock=self._make_view(), role=role)
            self._attach_engine(rid)

    def _make_view(self):
        return ReplicaClockView(self.clock) if self._virtual else self.clock

    def _attach_engine(self, rid: int) -> None:
        rep = self.replicas[rid]
        factory = self.role_factories.get(rep.role, self.engine_factory)
        rep.serve = ServingEngine(factory(), clock=rep.clock,
                                  config=self.serving_config, monitor=self.monitor,
                                  tracer=self.tracer, metrics=self.metrics,
                                  trace_track=f"replica{rid}",
                                  recorder=self.recorder)
        rep.generation += 1
        if self.anatomy_enabled:
            from ...telemetry.step_anatomy import StepAnatomy
            rep.serve.engine.set_anatomy(
                StepAnatomy(clock=rep.clock,
                            max_steps=self.anatomy_max_steps))
        if self.prefix_directory is not None:
            # a fresh engine's cache is empty: stale entries from the
            # replica's previous life (rolling restart) must go first
            # (purge drops BOTH tiers — the old host tier died with the
            # old engine)
            self.prefix_directory.purge(rid)
            pc = rep.serve.engine.kv.prefix_cache
            if pc is not None:
                pc.listener = self._directory_listener(rid)
        if self.kv_tier is not None:
            from ..kvtier import TierConfig, TieredKVManager
            cfg = self.kv_tier if isinstance(self.kv_tier, TierConfig) else None
            tier = TieredKVManager(rep.serve.engine, config=cfg,
                                   metrics=self.metrics)
            rep.serve.attach_tier(tier)
            if self.prefix_directory is not None:
                # host-tier publishes ride the SAME seq-numbered stream as
                # the device publishes — one ordered feed per replica, so
                # a demote(evict device, publish host) pair can never be
                # applied out of order router-side
                tier.listener = self._host_directory_listener(rid)

    def _directory_listener(self, rid: int):
        """Publish edge replica -> directory.  A transient fault at the
        ``prefix.publish`` site drops THIS update (the directory goes
        stale — cold or warm — which the routing staleness ladder absorbs:
        a mis-routed dispatch recomputes, never corrupts); ``InjectedCrash``
        is driver death and propagates.

        With a control transport attached the publish stops being a direct
        table write: it becomes a sequence-numbered ``dir_publish`` message
        on this replica's stream, and the ROUTER applies it on delivery —
        a dropped message now leaves a detectable seq GAP (the router pulls
        a full-digest resync) instead of being silently absorbed."""
        directory = self.prefix_directory

        def on_event(event: str, digest: int) -> None:
            if self.transport is not None:
                self._dir_seq[rid] += 1
                self.transport.send("dir_publish", rid, "router",
                                    {"op": event, "digest": digest},
                                    seq=self._dir_seq[rid])
                return
            try:
                if event == "publish":
                    directory.publish(rid, digest)
                else:
                    directory.retract(rid, digest)
            except InjectedCrash:
                raise
            except OSError as e:
                logger.warning(f"fleet: prefix directory {event} dropped for "
                               f"replica {rid}: {e}")
        return on_event

    def _host_directory_listener(self, rid: int):
        """Publish edge kvtier -> directory host table: ``host_publish``
        when a demoted prefix page lands host-side, ``host_evict`` when it
        leaves (promoted back or evicted under host pressure).  Same
        fault stance and (with a transport) the same ordered per-replica
        ``dir_publish`` stream as the device-tier listener."""
        directory = self.prefix_directory

        def on_event(event: str, digest: int) -> None:
            if self.transport is not None:
                self._dir_seq[rid] += 1
                self.transport.send("dir_publish", rid, "router",
                                    {"op": event, "digest": digest},
                                    seq=self._dir_seq[rid])
                return
            try:
                if event == "host_publish":
                    directory.publish_host(rid, digest)
                else:
                    directory.retract_host(rid, digest)
            except InjectedCrash:
                raise
            except OSError as e:
                logger.warning(f"fleet: prefix directory {event} dropped "
                               f"for replica {rid}: {e}")
        return on_event

    # ------------------------------------------------------- control plane

    def _send_heartbeat(self, rid: int) -> None:
        """One lease renewal: the replica's local health state plus its
        current ``load_stats()`` snapshot — the router's ONLY evidence of
        this replica under the transport (docs/SERVING.md "Control-plane
        transport").  No-op without a transport (perfect observation)."""
        if self.transport is None:
            return
        rep = self.replicas[rid]
        if rep.serve is None:
            return
        now = self.clock.now()
        last = self._hb_last[rid]
        if last is not None and now - last < self.hb_interval:
            return
        self._hb_last[rid] = now
        self._hb_seq[rid] += 1
        self.transport.send(
            "heartbeat", rid, "router",
            {"state": self.health.state(rid).value,
             "stats": rep.serve.load_stats(),
             "generation": rep.generation},
            seq=self._hb_seq[rid])

    def dir_snapshot(self, rid: int) -> Optional[dict]:
        """Full-digest resync snapshot of this replica's prefix cache plus
        the publish-stream BARRIER (the last seq folded into the snapshot)
        — the router's gap repair: everything at/below the barrier is IN
        the snapshot, buffered stream entries above it apply after.
        None when the replica has no engine (a resync request raced its
        death; the router's retry finds the replacement)."""
        rep = self.replicas[rid]
        if rep.serve is None:
            return None
        pc = rep.serve.engine.kv.prefix_cache
        digests = pc.held_digests() if pc is not None else []
        snap = {"digests": digests, "barrier": self._dir_seq[rid]}
        tier = rep.serve.tier
        if tier is not None:
            snap["host_digests"] = tier.host.held_prefix_digests()
        return snap

    def fence_replica(self, rid: int, epoch: int = 0) -> Dict[str, int]:
        """Execute a FENCE on this replica: cancel every in-flight request
        its frontend still holds (a zombie that outlived its lease keeps
        decoding work the router has already re-dispatched elsewhere —
        that work, and any late completion of it, must be discarded, never
        double-served).  Returns the frontend's cancel counts; a fresh
        engine (legit recovery, nothing to cancel) fences to zeros.

        Idempotent per ``epoch``: the fence/ack pair crosses the same
        lossy fabric as everything else, so a duplicated or retried FENCE
        can arrive AFTER the ack re-admitted the replica and the router
        re-dispatched new work to it — an already-executed epoch re-acks
        with zeros instead of cancelling that legitimate work."""
        if epoch <= self._fenced_epoch[rid]:
            return {"queued": 0, "active": 0}
        self._fenced_epoch[rid] = epoch
        rep = self.replicas[rid]
        if rep.serve is None:
            return {"queued": 0, "active": 0}
        return rep.serve.fence()

    def fenced_epoch(self, rid: int) -> int:
        """Highest fencing epoch this replica has EXECUTED — the
        replica-local half of the lifecycle-command epoch fence: a
        ``lifecycle_cmd`` stamped with an older epoch was issued before
        this replica was declared dead and must be rejected, not applied
        (``Router._apply_lifecycle``)."""
        return self._fenced_epoch[rid]

    def lifecycle_seen(self, rid: int) -> Dict[int, str]:
        """The replica's lifecycle-command dedup ledger (cmd seq -> ack
        status); survives engine swaps like the fencing epoch."""
        return self._lifecycle_seen[rid]

    def _emit(self, name: str, value: float) -> None:
        if self.monitor is None or not getattr(self.monitor, "enabled", True):
            return
        try:
            self.monitor.write_events([(name, value, len(self.health.history))])
        except InjectedCrash:
            raise  # simulated process death; chaos tests must see it
        except Exception as e:  # observability must never take down the fleet
            logger.warning(f"fleet monitor write failed: {e}")

    # ------------------------------------------------------------- queries

    @property
    def rids(self) -> List[int]:
        return sorted(self.replicas)

    def replica(self, rid: int) -> Replica:
        return self.replicas[rid]

    def is_idle(self, rid: int) -> bool:
        serve = self.replicas[rid].serve
        return serve is None or (not serve._queue and not serve._active)

    def load_stats(self) -> Dict[int, dict]:
        """Per-replica ``ServingEngine.load_stats()`` for every replica that
        currently has an engine (DEAD replicas are absent)."""
        return {rid: rep.serve.load_stats()
                for rid, rep in sorted(self.replicas.items()) if rep.serve is not None}

    def anatomy(self, rid: int):
        """The step-anatomy recorder of replica ``rid``'s CURRENT engine
        (None when anatomy is off or the replica is dead) — the router's
        per-round host-gap gauge input."""
        rep = self.replicas[rid]
        if rep.serve is None:
            return None
        anat = getattr(rep.serve.engine, "anatomy", None)
        return anat if getattr(anat, "enabled", False) else None

    def mark_anatomy_steady(self) -> None:
        """Declare warm-up over on every live replica's recorder: later
        JIT cache misses count as unexpected steady-state recompiles.
        Recover/restart replacements re-enter dispatch already steady —
        ``_warm_replacement`` AOT-compiles their step set and marks the
        fresh recorder before the replica serves its first request."""
        for rid in self.rids:
            anat = self.anatomy(rid)
            if anat is not None:
                anat.mark_steady()

    # ----------------------------------------------------------- lifecycle

    def rebase_clock(self) -> None:
        """Re-zero the shared clock so t=0 means 'serving starts' — pool
        construction builds and warms N engines, which on a WallClock takes
        long enough to age a workload's arrival timestamps and deadlines
        past before any request is served.  Every live frontend's epoch is
        re-stamped along with it (their ``_t0`` predates the reset)."""
        self.clock.reset()
        for rep in self.replicas.values():
            if rep.serve is not None:
                rep.serve.rebase_epoch()

    def kill(self, rid: int, reason: str = "killed") -> List[ServingRequest]:
        """Abrupt replica loss: discard the engine and return its in-flight
        requests (queued + active, in arrival order) for failover.  The
        returned ``ServingRequest`` objects carry the tokens they already
        delivered; the router resubmits them to survivors with
        ``resume_tokens`` so outputs stay recompute-identical."""
        rep = self.replicas[rid]
        if self.health.state(rid) is not ReplicaState.DEAD:
            self.health.kill(rid, reason)
        victims: List[ServingRequest] = []
        if rep.serve is not None:
            victims = sorted(
                list(rep.serve._queue) + list(rep.serve._active.values()),
                key=lambda r: (r.arrival_ts, r.uid))
            self._release(rep)
        if self.prefix_directory is not None:
            # death-with-directory-entries: the cache died with the engine,
            # so every digest this replica published is retracted at once —
            # the router must never route to (or import from) a ghost
            self.prefix_directory.purge(rid)
        return victims

    @staticmethod
    def _release(rep: Replica) -> None:
        """Drop the replica's engine and return its memory now.

        ``close`` first waits for a step the frontend still has in flight:
        with ``async_dispatch`` a replica is dropped with its last step
        queued on the card (its graph replay writing this engine's arena),
        which the GPU test ``test_killed_pipelined_replica_waits_and_frees``
        observes; serial ticks read their tokens back before returning and
        leave nothing queued (``chip_smoke.py`` phase 14 finds the stream
        idle at its kill).  The engine's object graph then holds
        reference cycles (its step programs and the frontend's helpers point
        back at it), so its KV arena, step graphs and graph pool would wait
        for Python's cycle collector while a replacement engine allocates
        its own beside them: collect them here."""
        rep.serve.close()
        rep.serve = None
        gc.collect()

    def _warm_replacement(self, rid: int) -> None:
        """A replacement engine must not pay its compile set inside the
        first served request's TTFT: AOT-compile the full reachable step
        set (``warm_all`` — an ``engine.aot_compile`` chaos fault falls
        back to lazy JIT per key, never a dead replica) and declare the
        fresh recorder steady — recovery compiles are deliberate warm-up
        by construction, and any LATER JIT miss on this replica is a real
        steady-state regression, not recovery noise."""
        rep = self.replicas[rid]
        warm = getattr(rep.serve.engine, "warm_all", None)
        if warm is not None:
            warm()
        anat = self.anatomy(rid)
        if anat is not None:
            anat.mark_steady()

    def recover(self, rid: int) -> None:
        """Attach a fresh engine to a DEAD replica (replacement host),
        pre-compiled and anatomy-steady before it re-enters dispatch."""
        assert self.health.state(rid) is ReplicaState.DEAD, \
            f"recover() on replica {rid} in state {self.health.state(rid).value}"
        self._attach_engine(rid)
        self._warm_replacement(rid)
        self.health.recovering(rid)

    def drain(self, rid: int) -> None:
        self.health.drain(rid)

    def set_role(self, rid: int, role) -> None:
        """Reassign the replica's serving role (MIXED⇄PREFILL/DECODE).
        Takes effect at the NEXT engine attach — ``restart``/``recover``
        pick the factory by ``Replica.role`` — so the caller drains
        first and no in-flight work is lost (autoscaler role loop,
        docs/SERVING.md "Closed-loop control")."""
        self.replicas[rid].role = ReplicaRole(role)

    def restart(self, rid: int) -> None:
        """Rolling restart of a DRAINED replica: must be idle (the point of
        draining is that nothing is lost), swaps in a fresh engine —
        pre-compiled and anatomy-steady, like a recovery replacement."""
        assert self.health.state(rid) is ReplicaState.DRAINING, \
            f"restart() on replica {rid} in state {self.health.state(rid).value}"
        assert self.is_idle(rid), f"restart() on replica {rid} before drained"
        rep = self.replicas[rid]
        if rep.serve is not None:
            self._release(rep)
        self._attach_engine(rid)
        self._warm_replacement(rid)
        self.health.recovering(rid, "rolling restart")

    # ---------------------------------------------------------------- tick

    def tick(self, rid: int):
        """One serving iteration on replica ``rid``.  Returns
        ``(out, victims)``: the engine step's token dict, plus the in-flight
        requests to fail over when this tick KILLED the replica (transient
        errors degrade per the health policy; device-loss-class errors and
        error streaks go DEAD and the engine is discarded).

        :class:`~...resilience.fault_injection.InjectedCrash` is re-raised —
        it simulates death of THIS driver process, not of one replica, and
        nothing may absorb it (the resilience-layer contract)."""
        if not self.health.serving(rid):
            return {}, []
        rep = self.replicas[rid]
        if rep.serve is None:
            return {}, []
        try:
            out = rep.serve.tick()
        except InjectedCrash:
            raise
        except Exception as e:
            state = self.health.record_error(rid, e)
            logger.warning(f"fleet: replica {rid} tick failed ({e}); now {state.value}")
            if state is ReplicaState.DEAD:
                return {}, self.kill(rid, reason=f"tick failure: {e}")
            # still alive (merely degraded): the replica process keeps
            # heartbeating — transient tick errors are replica-local news
            # the router learns via the reported state, not via silence
            self._send_heartbeat(rid)
            return {}, []
        self.health.record_success(rid)
        self._send_heartbeat(rid)
        return out, []
