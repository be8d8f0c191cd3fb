"""ServingEngine: the SLA-aware frontend over :class:`InferenceEngineV2`.

Reference: FastGen's serving methodology (``blogs/deepspeed-fastgen`` —
Poisson-arrival load, first-token + per-token SLAs) and Orca-style
iteration-level scheduling.  The v2 engine exposes ``put()``/``step()``
over *sequences*; this layer adds what "serving" means:

* a bounded request QUEUE with admission control (reject/backpressure at
  the request boundary instead of crashing mid-step — admission.py);
* FCFS-with-aging ordering, installed into ``SplitFuseScheduler.order_key``
  so step planning follows request priority/arrival, not dict-iteration
  order (priority classes age toward urgent so nothing starves);
* KV-pressure preemption (kv_pressure.py): the youngest sequence is
  evicted — pages released, generated tokens preserved on the request —
  and requeued for recompute-on-resume, instead of the step raising;
* deadlines: expired requests (queued or running) are timed out and their
  capacity reclaimed; goodput counts only deadline-met completions;
* per-request TTFT/TPOT/queue-wait accounting streamed through the
  existing ``monitor`` event surface (``write_events`` tuples), plus
  per-token delivery callbacks as tokens land.

The loop is clock-driven (clock.py): identical code serves wall-clock
traffic and deterministic virtual-clock CPU tests / the load harness.
"""

import dataclasses
import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..resilience.fault_injection import InjectedCrash
from ..telemetry.step_anatomy import NULL_ANATOMY
from ..telemetry.trace import NULL_TRACER
from ..utils.logging import logger
from .admission import AdmissionConfig, AdmissionController
from .clock import VirtualClock, WallClock  # noqa: F401  (re-exported convenience)
from .kv_pressure import KVPressureManager
from .metrics import ServingStats
from .request import RequestState, ServingRequest


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    admission: AdmissionConfig = AdmissionConfig()
    # deadline policy: True kills expired requests (queued or running) and
    # reclaims their capacity; False lets them finish late (still counted
    # against goodput — they missed the SLA either way)
    kill_on_deadline: bool = True
    # FCFS-with-aging: a request's priority class improves by one full class
    # per ``aging_interval`` seconds waited, so low-priority work cannot
    # starve behind a stream of urgent arrivals.  0 disables aging (pure
    # priority-then-FCFS).
    aging_interval: float = 0.0
    # VirtualClock cost model: seconds one engine step takes, as a function
    # of the planned token count (decodes + prefill chunk tokens).  None →
    # every step costs 1.0 virtual second (pure step-count latency).
    step_cost: Optional[Callable[[int], float]] = None
    # async double-buffered dispatch: each tick completes the PREVIOUS
    # step's readback, then enqueues the next step and returns — so step
    # g+1's host-side work (admission, scheduling, delivery) runs while
    # step g executes on device, blocking only at the sample/accept
    # readback.  Greedy token streams are byte-identical to the serial
    # loop (each request's tokens depend only on its own accepted
    # history); deadline expiry may fire up to one step earlier than the
    # serial loop would, since the overlap window checks deadlines before
    # the in-flight step's tokens fold.
    async_dispatch: bool = False


class ServingEngine:
    """Drives an :class:`InferenceEngineV2` as a servable endpoint."""

    def __init__(self, engine, clock=None, config: ServingConfig = None, monitor=None,
                 tracer=None, metrics=None, trace_track: str = "serving",
                 recorder=None):
        self.engine = engine
        self.clock = clock if clock is not None else VirtualClock()
        self.config = config or ServingConfig()
        self.monitor = monitor
        # telemetry (docs/OBSERVABILITY.md): ``tracer`` collects one trace
        # per request (phase spans derived from the request's state history
        # at terminal time — the per-token hot path does NO tracer work);
        # ``metrics`` is a MetricsRegistry for always-on counters/histograms;
        # ``recorder`` is the fleet flight recorder (attached directly, not
        # through the tracer, so a recorder-without-tracer fleet still gets
        # the replica-side control events)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics
        self.recorder = recorder
        self.trace_track = trace_track
        # uid -> (trace_id, parent_span_id, clamp_start): parent_span_id is
        # the fleet router's attempt span when this frontend is a replica
        # (phases clamp to the dispatch time so resumed attempts don't
        # double-count the backdated client arrival); both None standalone
        self._trace_ctx: Dict[int, Tuple[int, Optional[int], Optional[float]]] = {}
        self.admission = AdmissionController(self.config.admission, engine)
        self.kvp = KVPressureManager(engine, youth_key=self._youth_key)
        self.stats = ServingStats()
        # host KV tier (serving/kvtier): set via attach_tier().  When
        # present, park()/resume() stage idle sessions host-side and
        # KV-pressure preemption demotes instead of plain-evicting.
        self.tier = None
        self._queue: List[ServingRequest] = []
        self._active: Dict[int, ServingRequest] = {}
        self._parked: Dict[int, ServingRequest] = {}
        self._requests: Dict[int, ServingRequest] = {}
        self._uids = itertools.count(max(engine.state.seqs.keys(), default=-1) + 1)
        self._events_step = 0
        self._t0 = self.clock.now()
        # step-anatomy fold cursors (telemetry/step_anatomy.py): compiles
        # already bridged into metrics/events, steps already mirrored into
        # the flight-recorder ring.  The compile cursor starts at the
        # recorder's CURRENT log length so pre-frontend warm-up compiles
        # (harnesses warm before building the frontend) are not re-counted
        # as serving-time recompiles.
        self._compiles_seen = len(getattr(engine, "anatomy",
                                          NULL_ANATOMY).compiles)
        self._anat_steps_seen = 0
        # EWMA of clock-seconds per tick-with-work (load_stats input for the
        # fleet router's least-loaded policy); None until the first step runs
        self._ewma_step_s: Optional[float] = None
        # async double-buffered dispatch (config.async_dispatch): the
        # step enqueued last tick, completed at the NEXT tick's readback —
        # (InFlightStep, charged_cost, dispatch_ts) or None
        self._inflight = None
        # a fleet ReplicaClockView over a shared VirtualClock quantizes
        # latencies exactly like a bare VirtualClock — unwrap it so the
        # warning below fires for fleet replicas too
        base_clock = getattr(self.clock, "shared", self.clock)
        if isinstance(base_clock, VirtualClock) and \
                engine.econfig.decode_steps_per_dispatch > 1:
            # the fused decode path delivers up to k tokens per tick while
            # the virtual clock advances one step_cost — TTFT/TPOT would be
            # per-DISPATCH quantities, understated up to k-fold
            logger.warning(
                f"ServingEngine on a VirtualClock with decode_steps_per_dispatch="
                f"{engine.econfig.decode_steps_per_dispatch}: per-token latency "
                "metrics are quantized to fused-dispatch granularity; build the "
                "engine with decode_steps_per_dispatch=1 for SLA measurement")
        # step planning follows request priority/arrival instead of
        # dict-iteration (put) order — see SplitFuseScheduler.order_key
        if engine.scheduler.order_key is not None:
            logger.warning("ServingEngine: replacing an existing scheduler order_key "
                           "(another frontend on this engine? call close() on it first)")
        engine.scheduler.order_key = self._seq_order_key

    # ---------------------------------------------------------------- keys

    def _priority_key(self, req: ServingRequest, now: float):
        cls = req.priority
        if self.config.aging_interval > 0:
            cls -= (now - req.arrival_ts) / self.config.aging_interval
        return (cls, req.arrival_ts, req.uid)

    def _seq_order_key(self, seq):
        req = self._requests.get(seq.uid)
        if req is None:  # non-serving sequence (direct engine.put user): first
            return (float("-inf"), -1.0, seq.uid)
        return self._priority_key(req, self.clock.now())

    def _youth_key(self, uid: int):
        """Preemption victim order: least-urgent class first, then youngest
        arrival (least sunk work, weakest FCFS claim).  Uses the SAME aged
        priority as admission — a request that aged into urgency and got
        admitted must not then be the perpetual eviction victim on its raw
        class (admit/preempt ping-pong would undo the anti-starvation)."""
        req = self._requests.get(uid)
        if req is None:
            return (float("-inf"), float("-inf"), uid)
        return self._priority_key(req, self.clock.now())

    # -------------------------------------------------------------- submit

    def submit(self, prompt: Sequence[int], max_new_tokens: Optional[int] = None,
               deadline: Optional[float] = None, arrival_ts: Optional[float] = None,
               priority: float = 0.0, stream: Optional[Callable] = None,
               retry_policy=None, resume_tokens: Optional[Sequence[int]] = None,
               trace_id: Optional[int] = None,
               parent_span_id: Optional[int] = None,
               spec: Optional[bool] = None,
               kv_snapshot=None) -> ServingRequest:
        """Enqueue one request.  NEVER raises on overload: the returned
        request's state is REJECTED (with ``reject_reason``) when admission
        refuses it — callers inspect, the serving loop keeps running.

        ``resume_tokens``: tokens this request already generated on ANOTHER
        engine (fleet failover: its previous replica died mid-decode).  They
        seed ``req.tokens`` so admission prefills ``prompt + resume_tokens``
        and greedy decode continues with the identical next token — the same
        recompute-on-resume contract KV-pressure preemption uses, across
        replicas.  ``max_new_tokens`` still bounds the TOTAL output (resumed
        tokens included); it must exceed ``len(resume_tokens)``.

        ``trace_id`` / ``parent_span_id``: trace propagation (telemetry).
        A fleet router passes its client trace id plus the per-replica
        attempt span so this request's phase spans land in the CLIENT's
        trace; standalone, a fresh trace id is allocated per request.

        ``spec``: per-request speculative-decoding control — ``False``
        opts this request out of an engine-level ``SpecConfig`` (it rides
        verify rounds as a plain 1-token row), ``True``/``None`` keep the
        engine default.  On a spec-less engine the flag is a no-op.
        Acceptance lands on ``req.spec_proposed/spec_accepted`` and the
        ``spec/*`` metrics as the request decodes.

        ``kv_snapshot`` (a ``kvtransfer.KVSnapshot``): host-staged KV for
        ``prompt + resume_tokens``, exported from another replica.  At
        admission the engine tries the KV-IMPORT FAST PATH — scatter the
        staged pages into its arena and continue decode without
        recomputing the prompt; any rejection (crc mismatch, geometry
        drift, no page room) falls back to the ordinary
        recompute-on-resume prefill automatically, with the fallback
        counted on ``stats.kv_import_fallbacks`` and the
        ``migration/import_fallback`` metric.  Either way the snapshot is
        consumed at first admission (a preemption AFTER import resumes by
        recompute, as always).

        ``retry_policy`` (a resilience ``RetryPolicy``): re-probe admission
        while the rejection is TRANSIENT (``queue_full`` — pressure that
        drains); structural rejections (infeasible request) are final
        immediately.  The FIRST wait honors the admission controller's
        ``retry_after`` hint (queue depth x EWMA step seconds — when
        capacity plausibly exists) instead of a blind exponential ladder;
        only if that informed probe still finds the queue full does the
        policy's backoff schedule run, within its attempt/time budget.
        Each wait runs ``tick()``\\ s so the loop makes real progress while
        the submitter waits (in a single-threaded clock-driven driver
        nothing else would drain the queue); deadlines that expire during
        the wait expire because time — and engine work — genuinely
        passed.  A request rejected with ``queue_full`` carries the hint
        on ``req.retry_after`` either way."""
        from ..resilience import fault_injection as _fi
        _fi.check("serving.admit")  # chaos site: admission stragglers/faults
        now = self.clock.now() if arrival_ts is None else float(arrival_ts)
        if max_new_tokens is None:
            max_new_tokens = self.engine.econfig.max_new_tokens
        if max_new_tokens <= 0:
            raise ValueError(f"max_new_tokens must be positive, got {max_new_tokens}")
        uid = next(self._uids)
        while uid in self.engine.state.seqs:
            # a direct engine.put() caller (mixed use) claimed this uid after
            # the counter was snapshotted — skip past, never alias their
            # sequence (get_or_create would EXTEND its token list)
            uid = next(self._uids)
        req = ServingRequest(
            uid=uid, prompt=list(prompt), arrival_ts=now,
            max_new_tokens=max_new_tokens,
            deadline=deadline, priority=priority, stream=stream, spec=spec)
        if resume_tokens:
            if len(resume_tokens) >= max_new_tokens:
                raise ValueError(
                    f"resume_tokens ({len(resume_tokens)}) must leave output budget "
                    f"under max_new_tokens ({max_new_tokens}) — a fully-generated "
                    "request has nothing to resume")
            req.tokens.extend(int(t) for t in resume_tokens)
        req.kv_snapshot = kv_snapshot
        self._requests[req.uid] = req
        self.stats.submitted += 1
        if self.tracer.enabled:
            # fleet mode (parent attempt span given): phases clamp to the
            # submission instant so a resumed attempt's backdated arrival
            # doesn't double-count the previous attempt's time
            self._trace_ctx[req.uid] = (
                trace_id if trace_id is not None else self.tracer.new_trace_id(),
                parent_span_id,
                self.clock.now() if parent_span_id is not None else None)
        if self.metrics is not None:
            self.metrics.counter("serving/submitted").inc()
        ok, reason = self.admission.submit_ok(req, len(self._queue))
        if not ok and reason == "queue_full" and retry_policy is not None:
            from ..resilience.retry import backoff_until

            # FIRST honor the admission controller's retry-after hint: one
            # informed wait sized to the queue's estimated drain time,
            # ticking so the queue actually drains.  Only if the hinted
            # wait was not enough does the blind exponential ladder run —
            # the hint turns most backoffs into a single well-aimed probe.
            # The hint is CLAMPED to the policy's time budget (the caller
            # bounded how long submit may block — the hinted wait and the
            # ladder share ONE budget, not a budget each) and to the
            # request's own deadline (waiting past it can only time out).
            hint = self.admission.retry_after_hint(
                len(self._queue), self._ewma_step_s)
            hint = min(hint, retry_policy.budget_s)
            if deadline is not None:
                hint = max(0.0, min(hint, deadline - self.clock.now()))
            t_hint = self.clock.now()
            target = t_hint + hint
            ok, why = False, "queue_full"   # a zero hint changes nothing
            while self.clock.now() < target:
                before = self._progress_marker()
                self.tick()
                ok, why = self.admission.submit_ok(req, len(self._queue))
                if ok or why != "queue_full":
                    break   # capacity freed early (or drained into a
                    # structural answer): don't sit out the rest of the hint
                if self._progress_marker() == before:
                    # nothing admissible moved: wait out the remainder of
                    # the hint instead of spinning (WallClock sleeps here;
                    # a productive tick is progress, not a spin, so the
                    # marker — never the raw clock — decides; the wait
                    # itself cannot change what submit_ok reads)
                    self.clock.wait_until(target)
                    self._note_idle()
            if ok:
                reason = None
            elif why != "queue_full":
                reason = why   # drained into a structural rejection
            else:
                def _probe():
                    self.tick()  # drain queued work: backoff must be able to succeed
                    got, w = self.admission.submit_ok(req, len(self._queue))
                    return got, w == "queue_full"

                ladder = dataclasses.replace(
                    retry_policy, budget_s=max(
                        0.0, retry_policy.budget_s - (self.clock.now() - t_hint)))
                if backoff_until(_probe, ladder, self.clock,
                                 site="serving.admit"):
                    ok, reason = True, None
                else:
                    ok, reason = self.admission.submit_ok(req, len(self._queue))
            # the clock advanced (and the engine ticked) during the
            # backoff — a terminal transition stamped with the stale
            # pre-backoff `now` would erase the wait the request lived
            now = self.clock.now()
        if not ok:
            req.reject_reason = reason
            if reason == "queue_full":
                # transient: tell the client WHEN to come back (the fleet
                # router and submit(retry_policy=) both honor this)
                req.retry_after = self.admission.retry_after_hint(
                    len(self._queue), self._ewma_step_s)
            req.to(RequestState.REJECTED, now)
            self.stats.record_reject(reason)
            self.stats.record_terminal(req)
            self._requests.pop(req.uid, None)
            if self.metrics is not None:
                self.metrics.counter("serving/rejected").inc()
            self._trace_terminal(req, now)
            self._emit([("serving/rejected", 1.0, self._next_event_step())])
            return req
        self._queue.append(req)
        return req

    # ---------------------------------------------------------------- tick

    def tick(self) -> Dict[int, List[int]]:
        """One serving iteration.  Serial mode (default): expire
        deadlines, admit, resolve KV pressure, run one engine step,
        deliver tokens.  Async mode (``config.async_dispatch``): complete
        the step dispatched LAST tick, then enqueue the next one — see
        :meth:`_tick_pipelined`.  Returns the completed step's
        {uid: [tokens]} (empty when nothing was runnable)."""
        if self.tier is not None:
            # capacity-pressure demotion (docs/SERVING.md "Tiered KV"):
            # coldest-first device→host demotion / host drops once the
            # configured occupancy watermarks are crossed — a no-op with
            # the default (None) watermarks
            self.tier.enforce_watermarks()
        if self.config.async_dispatch:
            return self._tick_pipelined()
        return self._tick_serial()

    def _tick_serial(self) -> Dict[int, List[int]]:
        """The strictly serial host→device step loop.

        With a step-anatomy recorder on the engine, the tick opens the
        step window BEFORE the admission/preflight work (``step_begin``
        is idempotent — the engine's own call then no-ops) and attributes
        planning up to the engine call as the ``schedule`` segment; on
        clock-charged steps (VirtualClock / fleet clock views) the
        charged cost is forwarded as the step's device seconds.  Ticks
        that run no step leave the window open — their host work folds
        into the step that eventually runs, which is exactly the loop tax
        the anatomy exists to expose."""
        anat = getattr(self.engine, "anatomy", NULL_ANATOMY)
        if anat.enabled:
            anat.step_begin()
        now = self.clock.now()
        self._expire(now)
        self._admit(now)
        if not self._active:
            return {}
        evicted, plan = self.kvp.resolve()
        for seq in evicted:
            self._on_preempted(seq, now)
        if not self._active:  # everything runnable got preempted/expired
            return {}
        if not plan.decode and not plan.prefill:
            # every active sequence is paused (mid-KV-migration): there is
            # no step to run and no cost to charge — the export chunks are
            # the fleet driver's work, not this replica's step loop's
            return {}
        if anat.enabled:
            anat.mark("schedule")
        cost = 1.0
        if self.config.step_cost is not None:
            cost = self.config.step_cost(plan.planned_tokens)
        t_step = self.clock.now()
        out = self.engine.step(plan)
        # clock-domain step seconds: clocks that account the cost themselves
        # (VirtualClock, ReplicaClockView) return it; WallClock returns None
        # and the real elapsed time is measured
        charged = self.clock.on_step(cost)
        dt = charged if charged is not None else self.clock.now() - t_step
        self._ewma_step_s = dt if self._ewma_step_s is None \
            else 0.8 * self._ewma_step_s + 0.2 * dt
        if anat.enabled:
            if charged is not None:
                anat.charge_last_step(charged)
            self._fold_anatomy(anat)
        # fold BEFORE _deliver: finishing a request flushes its engine
        # sequence, which pops its last_spec_round entry
        self._record_spec_rounds()
        self._deliver(out, self.clock.now())
        return out

    def _tick_pipelined(self) -> Dict[int, List[int]]:
        """Async double-buffered serving tick: step g+1's host-side work
        runs while step g executes on device, blocking only at the
        sample/accept readback.

        Pipeline stages, in tick order:

        1. **overlap window** — deadline expiry and admission run while
           last tick's dispatch is still in flight; with a recorder
           attached the stretch lands in the open step's ``overlap``
           segment (loop tax hidden under device time).  A sequence
           flushed here while in flight is skipped whole at the fold
           (object-identity guards in ``complete_step``) — its computed
           tokens are discarded, never half-applied.
        2. **complete** — the one blocking point: read back step g's
           tokens and fold them into engine state.
        3. **dispatch** — KV-pressure preflight, plan, and enqueue step
           g+1.  The clock cost is charged AT DISPATCH (not completion),
           so every ``clock.now()`` reading a request observes matches
           the serial loop's.
        4. **deliver** — step g's tokens reach their requests while step
           g+1 is already on device; the timestamp is captured BEFORE
           g+1's charge, so delivery/finish times equal the serial
           loop's (sum of costs through step g).  Runs in a ``finally``:
           a g+1 dispatch failure must never lose g's delivered tokens.
        """
        anat = getattr(self.engine, "anatomy", NULL_ANATOMY)
        now = self.clock.now()
        self._expire(now)
        self._admit(now)
        if anat.enabled:
            anat.mark("overlap")   # no-op when no step window is open
        out: Dict[int, List[int]] = {}
        if self._inflight is not None:
            inf, charged, t_dispatch = self._inflight
            self._inflight = None
            out = self.engine.complete_step(inf)
            dt = charged if charged is not None \
                else self.clock.now() - t_dispatch
            self._ewma_step_s = dt if self._ewma_step_s is None \
                else 0.8 * self._ewma_step_s + 0.2 * dt
            if anat.enabled:
                self._fold_anatomy(anat)
            # fold BEFORE the next dispatch (it clears last_spec_round)
            # and BEFORE _deliver (finishing a request flushes its engine
            # sequence, which pops its entry)
            self._record_spec_rounds()
        # serial-parity delivery timestamp: the clock already carries
        # every step cost through g (charged at its own dispatch), and
        # g+1's charge has not landed yet
        t_deliver = self.clock.now()
        if not self._active:
            self._deliver(out, t_deliver)
            return out
        if anat.enabled:
            anat.step_begin()      # open step g+1's window for its planning
        try:
            evicted, plan = self.kvp.resolve()
            for seq in evicted:
                self._on_preempted(seq, now)
            if self._active and (plan.decode or plan.prefill):
                if anat.enabled:
                    anat.mark("schedule")
                cost = 1.0
                if self.config.step_cost is not None:
                    cost = self.config.step_cost(plan.planned_tokens)
                t_dispatch = self.clock.now()
                inf = self.engine.dispatch_step(plan)
                if inf is not None:
                    # charge-at-dispatch: clock-accounted costs land when
                    # the step enqueues, keeping arrivals/admission and
                    # delivery timestamps aligned with the serial loop
                    charged = self.clock.on_step(cost)
                    if charged is not None and anat.enabled:
                        # the virtual charge is this step's device time —
                        # claim it now so the next overlap window cannot
                        # absorb it as host work
                        anat.device_mark()
                    self._inflight = (inf, charged, t_dispatch)
        finally:
            self._deliver(out, t_deliver)
        return out

    def _fold_anatomy(self, anat) -> None:
        """Bridge the engine's step-anatomy state into the serving
        telemetry surfaces: new JIT cache misses become ``engine/
        recompiles`` counter increments (steady-state ones additionally
        the ``engine/recompile_steady_state`` counter + event — the AOT
        regression signal, loud by design), and the just-closed step is
        mirrored as one bounded ``anatomy/step`` span on this frontend's
        flight-recorder track."""
        compiles = anat.compiles
        if len(compiles) > self._compiles_seen:
            for c in list(compiles)[self._compiles_seen:]:
                if self.metrics is not None:
                    self.metrics.counter("engine/recompiles").inc()
                if c.steady:
                    if self.metrics is not None:
                        self.metrics.counter(
                            "engine/recompile_steady_state").inc()
                    logger.warning(
                        f"steady-state recompile: program {c.key} compiled "
                        f"at step {c.step_index} AFTER the warm-up boundary "
                        "— the bucketed step set is not closed")
                    self._emit([("engine/recompile_steady_state", 1.0,
                                 self._next_event_step())])
            self._compiles_seen = len(compiles)
        if anat.total_steps > self._anat_steps_seen:
            unseen = anat.total_steps - self._anat_steps_seen
            self._anat_steps_seen = anat.total_steps
            recorder = self.recorder if self.recorder is not None \
                else getattr(self.tracer, "recorder", None)
            if recorder is not None:
                # mirror EVERY unseen closed step, not just the newest —
                # a chaos-failed step closes its record but skips that
                # tick's fold, and its anatomy is exactly what a
                # crash-scoped dump needs (deque eviction bounds the tail)
                steps = anat.steps
                for rec in list(steps)[-min(unseen, len(steps)):]:
                    recorder.span(
                        "anatomy/step", f"anatomy/{self.trace_track}",
                        rec.end_ts - rec.wall_s, rec.end_ts,
                        attrs={"shape": rec.shape_key,
                               "host_gap_s": round(rec.host_gap_s, 9),
                               "host_s": round(rec.host_s(), 9),
                               "device_s": round(rec.device_s, 9),
                               "compiles": rec.compiles})

    def export_kv_gauges(self) -> None:
        """Publish the engine's KV-arena occupancy onto the metrics
        registry (``kv/*`` gauges — page occupancy, free-run
        fragmentation, prefix-cache share; docs/OBSERVABILITY.md "Step
        anatomy").  Standalone frontends call this at whatever cadence
        they report; the fleet router exports the per-replica variants
        once per fleet round instead.  No-op without a registry."""
        if self.metrics is None:
            return
        st = self.engine.kv.arena_stats()
        m = self.metrics
        m.gauge("kv/pages_in_use").set(st["in_use"])
        m.gauge("kv/pages_free").set(st["free"])
        m.gauge("kv/page_occupancy").set(st["occupancy"])
        m.gauge("kv/free_run_fragmentation").set(st["free_run_fragmentation"])
        m.gauge("kv/prefix_cache_pages").set(st["prefix_cache_pages"])
        m.gauge("kv/prefix_cache_share").set(st["prefix_cache_share"])
        if self.tier is not None:
            m.gauge("kv/host_pages").set(self.tier.host.pages_used)
            frac = self.tier.hidden_frac
            m.gauge("kv/tier_prefetch_hidden_frac").set(
                frac if frac is not None else 0.0)

    def _record_spec_rounds(self) -> None:
        """Fold the step's verify-round accounting (``engine.last_spec_round``,
        one ``(proposed, accepted, rollback_pages)`` per speculating uid)
        into per-request counters and the ``spec/*`` metrics."""
        rounds = getattr(self.engine, "last_spec_round", None)
        if not rounds:
            return
        for uid, (proposed, accepted, rb_pages) in rounds.items():
            req = self._active.get(uid)
            if req is not None:
                req.spec_proposed += proposed
                req.spec_accepted += accepted
                req.spec_rollback_pages += rb_pages
            if self.metrics is not None and proposed:
                self.metrics.counter("spec/proposed").inc(proposed)
                self.metrics.counter("spec/accepted").inc(accepted)
                self.metrics.counter("spec/rollback_pages").inc(rb_pages)
                self.metrics.histogram("spec/acceptance_rate").record(
                    accepted / proposed)

    def _expire(self, now: float) -> None:
        if not self.config.kill_on_deadline:
            return
        for req in [r for r in self._queue if r.deadline is not None and now > r.deadline]:
            self._queue.remove(req)
            self._finish(req, RequestState.TIMED_OUT, now)
        for uid in [u for u, r in self._active.items()
                    if r.deadline is not None and now > r.deadline]:
            req = self._active.pop(uid)
            self.engine.flush(uid)  # reclaim KV pages + engine state
            self._finish(req, RequestState.TIMED_OUT, now)
        for uid in [u for u, r in self._parked.items()
                    if r.deadline is not None and now > r.deadline]:
            req = self._parked.pop(uid)
            if self.tier is not None:
                self.tier.discard(uid)  # reclaim host pages + prefetch slot
            self._finish(req, RequestState.TIMED_OUT, now)

    def _admit(self, now: float) -> None:
        """FCFS-with-aging head-of-line admission: the queue is served in
        priority order and stops at the first request that does not fit —
        skipping ahead would starve large requests behind a stream of small
        ones (the aging mechanism exists to prevent exactly that)."""
        self._queue.sort(key=lambda r: self._priority_key(r, now))
        reserved = 0  # pages promised to this tick's earlier admissions
        while self._queue:
            req = self._queue[0]
            if not self.admission.can_start(req, reserved_pages=reserved):
                break
            self._queue.pop(0)
            assert req.remaining_new_tokens > 0, req
            assert req.uid not in self.engine.state.seqs, (
                f"uid {req.uid} already live in the engine (direct put() "
                "collision) — cannot admit")
            imported = req.kv_snapshot is not None and self._try_import(req)
            if not imported:
                if self.tier is not None:
                    # warm-on-host prefix promotion: pull any host-staged
                    # chain tail for this prompt device-side first, so the
                    # prefill below skips it via the ordinary match()
                    self._promote_prefix_for(req)
                self.engine.put([req.uid], [req.engine_tokens()],
                                max_new_tokens=req.remaining_new_tokens)
            if req.spec is not None:
                # re-applied on every (re)admission: preemption/flush
                # cleared the engine's per-uid opt-out
                self.engine.set_spec(req.uid, req.spec)
            # a tier promotion may have stalled admission (the non-hidden
            # transfer remainder advanced the clock): stamp with the
            # settled time, never a pre-stall reading
            adm_now = max(now, self.clock.now())
            if req.admitted_ts is None:
                req.admitted_ts = adm_now
            req.to(RequestState.PREFILL, adm_now)
            self._active[req.uid] = req
            reserved += self.admission._start_pages(req)

    def _try_import(self, req: ServingRequest) -> bool:
        """KV-import fast path at admission: scatter ``req.kv_snapshot``
        into this engine's arena so decode continues without recomputing
        the prompt.  Returns False — after consuming the snapshot — on any
        ordinary rejection (torn snapshot, geometry/dtype drift, token
        mismatch, no page room): the caller falls back to the recompute
        prefill, which is always correct.  Replica-fatal failures
        (``InjectedCrash`` driver death, ``DeviceLossError``) re-raise with
        the request pushed back onto the queue so the kill path collects
        it for failover."""
        from ..resilience.fault_injection import DeviceLossError
        from .kvtier import HostKVHandle
        from .kvtransfer import import_snapshot
        snap, req.kv_snapshot = req.kv_snapshot, None   # consumed either way
        if isinstance(snap, HostKVHandle):
            # parked/demoted locally: resolve the handle through the tier
            # (kv.promote chaos site, prefetch-window settlement).  A None
            # snapshot is any degradable miss — recompute owns the resume.
            snap, stall, window = self.tier.claim(
                req.uid, req.engine_tokens(), self.clock.now())
            if snap is None:
                self.stats.kv_import_fallbacks += 1
                if self.metrics is not None:
                    self.metrics.counter("migration/import_fallback").inc()
                return False
            self._charge_promote_stall(req, stall, window)
        try:
            import_snapshot(self.engine, req.uid, req.engine_tokens(), snap,
                            max_new_tokens=req.remaining_new_tokens)
        except InjectedCrash:
            raise  # simulated DRIVER death; chaos tests must see it
        except DeviceLossError:
            # this replica's device is gone: re-queue the request so the
            # health-driven kill path collects it for failover, then let
            # the loss classify this replica dead.  The snapshot is HOST
            # memory — it survives this device and goes back on the
            # request so failover can retry the import on a survivor.
            req.kv_snapshot = snap
            self._queue.insert(0, req)
            raise
        except Exception as e:
            logger.warning(f"kv import rejected for uid={req.uid} "
                           f"({e}); falling back to recompute-on-resume")
            self.stats.kv_import_fallbacks += 1
            if self.metrics is not None:
                self.metrics.counter("migration/import_fallback").inc()
            return False
        self.stats.kv_imports += 1
        if self.metrics is not None:
            self.metrics.counter("migration/kv_imports").inc()
        return True

    def _charge_promote_stall(self, req: ServingRequest, stall: float,
                              window) -> None:
        """Account one settled promotion transfer: wait out the non-hidden
        remainder (the prefetched part already hid under earlier device
        windows) and record the transfer interval on the request so
        telemetry carves it out of the queued phase as ``phase/promote``."""
        if stall > 0:
            self.clock.wait_until(self.clock.now() + stall)
            anat = getattr(self.engine, "anatomy", NULL_ANATOMY)
            if anat.enabled:
                anat.mark("promote_wait")
        if window is not None:
            req.promote_windows.append(window)

    def _promote_prefix_for(self, req: ServingRequest) -> None:
        """Pre-admission warm-on-host promotion: if the host tier holds a
        chain tail for this request's tokens beyond what the device prefix
        cache has, scatter it back and adopt it so the prefill's
        ``match()`` attaches those pages instead of recomputing their KV.
        Failures degrade silently to the ordinary cold prefill."""
        n, stall, window = self.tier.promote_prefix(
            req.engine_tokens(), self.clock.now())
        if n:
            self._charge_promote_stall(req, stall, window)

    def import_prefix(self, snapshot) -> int:
        """Adopt a host-staged hot-prefix snapshot into this replica's
        prefix cache (``kvtransfer.import_prefix``) so the NEXT admission
        of a matching prompt attaches the pages instead of recomputing
        their KV — the fleet prefix directory's cold-replica warm-up path
        (docs/SERVING.md "Prefix directory").  Returns pages imported;
        raises a ``SnapshotError`` subclass on rejection (the caller
        dispatches cold and counts the fallback).  Unlike the migration
        import this touches no request state — it is pure cache
        population, safe before the request is even submitted here."""
        from .kvtransfer import import_prefix
        n = import_prefix(self.engine, snapshot)
        if n:   # already-warm no-ops are not imports
            self.stats.prefix_imports += 1
            self.stats.prefix_import_pages += n
            if self.metrics is not None:
                self.metrics.counter("prefix/import").inc()
        return n

    # ------------------------------------------------- tiered KV (kvtier)

    def attach_tier(self, tier) -> None:
        """Wire a ``kvtier.TieredKVManager`` into this frontend: park()/
        resume() become available, KV-pressure preemption demotes victims
        to the host tier before releasing their pages (demotion-first),
        and admission resolves ``HostKVHandle`` snapshots through the
        tier's prefetch-hidden promotion path (docs/SERVING.md "Tiered
        KV")."""
        self.tier = tier
        self.kvp.tier = tier
        if tier.metrics is None:
            tier.metrics = self.metrics

    def park(self, uid: int, phase: str = "parked") -> bool:
        """Park an idle decoding session: demote its KV pages to the host
        tier, release its engine sequence, and hold the request in PARKED
        until :meth:`resume`.  The session costs ZERO device pages while
        parked; its resume promotes the staged pages back (prefetched, so
        the h2d transfer hides under intervening steps) instead of
        recomputing the prompt.  Returns False when the request is not an
        active unfinished DECODE (parking mid-prefill or mid-step work is
        not a supported window) or has no tier to park into.  A failed
        demotion still parks — that resume just recomputes (the
        kv_snapshot stays None), the ladder's never-wrong fallback.

        ``phase`` labels the PARKED interval for telemetry ("parked" for
        idle-session parks, "tool_stall" for a session's mid-generation
        tool-call stall — serving/sessions); the park/resume machinery is
        identical either way."""
        req = self._active.get(uid)
        if self.tier is None or req is None \
                or req.state is not RequestState.DECODE:
            return False
        seq = self.engine.state.seqs.get(uid)
        if seq is None or seq.done or seq.paused:
            return False
        now = self.clock.now()
        # demote BEFORE preempt: the gather needs the pages still live
        handle = self.tier.demote_sequence(uid)
        self.engine.preempt(uid)
        del self._active[uid]
        req.park_phase = phase
        req.to(RequestState.PARKED, now)
        req.kv_snapshot = handle
        self._parked[uid] = req
        self.stats.parks += 1
        if self.metrics is not None:
            self.metrics.counter("kv/park").inc()
        self._emit([("kv/park", 1.0, self._next_event_step())])
        return True

    def prefetch_resume(self, uid: int) -> bool:
        """Hint that a PARKED request will resume soon: issue its h2d
        promotion transfer NOW, so it runs under the device windows of the
        steps between this call and the actual :meth:`resume` — the
        prefetch-hidden promotion contract.  A session controller that
        knows the next user turn is coming (typing indicator, scheduled
        agent step) calls this ahead of resume; an unhinted resume still
        prefetches, it just has less time to hide.  Idempotent; False for
        an unknown/non-parked/snapshot-less uid."""
        req = self._parked.get(uid)
        if req is None or req.kv_snapshot is None or self.tier is None:
            return False
        self.tier.prefetch(uid, req.kv_snapshot.n_pages, self.clock.now())
        return True

    def resume(self, uid: int) -> bool:
        """Re-enqueue a PARKED request and issue its promotion prefetch
        (if :meth:`prefetch_resume` didn't already), so by the time
        admission reaches it the h2d transfer has (partly or wholly)
        hidden under the steps in between.  Returns False for an
        unknown/non-parked uid."""
        req = self._parked.pop(uid, None)
        if req is None:
            return False
        now = self.clock.now()
        req.to(RequestState.QUEUED, now)
        if req.kv_snapshot is not None and self.tier is not None:
            self.tier.prefetch(uid, req.kv_snapshot.n_pages, now)
        self._queue.append(req)
        self.stats.resumes += 1
        if self.metrics is not None:
            self.metrics.counter("kv/resume").inc()
        self._emit([("kv/resume", 1.0, self._next_event_step())])
        return True

    # ----------------------------------------------------------- migration

    def begin_migration(self, uid: int, chunk_pages: int = 4, source=None):
        """Pause a request for KV export (docs/SERVING.md "Disaggregated
        serving").  Its engine sequence keeps its pages but leaves step
        planning, so the pages stay byte-stable while the returned
        ``kvtransfer.KVExporter`` stages them chunk by chunk between this
        replica's ongoing ticks.

        Two migratable windows:

        * LATE PREFILL — the DistServe handoff boundary: at least one full
          page of prompt KV is staged and at most one prefill chunk
          remains, so the decode replica runs only the final chunk (which
          samples the first token) and the staging pause lands in TTFT,
          never in the token cadence;
        * DECODE — the catch-up path (short prompts prefill whole in one
          chunk and are first observable here; failed earlier migrations
          retry here).

        Returns None when the request is in neither window (not active,
        already paused, finished, or too early in prefill) or the engine's
        cache layout is not exportable — the router just skips it."""
        from .kvtransfer import KVExporter, KVImportError
        req = self._active.get(uid)
        if req is None or req.state not in (RequestState.PREFILL,
                                            RequestState.DECODE):
            return None
        seq = self.engine.state.seqs.get(uid)
        if seq is None or seq.done or seq.paused:
            return None
        if req.state is RequestState.PREFILL:
            if seq.seen_tokens < self.engine.kv.page_size or \
                    seq.remaining_prefill > self.engine.scheduler.config.prefill_chunk:
                return None  # too early: let the prefill replica keep grinding
        elif not seq.in_decode:
            return None
        seq.paused = True
        try:
            exporter = KVExporter(self.engine, uid, chunk_pages=chunk_pages,
                                  source=source)
        except KVImportError as e:
            # structurally unexportable on THIS engine (e.g. the
            # unroll_layers per-layer tuple cache layout): not a migratable
            # request, not an error — the caller keeps serving it here
            seq.paused = False
            logger.debug(f"begin_migration({uid}): not exportable ({e})")
            return None
        except Exception:
            seq.paused = False
            raise
        req.to(RequestState.MIGRATING, self.clock.now())
        return exporter

    def abort_migration(self, uid: int) -> None:
        """Resume a MIGRATING request in place (export failed, or no decode
        replica can take the handoff): the sequence re-enters step planning
        and the phase the pause interrupted (prefill or decode) continues
        on THIS replica exactly where it stopped."""
        req = self._active.get(uid)
        if req is None or req.state is not RequestState.MIGRATING:
            return
        seq = self.engine.state.seqs.get(uid)
        if seq is not None:
            seq.paused = False
        back = RequestState.DECODE if seq is not None and seq.in_decode \
            else RequestState.PREFILL
        req.to(back, self.clock.now())

    def complete_migration(self, uid: int) -> ServingRequest:
        """Close out a MIGRATING request whose snapshot fully exported: the
        engine sequence is flushed (pages released — full pages published
        to the prefix cache survive via the cache's refcount), the request
        reaches the MIGRATED terminal state on THIS replica, and the
        caller re-submits it on the decode replica with the snapshot.
        Returns the closed request."""
        now = self.clock.now()
        req = self._active.pop(uid)
        assert req.state is RequestState.MIGRATING, req
        self.engine.flush(uid)
        req.to(RequestState.MIGRATED, now)
        self.stats.record_terminal(req)
        self._requests.pop(req.uid, None)
        if self.metrics is not None:
            self.metrics.counter("serving/migrated").inc()
        self._trace_terminal(req, now)
        self._emit([("serving/migrated", 1.0, self._next_event_step())])
        return req

    def _on_preempted(self, seq, now: float) -> None:
        req = self._active.pop(seq.uid, None)
        if req is None:
            # a sequence put() directly on the engine by some other caller
            # (mixed use is allowed — _seq_order_key/_youth_key rank such
            # sequences so they are preempted only as a last resort).  Its
            # pages are already released; there is no request to requeue —
            # warn so the owner knows their sequence is gone
            logger.warning(f"KV pressure evicted non-frontend sequence uid={seq.uid} "
                           f"({len(seq.generated)} generated tokens lost to this "
                           "serving loop; re-put() it to resume)")
            self.stats.preemptions += 1
            return
        # every token the evicted sequence generated was already delivered to
        # req.tokens at the tick it was sampled — the descriptor can be
        # dropped without losing output
        req.to(RequestState.EVICTED, now)
        req.preemptions += 1
        self.stats.preemptions += 1
        if self.metrics is not None:
            self.metrics.counter("serving/preemptions").inc()
        self._emit([("serving/preempted", 1.0, self._next_event_step())])
        req.to(RequestState.QUEUED, now)
        if self.tier is not None and req.kv_snapshot is None:
            # demotion-first preemption (kv_pressure): the tier staged the
            # victim's pages before preempt freed them — ride the handle on
            # the request and start the promote prefetch NOW, so by
            # re-admission the h2d transfer has hidden under the steps that
            # ran in between
            handle = self.tier.handle_for(req.uid)
            if handle is not None:
                req.kv_snapshot = handle
                self.tier.prefetch(req.uid, handle.n_pages, now)
        self._queue.append(req)

    def _deliver(self, out: Dict[int, List[int]], now: float) -> None:
        for uid in sorted(out):
            toks = out[uid]
            req = self._active.get(uid)
            if req is None or not toks:
                continue
            if req.first_token_ts is None:
                req.first_token_ts = now
            if req.state is RequestState.PREFILL:
                req.to(RequestState.DECODE, now)
            req.tokens.extend(int(t) for t in toks)
            if req.stream is not None:
                try:
                    req.stream(req, [int(t) for t in toks], now)
                except InjectedCrash:
                    raise  # simulated process death; chaos tests must see it
                except Exception as e:
                    # one client's broken delivery sink (closed socket, ...)
                    # must not take down every other in-flight request; the
                    # request itself keeps generating — same stance as _emit
                    logger.warning(f"stream callback failed for uid={uid}: {e}")
                    req.stream = None
            seq = self.engine.state.seqs.get(uid)
            if seq is not None and seq.done:
                req.finish_ts = now
                self.engine.flush(uid)
                del self._active[uid]
                self._finish(req, RequestState.DONE, now)

    def _finish(self, req: ServingRequest, state: RequestState, now: float) -> None:
        req.to(state, now)
        self.stats.record_terminal(req)
        # terminal requests leave the lookup table (their engine sequence is
        # gone; keys here must not grow without bound in a long-lived
        # server) — the caller's handle and stats.finished keep the record
        self._requests.pop(req.uid, None)
        self._record_terminal_metrics(req, state, now)
        self._trace_terminal(req, now)
        step = self._next_event_step()
        events = [("serving/e2e_latency", now - req.arrival_ts, step),
                  ("serving/preemptions", float(req.preemptions), step)]
        if state is RequestState.DONE:
            if req.ttft is not None:
                events.append(("serving/ttft", req.ttft, step))
            if req.tpot is not None:
                events.append(("serving/tpot", req.tpot, step))
            if req.queue_wait is not None:
                events.append(("serving/queue_wait", req.queue_wait, step))
            events.append(("serving/deadline_met", 1.0 if req.met_deadline else 0.0, step))
        else:
            events.append(("serving/timed_out", 1.0, step))
        self._emit(events)

    # ----------------------------------------------------------- telemetry

    def _record_terminal_metrics(self, req: ServingRequest, state: RequestState,
                                 now: float) -> None:
        if self.metrics is None:
            return
        self.metrics.counter(f"serving/{state.value}").inc()
        self.metrics.histogram("serving/e2e_s").record(now - req.arrival_ts)
        if state is RequestState.DONE:
            if req.ttft is not None:
                self.metrics.histogram("serving/ttft_s").record(req.ttft)
            if req.tpot is not None:
                self.metrics.histogram("serving/tpot_s").record(req.tpot)
            if req.queue_wait is not None:
                self.metrics.histogram("serving/queue_wait_s").record(req.queue_wait)

    def _trace_terminal(self, req: ServingRequest, now: float) -> None:
        """Fold the finished request's state history into trace spans.

        Standalone: a ``request`` root span [arrival, terminal] on this
        frontend's track, with phase children (queued/prefill/decode) and
        one ``preempted`` span event per eviction.  Under a fleet router
        (an attempt parent span was passed at submit): only the phase
        children are emitted here — the router owns the root and the
        attempt spans, and phases clamp to the dispatch instant."""
        ctx = self._trace_ctx.pop(req.uid, None)
        if ctx is None:
            return
        from ..telemetry.spans import emit_attempt_spans
        trace_id, parent_id, clamp = ctx
        if parent_id is not None:
            emit_attempt_spans(self.tracer, req, trace_id, parent_id,
                               self.trace_track, end_ts=now, clamp_start=clamp)
            return
        root_id = self.tracer.reserve_span_id()
        emit_attempt_spans(self.tracer, req, trace_id, root_id,
                           self.trace_track, end_ts=now)
        events = [("preempted", ts, None) for st, ts in req.history
                  if st is RequestState.EVICTED]
        self.tracer.add_span(
            "request", trace_id, req.arrival_ts, now, span_id=root_id,
            track=self.trace_track, events=events,
            attrs={"uid": req.uid, "state": req.state.value,
                   "prompt_len": len(req.prompt), "n_tokens": len(req.tokens),
                   "preemptions": req.preemptions,
                   "reject_reason": req.reject_reason,
                   "ttft": req.ttft, "tpot": req.tpot,
                   "queue_wait": req.queue_wait,
                   "e2e": now - req.arrival_ts,
                   "deadline_met": req.met_deadline})

    # ---------------------------------------------------------------- loop

    def drain(self, max_ticks: int = 1_000_000) -> None:
        """Run ticks until queue + active are empty."""
        self._loop(pending_arrival=lambda: None, max_ticks=max_ticks)

    def loop(self, feed=None, max_ticks: int = 1_000_000) -> None:
        """Generic stall-guarded driver for callers that generate load
        dynamically (e.g. closed-loop benchmarking): ``feed()`` runs at the
        top of every iteration, may submit new requests, and returns the
        next known FUTURE arrival timestamp (or None).  Terminates when
        feed() has nothing pending and queue + active are empty; raises on
        a stall instead of spinning."""
        self._loop(pending_arrival=feed or (lambda: None), max_ticks=max_ticks)

    def run(self, arrivals: List[dict], max_ticks: int = 1_000_000) -> List[ServingRequest]:
        """Open-loop driver: ``arrivals`` is a list of submit() kwarg dicts,
        each with an ``arrival_ts``; requests are submitted as the clock
        passes their arrival time, idle gaps are skipped (VirtualClock) or
        slept (WallClock).  Returns the request objects in arrival order."""
        pending = sorted(arrivals, key=lambda a: a["arrival_ts"])
        reqs: List[ServingRequest] = []
        i = 0

        def feed():
            nonlocal i
            while i < len(pending) and pending[i]["arrival_ts"] <= self.clock.now():
                reqs.append(self.submit(**pending[i]))
                i += 1
            return pending[i]["arrival_ts"] if i < len(pending) else None

        self._loop(pending_arrival=feed, max_ticks=max_ticks)
        return reqs

    def _loop(self, pending_arrival, max_ticks: int) -> None:
        for _ in range(max_ticks):
            next_arrival = pending_arrival()
            if not self._queue and not self._active and self._inflight is None:
                if next_arrival is None:
                    return
                self.clock.wait_until(next_arrival)
                self._note_idle()
                continue
            marker = self._progress_marker()
            self.tick()
            if self._progress_marker() == marker:
                # nothing moved: only the passage of time can help (a future
                # arrival, or a queued deadline expiring — the latter only
                # when expiry is actually enforced) — jump to it
                waits = [r.deadline for r in self._queue if r.deadline is not None] \
                    if self.config.kill_on_deadline else []
                if next_arrival is not None:
                    waits.append(next_arrival)
                if not waits:
                    raise RuntimeError(
                        f"serving loop stalled: {len(self._queue)} queued, "
                        f"{len(self._active)} active, no admissible work and no "
                        "future event to wait for")
                self.clock.wait_until(min(waits) + 1e-9)
                self._note_idle()
        raise RuntimeError(f"serving loop exceeded max_ticks={max_ticks}")

    def _note_idle(self) -> None:
        """The loop just idled to a future event: exclude the jump from
        the step anatomy (idle is absent load, not step-loop tax — the
        next step is flagged ``after_idle`` instead)."""
        anat = getattr(self.engine, "anatomy", NULL_ANATOMY)
        if anat.enabled:
            anat.note_idle()

    def _progress_marker(self):
        # the in-flight flag counts as progress: a pipelined tick that
        # only dispatches (or only drains) changes nothing else yet
        return (len(self.stats.finished), self.stats.preemptions,
                len(self._queue), len(self._active),
                sum(s.seen_tokens for s in self.engine.state.seqs.values()),
                sum(len(r.tokens) for r in self._active.values()),
                self._inflight is not None)

    def fence(self) -> Dict[str, int]:
        """Cancel EVERY in-flight request on this frontend — the fleet
        fencing edge (docs/SERVING.md "Control-plane transport").  A
        replica that outlived its lease (a partition, not a death) kept
        decoding work the router has already re-dispatched to survivors;
        when the partition heals, the router's FENCE lands here and that
        zombie work — queued, active, or paused mid-migration — is
        dropped: engine sequences flushed (pages released; prefix-cache
        published pages survive via their refcounts), requests abandoned
        WITHOUT a terminal transition, exactly as a ``pool.kill`` abandons
        them — the fleet-level record was already re-homed, and a second
        terminal here would be the double-serve fencing exists to prevent.
        Returns the cancel counts for the fence ack."""
        if self._inflight is not None:
            # async mode with a step in flight: block on its readback and
            # discard the fold output — fenced work is dropped WHOLE (the
            # flushes below release its sequences), never half-applied
            inf, _, _ = self._inflight
            self._inflight = None
            try:
                self.engine.complete_step(inf)
            except InjectedCrash:
                raise
            except Exception as e:
                logger.warning(f"serving: in-flight step failed during "
                               f"fence ({e}); dropping it")
        counts = {"queued": len(self._queue), "active": len(self._active),
                  "parked": len(self._parked)}
        for req in list(self._queue):
            self._requests.pop(req.uid, None)
            self._trace_ctx.pop(req.uid, None)
        self._queue.clear()
        for uid in sorted(self._active):
            if uid in self.engine.state.seqs:
                self.engine.flush(uid)
            self._requests.pop(uid, None)
            self._trace_ctx.pop(uid, None)
        self._active.clear()
        for uid in sorted(self._parked):
            # parked zombies hold HOST pages, not device pages — reclaim
            # them through the tier, same no-terminal abandonment
            if self.tier is not None:
                self.tier.discard(uid)
            self._requests.pop(uid, None)
            self._trace_ctx.pop(uid, None)
        self._parked.clear()
        recorder = self.recorder if self.recorder is not None \
            else getattr(self.tracer, "recorder", None)
        if recorder is not None:
            # the replica-side half of the fencing episode, on this
            # frontend's own control track — pairs with the router-side
            # lease interval flipping FENCING→ALIVE in the same dump
            recorder.instant("ctrl/fence", f"ctrl/{self.trace_track}",
                             self.clock.now(), attrs=dict(counts))
        if counts["queued"] or counts["active"]:
            logger.warning(f"serving: fenced {counts['queued']} queued + "
                           f"{counts['active']} active request(s)")
        return counts

    def drop_trace(self, uid: int) -> None:
        """Discard this frontend's trace context for ``uid`` WITHOUT
        emitting phase spans — the router calls it when it fences or
        re-homes an attempt it can no longer trust (lease expiry): the
        router folds the attempt's observed history into the client trace
        itself, so a zombie's eventual terminal emission here would
        double-tile the attempt window.  Telemetry-only: request and
        engine state are untouched (the fence/kill path owns those)."""
        self._trace_ctx.pop(uid, None)

    def close(self) -> None:
        """Detach from the engine: wait for a step still in flight, restore
        dict-insertion step ordering and release the scheduler's reference
        to this frontend (a long-lived engine must not keep a discarded
        frontend — and its per-request stats log — reachable through
        order_key).

        The in-flight step (``async_dispatch``) is waited for and dropped
        unfolded: on the card it is a queued graph replay writing the
        engine's arena, and the fleet drops a killed replica's engine right
        after ``close``."""
        if self._inflight is not None:
            inf, _, _ = self._inflight
            self._inflight = None
            self.engine.wait_step(inf)
        if self.engine.scheduler.order_key is self._seq_order_key:
            self.engine.scheduler.order_key = None

    # ------------------------------------------------------------- metrics

    def load_stats(self) -> dict:
        """Cheap point-in-time load snapshot — the fleet router's policy
        input (O(active) dict/list reads, no engine work, safe to call every
        dispatch):

          queue_depth        — requests QUEUED at this replica (not yet in
                               the engine)
          active             — requests live in the engine (PREFILL/DECODE)
          outstanding_tokens — decode tokens still owed by active requests
                               (sum of ``remaining_new_tokens``) — the
                               least-outstanding-tokens policy's key
          free_kv_pages      — ``BlockedAllocator.free_pages`` right now
          ewma_step_s        — EWMA (alpha=0.2) of clock-seconds per
                               tick-with-work; None before the first step
        """
        return {
            "queue_depth": len(self._queue),
            "active": len(self._active),
            "parked": len(self._parked),
            "outstanding_tokens": sum(r.remaining_new_tokens for r in self._active.values()),
            "free_kv_pages": self.engine.kv.allocator.free_pages,
            "ewma_step_s": self._ewma_step_s,
        }

    def rebase_epoch(self) -> None:
        """Re-stamp this frontend's epoch at the clock's current reading.
        Callers that ``reset()`` a shared clock after expensive setup
        (fleet pool construction + engine warmup) must rebase every
        frontend built before the reset, or ``summary()``'s elapsed goes
        negative against the pre-reset ``_t0``."""
        self._t0 = self.clock.now()

    def summary(self) -> dict:
        """Aggregate stats record over this frontend's lifetime (see
        ``ServingStats.summary`` for the field definitions).  For a cheap
        instantaneous *load* snapshot — queue depth, outstanding decode
        tokens, free KV pages, EWMA step seconds — use :meth:`load_stats`;
        the fleet router polls that every dispatch, while ``summary()`` is
        the end-of-run report.

        ``monitor_dropped_events`` surfaces the ``MonitorMaster`` drop
        counter (the ``max_events`` cap): under a fleet's event volume the
        monitor sheds load silently at its own surface, and a summary that
        hid the loss would let a truncated metric stream read as a
        complete one.  ``dropped_spans`` is the tracer's equivalent."""
        rec = self.stats.summary(elapsed=self.clock.now() - self._t0)
        rec["monitor_dropped_events"] = int(getattr(self.monitor, "dropped_events", 0) or 0)
        rec["dropped_spans"] = int(self.tracer.dropped_spans)
        return rec

    def _next_event_step(self) -> int:
        self._events_step += 1
        return self._events_step

    def _emit(self, events) -> None:
        if self.monitor is None or not getattr(self.monitor, "enabled", True):
            return
        try:
            self.monitor.write_events(events)
        except InjectedCrash:
            raise  # simulated process death; chaos tests must see it
        except Exception as e:  # monitoring must never take down serving
            logger.warning(f"serving monitor write failed: {e}")
