"""Deterministic fleet simulator: arrivals + a scripted fault schedule.

Drives a :class:`~.router.Router` + :class:`~.pool.ReplicaPool` on the
pool's ONE shared clock in discrete *rounds* that model the fleet's
replicas stepping concurrently (``VirtualClock``: deterministic CPU
simulation; ``WallClock``: the same loop with real time — bench wall mode
reuses it rather than re-implementing the round structure):

  1. apply due schedule events (kill / recover / drain / restart);
  2. submit due arrivals, time out expired pending work, dispatch;
  3. tick every serving-capable replica once (each records its step cost
     into its :class:`~..clock.ReplicaClockView` instead of advancing);
  4. advance the shared clock by the MAX recorded cost — the round takes
     as long as its slowest replica, not the sum (that is what makes a
     4-replica fleet 4x the throughput of 1 in the simulation, as in
     life);
  5. fold per-replica completions up into fleet terminal states.

Everything is seeded/ordered deterministically (sorted replica order,
list-ordered arrivals and schedule, greedy decode), so the same inputs
produce bit-identical outputs on every run and machine — the property the
``bench_router.py --dryrun`` artifact and the chaos tests pin.

Token timestamps within a round are stamped at round START (the shared
clock advances only at step 4); latencies are therefore quantized to
round granularity — consistent across policies and replica counts, which
is what the comparisons need.

Schedule entries: ``(ts, action, rid)`` with action one of ``kill``,
``recover``, ``drain``, ``restart``.  ``restart`` of a DRAINING replica
defers until the replica is idle — the point of draining is that nothing
in flight is lost.
"""

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .health import ReplicaState
from .router import Router

_ACTIONS = ("kill", "recover", "drain", "restart")


# ------------------------------------------------------------------ workloads
#
# Seeded arrival generators for the fleet benches and tests.  All of them
# return Router.submit() kwarg dicts (with ``arrival_ts``) and are pure
# functions of their seed: same seed, bit-identical workload on every
# machine (np.random.default_rng is a seeded instance, so runs are
# deterministic and dslint's global-RNG rule stays satisfied).


def poisson_mixed_arrivals(seed: int, n_requests: int, rate: float, vocab: int,
                           short_len: int = 8, long_len: int = 96,
                           long_frac: float = 0.25,
                           short_new: int = 12, long_new: int = 12,
                           deadline_slack: Optional[float] = None) -> List[dict]:
    """Mixed long-prompt/short-prompt Poisson traffic — the workload
    prefill/decode disaggregation exists for: a minority of LONG prompts
    (``long_frac``) whose chunked prefills head-of-line-block every short
    request's decode steps on a monolithic replica.  Lengths jitter ±25%
    around their class mean so no two long prompts are identical.
    ``deadline_slack``: optional deadline = arrival + slack (None = no
    deadline — every request runs to completion, the shape divergence
    audits need)."""
    rng = np.random.default_rng(seed)
    t = 0.0
    arrivals = []
    for _ in range(n_requests):
        t += float(rng.exponential(1.0 / rate))
        is_long = bool(rng.random() < long_frac)
        mean_len = long_len if is_long else short_len
        p_len = max(2, int(rng.integers(int(mean_len * 0.75),
                                        int(mean_len * 1.25) + 1)))
        arrivals.append({
            "arrival_ts": round(t, 6),
            "prompt": [int(x) for x in rng.integers(1, vocab, p_len)],
            "max_new_tokens": int(long_new if is_long else short_new),
            "deadline": None if deadline_slack is None
            else round(t + deadline_slack, 6),
        })
    return arrivals


def heavy_tail_arrivals(seed: int, n_requests: int, rate: float, vocab: int,
                        prompt_median: int = 12, prompt_sigma: float = 0.8,
                        tail_frac: float = 0.1, tail_alpha: float = 1.2,
                        tail_scale: int = 32, max_prompt: int = 192,
                        out_median: int = 8, out_sigma: float = 0.5,
                        max_new: int = 24,
                        deadline_slack: Optional[float] = None) -> List[dict]:
    """Heavy-tailed production-shaped traffic: lognormal prompt/output
    length bodies with a Pareto(``tail_alpha``) prompt tail mixed in at
    ``tail_frac`` — the occasional pathological context that dominates
    p99s (alpha < 2: infinite-variance territory, clipped at
    ``max_prompt`` to the engine's geometry)."""
    rng = np.random.default_rng(seed)
    t = 0.0
    arrivals = []
    for _ in range(n_requests):
        t += float(rng.exponential(1.0 / rate))
        if rng.random() < tail_frac:
            p_len = int(tail_scale * float(rng.pareto(tail_alpha) + 1.0))
        else:
            p_len = int(rng.lognormal(np.log(prompt_median), prompt_sigma))
        p_len = int(np.clip(p_len, 2, max_prompt))
        o_len = int(np.clip(rng.lognormal(np.log(out_median), out_sigma),
                            2, max_new))
        arrivals.append({
            "arrival_ts": round(t, 6),
            "prompt": [int(x) for x in rng.integers(1, vocab, p_len)],
            "max_new_tokens": o_len,
            "deadline": None if deadline_slack is None
            else round(t + deadline_slack, 6),
        })
    return arrivals


def flash_crowd_arrivals(seed: int, n_requests: int, base_rate: float,
                         crowd_rate: float, crowd_start: float,
                         crowd_duration: float, vocab: int,
                         tenants: Optional[List[Tuple[str, float,
                                                      Optional[float]]]] = None,
                         prompt_median: int = 8, prompt_sigma: float = 0.5,
                         max_prompt: int = 64,
                         out_median: int = 10, out_sigma: float = 0.4,
                         max_new: int = 24) -> List[dict]:
    """Flash-crowd traffic with a tenant mix: Poisson arrivals at
    ``base_rate`` that spike to ``crowd_rate`` inside the window
    ``[crowd_start, crowd_start + crowd_duration)`` — the viral-moment
    shape the autoscaler + degradation ladder exist for.  ``tenants`` is a
    list of ``(name, mix_probability, deadline_slack_or_None)``; each
    arrival draws its tenant from the mix and gets ``deadline = arrival +
    slack`` (None = best-effort, runs to completion).  Deterministic in
    ``seed`` like every generator here."""
    rng = np.random.default_rng(seed)
    tenants = tenants or [("default", 1.0, None)]
    probs = np.asarray([t[1] for t in tenants], np.float64)
    probs = probs / probs.sum()
    t = 0.0
    arrivals = []
    crowd_end = crowd_start + crowd_duration
    for _ in range(n_requests):
        # piecewise-inhomogeneous Poisson: a gap that would cross a rate
        # boundary is re-drawn AT the boundary at the new rate (exactly
        # valid by memorylessness) — without this, one long base-rate gap
        # can jump clean over the whole crowd window
        while True:
            in_crowd = crowd_start <= t < crowd_end
            rate = crowd_rate if in_crowd else base_rate
            gap = float(rng.exponential(1.0 / rate))
            boundary = crowd_start if t < crowd_start \
                else (crowd_end if t < crowd_end else None)
            if boundary is not None and t + gap > boundary:
                t = boundary
                continue
            t += gap
            break
        i = int(rng.choice(len(tenants), p=probs))
        name, _, slack = tenants[i]
        p_len = int(np.clip(rng.lognormal(np.log(prompt_median), prompt_sigma),
                            2, max_prompt))
        o_len = int(np.clip(rng.lognormal(np.log(out_median), out_sigma),
                            2, max_new))
        arrivals.append({
            "arrival_ts": round(t, 6),
            "prompt": [int(x) for x in rng.integers(1, vocab, p_len)],
            "max_new_tokens": o_len,
            "deadline": None if slack is None else round(t + slack, 6),
            "tenant": name,
        })
    return arrivals


def diurnal_arrivals(seed: int, n_requests: int, base_rate: float,
                     amplitude: float, period: float, vocab: int,
                     phase: float = 0.0,
                     prefixes: Optional[List[List[int]]] = None,
                     prompt_median: int = 8, prompt_sigma: float = 0.5,
                     max_prompt: int = 64,
                     out_median: int = 10, out_sigma: float = 0.4,
                     max_new: int = 24,
                     deadline_slack: Optional[float] = None) -> List[dict]:
    """Diurnal sinusoid traffic: Poisson arrivals whose rate swings
    ``base_rate * (1 + amplitude * sin(2*pi*t/period))`` — the daily
    peak/trough shape planet-scale fleets provision for (the autoscale
    ROADMAP follow-on to the one-off ``flash_crowd_arrivals`` spike).
    Generated by THINNING, the piecewise-exact sibling of the flash
    crowd's boundary re-draw: candidate gaps are drawn at the PEAK rate
    and each candidate is kept with probability ``rate(t)/peak`` — exact
    for a smooth rate function, no discretization grid, and deterministic
    in ``seed`` like every generator here.

    ``phase`` (radians) shifts where in the cycle t=0 lands — ``-pi/2``
    starts at the trough, the natural 'day starts quiet' shape (and what
    lets caches warm before the first peak).  ``prefixes``: optional
    shared page-aligned prompt prefixes (system prompts / few-shot
    templates); each arrival draws one group uniformly and prepends it —
    the traffic shape prefix-directory routing exists for.
    ``deadline_slack``: deadline = arrival + slack (None = run to
    completion, as the divergence audits need)."""
    assert 0.0 <= amplitude < 1.0, amplitude
    rng = np.random.default_rng(seed)
    peak = base_rate * (1.0 + amplitude)
    t = 0.0
    arrivals = []
    for _ in range(n_requests):
        while True:
            t += float(rng.exponential(1.0 / peak))
            rate = base_rate * (1.0 + amplitude * np.sin(
                2.0 * np.pi * t / period + phase))
            if rng.random() < rate / peak:
                break
        p_len = int(np.clip(rng.lognormal(np.log(prompt_median), prompt_sigma),
                            2, max_prompt))
        o_len = int(np.clip(rng.lognormal(np.log(out_median), out_sigma),
                            2, max_new))
        prompt = [int(x) for x in rng.integers(1, vocab, p_len)]
        if prefixes:
            prompt = list(prefixes[int(rng.integers(0, len(prefixes)))]) + prompt
        arrivals.append({
            "arrival_ts": round(t, 6),
            "prompt": prompt,
            "max_new_tokens": o_len,
            "deadline": None if deadline_slack is None
            else round(t + deadline_slack, 6),
        })
    return arrivals


def session_arrivals(seed: int, n_sessions: int, vocab: int,
                     rate: Optional[float] = None,
                     turns_min: int = 2, turns_max: int = 4,
                     user_median: int = 12, user_sigma: float = 0.4,
                     max_user: int = 48,
                     new_median: int = 10, new_sigma: float = 0.3,
                     min_new: int = 4, max_new: int = 24,
                     think_median: float = 4.0, think_sigma: float = 0.6,
                     max_think: float = 60.0,
                     stall_prob: float = 0.35,
                     stall_at: Optional[Tuple[int, ...]] = None,
                     stall_median: float = 3.0, stall_sigma: float = 0.5,
                     max_stall: float = 30.0, tool_len: int = 6) -> List[dict]:
    """Agentic multi-turn session specs — the workload shape production
    serving actually sees (ROADMAP "Scenario diversity"): sessions x
    turns x lognormal think times x tool-stall probability, all seeded.
    Consumed by the :mod:`~..sessions` drivers (``SessionManager`` for
    one engine, ``FleetSessionCoordinator`` for a fleet) rather than
    submitted directly: sessions are CLOSED-LOOP — turn N+1's arrival is
    turn N's completion plus think time, and its prompt is the session's
    full transcript, neither knowable up front.

    Each element::

        {"sid": int, "start_ts": float, "turns": [
            {"user_tokens": [...], "max_new_tokens": int,
             "think_s": float,
             "stalls": [{"at_tokens": int, "stall_s": float,
                         "tool_tokens": [...]}, ...]}, ...]}

    ``rate``: Poisson session-start rate; None starts every session at
    t=0 (the resident-capacity shape ``bench_serving --kv-tier`` uses).
    ``stall_prob``: per-turn probability of ONE mid-generation tool
    stall at a seeded token offset; ``stall_at`` instead fires a stall
    at each of the given FIXED offsets in every turn (the deterministic
    bench shape — the r22 kv-tier leg is ``turns_min=turns_max=1,
    stall_at=(7, 14)``).  ``tool_len=0`` makes tool results empty (a
    pure pause, transcript unchanged).  Sigma-zero lognormals pin any
    length/duration to its median exactly.  Deterministic in ``seed``
    like every generator here."""
    assert 1 <= turns_min <= turns_max
    rng = np.random.default_rng(seed)
    t = 0.0
    sessions = []
    for sid in range(n_sessions):
        if rate is not None:
            t += float(rng.exponential(1.0 / rate))
        n_turns = int(rng.integers(turns_min, turns_max + 1))
        turns = []
        for _ in range(n_turns):
            u_len = int(np.clip(rng.lognormal(np.log(user_median), user_sigma),
                                2, max_user))
            o_len = int(np.clip(rng.lognormal(np.log(new_median), new_sigma),
                                min_new, max_new))
            think = round(float(np.clip(
                rng.lognormal(np.log(think_median), think_sigma),
                0.1, max_think)), 6)
            if stall_at is not None:
                offsets = [a for a in stall_at if a < o_len]
            else:
                offsets = ([int(rng.integers(2, max(3, o_len - 1)))]
                           if rng.random() < stall_prob else [])
            stalls = []
            for at in offsets:
                stalls.append({
                    "at_tokens": int(at),
                    "stall_s": round(float(np.clip(
                        rng.lognormal(np.log(stall_median), stall_sigma),
                        0.1, max_stall)), 6),
                    "tool_tokens": [int(x)
                                    for x in rng.integers(1, vocab, tool_len)],
                })
            turns.append({
                "user_tokens": [int(x) for x in rng.integers(1, vocab, u_len)],
                "max_new_tokens": o_len,
                "think_s": think,
                "stalls": stalls,
            })
        sessions.append({"sid": sid, "start_ts": round(t, 6), "turns": turns})
    return sessions


@dataclasses.dataclass(frozen=True)
class FleetEvent:
    ts: float
    action: str
    rid: int

    def __post_init__(self):
        assert self.action in _ACTIONS, f"unknown fleet event action '{self.action}'"


class FleetSimulator:

    def __init__(self, router: Router, max_rounds: int = 200_000,
                 autoscaler=None, controller=None):
        self.router = router
        self.pool = router.pool
        self.clock = router.clock
        #: optional closed-loop workload controller (duck-typed:
        #: ``pending() -> bool``, ``poll(now)`` submits work due now,
        #: ``next_wake(now) -> Optional[ts]`` joins the stall-guard wait
        #: list, ``marker()`` joins the progress signature).  The sessions
        #: ``FleetSessionCoordinator`` is the canonical one: open-loop
        #: ``arrivals`` can be listed up front, but a session's turn N+1
        #: arrives at turn N's completion + think time — only a controller
        #: polled inside the round loop can submit it.
        self.controller = controller
        # VirtualClock: deterministic rounds, time advances by max recorded
        # cost.  WallClock: the same round structure with real time (ticks
        # advance the clock themselves and there are no cost views to
        # drain, so the advance step below never fires), letting wall-mode
        # drivers reuse — instead of drift from — this loop.
        self.max_rounds = max_rounds
        self.rounds = 0
        # control plane (fleet/autoscale.py): stepped once per round,
        # BEFORE arrivals/dispatch, so a scale decision made from last
        # round's signals shapes this round's placement
        self.autoscaler = autoscaler
        #: provisioning cost receipts: ``replica_steps`` counts one unit
        #: per provisioned (non-DEAD) replica per WORKING round — the
        #: quantity static-max vs autoscaled provisioning is compared on;
        #: ``replica_seconds`` integrates provisioned count over clock
        #: time (idle waits included — a provisioned-but-idle replica
        #: still costs money)
        self.replica_steps = 0
        self.replica_seconds = 0.0

    def run(self, arrivals: List[dict],
            schedule: Optional[List[Tuple[float, str, int]]] = None) -> List:
        """``arrivals``: router ``submit()`` kwarg dicts, each with an
        ``arrival_ts``.  ``schedule``: ``(ts, action, rid)`` tuples.  Runs
        rounds until all arrivals are submitted, all schedule events
        applied, and every request is terminal.  Returns the
        ``FleetRequest`` objects in arrival order."""
        router, pool, clock = self.router, self.pool, self.clock
        pending_arrivals = sorted(arrivals, key=lambda a: (a["arrival_ts"],))
        events = sorted([e if isinstance(e, FleetEvent) else FleetEvent(*e)
                         for e in (schedule or [])], key=lambda e: (e.ts,))
        deferred_restarts: List[int] = []
        reqs = []
        a_i = e_i = 0

        for _ in range(self.max_rounds):
            self.rounds += 1
            now = clock.now()

            # 1. scripted fleet events due now
            while e_i < len(events) and events[e_i].ts <= now:
                ev = events[e_i]
                e_i += 1
                self._apply(ev, deferred_restarts)
            for rid in list(deferred_restarts):
                if pool.health.state(rid) is not ReplicaState.DRAINING:
                    # killed (or otherwise transitioned) while waiting to
                    # drain: the restart is moot — recovery owns it now
                    deferred_restarts.remove(rid)
                elif pool.is_idle(rid):
                    deferred_restarts.remove(rid)
                    pool.restart(rid)

            # 1.4 control-plane transport: drain due message deliveries
            # (heartbeats, publishes, fences, chunks), sweep the leases,
            # run the fence/resync retry timers — BEFORE dispatch, so this
            # round's placement sees the freshest view the fabric allows
            router.transport_poll(now)

            # 1.5 control plane: the autoscaler reads last round's signals
            # and acts (recover/drain/park, ladder moves) before this
            # round's dispatch sees the fleet
            if self.autoscaler is not None:
                self.autoscaler.step(now)

            # 2. arrivals + dispatch (a controller's closed-loop arrivals —
            # session turns due now — are polled in the same window, so
            # they see the same dispatch the open-loop arrivals do)
            while a_i < len(pending_arrivals) and \
                    pending_arrivals[a_i]["arrival_ts"] <= now:
                reqs.append(router.submit(**pending_arrivals[a_i]))
                a_i += 1
            if self.controller is not None:
                self.controller.poll(now)
            router.dispatch_pending(now)

            # 3. one concurrent tick across the fleet
            marker = self._marker(a_i, e_i)
            n_provisioned = sum(1 for rid in pool.rids
                                if pool.health.state(rid) is not ReplicaState.DEAD)
            costs = []
            for rid in pool.rids:
                if not pool.health.serving(rid):
                    continue
                _out, victims = pool.tick(rid)
                if victims and router.transport is None:
                    # perfect observation: the router learns of the death
                    # instantly.  Under the transport it must NOT — the
                    # replica simply stops heartbeating and the router's
                    # lease machinery diagnoses the silence (the victims'
                    # fleet records re-home at lease expiry, tokens intact)
                    router.on_replica_dead(rid, reason="health-declared death")
                view = pool.replica(rid).clock
                cost = view.take_cost() if hasattr(view, "take_cost") else 0.0
                if cost > 0:
                    costs.append(cost)

            # 4. the round took as long as its slowest replica
            if costs:
                clock.advance(max(costs))
                # provisioning receipt: every non-DEAD replica billed one
                # step for this working round (parked replicas are free —
                # the saving the autoscale bench measures)
                self.replica_steps += n_provisioned

            # 4.5 per-round observability: replica load_stats gauges (and
            # the serving-count/rung gauges) — no-op without a registry
            router.export_replica_gauges()

            # 5. completions
            router.poll(clock.now())
            self.replica_seconds += (clock.now() - now) * n_provisioned

            if a_i >= len(pending_arrivals) and e_i >= len(events) \
                    and not deferred_restarts and router.outstanding == 0 \
                    and (self.controller is None
                         or not self.controller.pending()):
                if self.autoscaler is not None:
                    self.autoscaler.finalize(clock.now())
                return reqs

            if not costs and self._marker(a_i, e_i) == marker:
                # nothing moved: only the passage of time can help — jump to
                # the next known event, or fail loudly instead of spinning
                waits = router.pending_timestamps()
                # control-plane wake-ups: in-flight deliveries, partition
                # boundaries, lease deadlines, fence/resync retries — a
                # quiet fleet must still wake to expire a lease or see a
                # partition heal (empty without a transport)
                waits.extend(router.control_timestamps(clock.now()))
                if a_i < len(pending_arrivals):
                    waits.append(pending_arrivals[a_i]["arrival_ts"])
                if e_i < len(events):
                    waits.append(events[e_i].ts)
                if self.autoscaler is not None:
                    wake = self.autoscaler.wake_ts(clock.now())
                    if wake is not None:
                        waits.append(wake)
                if self.controller is not None:
                    # closed-loop wake-ups: think-time turn starts, tool-
                    # stall resumes, prefetch leads — a fleet whose every
                    # session is thinking must still wake to start the
                    # next turn
                    wake = self.controller.next_wake(clock.now())
                    if wake is not None:
                        waits.append(wake)
                if not waits:
                    raise RuntimeError(
                        f"fleet simulation stalled at t={now}: "
                        f"{router.outstanding} outstanding request(s), "
                        f"replicas {[(r, pool.health.state(r).value) for r in pool.rids]}, "
                        "no future arrival/schedule/deadline to wait for")
                t_jump = clock.now()
                clock.wait_until(min(waits) + 1e-9)
                self.replica_seconds += (clock.now() - t_jump) * n_provisioned
                if clock.now() > t_jump:
                    # idle jump: exclude it from every replica's step
                    # anatomy (idle is absent load, not step-loop tax —
                    # same stance as ServingEngine._note_idle)
                    for rid in pool.rids:
                        anat = pool.anatomy(rid)
                        if anat is not None:
                            anat.note_idle()
        raise RuntimeError(f"fleet simulation exceeded max_rounds={self.max_rounds}")

    def _apply(self, ev: FleetEvent, deferred_restarts: List[int]) -> None:
        pool, router = self.pool, self.router
        state = pool.health.state(ev.rid)
        if ev.action == "kill":
            if router.transport is not None:
                # a scheduled kill under the transport is a silent host
                # loss: the engine dies, heartbeats stop, and the ROUTER
                # finds out the only way a partitioned-or-dead replica can
                # be found out — its lease expires
                pool.kill(ev.rid, reason="scheduled kill")
            else:
                router.on_replica_dead(ev.rid, reason="scheduled kill")
        elif ev.action == "recover":
            if state is ReplicaState.DEAD:
                # via the router: a prefix directory triggers the
                # directory-driven warm-up (hottest chains pre-imported
                # while the replica is still RECOVERING)
                router.recover_replica(ev.rid)
            # recovering a live replica is a schedule no-op, not an error —
            # chaos schedules are random and may recover before the kill
        elif ev.action == "drain":
            if state.dispatchable:
                pool.drain(ev.rid)
        elif ev.action == "restart":
            if state is ReplicaState.DRAINING:
                if pool.is_idle(ev.rid):
                    pool.restart(ev.rid)
                else:
                    deferred_restarts.append(ev.rid)

    def _marker(self, a_i: int, e_i: int):
        router = self.router
        # engine-side seen_tokens is part of progress: a multi-chunk
        # prefill advances for whole rounds without delivering a token, and
        # on a WallClock there are no step costs to prove the round worked
        seen = sum(s.seen_tokens
                   for rep in self.pool.replicas.values() if rep.serve is not None
                   for s in rep.serve.engine.state.seqs.values())
        return (a_i, e_i, len(router.requests), router.outstanding,
                router.stats["dispatches"], router.stats["failovers"],
                # migration pump progress: export chunks advance no clock
                # and deliver no tokens, but they ARE progress — without
                # these the stall detector would fire mid-export on an
                # otherwise-idle fleet
                router.stats["migration_chunks"],
                router.stats["migrations_started"],
                router.stats["migration_fallbacks"],
                sum(len(r.tokens) for r in router.requests), seen,
                len(self.pool.health.history),
                # control-plane progress: scale decisions and ladder moves
                # advance no clock and deliver no tokens, but they ARE
                # progress (a recover this round changes next round)
                self.autoscaler.marker() if self.autoscaler is not None else None,
                # closed-loop controller progress: a session state change
                # (turn started, stall entered/resumed) advances no clock
                # and may deliver no tokens this round, but it IS progress
                self.controller.marker() if self.controller is not None else None,
                # transport control transitions (lease/fence/resync) — same
                # stance; raw send counters are deliberately excluded (see
                # Router.control_marker)
                router.control_marker())
