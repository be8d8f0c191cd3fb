"""Session drivers: move :class:`~.session.Session` machines through an
engine or a fleet.

Two drivers share the Session bookkeeping and the tool-stall ladder:

* :class:`SessionManager` — closed-loop over ONE
  :class:`~..engine.ServingEngine` (the ``bench_serving.py --kv-tier``
  workload driver and the unit-test harness).  Tool stalls park the
  request through the engine's host KV tier (``serve.park(uid,
  phase="tool_stall")``), prefetch a lead interval before the seeded
  tool result lands, then resume — the r22 prefetch-hidden contract.
* :class:`FleetSessionCoordinator` — the same loop over a fleet
  :class:`~..fleet.router.Router`, implementing the
  :class:`~..fleet.sim.FleetSimulator` controller protocol
  (``pending()/poll(now)/next_wake(now)/marker()``).  Turns are routed
  with ``session=sid`` so the ``session_affinity`` policy can pin the
  session to the replica holding its warm pages; a sticky replica's
  death mid-stall is survived by the router's failover harvest (the
  parked host snapshot is re-imported on a survivor, or recompute runs
  — outputs golden either way), and the coordinator simply RE-PARKS the
  resurrected request for the stall's remainder.

Fault sites (docs/RESILIENCE.md): ``session.route`` fires at the
coordinator's turn-routing edge — an ``os_error`` there degrades ONE
turn to stateless routing (submitted without its session tag; counted,
never a crash).  ``session.tool_result`` fires at the seeded tool-result
delivery — an ``os_error`` extends the stall by ``tool_retry_s`` and the
delivery is retried (absorbed).  ``InjectedCrash`` propagates from both,
as everywhere.
"""

from typing import Dict, List, Optional

from ...resilience import fault_injection as _fi
from ..request import RequestState
from .session import Session, SessionConfig, SessionState

__all__ = ["SessionManager", "FleetSessionCoordinator"]

_TERMINAL = (RequestState.DONE, RequestState.TIMED_OUT, RequestState.REJECTED)


class _SessionDriverBase:
    """The state-walk both drivers share; subclasses supply the
    request-facing verbs (submit/park/prefetch/resume and the per-request
    token/state reads)."""

    def __init__(self, sessions: List[dict],
                 config: Optional[SessionConfig] = None):
        self.config = config or SessionConfig()
        self.sessions = [Session(s["sid"], s["turns"], s.get("start_ts", 0.0))
                         for s in sessions]
        self.stats = {"turns_submitted": 0, "turns_completed": 0,
                      "stalls": 0, "tool_results": 0, "route_faults": 0,
                      "tool_result_faults": 0, "reparks": 0,
                      "abandoned": 0}
        #: sid -> when the session's next driver action is due (think-time
        #: turn starts, stall resumes, prefetch leads) — the wake feed
        self._wakes: Dict[object, float] = {}

    # ------------------------------------------------- subclass contract

    def _submit_turn(self, sess: Session, prompt: List[int], now: float):
        raise NotImplementedError

    def _req_state(self, sess: Session) -> RequestState:
        raise NotImplementedError

    def _req_tokens(self, sess: Session) -> List[int]:
        raise NotImplementedError

    def _park(self, sess: Session) -> bool:
        raise NotImplementedError

    def _prefetch(self, sess: Session) -> bool:
        raise NotImplementedError

    def _resume(self, sess: Session) -> bool:
        raise NotImplementedError

    # -------------------------------------------------- controller hooks

    def pending(self) -> bool:
        return any(not s.closed for s in self.sessions)

    def next_wake(self, now: float) -> Optional[float]:
        due = [t for t in self._wakes.values() if t > now]
        return min(due) if due else None

    def marker(self):
        """Progress signature for the simulator's stall guard: any state
        or counter movement means the round worked."""
        return (tuple(sorted(self.stats.items())),
                tuple((s.sid, s.state.value, s.turn_idx)
                      for s in self.sessions))

    # ---------------------------------------------------------- the walk

    def poll(self, now: float) -> None:
        for sess in self.sessions:
            if sess.closed:
                self._wakes.pop(sess.sid, None)
                continue
            if sess.state is SessionState.PENDING:
                if now >= sess.start_ts:
                    self._start_turn(sess, now)
                else:
                    self._wakes[sess.sid] = sess.start_ts
            elif sess.state is SessionState.THINKING:
                if now >= self._wakes.get(sess.sid, 0.0):
                    self._start_turn(sess, now)
            elif sess.state is SessionState.ACTIVE_TURN:
                self._poll_active(sess, now)
            elif sess.state is SessionState.TOOL_STALL:
                self._poll_stalled(sess, now)
            else:
                pass  # CLOSED: handled above

    def _start_turn(self, sess: Session, now: float) -> None:
        prompt = sess.begin_turn(now)
        self._wakes.pop(sess.sid, None)
        self._submit_turn(sess, prompt, now)
        self.stats["turns_submitted"] += 1

    def _poll_active(self, sess: Session, now: float) -> None:
        state = self._req_state(sess)
        if state in _TERMINAL:
            if state is not RequestState.DONE:
                self.stats["abandoned"] += 1
                sess.abandon(now)
                self._wakes.pop(sess.sid, None)
                return
            think = sess.finish_turn(self._req_tokens(sess), now)
            self.stats["turns_completed"] += 1
            if think is None:
                self._wakes.pop(sess.sid, None)
            else:
                self._wakes[sess.sid] = now + think
            return
        tokens = self._req_tokens(sess)
        if sess.stall_due(tokens) and state is RequestState.DECODE \
                and self._park(sess):
            sess.enter_stall(tokens, now)
            self.stats["stalls"] += 1
            self._arm_stall_wake(sess)
        # stall due but unparkable this tick (mid-prefill, a migration
        # window, a dying replica): the detector keeps it armed and the
        # next delivered batch retries

    def _poll_stalled(self, sess: Session, now: float) -> None:
        cur = sess.cur
        lead = self.config.prefetch_lead_s
        if not cur["prefetched"] and now >= cur["resume_at"] - lead:
            self._prefetch(sess)   # best-effort; an unhinted resume still works
            cur["prefetched"] = True
            self._arm_stall_wake(sess)
        if now >= cur["resume_at"]:
            try:
                _fi.check("session.tool_result")
            except _fi.InjectedCrash:
                raise
            except OSError:
                # the tool backend hiccuped: the stall extends one retry
                # interval and the delivery is re-attempted — absorbed
                self.stats["tool_result_faults"] += 1
                cur["resume_at"] = now + self.config.tool_retry_s
                cur["prefetched"] = False
                self._arm_stall_wake(sess)
                return
            self._resume(sess)
            sess.exit_stall(now)
            self.stats["tool_results"] += 1
            self._wakes.pop(sess.sid, None)
            # the request may ALREADY be terminal (it kept generating
            # unparked — park_stalls off, or a failover recompute ran to
            # completion during the stall): fold it now, or the driver
            # loop sees an open session with nothing runnable and no wake
            self._poll_active(sess, now)

    def _arm_stall_wake(self, sess: Session) -> None:
        cur = sess.cur
        lead = self.config.prefetch_lead_s
        self._wakes[sess.sid] = (cur["resume_at"] if cur["prefetched"]
                                 else cur["resume_at"] - lead)

    # ----------------------------------------------------------- receipts

    def transcripts(self) -> Dict[object, List[int]]:
        return {s.sid: list(s.transcript) for s in self.sessions}

    def turn_ttfts(self) -> List[float]:
        return [t for s in self.sessions for t in s.turn_ttfts()]


class SessionManager(_SessionDriverBase):
    """Closed-loop session driver over one :class:`ServingEngine`.

    ``run()`` owns the whole loop (tick, poll, idle clock jumps); a
    caller embedding the manager in a larger loop instead calls
    ``poll(now)`` after its own ticks and honors ``next_wake``.
    """

    def __init__(self, serve, sessions: List[dict],
                 config: Optional[SessionConfig] = None, stream=None):
        super().__init__(sessions, config)
        self.serve = serve
        self._user_stream = stream
        self._reqs: Dict[object, object] = {}   # sid -> live ServingRequest

    # ------------------------------------------------------------- verbs

    def _submit_turn(self, sess, prompt, now):
        def stream(req, toks, ts, _sess=sess):
            _sess.note_first_token(ts)
            if self._user_stream is not None:
                self._user_stream(_sess, req, toks, ts)
        self._reqs[sess.sid] = self.serve.submit(
            prompt, max_new_tokens=sess.cur["spec"]["max_new_tokens"],
            arrival_ts=now, stream=stream)

    def _req_state(self, sess):
        return self._reqs[sess.sid].state

    def _req_tokens(self, sess):
        return list(self._reqs[sess.sid].tokens)

    def _park(self, sess):
        if not self.config.park_stalls:
            return True   # tests: stall accounting without a real park
        return self.serve.park(self._reqs[sess.sid].uid, phase="tool_stall")

    def _prefetch(self, sess):
        return self.serve.prefetch_resume(self._reqs[sess.sid].uid)

    def _resume(self, sess):
        if not self.config.park_stalls:
            return True
        return self.serve.resume(self._reqs[sess.sid].uid)

    # -------------------------------------------------------------- loop

    def run(self, max_steps: int = 1_000_000) -> List[Session]:
        serve = self.serve
        for _ in range(max_steps):
            now = serve.clock.now()
            self.poll(now)
            if not self.pending():
                return self.sessions
            if not serve._active and not serve._queue:
                wake = self.next_wake(now)
                if wake is None:
                    raise RuntimeError(
                        f"session loop wedged at t={now}: "
                        f"{sum(1 for s in self.sessions if not s.closed)} "
                        "open session(s), nothing runnable, no future wake")
                serve.clock.wait_until(wake + 1e-9)
                continue
            serve.tick()
        raise RuntimeError(f"session loop exceeded max_steps={max_steps}")


class FleetSessionCoordinator(_SessionDriverBase):
    """Fleet-side session driver: the :class:`FleetSimulator` controller
    that submits each turn through the router (``session=sid`` so the
    affinity policy can pin it), parks/resumes tool stalls on whichever
    replica currently runs the request, and re-parks a stalled request
    that failover resurrected on a survivor mid-stall."""

    def __init__(self, router, sessions: List[dict],
                 config: Optional[SessionConfig] = None):
        super().__init__(sessions, config)
        self.router = router
        self._frs: Dict[object, object] = {}    # sid -> live FleetRequest

    # ------------------------------------------------------------- verbs

    def _submit_turn(self, sess, prompt, now):
        mnt = sess.cur["spec"]["max_new_tokens"]
        try:
            _fi.check("session.route")
            fr = self.router.submit(prompt, max_new_tokens=mnt,
                                    arrival_ts=now, session=sess.sid)
        except _fi.InjectedCrash:
            raise
        except OSError:
            # the session-routing edge failed: this turn degrades to
            # stateless routing (no session tag, no stickiness) — counted,
            # never a crash; the NEXT turn re-enters the sticky path
            self.stats["route_faults"] += 1
            fr = self.router.submit(prompt, max_new_tokens=mnt,
                                    arrival_ts=now)
        self._frs[sess.sid] = fr

    def _fleet_req(self, sess):
        return self._frs[sess.sid]

    def _req_state(self, sess):
        from ..fleet.router import FleetState
        fr = self._fleet_req(sess)
        if fr.state is FleetState.DONE:
            return RequestState.DONE
        if fr.state in (FleetState.TIMED_OUT, FleetState.REJECTED):
            return RequestState.TIMED_OUT
        # PENDING/DISPATCHED (incl. a failover in flight): still working.
        # Report DECODE once tokens exist so the stall ladder can park.
        return (RequestState.DECODE if fr.tokens else RequestState.PREFILL)

    def _req_tokens(self, sess):
        return list(self._fleet_req(sess).tokens)

    def _park(self, sess):
        return self.router.park_request(self._fleet_req(sess),
                                        phase="tool_stall")

    def _prefetch(self, sess):
        return self.router.prefetch_resume_request(self._fleet_req(sess))

    def _resume(self, sess):
        return self.router.resume_request(self._fleet_req(sess))

    # ------------------------------------------------ failover awareness

    def _poll_active(self, sess, now):
        # the fleet path has no per-token stream into the session: fold
        # the router's first-token observation instant (idempotent — the
        # first call wins, so a failover's re-delivery cannot move it)
        ftt = self._fleet_req(sess).first_token_ts
        if ftt is not None:
            sess.note_first_token(ftt)
        super()._poll_active(sess, now)

    def _poll_stalled(self, sess, now):
        # a sticky-replica death displaced the parked request and failover
        # resurrected it generating on a survivor: re-park it for the
        # stall's remainder (bytes are unaffected — greedy continuation —
        # but the stall's TIMING contract is the session's to keep)
        if now < sess.cur["resume_at"] \
                and self.router.request_decoding(self._fleet_req(sess)) \
                and self._park(sess):
            self.stats["reparks"] += 1
        super()._poll_stalled(sess, now)
