"""Agentic session state: one multi-turn conversation over the fleet.

Production traffic at scale is *sessions*, not single-shot arrivals
(ROADMAP "Scenario diversity"): multi-turn conversations and agent loops
with think-time gaps between turns, tool-call stalls *mid-generation*,
and per-turn prefix growth — turn N+1's prompt is turn N's full
transcript, the prefix directory's ideal customer.  This module is the
pure state half of the subsystem; the drivers that move sessions through
an engine or a fleet live in :mod:`.manager`.

A :class:`Session` is a validated state machine::

    PENDING → ACTIVE_TURN → THINKING → ACTIVE_TURN → … → CLOSED
                   │    ▲
                   ▼    │   (tool-call marker fired mid-generation: the
               TOOL_STALL    request PARKS via the host KV tier with its
                             partial generation intact and resumes
                             byte-identically when the seeded tool
                             result arrives)

Turn semantics:

* each turn is one serving request whose prompt is the session's full
  transcript so far plus the turn's user message;
* generated tokens join the transcript at the turn boundary, and a
  fired tool call's result tokens append AFTER the turn's generation —
  so a stalled turn's token stream is byte-identical to an unstalled
  run of the same prompt (greedy decode; the park/resume ladder never
  changes bytes, only timing);
* every turn's completed full pages publish into the replica's prefix
  cache as it generates (``StateManager.note_progress``), so turn N+1
  routed to the same replica re-attaches the whole transcript's pages
  and prefills only the new suffix — the warmth ``session_affinity``
  routing (fleet/policies.py) exists to preserve.

Terminal is CLOSED: every turn completed (or the session was abandoned
— rejection/timeout of a turn closes the session; the chaos tests pin
exactly-once closure).
"""

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence

__all__ = ["SessionState", "SessionConfig", "ToolCallDetector", "Session"]


class SessionState(enum.Enum):
    PENDING = "pending"           # generated: not yet started (start_ts future)
    ACTIVE_TURN = "active_turn"   # a turn's request is live on some replica
    TOOL_STALL = "tool_stall"     # parked mid-generation awaiting a tool result
    THINKING = "thinking"         # between turns (the user's think time)
    CLOSED = "closed"             # every turn done, or the session abandoned

    @property
    def terminal(self) -> bool:
        return self is SessionState.CLOSED


_SESSION_ALLOWED = {
    SessionState.PENDING: {SessionState.ACTIVE_TURN, SessionState.CLOSED},
    # a turn either fires a tool call (parks mid-generation), completes
    # into think time (more turns follow), or completes the session
    SessionState.ACTIVE_TURN: {SessionState.TOOL_STALL, SessionState.THINKING,
                               SessionState.CLOSED},
    # the seeded tool result arrived: the request resumes in place
    # (byte-identical continuation); CLOSED covers abandonment mid-stall
    SessionState.TOOL_STALL: {SessionState.ACTIVE_TURN, SessionState.CLOSED},
    SessionState.THINKING: {SessionState.ACTIVE_TURN, SessionState.CLOSED},
    SessionState.CLOSED: set(),
}


@dataclasses.dataclass(frozen=True)
class SessionConfig:
    """Driver knobs shared by the engine-level :class:`~.manager.
    SessionManager` and the fleet :class:`~.manager.FleetSessionCoordinator`."""
    #: issue ``prefetch_resume`` this many clock-seconds BEFORE a stall's
    #: scheduled resume, so the h2d promotion hides under other sessions'
    #: device windows (the r22 prefetch-hidden contract); 0 = unhinted.
    prefetch_lead_s: float = 0.0
    #: how long a ``session.tool_result`` delivery fault extends the
    #: stall before the next delivery attempt (absorbed, never wrong).
    tool_retry_s: float = 0.5
    #: park tool stalls through the host KV tier (False only makes sense
    #: in tests; the stateless bench baseline instead runs a zero-capacity
    #: tier so every park degrades to recompute-on-resume).
    park_stalls: bool = True


class ToolCallDetector:
    """Decides, per delivered-token batch, whether a turn just hit a
    tool-call boundary.

    Two trigger kinds, composable:

    * ``marker`` — a stop-sequence token run: fires when the generation's
      tail equals the marker (the production shape; testable on the tiny
      greedy model by choosing a run from the turn's own golden tokens);
    * ``at_counts`` — deterministic token-count triggers (the bench
      shape: seeded workloads fire stalls at exact offsets so runs are
      byte-comparable).

    Each trigger fires at most once per position: ``due()`` is a pure
    peek, ``fire()`` consumes — the split lets a driver whose park
    attempt failed this tick (e.g. the request is still in prefill)
    retry on the next delivery instead of losing the stall.
    """

    def __init__(self, marker: Optional[Sequence[int]] = None,
                 at_counts: Sequence[int] = ()):
        self.marker = [int(t) for t in marker] if marker else None
        self.at_counts = sorted(int(c) for c in at_counts)
        self._next = 0          # index of the next unconsumed at_count
        self._fired_len = 0     # generation length already consumed by fire()

    def due(self, tokens: Sequence[int]) -> bool:
        n = len(tokens)
        if self._next < len(self.at_counts) and n >= self.at_counts[self._next]:
            return True
        if self.marker and n > self._fired_len and n >= len(self.marker) \
                and [int(t) for t in tokens[-len(self.marker):]] == self.marker:
            return True
        return False

    def fire(self, tokens: Sequence[int]) -> None:
        assert self.due(tokens), "fire() without a due trigger"
        if self._next < len(self.at_counts) \
                and len(tokens) >= self.at_counts[self._next]:
            self._next += 1
        self._fired_len = len(tokens)


class Session:
    """One session's validated state + transcript bookkeeping.

    Pure bookkeeping — no engine or router reference.  The drivers in
    :mod:`.manager` call the turn-lifecycle methods below and own all
    clock/transport concerns, so the same Session moves identically
    through the single-engine manager, the fleet coordinator, and the
    chaos harnesses.

    ``turns`` is a list of turn spec dicts (the :func:`~..fleet.sim.
    session_arrivals` shape)::

        {"user_tokens": [...], "max_new_tokens": int, "think_s": float,
         "stalls": [{"at_tokens": int, "stall_s": float,
                     "tool_tokens": [...]}, ...],
         "tool_marker": [...]?}
    """

    def __init__(self, sid, turns: List[dict], start_ts: float = 0.0):
        assert turns, f"session {sid}: at least one turn required"
        self.sid = sid
        self.turns = [dict(t) for t in turns]
        self.start_ts = float(start_ts)
        self.state = SessionState.PENDING
        self.history = [(self.state, self.start_ts)]
        #: the full token history: prompts, generations, and tool results
        #: of every completed turn (+ the current turn's prompt while one
        #: is live) — turn N+1's prompt is exactly this list's value at
        #: its submit
        self.transcript: List[int] = []
        self.turn_idx = -1
        #: live-turn scratch (prompt, detector, stall bookkeeping); None
        #: between turns
        self.cur: Optional[Dict] = None
        #: per-completed-turn receipts: ``{"turn", "submit_ts",
        #: "first_token_ts", "turn_ttft", "finish_ts", "n_tokens",
        #: "stalls_fired"}``
        self.turn_records: List[dict] = []
        self.stalls_fired = 0

    def __repr__(self):
        return (f"Session(sid={self.sid}, state={self.state.value}, "
                f"turn={self.turn_idx + 1}/{len(self.turns)})")

    def to(self, state: SessionState, ts: float) -> None:
        if state not in _SESSION_ALLOWED[self.state]:
            raise ValueError(f"session {self.sid}: illegal transition "
                             f"{self.state.value} -> {state.value}")
        self.state = state
        self.history.append((state, ts))

    @property
    def closed(self) -> bool:
        return self.state is SessionState.CLOSED

    @property
    def completed_turns(self) -> int:
        return len(self.turn_records)

    # ------------------------------------------------------ turn lifecycle

    def begin_turn(self, ts: float) -> List[int]:
        """Start the next turn at ``ts``: extend the transcript with the
        turn's user message and return the full prompt to submit (the
        whole transcript — per-turn prefix growth is the point)."""
        self.turn_idx += 1
        spec = self.turns[self.turn_idx]
        self.transcript.extend(int(t) for t in spec["user_tokens"])
        prompt = list(self.transcript)
        self.cur = {
            "spec": spec,
            "prompt": prompt,
            "detector": ToolCallDetector(
                marker=spec.get("tool_marker"),
                at_counts=[s["at_tokens"] for s in spec.get("stalls", ())]),
            "submit_ts": ts,
            "first_token_ts": None,
            "stall_i": 0,        # next stall spec to consume on a fire
            "tool_tokens": [],   # fired stalls' results, joined at turn end
            "resume_at": None,   # while TOOL_STALL: when the result lands
            "prefetched": False,
        }
        self.to(SessionState.ACTIVE_TURN, ts)
        return prompt

    def note_first_token(self, ts: float) -> None:
        if self.cur is not None and self.cur["first_token_ts"] is None:
            self.cur["first_token_ts"] = ts

    def stall_due(self, tokens: Sequence[int]) -> bool:
        """Should the live turn park for a tool call, given its generated
        tokens so far?  Pure peek — :meth:`enter_stall` consumes."""
        return (self.state is SessionState.ACTIVE_TURN
                and self.cur is not None
                and self.cur["detector"].due(tokens))

    def enter_stall(self, tokens: Sequence[int], ts: float) -> dict:
        """Consume the due trigger and transition to TOOL_STALL; returns
        the stall spec (``stall_s``, ``tool_tokens``) the driver
        schedules the resume from.  A marker fire beyond the seeded
        stall list gets a zero-length default spec."""
        cur = self.cur
        cur["detector"].fire(tokens)
        stalls = cur["spec"].get("stalls", ())
        spec = (stalls[cur["stall_i"]] if cur["stall_i"] < len(stalls)
                else {"stall_s": 0.0, "tool_tokens": []})
        cur["stall_i"] += 1
        cur["resume_at"] = ts + float(spec.get("stall_s", 0.0))
        cur["prefetched"] = False
        self.stalls_fired += 1
        self.to(SessionState.TOOL_STALL, ts)
        return spec

    def exit_stall(self, ts: float) -> None:
        """The seeded tool result arrived: stage its tokens (joined to the
        transcript at turn end — generation itself continues
        byte-identically) and return to ACTIVE_TURN."""
        cur = self.cur
        stalls = cur["spec"].get("stalls", ())
        i = cur["stall_i"] - 1
        if 0 <= i < len(stalls):
            cur["tool_tokens"].extend(int(t)
                                      for t in stalls[i].get("tool_tokens", ()))
        cur["resume_at"] = None
        self.to(SessionState.ACTIVE_TURN, ts)

    def finish_turn(self, generated: Sequence[int], ts: float) -> Optional[float]:
        """The turn's request completed: fold its generation (then any
        tool results) into the transcript, record the turn receipt, and
        advance — returns the think time before the next turn, or None
        when the session just CLOSED."""
        cur = self.cur
        self.transcript.extend(int(t) for t in generated)
        self.transcript.extend(cur["tool_tokens"])
        ftt = cur["first_token_ts"]
        self.turn_records.append({
            "turn": self.turn_idx,
            "submit_ts": cur["submit_ts"],
            "first_token_ts": ftt,
            "turn_ttft": (None if ftt is None
                          else round(ftt - cur["submit_ts"], 9)),
            "finish_ts": ts,
            "n_tokens": len(generated),
            "stalls_fired": cur["stall_i"],
        })
        self.cur = None
        if self.turn_idx + 1 >= len(self.turns):
            self.to(SessionState.CLOSED, ts)
            return None
        think = float(self.turns[self.turn_idx].get("think_s", 0.0))
        self.to(SessionState.THINKING, ts)
        return think

    def abandon(self, ts: float) -> None:
        """Close the session from any live state (a turn was rejected or
        timed out; the session cannot meaningfully continue)."""
        if not self.closed:
            self.cur = None
            self.to(SessionState.CLOSED, ts)

    # ----------------------------------------------------------- receipts

    def turn_ttfts(self) -> List[float]:
        return [r["turn_ttft"] for r in self.turn_records
                if r["turn_ttft"] is not None]
