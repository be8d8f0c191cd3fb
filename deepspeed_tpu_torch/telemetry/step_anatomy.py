"""Per-step anatomy: where does one engine step's wall time actually go?

The ROADMAP's largest open perf item — the AOT-compiled serving step —
cannot be judged without a number for the Python step-loop tax it exists
to kill.  This module decomposes EVERY engine step into:

* named **host segments**, measured as disjoint cursor intervals on the
  recorder's clock —

    ``schedule``       step planning (``SplitFuseScheduler.plan`` /
                       the serving frontend's KV-pressure preflight)
    ``draft_plan``     speculative draft planning (``_plan_drafts``)
    ``verify_plan``    verify-batch staging (history splice + ``pack``)
    ``aot_compile``    ahead-of-time ``lower().compile()`` work done
                       inside a step window (``warm_all`` invoked while
                       a step is open — deliberate warm-up, not a miss)
    ``compile_wait``   a dispatch that triggered a JIT cache miss — the
                       trace+compile ride the first call synchronously
    ``dispatch``       host-side dispatch of an already-compiled program
                       (batch packing, array staging, the jitted call's
                       enqueue)
    ``sample_accept``  host-side token fold (argmax accept loop, EOS/
                       limit checks, rollback truncation)
    ``overlap``        host work for step g+1 executed while step g was
                       still in flight on device (the async double-
                       buffered tick's scheduling/admission/delivery
                       window — loop tax HIDDEN under device time)
    ``bookkeeping``    everything else inside the step window (prefix-
                       cache publish, descriptor updates, the residual
                       between the last mark and step end)

* **device compute** — the blocking materialization of the dispatch's
  outputs on a real clock, or the explicitly charged virtual step cost
  (``charge_last_step``) under ``VirtualClock``/``ReplicaClockView``;

* the **host gap** — clock time between the previous step's end and this
  step's begin: the serving loop's admission/deadline/delivery work, the
  per-tick Python re-entry the AOT item wants amortized away.  Idle
  waits (``note_idle``) are excluded — idle is absent load, not loop
  tax — and the following step is flagged ``after_idle``.

The decomposition TILES by construction: every component is a
non-negative clock difference (or an explicit charge), and

    wall_s == host_gap_s + sum(host segments) + device_s

exactly, per step.  ``scripts/step_anatomy.py`` re-verifies the tiling
from the committed per-step table within 1e-6 (exit 1 on mismatch) —
the same trust-but-re-verify stance as ``why_slow.py``'s cause tiling.

A **compile tracker** rides along: every JIT cache miss the engine
reports (``note_compile``) is tagged warm-up or — after
:meth:`mark_steady` — an *unexpected steady-state recompile*, the
regression guard the AOT roadmap item will be held to (a serving step
set that recompiles mid-measurement is not AOT).  On the PyTorch engine a
compile is the build of one step program: a CUDA graph's capture on the
card, the first eager dispatch of a key on the CPU.

Overhead contract: the disabled path (:data:`NULL_ANATOMY`) allocates
NOTHING per call — one attribute read + one predicate per hook, pinned
by the tracemalloc test alongside :data:`~.trace.NULL_TRACER`.
Deliberately stdlib-only: the engine imports it at
module scope and ``scripts/step_anatomy.py`` stays standalone.
"""

from collections import deque
from typing import Dict, List, Optional

from .trace import PerfClock

__all__ = ["HOST_SEGMENTS", "StepAnatomy", "NullStepAnatomy", "NULL_ANATOMY",
           "StepRecord", "CompileRecord"]

#: the closed host-segment vocabulary; every step exports all of them
#: (zero-filled) so the per-step table has one fixed shape
HOST_SEGMENTS = ("schedule", "draft_plan", "verify_plan", "aot_compile",
                 "compile_wait", "dispatch", "sample_accept", "overlap",
                 "bookkeeping", "promote_wait")


class StepRecord:
    """One recorded engine step (mutable only via the recorder)."""

    __slots__ = ("index", "path", "batch", "chunk", "segments", "device_s",
                 "host_gap_s", "wall_s", "after_idle", "compiles", "end_ts")

    def __init__(self, index: int):
        self.index = index
        self.path: Optional[str] = None      # decode|prefill|mixed|spec_verify|multi_decode
        self.batch: Optional[int] = None     # bucketed batch of the dispatch
        self.chunk: Optional[int] = None     # chunk width / verify width / fused k
        self.segments: Dict[str, float] = {s: 0.0 for s in HOST_SEGMENTS}
        self.device_s = 0.0
        self.host_gap_s = 0.0
        self.wall_s = 0.0
        self.after_idle = False
        self.compiles = 0                    # JIT cache misses THIS step paid for
        self.end_ts = 0.0                    # recorder-clock time at step end

    @property
    def shape_key(self) -> str:
        return f"{self.path}:b{self.batch}:c{self.chunk}"

    def host_s(self) -> float:
        return sum(self.segments.values())

    def to_row(self) -> dict:
        """Deterministic export row (9-dp rounding, sorted segment keys)."""
        return {
            "index": self.index,
            "path": self.path,
            "batch": self.batch,
            "chunk": self.chunk,
            "shape": self.shape_key,
            "segments": {s: round(self.segments[s], 9) for s in HOST_SEGMENTS},
            "device_s": round(self.device_s, 9),
            "host_gap_s": round(self.host_gap_s, 9),
            "wall_s": round(self.wall_s, 9),
            "after_idle": self.after_idle,
            "compiles": self.compiles,
        }


class CompileRecord:
    """One compile event: which program key, at which step, whether it
    fired after the warm-up boundary (``steady`` = the regression), and
    whether it was a deliberate AOT ``lower().compile()`` (``aot``)
    rather than a JIT cache miss a dispatch paid for synchronously."""

    __slots__ = ("key", "step_index", "steady", "ts", "aot")

    def __init__(self, key: str, step_index: int, steady: bool, ts: float,
                 aot: bool = False):
        self.key = key
        self.step_index = step_index
        self.steady = steady
        self.ts = ts
        self.aot = aot

    def to_row(self) -> dict:
        return {"key": self.key, "step_index": self.step_index,
                "steady": self.steady, "aot": self.aot,
                "ts": round(self.ts, 9)}


class StepAnatomy:
    """Per-step anatomy recorder with a pluggable clock.

    ``clock``: any ``now() -> float`` provider (``VirtualClock``,
    ``ReplicaClockView``, ``WallClock``, :class:`~.trace.PerfClock`
    default).  ``max_steps`` bounds the per-step table (deque; evictions
    counted in ``dropped_steps``); lifetime totals keep accumulating past
    the cap, so the host-gap-fraction gauges never lie about the window
    they cover being the whole run."""

    enabled = True

    def __init__(self, clock=None, max_steps: int = 4096):
        if max_steps < 1:
            raise ValueError(f"max_steps must be >= 1, got {max_steps}")
        self.clock = clock if clock is not None else PerfClock()
        self.steps = deque(maxlen=int(max_steps))
        self.dropped_steps = 0
        self.compiles: List[CompileRecord] = []
        self.steady_state_recompiles = 0
        #: monotonic count of CLOSED steps (deque eviction never rewinds it)
        self.total_steps = 0
        # lifetime totals (survive deque eviction; the cheap gauge inputs)
        self.total_wall_s = 0.0
        self.total_host_s = 0.0
        self.total_device_s = 0.0
        self.total_host_gap_s = 0.0
        self._steady = False
        self._last_end: Optional[float] = None
        self._after_idle = False
        self._cur: Optional[StepRecord] = None
        self._gap0 = 0.0        # inter-step gap captured at step_begin
        self._t = 0.0           # segment cursor

    # ------------------------------------------------------------- lifecycle

    def step_begin(self) -> None:
        """Open a step window.  Idempotent while a step is open: the
        serving frontend opens the window before its admission/preflight
        work and the engine's own ``step_begin`` then no-ops, so the two
        layers share one step without coordination."""
        if self._cur is not None:
            return
        t = self.clock.now()
        self._cur = StepRecord(self.total_steps)
        if self._last_end is not None:
            self._gap0 = t - self._last_end
            if self._gap0 < 0:   # clock-domain mixup must not corrupt tiling
                self._gap0 = 0.0
        else:
            self._gap0 = 0.0
        self._cur.after_idle = self._after_idle
        self._after_idle = False
        self._t = t

    def mark(self, segment: str) -> None:
        """Attribute the cursor interval ``[last mark, now]`` to
        ``segment`` and advance the cursor.  Outside an open step (a
        frontend early-return path) the call is a no-op."""
        cur = self._cur
        if cur is None:
            return
        t = self.clock.now()
        dt = t - self._t
        if dt > 0:
            cur.segments[segment] = cur.segments.get(segment, 0.0) + dt
        self._t = t

    def device_mark(self) -> None:
        """Attribute the cursor interval to device compute (the blocking
        output materialization on a real clock)."""
        cur = self._cur
        if cur is None:
            return
        t = self.clock.now()
        dt = t - self._t
        if dt > 0:
            cur.device_s += dt
        self._t = t

    def note_shape(self, path: str, batch: int, chunk: int) -> None:
        """Tag the open step with its dispatch shape — the per-(bucket,
        batch-shape) attribution key.  A step that never dispatches
        (empty plan) keeps ``path=None`` and is DISCARDED at step_end:
        its host time folds into the next real step's host gap, which is
        exactly what that time is (loop tax without device work)."""
        if self._cur is not None:
            self._cur.path = path
            self._cur.batch = int(batch)
            self._cur.chunk = int(chunk)

    def note_compile(self, key: str, aot: bool = False) -> None:
        """One compile event (the engine's ``_step_fns`` grew an entry).
        A JIT cache miss (``aot=False``) is tagged warm-up until
        :meth:`mark_steady`; after it, counted as an unexpected
        steady-state recompile — the AOT regression signal.  A deliberate
        ``warm_all`` AOT compile (``aot=True``) is NEVER steady-state
        noise: it is the warm-up mechanism itself, and does not bump the
        per-step JIT-miss counter either."""
        idx = self._cur.index if self._cur is not None else self.total_steps
        rec = CompileRecord(key, idx, self._steady and not aot,
                            self.clock.now(), aot=aot)
        self.compiles.append(rec)
        if self._cur is not None and not aot:
            self._cur.compiles += 1
        if rec.steady:
            self.steady_state_recompiles += 1

    def note_idle(self) -> None:
        """The driver idled (an arrival/deadline ``wait_until`` jump):
        exclude the idle stretch from the anatomy.  Between steps the gap
        origin resets (next step's host gap starts at 0, flagged
        ``after_idle``); inside an open step the cursor snaps to now so
        the jump lands in no segment."""
        if self._cur is not None:
            self._t = self.clock.now()
            self._cur.after_idle = True
        else:
            self._last_end = None
        self._after_idle = True

    def step_end(self) -> Optional[StepRecord]:
        """Close the step window: the residual cursor interval becomes
        ``bookkeeping``, the inter-step gap becomes ``host_gap_s``, and
        ``wall_s`` is the exact component sum (the tiling invariant).
        Returns the closed record, or None when the step never dispatched
        (discarded — see :meth:`note_shape`)."""
        cur = self._cur
        if cur is None:
            return None
        t = self.clock.now()
        tail = t - self._t
        if tail > 0:
            cur.segments["bookkeeping"] += tail
        self._cur = None
        if cur.path is None:
            # planned-but-empty step: keep the gap origin where it was so
            # this window folds into the next real step's host gap
            return None
        cur.host_gap_s = self._gap0
        cur.wall_s = cur.host_gap_s + cur.host_s() + cur.device_s
        cur.end_ts = t
        self._last_end = t
        self._retain(cur)
        return cur

    def charge_last_step(self, dt: float) -> Optional[StepRecord]:
        """Post-hoc device charge for clock-driven frontends: a
        ``VirtualClock``/``ReplicaClockView`` accounts the step cost via
        ``clock.on_step`` AFTER the engine step returned, so the serving
        loop forwards the charged seconds here.  The last record's device
        and wall grow by ``dt`` and the gap origin re-anchors at the
        clock's current reading (a VirtualClock just advanced by the
        charge; a deferred ReplicaClockView has not, and its round
        advance shows up in the next step's host gap — the round-
        quantization the fleet simulator actually imposes)."""
        if not dt >= 0:
            raise ValueError(f"step charge cannot be negative (dt={dt})")
        if not self.steps:
            return None
        rec = self.steps[-1]
        rec.device_s += dt
        rec.wall_s += dt
        self.total_device_s += dt
        self.total_wall_s += dt
        self._last_end = self.clock.now()
        rec.end_ts = self._last_end
        return rec

    def mark_steady(self) -> None:
        """Declare warm-up over: every later JIT cache miss is an
        unexpected steady-state recompile.  One-way by design — a harness
        that wants a fresh warm-up builds a fresh recorder."""
        self._steady = True

    @property
    def steady(self) -> bool:
        return self._steady

    def reset_steps(self) -> None:
        """Drop the per-step table and lifetime totals, keep the compile
        log and the steady boundary — the bench pattern: warm up, mark
        steady, reset, measure (warm-up steps must not dilute the
        measured host-gap fractions; warm-up COMPILES must stay on the
        record, they are what 'steady state' is defined against)."""
        self.steps.clear()
        self.dropped_steps = 0
        self.total_steps = 0
        self.total_wall_s = self.total_host_s = 0.0
        self.total_device_s = self.total_host_gap_s = 0.0
        self._last_end = None
        self._after_idle = False
        self._cur = None

    # --------------------------------------------------------------- intake

    def _retain(self, rec: StepRecord) -> None:
        if self.steps.maxlen is not None and len(self.steps) == self.steps.maxlen:
            self.dropped_steps += 1
        self.steps.append(rec)
        self.total_steps += 1
        self.total_wall_s += rec.wall_s
        self.total_host_s += rec.host_s()
        self.total_device_s += rec.device_s
        self.total_host_gap_s += rec.host_gap_s

    # -------------------------------------------------------------- queries

    @property
    def last_step(self) -> Optional[StepRecord]:
        return self.steps[-1] if self.steps else None

    def host_gap_fraction(self) -> Optional[float]:
        """Lifetime host-gap share of wall time — the one-number loop-tax
        gauge (None before the first step)."""
        if self.total_wall_s <= 0:
            return None
        return self.total_host_gap_s / self.total_wall_s

    def by_shape(self) -> Dict[str, dict]:
        """Per-(path, batch, chunk) aggregation over the RETAINED steps
        (the deque window; ``dropped_steps`` tells the reader when that
        window is not the whole run).  Deterministic key order."""
        out: Dict[str, dict] = {}
        for rec in self.steps:
            agg = out.get(rec.shape_key)
            if agg is None:
                agg = out[rec.shape_key] = {
                    "steps": 0, "wall_s": 0.0, "host_s": 0.0,
                    "device_s": 0.0, "host_gap_s": 0.0, "compiles": 0,
                    "segments": {s: 0.0 for s in HOST_SEGMENTS}}
            agg["steps"] += 1
            agg["wall_s"] += rec.wall_s
            agg["host_s"] += rec.host_s()
            agg["device_s"] += rec.device_s
            agg["host_gap_s"] += rec.host_gap_s
            agg["compiles"] += rec.compiles
            for s in HOST_SEGMENTS:
                agg["segments"][s] += rec.segments[s]
        for key in sorted(out):
            agg = out[key]
            wall = agg["wall_s"]
            rounded = {
                "steps": agg["steps"],
                "wall_s": round(wall, 9),
                "host_s": round(agg["host_s"], 9),
                "device_s": round(agg["device_s"], 9),
                "host_gap_s": round(agg["host_gap_s"], 9),
                "host_gap_fraction": round(agg["host_gap_s"] / wall, 6)
                if wall > 0 else None,
                "compiles": agg["compiles"],
                "segments": {s: round(agg["segments"][s], 9)
                             for s in HOST_SEGMENTS},
            }
            out[key] = rounded
        return {k: out[k] for k in sorted(out)}

    def summary(self) -> dict:
        return {
            "steps": self.total_steps,
            "retained_steps": len(self.steps),
            "dropped_steps": self.dropped_steps,
            "wall_s": round(self.total_wall_s, 9),
            "host_s": round(self.total_host_s, 9),
            "device_s": round(self.total_device_s, 9),
            "host_gap_s": round(self.total_host_gap_s, 9),
            "host_gap_fraction": None if self.total_wall_s <= 0
            else round(self.total_host_gap_s / self.total_wall_s, 6),
            "compiles": len(self.compiles),
            "steady_state_recompiles": self.steady_state_recompiles,
            "steady": self._steady,
        }

    def to_doc(self) -> dict:
        """The full deterministic export (what ``bench_serving.py
        --anatomy`` commits and ``scripts/step_anatomy.py`` re-verifies):
        per-step table, compile log, per-shape fold, summary.  Pure data,
        9-dp rounding, sorted keys downstream.  Schema 2 = the r20
        segment vocabulary (``aot_compile``/``overlap``) plus the
        compile log's ``aot`` flag."""
        return {
            "schema": 2,
            "summary": self.summary(),
            "by_shape": self.by_shape(),
            "steps": [rec.to_row() for rec in self.steps],
            "compiles": [c.to_row() for c in self.compiles],
        }

    # ------------------------------------------------------------ span lift

    def emit_spans(self, tracer, trace_id: Optional[int] = None,
                   track: str = "anatomy") -> int:
        """Lift the retained per-step records into tracer spans: one
        ``anatomy/step`` parent per step with its components laid
        end-to-end inside the window.  Naming contract: only
        ``host_gap`` and ``compile_wait`` — the two step-anatomy entries
        in the REQUEST-phase taxonomy (``trace_report.PHASES``,
        ``why_slow.CAUSES``) — emit as ``phase/<name>``; the plain host
        segments and device compute emit as ``anatomy/<name>``, which
        the request folds ignore by design.  So anatomy spans sharing a
        trace file with request traces never surface as ``unknown:<p>``:
        they either fold by name or are skipped, never half-parsed.
        Returns spans emitted; no-op (0) on a disabled tracer."""
        if not getattr(tracer, "enabled", False):
            return 0
        tid = trace_id if trace_id is not None else tracer.new_trace_id()
        n = 0
        for rec in self.steps:
            t0 = rec.end_ts - rec.wall_s
            parent = tracer.add_span(
                "anatomy/step", tid, t0, rec.end_ts, track=track,
                attrs={"shape": rec.shape_key, "compiles": rec.compiles,
                       "after_idle": rec.after_idle})
            n += 1
            t = t0
            parts = [("phase/host_gap", rec.host_gap_s)]
            parts += [("phase/compile_wait" if s == "compile_wait"
                       else f"anatomy/{s}", rec.segments[s])
                      for s in HOST_SEGMENTS]
            parts.append(("anatomy/device", rec.device_s))
            for name, dur in parts:
                if dur <= 0:
                    continue
                tracer.add_span(name, tid, t, t + dur,
                                parent_id=parent.span_id, track=track)
                t += dur
                n += 1
        return n


class NullStepAnatomy:
    """Disabled recorder: every hook is a no-op and allocates nothing —
    the engine hot path costs one attribute read + one predicate per
    step when anatomy is off (pinned by tracemalloc tests)."""

    enabled = False
    steps: tuple = ()
    compiles: tuple = ()
    dropped_steps = 0
    total_steps = 0
    steady_state_recompiles = 0
    steady = False

    def step_begin(self) -> None:
        pass

    def mark(self, segment) -> None:
        pass

    def device_mark(self) -> None:
        pass

    def note_shape(self, path, batch, chunk) -> None:
        pass

    def note_compile(self, key, aot=False) -> None:
        pass

    def note_idle(self) -> None:
        pass

    def step_end(self) -> None:
        return None

    def charge_last_step(self, dt) -> None:
        return None

    def mark_steady(self) -> None:
        pass

    def reset_steps(self) -> None:
        pass

    @property
    def last_step(self):
        return None

    def host_gap_fraction(self):
        return None

    def by_shape(self) -> dict:
        return {}

    def summary(self) -> dict:
        return {}

    def to_doc(self) -> dict:
        return {"schema": 2, "summary": {}, "by_shape": {}, "steps": [],
                "compiles": []}

    def emit_spans(self, tracer, trace_id=None, track="anatomy") -> int:
        return 0


NULL_ANATOMY = NullStepAnatomy()
