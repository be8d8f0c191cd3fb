"""The port's agentic sessions (``deepspeed_tpu_torch/serving/sessions``)
against the JAX package, scenario by scenario.

The scenarios of ``tests/unit/inference/test_sessions.py`` run over both
packages (``tests/torch_serving_backends.py``): the session state machine's
transition table, the tool-call detector, turn bookkeeping, and the
``SessionManager`` driving multi-turn sessions with tool stalls parked
through the host KV tier — every transcript equal to a fresh engine
replaying the session turn by turn — with the park's ``tool_stall`` label,
and with stall parking switched off.  The session specs are built here from
a seed.  Each run makes the JAX test's assertions; transcripts, turn
records, manager, serving and tier stats must be equal across the two.  The
fleet-side ``FleetSessionCoordinator`` runs the scenarios of
``tests/unit/resilience/test_session_chaos.py`` over both packages.
"""

import numpy as np
import pytest
from torch_serving_backends import make_backends, unit_scenario
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def backends():
    return make_backends(max_pos=128)


def session_specs(seed, n_sessions, turns, stall_prob, tool_len):
    """Closed-loop session specs in the shape ``SessionManager`` takes:
    ``turns`` turns each, user prompts of 3–10 tokens, 4–8 new tokens,
    think gaps and one tool stall per turn with probability ``stall_prob``."""
    rng = np.random.default_rng(seed)
    specs = []
    for sid in range(n_sessions):
        spec_turns = []
        for _ in range(turns):
            new = int(rng.integers(4, 9))
            stalls = [{"at_tokens": int(rng.integers(2, new)), "stall_s": round(float(rng.uniform(0.5, 3.0)), 6),
                       "tool_tokens": rng.integers(1, 128, tool_len).tolist()}] if rng.random() < stall_prob else []
            spec_turns.append({"user_tokens": rng.integers(1, 128, int(rng.integers(3, 11))).tolist(),
                               "max_new_tokens": new, "think_s": round(float(rng.uniform(0.5, 3.0)), 6),
                               "stalls": stalls})
        specs.append({"sid": sid, "start_ts": 0.0, "turns": spec_turns})
    return specs


def _state_machine(be):
    S = be.sessions.SessionState
    allowed = {S.PENDING: {S.ACTIVE_TURN, S.CLOSED}, S.ACTIVE_TURN: {S.TOOL_STALL, S.THINKING, S.CLOSED},
               S.TOOL_STALL: {S.ACTIVE_TURN, S.CLOSED}, S.THINKING: {S.ACTIVE_TURN, S.CLOSED}, S.CLOSED: set()}
    table = []
    for src in S:
        for dst in S:
            sess = be.sessions.Session(sid=0, turns=[{"user_tokens": [1], "max_new_tokens": 2, "think_s": 0.0,
                                                      "stalls": []}], start_ts=0.0)
            sess.state = src
            if dst in allowed[src]:
                sess.to(dst, 1.0)
                assert sess.state is dst
            else:
                with pytest.raises(ValueError, match="illegal transition"):
                    sess.to(dst, 1.0)
            table.append((src.name, dst.name, dst in allowed[src]))
    return table


def _tool_call_detector(be):
    det = be.sessions.ToolCallDetector(at_counts=(3, 5))
    seen = [det.due([1, 2]), det.due([1, 2, 3]), det.due([1, 2, 3])]
    det.fire([1, 2, 3])
    seen += [det.due([1, 2, 3]), det.due([1, 2, 3, 4, 5])]
    det.fire([1, 2, 3, 4, 5])
    seen.append(det.due([1] * 50))
    with pytest.raises(AssertionError):
        det.fire([1] * 50)
    det = be.sessions.ToolCallDetector(marker=(7, 8))
    seen += [det.due([7]), det.due([1, 7, 8])]
    det.fire([1, 7, 8])
    seen += [det.due([1, 7, 8]), det.due([1, 7, 8, 7, 8])]
    assert seen == [False, True, True, False, True, False, False, True, False, True]
    return seen


def _turn_bookkeeping(be):
    turns = [{"user_tokens": [1, 2], "max_new_tokens": 4, "think_s": 1.5,
              "stalls": [{"at_tokens": 2, "stall_s": 3.0, "tool_tokens": [50]}]},
             {"user_tokens": [3], "max_new_tokens": 2, "think_s": 0.0, "stalls": []}]
    sess = be.sessions.Session(sid=9, turns=turns, start_ts=0.0)
    assert sess.begin_turn(0.0) == [1, 2]
    sess.note_first_token(0.4)
    sess.note_first_token(9.9)
    assert sess.stall_due([10, 11])
    stall = sess.enter_stall([10, 11], ts=1.0)
    assert sess.state is be.sessions.SessionState.TOOL_STALL
    assert stall["tool_tokens"] == [50] and sess.cur["resume_at"] == 4.0
    sess.exit_stall(ts=4.0)
    assert sess.finish_turn([10, 11, 12], ts=5.0) == 1.5
    assert sess.transcript == [1, 2, 10, 11, 12, 50]
    assert sess.turn_records[0]["turn_ttft"] == pytest.approx(0.4)
    assert sess.begin_turn(6.5) == [1, 2, 10, 11, 12, 50, 3]
    assert sess.finish_turn([20], ts=7.0) is None
    assert sess.closed and sess.completed_turns == 2
    return {"transcript": sess.transcript, "records": sess.turn_records}


def _serve(be):
    return be.serve(tier_config=be.kvtier.TierConfig(host_capacity_pages=64))


def _replay(be, spec):
    """The session turn by turn on a fresh engine: the golden transcript."""
    eng = be.engine()
    transcript = []
    for t in spec["turns"]:
        transcript.extend(t["user_tokens"])
        transcript.extend(eng.generate([list(transcript)], max_new_tokens=t["max_new_tokens"])[0])
        for st in t["stalls"]:
            transcript.extend(st["tool_tokens"])
    return transcript


def _manager_transcripts(be):
    specs = session_specs(seed=7, n_sessions=3, turns=3, stall_prob=0.6, tool_len=3)
    serve, tier = _serve(be)
    mgr = be.sessions.SessionManager(serve, specs, be.sessions.SessionConfig(prefetch_lead_s=0.5))
    out = mgr.run()
    assert all(s.state is be.sessions.SessionState.CLOSED for s in out)
    assert mgr.stats["turns_completed"] == sum(len(s["turns"]) for s in specs)
    n_stalls = sum(len(t["stalls"]) for s in specs for t in s["turns"])
    assert n_stalls and mgr.stats["stalls"] == n_stalls == mgr.stats["tool_results"]
    assert serve.stats.parks == serve.stats.resumes == n_stalls
    assert tier.stats["demotions"] == tier.stats["promotions"] == n_stalls
    assert serve.stats.kv_import_fallbacks == 0
    for s in out:
        assert len(s.turn_ttfts()) == len(s.turns)
    for spec in specs:
        assert mgr.transcripts()[spec["sid"]] == _replay(be, spec)
    return {"transcripts": mgr.transcripts(), "mgr": dict(mgr.stats), "tier": dict(tier.stats),
            "summary": serve.summary(), "turns": [s.turn_records for s in out], "clock": serve.clock.now()}


def _park_phase_label(be):
    specs = [{"sid": 0, "start_ts": 0.0, "turns": [
        {"user_tokens": [5, 9, 2, 7], "max_new_tokens": 8, "think_s": 0.0,
         "stalls": [{"at_tokens": 3, "stall_s": 2.0, "tool_tokens": [42]}]}]}]
    serve, _ = _serve(be)
    seen = []
    orig_park = serve.park

    def spy_park(uid, phase="parked"):
        ok = orig_park(uid, phase=phase)
        if ok:
            req = serve._parked[uid]
            seen.append((req.park_phase, req.state.name))
        return ok

    serve.park = spy_park
    mgr = be.sessions.SessionManager(serve, specs, be.sessions.SessionConfig())
    mgr.run()
    assert seen == [("tool_stall", "PARKED")]
    assert mgr.transcripts()[0] == mgr.sessions[0].transcript
    return {"seen": seen, "transcripts": mgr.transcripts()}


def _park_stalls_disabled(be):
    specs = session_specs(seed=3, n_sessions=1, turns=2, stall_prob=1.0, tool_len=2)
    out = {}
    for park in (True, False):
        serve, _ = _serve(be)
        mgr = be.sessions.SessionManager(serve, specs, be.sessions.SessionConfig(park_stalls=park))
        states = [s.state.name for s in mgr.run()]
        out[park] = {"parks": serve.stats.parks, "transcripts": mgr.transcripts(), "states": states}
    assert out[True]["parks"] >= 1 and out[False]["parks"] == 0
    assert out[True]["transcripts"] == out[False]["transcripts"]
    assert out[True]["states"] == out[False]["states"] == ["CLOSED"]
    return out


SCENARIOS = {
    "state_machine": _state_machine,
    "tool_call_detector": _tool_call_detector,
    "turn_bookkeeping": _turn_bookkeeping,
    "manager_transcripts_match_fresh_engine": _manager_transcripts,
    "park_phase_label": _park_phase_label,
    "park_stalls_disabled": _park_stalls_disabled,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_session_scenario_matches_jax(backends, name):
    want = SCENARIOS[name](backends["jax"])
    got = SCENARIOS[name](backends["port"])
    assert got == want


CHAOS = "resilience/test_session_chaos.py"
FLEET_CASES = ["kill_sticky_replica_mid_stall_harvests_and_reparks", "kill_sticky_replica_between_turns_rehomes"]


@pytest.mark.parametrize("name", FLEET_CASES)
def test_fleet_session_scenario_matches_jax(name, tmp_path):
    """The fleet side: ``FleetSessionCoordinator`` driving sessions through
    a router under a sticky replica's death (``test_session_chaos.py``,
    run unchanged over both packages by ``unit_scenario``): transcripts,
    coordinator stats, request streams, ``router.summary()``, the health
    history and page accounting equal across the two packages."""
    want = unit_scenario(CHAOS, f"test_{name}", "jax", tmp_path)
    got = unit_scenario(CHAOS, f"test_{name}", "port", tmp_path)
    assert got == want
