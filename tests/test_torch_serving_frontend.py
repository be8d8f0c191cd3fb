"""The port's SLA serving frontend (``deepspeed_tpu_torch/serving``) against
the JAX package's, scenario by scenario.

Each scenario of ``tests/unit/inference/test_serving_frontend.py`` —
lifecycle and streaming, TTFT from arrival, admission rejection (queue full,
infeasible, an arena-filling request), KV-pressure preemption of the
youngest with a victim output identical to an unpreempted run (prefix cache
on and off), deadlines and goodput, priority with aging, and the monitor's
events — runs over the JAX engine and over the port's ``build_engine(
device="cpu")`` on the same weights (``tests/torch_serving_backends.py``).
Each run makes the JAX test's own assertions, and the two runs' tokens,
request states and histories, latencies on the virtual clock, stats
counters and page accounting must be equal.
"""

import numpy as np
import pytest
from torch_serving_backends import assert_clean, make_backends, page_view, serve_view


@pytest.fixture(scope="module")
def backends():
    return make_backends(max_pos=128)


def _lifecycle(be):
    prompts = [[5, 9, 2, 7, 1], [3, 3, 8]]
    golden = be.generate(prompts, 6)
    streamed = {}

    def on_tokens(req, toks, ts):
        streamed.setdefault(req.uid, []).extend(toks)

    serve, _ = be.serve()
    reqs = [serve.submit(p, max_new_tokens=6, stream=on_tokens) for p in prompts]
    serve.drain()
    S = be.RequestState
    assert [r.state for r in reqs] == [S.DONE] * 2
    assert [list(r.tokens) for r in reqs] == golden
    assert [streamed[r.uid] for r in reqs] == golden
    for r in reqs:
        assert [s for s, _ in r.history] == [S.QUEUED, S.PREFILL, S.DECODE, S.DONE]
        assert r.ttft > 0 and r.tpot > 0 and r.met_deadline
    return {"serve": serve_view(serve, reqs), "streamed": streamed}


def _ttft_includes_queue_wait(be):
    serve, _ = be.serve(max_seqs=1)
    a = serve.submit([5, 9, 2, 7, 1], max_new_tokens=5)
    b = serve.submit([3, 3, 8], max_new_tokens=5)
    serve.drain()
    assert a.state is be.RequestState.DONE and b.state is be.RequestState.DONE
    assert b.queue_wait > 0 and b.ttft >= b.queue_wait
    return serve_view(serve, [a, b])


def _admission_queue_full(be):
    cfg = be.serving.ServingConfig(admission=be.serving.AdmissionConfig(max_queue_depth=2))
    serve, _ = be.serve(config=cfg, max_seqs=1)
    reqs = [serve.submit([5 + i, 9, 2], max_new_tokens=3) for i in range(6)]
    rejected = [r for r in reqs if r.state is be.RequestState.REJECTED]
    assert len(rejected) == 4 and all(r.reject_reason == "queue_full" for r in rejected)
    serve.drain()
    assert sum(r.state is be.RequestState.DONE for r in reqs) == 2
    s = serve.summary()
    assert s["rejected"] == 4 and s["reject_reasons"] == {"queue_full": 4}
    return serve_view(serve, reqs)


def _infeasible_rejected(be):
    serve, _ = be.serve()
    r1 = serve.submit(list(range(1, 60)), max_new_tokens=10)   # 69 tokens > 8 pages of 8
    assert r1.state is be.RequestState.REJECTED and r1.reject_reason == "exceeds_max_pages_per_seq"
    r2 = serve.submit([5, 9, 2], max_new_tokens=3)
    serve.drain()
    assert r2.state is be.RequestState.DONE
    return serve_view(serve, [r1, r2])


def _arena_filling_request(be):
    serve, _ = be.serve(num_pages=8)    # 7 usable pages; 50 + 1 tokens need all 7
    req = serve.submit(list(range(1, 51)), max_new_tokens=1)
    assert req.state is not be.RequestState.REJECTED
    serve.drain()
    assert req.state is be.RequestState.DONE and len(req.tokens) == 1
    return serve_view(serve, [req])


def _pressure_prompts(seed):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(1, 100, 9)] for _ in range(2)]


def _preempts_youngest_identically(be, prefix_cache):
    p1, p2 = _pressure_prompts(0)
    golden = be.generate([p1, p2], 20)
    serve, _ = be.serve(num_pages=8, enable_prefix_cache=prefix_cache)   # 7 pages; each ends at 4
    r1 = serve.submit(p1, max_new_tokens=20)
    r2 = serve.submit(p2, max_new_tokens=20)
    serve.drain()
    assert serve.stats.preemptions >= 1
    victims = [r for r in (r1, r2) if r.preemptions]
    assert victims and all(be.RequestState.EVICTED in [s for s, _ in r.history] for r in victims)
    assert [list(r1.tokens), list(r2.tokens)] == golden
    pages = page_view(serve.engine)
    assert pages["free"] + pages["cached"] == pages["num_pages"] - 1
    view = serve_view(serve, [r1, r2])
    assert_clean(serve.engine)
    return view


def _preemption_prefers_youngest(be):
    p1, p2 = _pressure_prompts(1)
    serve, _ = be.serve(num_pages=8)
    r1 = serve.submit(p1, max_new_tokens=20)
    serve.tick()
    r2 = serve.submit(p2, max_new_tokens=20)
    serve.drain()
    assert r1.preemptions == 0 and r2.preemptions >= 1
    return serve_view(serve, [r1, r2])


def _missed_deadline(be):
    serve, _ = be.serve()
    ok = serve.submit([5, 9, 2, 7, 1], max_new_tokens=4, deadline=1000.0)
    late = serve.submit([3, 3, 8], max_new_tokens=20, deadline=3.0)
    serve.drain()
    assert ok.state is be.RequestState.DONE and ok.met_deadline
    assert late.state is be.RequestState.TIMED_OUT and late.uid not in serve.engine.state.seqs
    s = serve.summary()
    assert s["timed_out"] == 1 and s["deadline_met"] == 1 and s["goodput_rps"] == pytest.approx(1 / s["elapsed"])
    return serve_view(serve, [ok, late])


def _late_completion_without_kill(be):
    serve, _ = be.serve(config=be.serving.ServingConfig(kill_on_deadline=False))
    late = serve.submit([3, 3, 8], max_new_tokens=8, deadline=2.0)
    serve.drain()
    assert late.state is be.RequestState.DONE and not late.met_deadline
    assert serve.summary()["goodput_rps"] == 0.0
    return serve_view(serve, [late])


def _queued_expiry(be):
    serve, _ = be.serve(max_seqs=1)
    a = serve.submit([5, 9, 2, 7, 1], max_new_tokens=10)
    b = serve.submit([3, 3, 8], max_new_tokens=4, deadline=2.0)
    serve.drain()
    assert a.state is be.RequestState.DONE and b.state is be.RequestState.TIMED_OUT and b.admitted_ts is None
    return serve_view(serve, [a, b])


def _priority_and_aging(be):
    out = {}
    for aging in (0.0, 10.0):
        serve, _ = be.serve(max_seqs=1, config=be.serving.ServingConfig(aging_interval=aging))
        old = serve.submit([5, 9, 2], max_new_tokens=3, priority=5.0, arrival_ts=-100.0)
        fresh = serve.submit([3, 3, 8], max_new_tokens=3, priority=0.0, arrival_ts=0.0)
        serve.drain()
        out[aging] = serve_view(serve, [old, fresh])
        # pure priority: the fresh urgent request first; aging: the old one
        assert (old.finish_ts < fresh.finish_ts) is (aging > 0)
    return out


class _Monitor:
    enabled = True

    def __init__(self):
        self.events = []

    def write_events(self, events):
        self.events.extend(events)


def _monitor_events(be):
    mon = _Monitor()
    p1, p2 = _pressure_prompts(0)
    serve, _ = be.serve(num_pages=8, monitor=mon)
    serve.submit(p1, max_new_tokens=20)
    serve.submit(p2, max_new_tokens=20)
    serve.drain()
    tags = {t for t, _, _ in mon.events}
    assert {"serving/ttft", "serving/tpot", "serving/queue_wait", "serving/e2e_latency", "serving/preempted",
            "serving/deadline_met"} <= tags
    return [(t, float(v), int(s)) for t, v, s in mon.events]


SCENARIOS = {
    "lifecycle_and_streaming": _lifecycle,
    "ttft_includes_queue_wait": _ttft_includes_queue_wait,
    "admission_queue_full": _admission_queue_full,
    "infeasible_rejected": _infeasible_rejected,
    "arena_filling_request": _arena_filling_request,
    "preempts_youngest_prefix_cache": lambda be: _preempts_youngest_identically(be, True),
    "preempts_youngest_no_prefix_cache": lambda be: _preempts_youngest_identically(be, False),
    "preemption_prefers_youngest": _preemption_prefers_youngest,
    "missed_deadline_goodput": _missed_deadline,
    "late_completion_without_kill": _late_completion_without_kill,
    "queued_expiry": _queued_expiry,
    "priority_and_aging": _priority_and_aging,
    "monitor_events": _monitor_events,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_frontend_scenario_matches_jax(backends, name):
    want = SCENARIOS[name](backends["jax"])
    got = SCENARIOS[name](backends["port"])
    assert got == want


def _anatomy(be):
    """A ``StepAnatomy`` on the serving clock, attached to the engine: the
    engine opens each step's window in ``dispatch_step`` and closes it in
    ``complete_step``, and the frontend folds every closed step."""
    p1, p2 = _pressure_prompts(0)
    serve, _ = be.serve(num_pages=8)
    anat = serve.engine.set_anatomy(be.telemetry.StepAnatomy(clock=serve.clock))
    reqs = [serve.submit(p, max_new_tokens=12) for p in (p1, p2)]
    serve.drain()
    assert anat.total_steps > 0 and anat._cur is None and serve._anat_steps_seen == anat.total_steps
    summary = {k: v for k, v in anat.summary().items() if k != "compiles"}
    shapes = {k: {f: v for f, v in agg.items() if f != "compiles"} for k, agg in anat.by_shape().items()}
    compiles = [(c.key, c.step_index, c.steady, c.aot) for c in anat.compiles]
    return {"summary": summary, "by_shape": shapes, "serve": serve_view(serve, reqs)}, compiles


def test_step_anatomy_windows_match_jax(backends):
    """The step windows, their shapes and their times on the virtual clock
    equal the JAX engine's, and so does the compile log: the port builds a
    step program at the first dispatch of each key, where the JAX engine
    compiles one."""
    want, jax_compiles = _anatomy(backends["jax"])
    got, port_compiles = _anatomy(backends["port"])
    assert got == want
    assert port_compiles == jax_compiles and len(jax_compiles) > 0


def test_engine_spec_hooks(backends):
    """On an engine without a spec config ``set_spec`` is a no-op either
    way and ``last_spec_round`` stays empty; with one, ``set_spec`` records
    the request's choice until the request leaves — as in the JAX engine."""
    views = {}
    for name, be in backends.items():
        eng = be.engine()
        eng.put([0], [[5, 9, 2]], max_new_tokens=2)
        eng.set_spec(0, False)
        eng.set_spec(0, True)
        eng.step()
        plain = (dict(eng._spec_on), dict(eng.last_spec_round))
        eng.preempt(0)
        spec_eng = be.engine(spec=be.v2.SpecConfig(max_draft=4))
        spec_eng.put([0], [[5, 9, 2]], max_new_tokens=2)
        spec_eng.set_spec(0, False)
        recorded = dict(spec_eng._spec_on)
        spec_eng.flush(0)
        views[name] = (plain, recorded, dict(spec_eng._spec_on), eng.anatomy.enabled)
    assert views["port"] == views["jax"] == (({}, {}), {0: False}, {}, False)
