"""Speculative decoding in the port (``deepspeed_tpu_torch/inference/v2/spec``
and the engine's verify path) against the JAX package's, scenario by
scenario.

The scenarios of ``tests/unit/inference/test_spec_decode.py`` — the n-gram
drafter, greedy parity by construction, speculation off under sampling, one
verify program per batch bucket, the ``engine.verify_step`` fault site,
``warm_verify``, the scheduler's budget for verify slots, ``_plan_drafts``
under a small budget, the paged-KV rollback, the serving frontend's
acceptance accounting and ``spec/*`` metrics, the per-request opt-out,
preemption mid-speculation and the seeded property audit (seed 0) — and
every scenario of ``tests/unit/inference/test_spec_index.py`` run over the
JAX engine and over the port's ``build_engine(device="cpu")`` on the same
float32 weights (``tests/torch_serving_backends.py``: the model that
``test_spec_decode.py:21-33`` serves, with its page 8, token budget 64 and
decode bucket 4).  Each run makes the JAX test's own assertions, and the two
packages' tokens, ``spec_stats``, per-step ``last_spec_round``, program keys
and page accounting must be equal.
"""

import dataclasses
import importlib
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_serving_backends import page_view, request_view

from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu.telemetry import MetricsRegistry

PROMPTS = [[5, 9, 2, 7, 1], [3, 3, 8], [1, 2, 3, 1, 2, 3, 1, 2], [11, 4, 6, 2]]


@pytest.fixture(scope="module")
def backends():
    from torch_serving_backends import make_backends
    return make_backends(max_pos=128)


@pytest.fixture(scope="module")
def reference(backends):
    """The cache-free JAX model's greedy continuation of a prompt."""
    jax_be = backends["jax"]
    model = JaxLlama(jax_be.cfg)
    apply = jax.jit(model.apply)
    memo = {}

    def greedy(prompt, n_new):
        key = (tuple(prompt), n_new)
        if key not in memo:
            # one fixed width (the model's positions), causal: the logits at
            # the last real position do not see the zero padding after it
            ids = np.zeros((1, jax_be.cfg.max_position_embeddings), np.int32)
            ids[0, :len(prompt)] = prompt
            out = []
            for i in range(n_new):
                logits = apply(jax_be.params, jnp.asarray(ids))
                nxt = int(jnp.argmax(logits[0, len(prompt) + i - 1]))
                ids[0, len(prompt) + i] = nxt
                out.append(nxt)
            memo[key] = out
        return memo[key]

    return greedy


def spec_engine(be, spec=True, **overrides):
    """``test_spec_decode.py``'s ``_engine``: spec ``max_draft`` 4 and the
    engine's default of 8 fused decode rounds, unless overridden."""
    overrides.setdefault("decode_steps_per_dispatch", 8)
    return be.engine(spec=be.v2.SpecConfig(max_draft=4) if spec else None, **overrides)


def spec_serve(be, spec=True, num_pages=64, metrics=None, **engine_kw):
    """``test_spec_decode.py``'s ``_serve``: one decode round a tick."""
    serve, _ = be.serve(num_pages=num_pages, spec=be.v2.SpecConfig(max_draft=4) if spec else None,
                        decode_steps_per_dispatch=1, **engine_kw)
    serve.metrics = metrics
    return serve


def stats_view(eng) -> dict:
    return dataclasses.asdict(eng.spec_stats)


def step_rounds(eng, uids, limit=64) -> list:
    """Step until every uid is done; each step's ``last_spec_round``."""
    rounds = []
    for _ in range(limit):
        if all(eng.state.seqs[u].done for u in uids):
            break
        eng.step()
        rounds.append(sorted(eng.last_spec_round.items()))
    return rounds


# ---------------------------------------------------------------- drafter


def _drafter_longest_suffix(be):
    d = be.v2.NGramDrafter(max_ngram=3, min_ngram=1)
    toks = [7, 8, 9, 1, 2, 3, 7, 8, 9]
    got = [d.draft(toks, 3), d.draft(toks, 2), d.draft([5, 1, 9, 5, 2, 9, 5], 2), d.draft([1, 2, 3, 4], 4),
           d.draft([1, 2], 0), d.draft([], 4)]
    assert got == [[1, 2, 3], [1, 2], [2, 9], [], [], []]
    return got


def _drafter_registry(be):
    d = be.v2.make_drafter(be.v2.SpecConfig(max_draft=4, max_ngram=2))
    toks = [int(t) for t in np.random.default_rng(0).integers(1, 20, 40)]
    assert d.draft(toks, 4) == d.draft(list(toks), 4)
    errors = []
    for make, match in ((lambda: be.v2.make_drafter(be.v2.SpecConfig(drafter="nope")), "unknown drafter"),
                        (lambda: be.v2.SpecConfig(max_draft=0), "max_draft"),
                        (lambda: be.v2.SpecConfig(min_ngram=3, max_ngram=2), "min_ngram")):
        with pytest.raises(ValueError, match=match) as err:
            make()
        errors.append(str(err.value))
    return {"draft": d.draft(toks, 4), "errors": errors}


# ---------------------------------------------------------- engine parity


def _generate_matches_reference(be, reference):
    eng = spec_engine(be)
    outs = eng.generate(PROMPTS, max_new_tokens=12)
    for prompt, got in zip(PROMPTS, outs):
        assert got == reference(prompt, 12), prompt
    assert outs == spec_engine(be, spec=False).generate(PROMPTS, max_new_tokens=12)
    st = eng.spec_stats
    assert st.rounds > 0 and st.proposed > 0 and st.accepted > 0
    assert st.emitted >= st.accepted + st.rounds
    return {"outs": outs, "stats": stats_view(eng), "pages": page_view(eng)}


def _off_under_sampling(be, reference):
    eng = spec_engine(be, greedy=False, temperature=0.8)
    assert eng.econfig.spec is None and eng.drafter is None
    outs = eng.generate([[5, 9, 2, 7, 1]], max_new_tokens=4)
    assert len(outs[0]) == 4
    # sampled tokens come from each package's own generator: only the
    # lengths and the dropped config are compared
    return {"lens": [len(o) for o in outs], "spec": eng.econfig.spec}


def _one_verify_program_per_bucket(be, reference):
    eng = spec_engine(be)
    eng.generate(PROMPTS, max_new_tokens=12)
    eng.generate([[9, 1, 4, 9, 1, 4, 9]], max_new_tokens=12)
    verify_keys = sorted(k for k in eng._step_fns if k[0] == "verify")
    assert verify_keys, "no verify program built — speculation never ran"
    assert {k[2] for k in verify_keys} == {eng.econfig.spec.max_draft + 1}
    assert len(verify_keys) == len({k[1] for k in verify_keys})
    assert set(verify_keys) <= {k for k in eng.step_shape_set() if k[0] == "verify"}
    return {"verify_keys": verify_keys, "stats": stats_view(eng)}


def _verify_fault_restores_history(be, reference):
    fi = be.fault_injection
    assert "engine.verify_step" in fi.INJECTION_SITES
    eng = spec_engine(be)
    uids = list(range(len(PROMPTS)))
    fi.configure_fault_injection({"seed": 0, "sites": [{"site": "engine.verify_step", "kind": "device_loss",
                                                        "at": 1}]})
    try:
        eng.put(uids, PROMPTS, max_new_tokens=12)
        with pytest.raises(fi.DeviceLossError, match="DEVICE_LOST"):
            for _ in range(64):
                eng.step()
        for u in uids:
            seq = eng.state.seqs[u]
            assert len(seq.tokens) == len(PROMPTS[u]) + len(seq.generated)
        at_fault = [list(eng.state.seqs[u].tokens) for u in uids]
    finally:
        fi.configure_fault_injection(None)
    rounds = step_rounds(eng, uids)
    outs = [list(eng.state.seqs[u].generated) for u in uids]
    for u in uids:
        assert outs[u] == reference(PROMPTS[u], 12)
    return {"at_fault": at_fault, "outs": outs, "rounds": rounds, "stats": stats_view(eng)}


def _warm_verify_parity(be, reference):
    eng = spec_engine(be)
    eng.warm_verify([1, 8])
    warmed = sorted(k for k in eng._step_fns if k[0] == "verify")
    assert warmed
    outs = eng.generate(PROMPTS, max_new_tokens=12)
    for prompt, got in zip(PROMPTS, outs):
        assert got == reference(prompt, 12)
    assert eng.spec_stats.rounds > 0
    assert sorted(k for k in eng._step_fns if k[0] == "verify") == warmed
    spec_engine(be, spec=False).warm_verify([1, 8])       # no-op on a spec-less engine
    return {"warmed": warmed, "outs": outs, "stats": stats_view(eng)}


def _plan_drafts_budget(be, reference):
    eng = spec_engine(be)
    for uid in range(4):
        seq = eng.state.get_or_create(uid, [1, 2, 3, 1, 2, 3, 1, 2])
        eng.kv.ensure_capacity(seq, seq.remaining_prefill)
        seq.seen_tokens = len(seq.tokens) - 1
        seq.generated = [seq.tokens[-1]]
        eng._max_new[uid] = 16
    seqs = [eng.state.seqs[u] for u in range(4)]
    drafts = eng._plan_drafts(seqs)
    assert all(len(d) >= 3 for d in drafts)
    eng.econfig = dataclasses.replace(eng.econfig, scheduler=dataclasses.replace(eng.econfig.scheduler,
                                                                                 token_budget=12))
    shrunk = eng._plan_drafts(seqs)
    assert sum(1 + len(d) for d in shrunk) <= 12
    assert any(shrunk)
    return {"drafts": drafts, "shrunk": shrunk}


def _verify_tokens_derived(be, reference):
    eng = spec_engine(be)
    assert eng.econfig.scheduler.spec_verify_tokens == eng.econfig.spec.max_draft
    return dataclasses.asdict(eng.econfig.scheduler)


def _rollback_frees_pages(be, reference):
    eng = spec_engine(be, enable_prefix_cache=False)
    outs = eng.generate(PROMPTS, max_new_tokens=16)
    st = eng.spec_stats
    assert st.proposed > st.accepted, "every draft accepted — rollback untested"
    assert eng.kv.allocator.free_pages == eng.kv.num_pages - 1
    assert (np.asarray(eng.kv.allocator._rc[1:]) == 0).all()
    return {"outs": outs, "stats": stats_view(eng), "pages": page_view(eng)}


# ----------------------------------------------------------- serving layer


def _serving_parity_and_metrics(be, reference):
    baseline = spec_serve(be, spec=False)
    base_reqs = [baseline.submit(p, max_new_tokens=10) for p in PROMPTS]
    baseline.drain()
    metrics = MetricsRegistry()
    serve = spec_serve(be, metrics=metrics)
    reqs = [serve.submit(p, max_new_tokens=10) for p in PROMPTS]
    serve.drain()
    assert [list(r.tokens) for r in reqs] == [list(r.tokens) for r in base_reqs]
    assert all(r.state is be.RequestState.DONE for r in reqs)
    accepted = sum(r.spec_accepted for r in reqs)
    proposed = sum(r.spec_proposed for r in reqs)
    assert proposed > 0 and accepted > 0
    assert metrics.counter("spec/proposed").value == proposed
    assert metrics.counter("spec/accepted").value == accepted
    hist = metrics.histogram("spec/acceptance_rate")
    assert hist.count > 0
    winners = [i for i, r in enumerate(reqs) if r.spec_accepted]
    assert winners
    for i in winners:
        assert reqs[i].tpot < base_reqs[i].tpot
        assert reqs[i].spec_acceptance == reqs[i].spec_accepted / reqs[i].spec_proposed
    return {"requests": [request_view(r) for r in reqs], "baseline": [request_view(r) for r in base_reqs],
            "spec": [(r.spec_proposed, r.spec_accepted, r.spec_rollback_pages) for r in reqs],
            "metrics": {n: metrics.counter(n).value for n in ("spec/proposed", "spec/accepted",
                                                             "spec/rollback_pages")},
            "acceptance_count": hist.count, "stats": stats_view(serve.engine)}


def _per_request_opt_out(be, reference):
    serve = spec_serve(be)
    r_on = serve.submit([1, 2, 3, 1, 2, 3, 1, 2], max_new_tokens=10)
    r_off = serve.submit([1, 2, 3, 1, 2, 3, 1, 2], max_new_tokens=10, spec=False)
    serve.drain()
    assert list(r_on.tokens) == list(r_off.tokens)
    assert r_off.spec_proposed == 0 and r_off.spec_acceptance is None
    assert r_on.spec_proposed > 0
    return {"on": request_view(r_on), "off": request_view(r_off), "spec_on": (r_on.spec_proposed,
                                                                              r_on.spec_accepted)}


def _preempt_during_speculation(be, prefix_cache):
    rng = np.random.default_rng(0)
    p1 = [int(x) for x in rng.integers(1, 100, 9)]
    p2 = [int(x) for x in rng.integers(1, 100, 9)]
    golden = be.generate([p1, p2], 20)
    serve = spec_serve(be, num_pages=7, enable_prefix_cache=prefix_cache)
    r1 = serve.submit(p1, max_new_tokens=20)
    r2 = serve.submit(p2, max_new_tokens=20)
    serve.drain()
    assert serve.stats.preemptions >= 1
    assert [r1.state, r2.state] == [be.RequestState.DONE] * 2
    assert [list(r1.tokens), list(r2.tokens)] == golden
    assert r1.spec_proposed + r2.spec_proposed > 0, "speculation never engaged"
    eng = serve.engine
    cached = eng.kv.prefix_cache.cached_pages if eng.kv.prefix_cache else 0
    assert eng.kv.allocator.free_pages + cached == eng.kv.num_pages - 1
    return {"requests": [request_view(r1), request_view(r2)], "preemptions": serve.stats.preemptions,
            "stats": stats_view(eng), "pages": page_view(eng)}


def _property_cycles(be, seed):
    rng = np.random.default_rng(seed)
    prompts = [[int(x) for x in rng.integers(1, 100, int(rng.integers(4, 10)))] for _ in range(5)]
    lens = [int(rng.integers(6, 14)) for _ in prompts]
    golden = [be.generate([p], n)[0] for p, n in zip(prompts, lens)]
    serve = spec_serve(be, num_pages=12)
    reqs = [serve.submit(p, max_new_tokens=n, arrival_ts=float(i)) for i, (p, n) in enumerate(zip(prompts, lens))]
    serve.drain()
    assert all(r.state is be.RequestState.DONE for r in reqs)
    assert [list(r.tokens) for r in reqs] == golden
    eng = serve.engine
    rc = eng.kv.allocator._rc
    free = eng.kv.allocator._free
    assert len(free) == len(set(free)), "free list has duplicates"
    for p in free:
        assert rc[p] == 0
    cached = eng.kv.prefix_cache.cached_pages if eng.kv.prefix_cache else 0
    assert eng.kv.allocator.free_pages + cached == eng.kv.num_pages - 1
    assert eng.spec_stats.rollback_pages >= 0
    return {"requests": [request_view(r) for r in reqs], "stats": stats_view(eng), "pages": page_view(eng),
            "preemptions": serve.stats.preemptions}


SCENARIOS = {
    "drafter_longest_suffix": lambda be, ref: _drafter_longest_suffix(be),
    "drafter_registry": lambda be, ref: _drafter_registry(be),
    "generate_matches_reference": _generate_matches_reference,
    "off_under_sampling": _off_under_sampling,
    "one_verify_program_per_bucket": _one_verify_program_per_bucket,
    "verify_fault_restores_history": _verify_fault_restores_history,
    "warm_verify_parity": _warm_verify_parity,
    "plan_drafts_budget": _plan_drafts_budget,
    "verify_tokens_derived": _verify_tokens_derived,
    "rollback_frees_pages": _rollback_frees_pages,
    "serving_parity_and_metrics": _serving_parity_and_metrics,
    "per_request_opt_out": _per_request_opt_out,
    "preempt_prefix_cache": lambda be, ref: _preempt_during_speculation(be, True),
    "preempt_no_prefix_cache": lambda be, ref: _preempt_during_speculation(be, False),
    "property_seed_0": lambda be, ref: _property_cycles(be, 0),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_spec_scenario_matches_jax(backends, reference, name):
    want = SCENARIOS[name](backends["jax"], reference)
    got = SCENARIOS[name](backends["port"], reference)
    assert got == want


def test_spec_steps_fold_identical_rounds(backends):
    """Step by step, the two engines run the same verify rounds: each
    step's ``last_spec_round`` (proposed, accepted, rollback pages per uid)
    and the page accounting after every step are equal."""
    views = {}
    for name, be in backends.items():
        eng = spec_engine(be)
        uids = list(range(len(PROMPTS)))
        eng.put(uids, PROMPTS, max_new_tokens=12)
        rounds, pages = [], []
        for _ in range(64):
            if all(eng.state.seqs[u].done for u in uids):
                break
            eng.step()
            rounds.append(sorted(eng.last_spec_round.items()))
            pages.append(page_view(eng))
        views[name] = (rounds, pages, [list(eng.state.seqs[u].generated) for u in uids], stats_view(eng))
    assert any(views["jax"][0]), "no step ran a verify round"
    assert views["port"] == views["jax"]


def test_scheduler_mixed_step_never_charges_verify_tokens(backends):
    """A mixed plan charges decode rows 1 token each: verify rounds run
    only on pure-decode steps (``test_spec_decode.py:185``)."""
    plans = {}
    for name, be in backends.items():
        ragged = importlib.import_module(f"{be.v2.__name__}.ragged")
        kv = ragged.BlockedKVCache(num_pages=64, page_size=8, max_pages_per_seq=8)
        state = ragged.StateManager(kv, max_batch=8)
        for uid in range(2):
            seq = state.get_or_create(uid, list(range(1, 10)))
            seq.seen_tokens = len(seq.tokens)
            seq.generated = [7]
        state.get_or_create(10, list(range(1, 40)))
        sched = be.sched.SplitFuseScheduler(be.sched.SchedulerConfig(token_budget=32, max_seqs=8, prefill_chunk=16,
                                                                     decode_bucket=4, spec_verify_tokens=4))
        plan = sched.plan(state)
        assert len(plan.decode) == 2
        assert [n for _, n in plan.prefill] == [16]
        plans[name] = ([s.uid for s in plan.decode], [(s.uid, n) for s, n in plan.prefill])
    assert plans["port"] == plans["jax"]


# ------------------------------------------------ test_spec_index.py's cases


def _drafters(backends, **kw):
    return [be.v2.NGramDrafter(**kw) for be in backends.values()]


def test_index_long_history_identical_to_scan(backends):
    rng = random.Random(0)
    drafters = _drafters(backends, max_ngram=3, min_ngram=1)
    toks = []
    for step in range(3000):
        toks.append(rng.randrange(2, 40))
        if step % 7 == 0:
            k = rng.randrange(1, 6)
            got = [d.draft(toks, k) for d in drafters]
            assert got[0] == got[1] == drafters[1]._scan_draft(list(toks), k), f"divergence at len={len(toks)}"
    for d in drafters:
        assert len(d._indexes) == 1
        (idx, ) = d._indexes.values()
        assert idx.indexed == 2997 and idx.tokens is toks


@pytest.mark.parametrize("max_ngram", [1, 2, 4])
def test_index_engine_mutation_pattern_fuzz(backends, max_ngram):
    rng = random.Random(max_ngram)
    drafters = _drafters(backends, max_ngram=max_ngram, min_ngram=1)
    for _ in range(60):
        toks = [rng.randrange(2, 9) for _ in range(rng.randrange(0, 30))]
        for _ in range(80):
            k = rng.randrange(0, 5)
            got = [d.draft(toks, k) for d in drafters]
            assert got[0] == got[1] == drafters[1]._scan_draft(list(toks), k)
            base = len(toks)
            toks.extend(rng.randrange(2, 9) for _ in range(rng.randrange(0, 4)))
            del toks[base:]
            for _ in range(rng.randrange(1, 3)):
                toks.append(rng.randrange(2, 9))
            if rng.random() < 0.05:
                toks = list(toks)


def test_index_truncation_below_index_rebuilds(backends):
    for d in _drafters(backends, max_ngram=3):
        toks = [1, 2, 3, 1, 2, 3, 1, 2]
        assert d.draft(toks, 3) == d._scan_draft(list(toks), 3) == [3, 1, 2]
        del toks[3:]
        toks.extend([9, 9, 1, 2])
        assert d.draft(toks, 3) == d._scan_draft(list(toks), 3)
        toks2 = [5, 6, 5, 6, 5]
        assert d.draft(toks2, 2) == [6, 5]
        toks2[-1] = 7
        toks2[0] = 7
        assert d.draft(toks2, 2) == d._scan_draft(list(toks2), 2)


def test_index_cache_is_bounded(backends):
    for d in _drafters(backends, max_ngram=2, max_cached_seqs=4):
        for t in [[i, i + 1, i, i + 1] for i in range(10)]:
            d.draft(t, 2)
        assert len(d._indexes) == 4


def test_index_non_list_histories_use_reference_scan(backends):
    for d in _drafters(backends, max_ngram=3):
        assert d.draft((4, 5, 6, 4, 5, 6, 4), 2) == [5, 6]
        assert not d._indexes


def test_index_drafter_contract_unchanged(backends):
    for be in backends.values():
        d = be.v2.make_drafter(be.v2.SpecConfig(max_draft=4, max_ngram=3, min_ngram=1))
        assert isinstance(d, be.v2.NGramDrafter)
        assert d.draft([], 4) == [] and d.draft([1], 4) == [] and d.draft([1, 2, 1, 2], 0) == []
        assert d.draft([3, 4, 3], 4) == [4, 3]
        with pytest.raises(ValueError, match="min_ngram"):
            be.v2.NGramDrafter(max_ngram=2, min_ngram=3)
