"""The serving engine's step set in the port against the JAX engine's:
``step_shape_set`` keys and labels, ``warm_all``'s counts, its
``engine.aot_compile`` fault stance and the compile log, and the pipelined
serving tick on top of them: the scenarios of
``tests/unit/inference/test_async_dispatch.py`` (``:59``, ``:89``, the
serial/async parity under forced preemption with speculation off and on
``:136``, a crash mid-pipeline ``:196``) over both packages on the same
float32 weights (``tests/torch_serving_backends.py``).

On the CPU the port builds no graph: a key counts as built after one
all-padding eager dispatch.  The CUDA-graph route (``step_graphs.GraphStep``)
has its own tests here, marked ``cuda``: each key's replay equals its eager
forward bit for bit, in tokens and in KV arena bytes; the launch counters
move per replay by the deltas the capture recorded; categorical sampling
draws fresh numbers at every replay.  Run them on a card with ``python -m
pytest --noconftest tests/test_torch_step_set.py -m cuda -q``.
"""

import dataclasses
import importlib
import pkgutil

import numpy as np
import pytest
import torch
from torch_serving_backends import page_view

from deepspeed_tpu_torch.inference.v2 import (PagedKVConfig, RaggedInferenceEngineConfig, SchedulerConfig,
                                              SpecConfig, build_engine)
from deepspeed_tpu_torch.inference.v2.step_graphs import KERNEL_COUNTERS, ReplayCounts
from deepspeed_tpu_torch.models.llama import PRESETS, init_weights_
from deepspeed_tpu_torch.models.llama_cache import LlamaForCausalLMWithCache
from deepspeed_tpu_torch.ops.paged_attention import paged_attention_cuda

#: ``test_async_dispatch.py``'s prompts (the repetitive ones engage the drafter)
PROMPTS = [[5, 9, 2, 7, 1], [3, 3, 8], [1, 2, 3, 1, 2, 3, 1, 2], [11, 4, 6, 2], [9, 1, 4, 9, 1, 4, 9],
           [2, 8, 2, 8, 2], [7, 7, 5, 1], [6, 2, 6, 2, 6, 2]]

#: the engine settings of three step sets: chip_smoke.py phase 3's
#: scheduler (one batch bucket of 8, chunk 256, 8 fused rounds), three
#: batch buckets with 4 fused rounds, and a spec engine
STEP_SETS = {
    "phase3": dict(max_seqs=8, decode_bucket=8, prefill_chunk=256, decode_steps_per_dispatch=8),
    "buckets_12": dict(max_seqs=12, decode_bucket=4, decode_steps_per_dispatch=4),
    "spec": dict(decode_steps_per_dispatch=8, spec="max_draft_4"),
}


@pytest.fixture(scope="module")
def backends():
    from torch_serving_backends import make_backends
    return make_backends(max_pos=128)


def _engine(be, **kw):
    if kw.get("spec") == "max_draft_4":
        kw["spec"] = be.v2.SpecConfig(max_draft=4)
    return be.engine(**kw)


@pytest.mark.parametrize("name", list(STEP_SETS))
def test_step_shape_set_matches_jax(backends, name):
    views = {}
    for pkg, be in backends.items():
        eng = _engine(be, **STEP_SETS[name])
        keys = eng.step_shape_set()
        views[pkg] = (keys, [eng._key_label(k) for k in keys])
    assert views["port"] == views["jax"]
    if name == "phase3":
        assert views["port"][0] == [(8, 1), (8, 256), ("multi", 8, 2), ("multi", 8, 4), ("multi", 8, 8)]


def _warm_all_closes_the_step_set(be):
    """``test_async_dispatch.py:59``: ``warm_all`` builds every key, a
    second call is all cached, and serving after it builds nothing."""
    eng = be.engine(spec=be.v2.SpecConfig(max_draft=4))
    clock = be.serving.VirtualClock()
    anat = eng.set_anatomy(be.telemetry.StepAnatomy(clock=clock))
    res = eng.warm_all()
    assert res["fallback"] == 0 and res["cached"] == 0
    assert res["compiled"] == len(res["keys"]) == len(eng.step_shape_set())
    assert set(res["keys"]) == {"step:b4:c1", "step:b4:c8", "step:b8:c1", "step:b8:c8", "verify:b4:w5",
                                "verify:b8:w5"}
    assert all(c.aot for c in anat.compiles)
    anat.mark_steady()
    res2 = eng.warm_all()
    assert res2["compiled"] == 0 and res2["cached"] == len(res["keys"])
    serve = be.serving.ServingEngine(eng, clock=clock, config=be.serving.ServingConfig())
    reqs = serve.run([dict(prompt=p, max_new_tokens=8, arrival_ts=0.0) for p in PROMPTS])
    assert all(r.state is be.RequestState.DONE for r in reqs)
    assert eng.spec_stats.rounds > 0
    assert anat.steady_state_recompiles == 0
    assert sum(r.compiles for r in anat.steps) == 0
    return {"warm": res, "rewarm": res2, "tokens": [list(r.tokens) for r in reqs],
            "compiles": [(c.key, c.steady, c.aot) for c in anat.compiles],
            "stats": dataclasses.asdict(eng.spec_stats), "pages": page_view(eng)}


def _aot_fault_falls_back_to_lazy(be):
    """``test_async_dispatch.py:89``: injected faults during ``warm_all``
    leave their keys to be built at their first dispatch (logged as
    steady-state compiles once the recorder is steady); a re-warm closes
    the set; ``InjectedCrash`` propagates."""
    fi = be.fault_injection
    assert "engine.aot_compile" in fi.INJECTION_SITES
    eng = be.engine()
    anat = eng.set_anatomy(be.telemetry.StepAnatomy(clock=be.serving.VirtualClock()))
    fi.configure_fault_injection({"seed": 0, "sites": [
        {"site": "engine.aot_compile", "kind": "os_error", "at": 1},
        {"site": "engine.aot_compile", "kind": "device_loss", "at": 3}]})
    try:
        res = eng.warm_all()
    finally:
        fi.configure_fault_injection(None)
    assert res["fallback"] == 2
    assert res["compiled"] == len(res["keys"]) - 2
    built = sorted(map(str, eng._step_fns))
    anat.mark_steady()
    outs = eng.generate(PROMPTS[:4], max_new_tokens=6)
    assert outs == be.engine().generate(PROMPTS[:4], max_new_tokens=6)
    lazy = [(c.key, c.steady, c.aot) for c in anat.compiles if not c.aot]
    assert lazy and all(steady for _, steady, _ in lazy)
    res2 = eng.warm_all()
    assert res2["fallback"] == 0
    assert res2["compiled"] + res2["cached"] == len(res2["keys"])
    eng2 = be.engine()
    fi.configure_fault_injection({"seed": 0, "sites": [{"site": "engine.aot_compile", "kind": "crash", "at": 1}]})
    try:
        with pytest.raises(fi.InjectedCrash):
            eng2.warm_all()
    finally:
        fi.configure_fault_injection(None)
    return {"warm": res, "built": built, "outs": outs, "rewarm": res2,
            "compiles": [(c.key, c.steady, c.aot) for c in anat.compiles],
            "steady_recompiles": anat.steady_state_recompiles}


def _tokens_after_warm_all(be):
    """Greedy streams after ``warm_all`` (its all-padding dispatches write
    only the null page) equal those of an engine never warmed."""
    streams = []
    for warm in (True, False):
        eng = be.engine(decode_steps_per_dispatch=8, spec=be.v2.SpecConfig(max_draft=4))
        if warm:
            eng.warm_all()
        streams.append(eng.generate(PROMPTS, max_new_tokens=10))
    assert streams[0] == streams[1]
    return streams[0]


def _serve_once(be, async_dispatch, spec, num_pages, max_new_tokens=20):
    eng = be.engine(num_pages=num_pages, max_pages_per_seq=4, spec=spec)
    serve = be.serving.ServingEngine(eng, clock=be.serving.VirtualClock(),
                                     config=be.serving.ServingConfig(async_dispatch=async_dispatch))
    reqs = serve.run([dict(prompt=p, max_new_tokens=max_new_tokens, arrival_ts=0.0) for p in PROMPTS])
    return [(r.state.name, list(r.tokens), r.finish_ts) for r in reqs], serve.stats.preemptions, eng


def _async_parity(be, spec):
    """``test_async_dispatch.py:136``: the pipelined tick's streams equal
    the serial tick's with KV-pressure preemption firing mid-run."""
    spec = be.v2.SpecConfig(max_draft=4) if spec else None
    serial, pre_s, _ = _serve_once(be, False, spec, num_pages=16)
    piped, pre_a, eng = _serve_once(be, True, spec, num_pages=16)
    assert [o[:2] for o in serial] == [o[:2] for o in piped]
    assert all(state == "DONE" for state, _, _ in serial)
    assert pre_s > 0 and pre_a == pre_s
    if spec is not None:
        assert eng.spec_stats.rounds > 0
    return {"serial": serial, "piped": piped, "preemptions": pre_s, "stats": dataclasses.asdict(eng.spec_stats)}


def _crash_mid_pipeline(be):
    """``test_async_dispatch.py:196``: a crash at ``engine.verify_step``
    inside the pipelined dispatch leaves no unverified draft in any
    history, and the same frontend then drains to the serial run's
    streams."""
    spec = be.v2.SpecConfig(max_draft=4)
    baseline, _, _ = _serve_once(be, False, spec, num_pages=64, max_new_tokens=12)
    eng = be.engine(num_pages=64, max_pages_per_seq=4, spec=spec)
    serve = be.serving.ServingEngine(eng, clock=be.serving.VirtualClock(),
                                     config=be.serving.ServingConfig(async_dispatch=True))
    reqs = [serve.submit(p, max_new_tokens=12, arrival_ts=0.0) for p in PROMPTS]
    fi = be.fault_injection
    fi.configure_fault_injection({"seed": 0, "sites": [{"site": "engine.verify_step", "kind": "crash", "at": 1}]})
    try:
        with pytest.raises(fi.InjectedCrash):
            for _ in range(256):
                serve.tick()
    finally:
        fi.configure_fault_injection(None)
    for uid, seq in eng.state.seqs.items():
        req = next(r for r in reqs if r.uid == uid)
        assert len(seq.tokens) == len(req.prompt) + len(seq.generated)
    at_crash = sorted((uid, list(seq.tokens)) for uid, seq in eng.state.seqs.items())
    serve.run([])
    out = [(r.state.name, list(r.tokens), r.finish_ts) for r in reqs]
    assert out == baseline
    return {"at_crash": at_crash, "out": out}


SCENARIOS = {"warm_all_closes_the_step_set": _warm_all_closes_the_step_set,
             "aot_fault_falls_back_to_lazy": _aot_fault_falls_back_to_lazy,
             "tokens_after_warm_all": _tokens_after_warm_all,
             "async_parity_spec_off": lambda be: _async_parity(be, False),
             "async_parity_spec_on": lambda be: _async_parity(be, True),
             "crash_mid_pipeline": _crash_mid_pipeline}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_step_set_scenario_matches_jax(backends, name):
    want = SCENARIOS[name](backends["jax"])
    got = SCENARIOS[name](backends["port"])
    assert got == want


def test_replay_counts_on_a_stub_graph(backends):
    """The graph route's launch accounting, on a stub graph: what the
    capture's Python added to the counters is taken back out and added
    again at every replay."""
    eng = backends["port"].engine()

    class StubGraph:
        def __init__(self, engine, layers):
            self.counts = ReplayCounts(engine)
            with self.counts.capturing():      # what capturing one forward runs
                engine.forward_calls += 1
                paged_attention_cuda.launches += layers
                paged_attention_cuda.split_calls += layers

        def replay(self):
            self.counts.replayed()

    saved = (paged_attention_cuda.launches, paged_attention_cuda.split_calls)
    try:
        paged_attention_cuda.launches = paged_attention_cuda.split_calls = 0
        eng.forward_calls = 3
        graph = StubGraph(eng, layers=2)
        assert (eng.forward_calls, paged_attention_cuda.launches, paged_attention_cuda.split_calls) == (3, 0, 0)
        # forward_calls, K3's launches, the other wrappers' launches, K3's split_calls
        assert graph.counts.deltas == (1, 2) + (0, ) * (len(KERNEL_COUNTERS) - 2) + (2, )
        for _ in range(4):
            graph.replay()
        assert (eng.forward_calls, paged_attention_cuda.launches, paged_attention_cuda.split_calls) == (7, 8, 8)
        assert graph.counts.get(paged_attention_cuda) == graph.counts.get(paged_attention_cuda, "split_calls") == 8
        assert graph.counts.added[0] == 4
        with pytest.raises(RuntimeError):
            with ReplayCounts(eng).capturing():
                eng.forward_calls += 5
                raise RuntimeError("capture failed")
        assert eng.forward_calls == 7     # a failed capture adds nothing
    finally:
        paged_attention_cuda.launches, paged_attention_cuda.split_calls = saved


def test_kernel_counters_cover_every_counted_wrapper():
    """Every kernel wrapper of the port that counts its launches is in
    ``KERNEL_COUNTERS``, so a capture of any of them is accounted."""
    import deepspeed_tpu_torch.ops as ops
    counted = set()
    for info in pkgutil.walk_packages(ops.__path__, ops.__name__ + "."):
        mod = importlib.import_module(info.name)
        counted |= {(v, "launches") for v in vars(mod).values()
                    if callable(v) and isinstance(getattr(v, "launches", None), int)}
    assert len(counted) == 11
    assert counted | {(paged_attention_cuda, "split_calls")} == set(KERNEL_COUNTERS)


# ---------------------------------------------------------------- on the card


def _card_engine(dtype, greedy=True):
    """A 2-layer Llama (hidden 256, 4/2 heads of 64, vocab 256) on the card."""
    cfg = dataclasses.replace(PRESETS["tiny"], hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                              dtype=dtype, param_dtype=dtype, attention_impl="flash")
    model = LlamaForCausalLMWithCache(cfg, page_size=16, device="cuda")
    state = init_weights_(model, torch.Generator(device="cuda").manual_seed(0)).state_dict()
    econf = RaggedInferenceEngineConfig(kv=PagedKVConfig(num_pages=128, page_size=16, max_pages_per_seq=16),
                                        scheduler=SchedulerConfig(token_budget=256, max_seqs=8, prefill_chunk=32,
                                                                  decode_bucket=4),
                                        kv_dtype=dtype, greedy=greedy, decode_steps_per_dispatch=4,
                                        spec=SpecConfig(max_draft=4) if greedy else None)
    return build_engine(cfg, state, econf, device="cuda")


def _key_batches(eng, rng):
    """One real packed batch per step-set key: 8 sequences in decode (three
    of them in the bucket of 4 for the b4 keys) and 8 new prompts whose
    first chunk fills the chunk keys."""
    vocab = eng.cfg.vocab_size
    eng.put(list(range(8)), [rng.integers(0, vocab, int(n)).tolist() for n in rng.integers(20, 90, 8)],
            max_new_tokens=64)
    while not all(s.in_decode for s in eng.state.seqs.values()):
        eng.step()
    eng.put(list(range(100, 108)), [rng.integers(0, vocab, 70).tolist() for _ in range(8)], max_new_tokens=8)
    decode = [eng.state.seqs[u] for u in range(8)]
    fresh = [eng.state.seqs[u] for u in range(100, 108)]
    batches = {}
    for key in eng.step_shape_set():
        b = key[1] if isinstance(key[0], str) else key[0]
        rows = decode[:b - 1 if b < 8 else b]
        if key[0] == "multi":
            for s in rows:
                eng.kv.ensure_capacity(s, key[2])
            rb = eng.state.pack([(s, 1) for s in rows], 1, pad_to=b)
            arrays = (rb.tokens[:, 0], rb.start_pos, rb.block_tables, rb.chunk_lens)
        elif key[0] == "verify":
            for s in rows:
                s.tokens.extend(rng.integers(0, vocab, 4).tolist())
            rb = eng.state.pack([(s, 5) for s in rows], key[2], pad_to=b)
            for s in rows:
                del s.tokens[-4:]
            arrays = (rb.tokens, rb.start_pos, rb.block_tables, rb.chunk_lens)
        else:
            work = [(s, 1) for s in rows] if key[1] == 1 else [(s, key[1]) for s in fresh[:len(rows)]]
            rb = eng.state.pack(work, key[1], pad_to=b)
            arrays = (rb.tokens, rb.start_pos, rb.block_tables, rb.chunk_lens)
        batches[key] = tuple(np.ascontiguousarray(a) for a in arrays)
    return batches


def _counters(eng) -> tuple:
    return (eng.forward_calls, ) + tuple(getattr(fn, name) for fn, name in KERNEL_COUNTERS)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_graph_replay_equals_eager_forward(dtype):
    """Key by key, one replay of the key's graph and its step run eagerly
    on the same packed batch give the same tokens and leave the same KV
    arena, bit for bit; each replay adds its capture's counter deltas."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    eng = _card_engine(dtype)
    res = eng.warm_all()
    assert res["compiled"] == len(res["keys"]) and res["fallback"] == 0
    batches = _key_batches(eng, np.random.default_rng(0))
    for key, arrays in batches.items():
        prog = eng._step_fns[key]
        fn = eng._step_fn(key)[0]
        before = [t.clone() for t in eng.cache]
        eager = fn(*(torch.from_numpy(a).cuda() for a in arrays))
        eager_arena = [t.clone() for t in eng.cache]
        for t, s in zip(eng.cache, before):
            t.copy_(s)
        counts = _counters(eng)
        graph = prog.run(arrays)
        torch.cuda.synchronize()
        after = _counters(eng)
        assert tuple(a - c for a, c in zip(after, counts)) == prog.counts.deltas
        layers = eng.cfg.num_hidden_layers
        assert prog.counts.deltas[1] == layers * prog.counts.deltas[0] > 0, key
        assert torch.equal(eager, graph), key
        assert all(torch.equal(a, b) for a, b in zip(eager_arena, eng.cache)), key
        assert graph.data_ptr() != prog.output.data_ptr()


@pytest.mark.cuda
def test_categorical_replays_draw_fresh_numbers():
    """Sampling under a graph: the engine's generator is registered with
    each graph, so two replays of one key on one batch draw different
    tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    eng = _card_engine(torch.float32, greedy=False)
    eng.warm_all()
    batches = _key_batches(eng, np.random.default_rng(1))
    key = ("multi", 8, 4)
    draws = [eng._step_fns[key].run(batches[key]).cpu() for _ in range(2)]
    assert not torch.equal(draws[0], draws[1])


@pytest.mark.cuda
def test_pipelined_serving_on_graphs_equals_serial():
    """The pipelined tick dispatches step g+1 while step g is in flight,
    often on the same graph: its input copy and replay queue behind step
    g's on the stream, and step g's tokens are a copy the replay cannot
    overwrite.  Its streams equal the serial tick's, speculation on."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from deepspeed_tpu_torch.serving import ServingConfig, ServingEngine, VirtualClock
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(2)
    pattern = rng.integers(0, 256, 12).tolist()
    mix = [dict(prompt=rng.integers(0, 256, int(n)).tolist(), max_new_tokens=24, arrival_ts=0.0)
           for n in rng.integers(10, 60, 6)] + [dict(prompt=pattern * 4, max_new_tokens=24, arrival_ts=0.0)]
    streams = []
    for async_dispatch in (False, True):
        eng = _card_engine(torch.float32)
        serve = ServingEngine(eng, clock=VirtualClock(), config=ServingConfig(async_dispatch=async_dispatch))
        reqs = serve.run([dict(m) for m in mix])
        assert all(r.state.name == "DONE" for r in reqs)
        assert eng.spec_stats.rounds > 0
        streams.append([list(r.tokens) for r in reqs])
    assert streams[0] == streams[1]
