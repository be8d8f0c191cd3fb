"""The serving fleet on the card: replicas of one engine factory sharing
one set of weights, a killed replica's memory returned, and a recovered
replica's step graphs — run with ``python -m pytest --noconftest
tests/test_torch_fleet_gpu.py -m cuda -q``; they skip without a GPU.

The model is a 4-layer Llama of hidden 1024 (8/2 heads of 128, vocab 256),
bf16, pages of 16 tokens: small enough to build in a second, wide enough
that K3 runs its tensor-core path.
"""

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference.v2 import PagedKVConfig, RaggedInferenceEngineConfig, SchedulerConfig, build_engine
from deepspeed_tpu_torch.models.llama import PRESETS, init_weights_
from deepspeed_tpu_torch.models.llama_cache import LlamaForCausalLMWithCache

MIB = 1 << 20


def _weights():
    cfg = dataclasses.replace(PRESETS["tiny"], hidden_size=1024, intermediate_size=2048, num_hidden_layers=4,
                              num_attention_heads=8, num_key_value_heads=2, dtype=torch.bfloat16,
                              param_dtype=torch.bfloat16, attention_impl="flash")
    model = LlamaForCausalLMWithCache(cfg, page_size=16, device="cuda")
    return cfg, init_weights_(model, torch.Generator(device="cuda").manual_seed(0)).state_dict()


def _fleet(n, async_dispatch=False):
    """``n`` replicas of one factory over one state dict on a virtual clock;
    the factory keeps a weak reference to every engine it builds."""
    from deepspeed_tpu_torch.serving import ServingConfig, VirtualClock
    from deepspeed_tpu_torch.serving.fleet import ReplicaPool, RoundRobinPolicy, Router
    cfg, state = _weights()
    econf = RaggedInferenceEngineConfig(kv=PagedKVConfig(num_pages=256, page_size=16, max_pages_per_seq=32),
                                        scheduler=SchedulerConfig(token_budget=256, max_seqs=8, prefill_chunk=64,
                                                                  decode_bucket=8),
                                        kv_dtype=torch.bfloat16, decode_steps_per_dispatch=8)
    made = []

    def factory():
        eng = build_engine(cfg, state, econf, device="cuda")
        made.append(weakref.ref(eng))
        return eng

    pool = ReplicaPool(factory, n, clock=VirtualClock(), serving_config=ServingConfig(async_dispatch=async_dispatch))
    return Router(pool, RoundRobinPolicy()), pool, state, made


def _submit(router, n, seed):
    rng = np.random.default_rng(seed)
    return [router.submit(rng.integers(0, 256, int(k)).tolist(), max_new_tokens=32, arrival_ts=0.0)
            for k in rng.integers(20, 120, n)]


def _arena_bytes(eng):
    return sum(t.numel() * t.element_size() for t in eng.cache)


@pytest.mark.cuda
def test_replicas_share_weight_storage():
    """Every replica's parameters are the state dict's tensors: one copy of
    the weights on the card, whatever the replica count."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    _, pool, state, _ = _fleet(3)
    ptrs = {name: t.data_ptr() for name, t in state.items()}
    for rid in pool.rids:
        params = dict(pool.replica(rid).serve.engine.model.named_parameters())
        assert params and {n: p.data_ptr() for n, p in params.items()} == {n: ptrs[n] for n in params}
    caches = [pool.replica(rid).serve.engine.cache[0].data_ptr() for rid in pool.rids]
    assert len(set(caches)) == len(caches)          # each replica its own arena


@pytest.mark.cuda
def test_killed_pipelined_replica_waits_and_frees():
    """A pipelined replica killed with its last step still queued on the
    card (held behind a device-side spin, so the replay cannot have run):
    the kill waits for that step, and the dead engine — KV arena, step
    graphs, graph pool — is collected before ``kill`` returns, its arena
    returned to the allocator.  The survivor's streams are the serial
    fleet's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    router, pool, _, made = _fleet(2, async_dispatch=True)
    for rid in pool.rids:
        pool.replica(rid).serve.engine.warm_all()
    reqs = _submit(router, 8, seed=0)
    router.dispatch_pending()
    while pool.replica(1).serve._inflight is None or not pool.replica(1).serve.engine.state.seqs:
        for rid in pool.rids:
            pool.tick(rid)
        router.poll()
    eng = pool.replica(1).serve.engine

    def spin_then_dispatch(plan=None, real=eng.dispatch_step):
        torch.cuda._sleep(200_000_000)              # ~0.1 s of device time ahead of the step
        return real(plan)
    eng.dispatch_step = spin_then_dispatch
    pool.tick(1)                                    # completes step g, queues step g+1 behind the spin
    del eng.dispatch_step, eng, spin_then_dispatch
    serve = pool.replica(1).serve
    assert serve._inflight is not None and not torch.cuda.current_stream().query()
    arena = _arena_bytes(serve.engine)
    del serve
    before = torch.cuda.memory_allocated()
    victims = router.on_replica_dead(1, reason="test kill")
    assert victims
    assert torch.cuda.current_stream().query()      # the queued step was waited for
    assert made[1]() is None                        # nothing keeps the dead engine reachable
    assert torch.cuda.memory_allocated() <= before - arena + 16 * MIB
    from deepspeed_tpu_torch.serving.fleet import FleetSimulator
    FleetSimulator(router).run([])
    assert all(r.state.name == "DONE" and len(r.tokens) == 32 for r in reqs)


@pytest.mark.cuda
def test_recovered_replica_graphs_replay_equal_to_eager():
    """A replica recovered while its peer has a step queued on the card:
    the fresh engine captures its step set (``warm_all`` in
    ``_warm_replacement``) on its own capture stream, and each of its
    graphs, replayed on a real packed batch, gives the eager step's tokens
    and KV arena bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from test_torch_step_set import _key_batches
    router, pool, _, made = _fleet(2, async_dispatch=True)
    _submit(router, 8, seed=1)
    router.dispatch_pending()
    for _ in range(3):
        for rid in pool.rids:
            pool.tick(rid)
        router.poll()
    router.on_replica_dead(1, reason="test kill")
    pool.tick(0)                                    # the survivor's next step, queued
    torch.cuda._sleep(200_000_000)                  # and ~0.1 s of device time behind it
    assert not torch.cuda.current_stream().query()
    router.recover_replica(1)
    eng = pool.replica(1).serve.engine
    assert len(made) == 3 and made[2]() is eng
    assert set(eng._step_fns) == set(eng.step_shape_set())
    batches = _key_batches(eng, np.random.default_rng(2))
    for key, arrays in batches.items():
        prog, fn = eng._step_fns[key], eng._step_fn(key)[0]
        before = [t.clone() for t in eng.cache]
        eager = fn(*(torch.from_numpy(a).cuda() for a in arrays))
        eager_arena = [t.clone() for t in eng.cache]
        for t, s in zip(eng.cache, before):
            t.copy_(s)
        graph = prog.run(arrays)
        torch.cuda.synchronize()
        assert torch.equal(eager, graph), key
        assert all(torch.equal(a, b) for a, b in zip(eager_arena, eng.cache)), key
    del eng, prog, fn, before, eager_arena
    gc.collect()
