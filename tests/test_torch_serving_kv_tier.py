"""The port's tiered paged KV (``deepspeed_tpu_torch/serving/kvtier``: host
tier, park/resume, demotion-first preemption, warm-on-host prefixes,
watermarks) against the JAX package, scenario by scenario.

The scenarios of ``tests/unit/inference/test_kv_tier.py`` run over both
engines on the same weights (``tests/torch_serving_backends.py``): park and
resume equal to the never-parked golden (prefix cache on and off), a
prefetched promotion hidden under later steps, an unhinted resume that
stalls, KV-pressure preemption that demotes and promotes back, the tier
against evict-and-recompute on the clock, a prefix evicted to the host and
promoted back, the host tier's capacity, the device and host watermarks,
and a seeded audit of random park/resume/preempt interleavings, and park and
resume under speculative decoding.  Each run makes the JAX test's
assertions; tokens, states, serving and tier stats, the clock and page
accounting must be equal across the two.  The fleet directory's host tier
(``test_kv_tier.py:303``) runs in ``tests/test_torch_serving_fleet_directory.py``.
"""

import numpy as np
import pytest
from torch_serving_backends import PAGE, assert_clean, make_backends, serve_view


@pytest.fixture(scope="module")
def backends():
    return make_backends(max_pos=128)


def _decode_until(serve, be, req, min_tokens=2, max_ticks=200):
    for _ in range(max_ticks):
        if req.state is be.RequestState.DECODE and len(req.tokens) >= min_tokens:
            return
        serve.tick()
    raise AssertionError(f"uid={req.uid} never reached DECODE with {min_tokens} tokens")


def _tier_view(serve, tier, reqs):
    view = serve_view(serve, reqs)
    view["tier"] = dict(tier.stats)
    view["host_pages"] = tier.host.pages_used
    view["hidden_frac"] = tier.hidden_frac
    assert tier.host.pages_used == sum(tier.host._lru.values()) <= tier.host.capacity_pages
    assert_clean(serve.engine)
    return view


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(1, 100, n)] for n in lens]


def _park_resume(be, prefix_cache):
    p1, p2 = _prompts(0, (9, 5))
    golden = be.generate([p1, p2], 10)
    serve, tier = be.serve(tier=True, enable_prefix_cache=prefix_cache)
    r1 = serve.submit(p1, max_new_tokens=10)
    r2 = serve.submit(p2, max_new_tokens=10)
    _decode_until(serve, be, r1)
    assert serve.park(r1.uid)
    assert serve.load_stats()["parked"] == 1 and r1.uid not in serve.engine.state.seqs
    for _ in range(3):
        serve.tick()
    assert serve.resume(r1.uid)
    serve.drain()
    assert [list(r1.tokens), list(r2.tokens)] == golden
    assert be.RequestState.PARKED in [s for s, _ in r1.history]
    assert serve.stats.parks == serve.stats.resumes == 1
    assert tier.stats["demotions"] == tier.stats["promotions"] == 1
    assert serve.stats.kv_imports >= 1 and serve.stats.kv_import_fallbacks == 0
    return _tier_view(serve, tier, [r1, r2])


def _park_resume_spec(be):
    """``test_kv_tier.py:114``: with speculation on, the resumed stream
    still equals the never-parked golden (the verify loop replays from the
    imported KV exactly)."""
    spec = be.v2.SpecConfig(max_draft=4)
    (p1, ) = _prompts(3, (9, ))
    golden = be.generate([p1], 10, spec=spec)
    serve, tier = be.serve(tier=True, spec=spec)
    r1 = serve.submit(p1, max_new_tokens=10)
    _decode_until(serve, be, r1)
    assert serve.park(r1.uid)
    serve.tick()
    assert serve.resume(r1.uid)
    serve.drain()
    assert r1.state is be.RequestState.DONE and [list(r1.tokens)] == golden
    assert tier.stats["promotions"] == 1
    view = _tier_view(serve, tier, [r1])
    view["spec_stats"] = vars(serve.engine.spec_stats)
    return view


def _prefetch_hides_transfer(be):
    p1, p2 = _prompts(1, (9, 9))
    golden = be.generate([p1, p2], 12)
    serve, tier = be.serve(tier_config=be.kvtier.TierConfig(h2d_page_s=0.002))
    r1 = serve.submit(p1, max_new_tokens=12)
    r2 = serve.submit(p2, max_new_tokens=12)
    _decode_until(serve, be, r1)
    assert serve.park(r1.uid) and serve.prefetch_resume(r1.uid)
    for _ in range(8):
        serve.tick()
    assert serve.resume(r1.uid)
    serve.drain()
    assert [list(r1.tokens), list(r2.tokens)] == golden
    assert tier.hidden_frac > 0.5 and r1.promote_windows
    return _tier_view(serve, tier, [r1, r2])


def _unhinted_resume_stalls(be):
    (p1, ) = _prompts(2, (9, ))
    golden = be.generate([p1], 8)
    serve, tier = be.serve(tier_config=be.kvtier.TierConfig(h2d_page_s=0.01))
    r1 = serve.submit(p1, max_new_tokens=8)
    _decode_until(serve, be, r1)
    assert serve.park(r1.uid)
    t0 = serve.clock.now()
    assert serve.resume(r1.uid)
    serve.tick()
    assert serve.clock.now() - t0 >= 0.01
    serve.drain()
    assert [list(r1.tokens)] == golden and tier.hidden_frac < 1.0
    return _tier_view(serve, tier, [r1])


def _pressure_demotes_and_promotes(be):
    p1, p2 = _prompts(0, (9, 9))
    golden = be.generate([p1, p2], 20)
    serve, tier = be.serve(tier=True, num_pages=8)   # 7 pages; each ends at 4
    r1 = serve.submit(p1, max_new_tokens=20)
    r2 = serve.submit(p2, max_new_tokens=20)
    serve.drain()
    assert serve.stats.preemptions >= 1 and tier.stats["demotions"] >= 1 and serve.stats.kv_imports >= 1
    assert [list(r1.tokens), list(r2.tokens)] == golden
    return _tier_view(serve, tier, [r1, r2])


def _tier_cheaper_than_recompute(be):
    p1, p2 = _prompts(0, (9, 9))
    out = {}
    for with_tier in (True, False):
        serve, tier = be.serve(tier=with_tier, num_pages=8)
        reqs = [serve.submit(p, max_new_tokens=20) for p in (p1, p2)]
        serve.drain()
        out[with_tier] = (serve.clock.now(), serve.stats.kv_imports, [list(r.tokens) for r in reqs])
    assert out[True][2] == out[False][2]
    assert out[True][1] >= 1 and out[False][1] == 0 and out[True][0] < out[False][0]
    return out


def _prefix_to_host_and_back(be):
    prefix = list(range(1, 2 * PAGE + 1))
    prompts = [prefix + [40], prefix + [41]]
    golden = be.generate(prompts, 4)
    serve, tier = be.serve(tier=True)
    r1 = serve.submit(prompts[0], max_new_tokens=4)
    serve.drain()
    pc = serve.engine.kv.prefix_cache
    assert pc.cached_pages >= 2
    pc.evict(serve.engine.kv.num_pages)
    assert pc.cached_pages == 0 and tier.stats["prefix_demotions"] >= 2
    depth_before = tier.host_prefix_depth(prompts[1])
    assert depth_before >= 2
    r2 = serve.submit(prompts[1], max_new_tokens=4)
    serve.drain()
    assert [list(r1.tokens), list(r2.tokens)] == golden
    assert tier.stats["prefix_promotions"] >= 2 and tier.host_prefix_depth(prompts[1]) == 0
    view = _tier_view(serve, tier, [r1, r2])
    view["depth_before"] = depth_before
    return view


def _host_snapshot(be, tokens, n_pages):
    s = be.kvtransfer.KVSnapshot(tokens=list(tokens), seen_tokens=len(tokens), page_size=PAGE,
                                 block_shape=(2, PAGE, 2, 2, 4), dtype="float32", source="test")
    s.add_chunk(np.zeros((2, n_pages, PAGE, 2, 2, 4), np.float32))
    s.complete = True
    return s


def _host_capacity(be):
    tier = be.kvtier.HostKVTier(capacity_pages=4)
    assert tier.put_seq(1, _host_snapshot(be, [1] * 8, 2)) and tier.put_seq(2, _host_snapshot(be, [2] * 8, 2))
    assert tier.pages_used == 4
    assert not tier.put_seq(3, _host_snapshot(be, [3] * 48, 6))
    assert tier.stats["rejected_oversize"] == 1
    assert tier.put_seq(4, _host_snapshot(be, [4] * 8, 2))
    assert tier.pages_used == 4 and tier.peek_seq(1) is None and tier.peek_seq(2) is not None
    assert tier.take_seq(2).n_pages == 2 and tier.pages_used == 2
    return {"stats": dict(tier.stats), "used": tier.pages_used}


def _device_watermark(be):
    cfg = be.kvtier.TierConfig(host_capacity_pages=64, device_watermark_hi=0.08, device_watermark_lo=0.03)
    serve, tier = be.serve(tier_config=cfg)
    for i in range(3):
        serve.submit(list(range(10 * i + 1, 10 * i + 2 * PAGE + 1)), max_new_tokens=2)
    serve.drain()
    pc, alloc = serve.engine.kv.prefix_cache, serve.engine.kv.allocator
    usable = serve.engine.kv.num_pages - 1
    assert (usable - alloc.free_pages) / usable >= cfg.device_watermark_hi
    out = tier.enforce_watermarks()
    used_after = usable - alloc.free_pages
    assert out["device_demoted"] > 0 and used_after <= int(cfg.device_watermark_lo * usable)
    assert tier.stats["prefix_demotions"] >= out["device_demoted"] == tier.stats["watermark_demotions"]
    assert tier.enforce_watermarks() == {"device_demoted": 0, "host_dropped": 0}
    serve.tick()
    assert tier.stats["watermark_demotions"] == out["device_demoted"] and pc.cached_pages == used_after
    return {"out": out, "used_after": used_after, "tier": dict(tier.stats)}


def _host_watermark(be):
    cfg = be.kvtier.TierConfig(host_capacity_pages=8, host_watermark_hi=0.7, host_watermark_lo=0.3)
    serve, tier = be.serve(tier_config=cfg)
    for uid in (1, 2, 3):
        assert tier.host.put_seq(uid, _host_snapshot(be, [uid] * (2 * PAGE), 2))
    assert tier.host.pages_used == 6
    out = tier.enforce_watermarks()
    assert out["host_dropped"] == 4 and tier.host.peek_seq(1) is None and tier.host.peek_seq(2) is None
    assert tier.host.peek_seq(3) is not None and tier.host.pages_used == 2
    assert tier.enforce_watermarks() == {"device_demoted": 0, "host_dropped": 0}
    return {"out": out, "tier": dict(tier.stats), "used": tier.host.pages_used}


def _property_audit(be, seed=0):
    rng = np.random.default_rng(seed)
    prompts = [[int(x) for x in rng.integers(1, 100, int(rng.integers(5, 12)))] for _ in range(8)]
    golden = be.generate(prompts, 10)
    serve, tier = be.serve(num_pages=32, max_seqs=4,
                           tier_config=be.kvtier.TierConfig(host_capacity_pages=12, h2d_page_s=0.001))
    reqs, pending = [], list(enumerate(prompts))
    for _ in range(120):
        op = rng.choice(["tick", "tick", "admit", "park", "resume", "prefetch", "idle"])
        if op == "admit" and pending:
            i, p = pending.pop(0)
            deadline = serve.clock.now() + 2.0 if i in (2, 5) else None
            reqs.append(serve.submit(list(p), max_new_tokens=10, deadline=deadline))
        elif op == "park":
            decoding = [u for u, r in serve._active.items() if r.state is be.RequestState.DECODE]
            if decoding:
                serve.park(int(rng.choice(decoding)))
        elif op in ("resume", "prefetch"):
            parked = sorted(serve._parked)
            if parked:
                (serve.resume if op == "resume" else serve.prefetch_resume)(int(rng.choice(parked)))
        elif op == "idle":
            serve.clock.wait_until(serve.clock.now() + 0.3)
        else:
            serve.tick()
        assert tier.host.pages_used <= tier.host.capacity_pages
    for _, p in pending:
        reqs.append(serve.submit(list(p), max_new_tokens=10))
    for uid in sorted(serve._parked):
        serve.resume(uid)
    serve.drain()
    while serve._parked:
        serve.resume(sorted(serve._parked)[0])
        serve.drain()
    assert len(reqs) == 8
    for req, gold in zip(reqs, golden):
        assert len([s for s, _ in req.history if s.terminal]) == 1
        if req.state is be.RequestState.DONE:
            assert list(req.tokens) == gold
        else:
            assert req.state is be.RequestState.TIMED_OUT and list(req.tokens) == gold[:len(req.tokens)]
    return _tier_view(serve, tier, reqs)


SCENARIOS = {
    "park_resume_prefix_cache": lambda be: _park_resume(be, True),
    "park_resume_no_prefix_cache": lambda be: _park_resume(be, False),
    "park_resume_spec": _park_resume_spec,
    "prefetch_hides_transfer": _prefetch_hides_transfer,
    "unhinted_resume_stalls": _unhinted_resume_stalls,
    "pressure_demotes_and_promotes": _pressure_demotes_and_promotes,
    "tier_cheaper_than_recompute": _tier_cheaper_than_recompute,
    "prefix_to_host_and_back": _prefix_to_host_and_back,
    "host_capacity": _host_capacity,
    "device_watermark": _device_watermark,
    "host_watermark": _host_watermark,
    "property_audit": _property_audit,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_tier_scenario_matches_jax(backends, name):
    want = SCENARIOS[name](backends["jax"])
    got = SCENARIOS[name](backends["port"])
    assert got == want
