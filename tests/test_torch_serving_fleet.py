"""The port's serving fleet (``deepspeed_tpu_torch/serving/fleet``: the
router, the replica pool, the routing policies, health tracking and the
simulator) against the JAX package, scenario by scenario.

Each scenario is a test function of ``tests/unit/inference/
test_fleet_router.py`` run unchanged over both packages
(``torch_serving_backends.unit_scenario``): the module's own tiny float32
Llama (vocab 128, hidden 64, 2 layers, page 8) on the JAX fixture's weights,
its own helpers and its own assertions.  Round-robin dispatch, prefix
affinity and its saturation fallback, a kill mid-decode failing over with
outputs identical to ``generate`` (prefix cache on and off, and under
speculative decoding), the simulator's bit-reproducibility, the sole
replica's kill and recovery, drain and rolling restart, the health tracker,
fatal-error classification and ``resume_tokens`` validation.  Beyond the
JAX test's assertions, every request's tokens, state and history,
``router.summary()``, the health history, page accounting, the metrics
snapshot and the clock must be equal across the two packages.
"""

import pytest
from torch_serving_backends import unit_scenario

ROUTER = "inference/test_fleet_router.py"
CASES = [
    ("round_robin_distributes_and_matches_generate", {}),
    ("prefix_affinity_routes_to_warm_replica", {}),
    ("prefix_affinity_falls_back_when_warm_target_saturated", {}),
    ("kill_mid_decode_failover_outputs_identical", {"prefix_cache": True}),
    ("kill_mid_decode_failover_outputs_identical", {"prefix_cache": False}),
    ("kill_mid_decode_failover_with_speculation_identical", {"prefix_cache": True}),
    ("fleet_sim_bit_reproducible", {}),
    ("kill_sole_replica_stalls_then_recover_completes", {}),
    ("drain_blocks_new_dispatch_and_rolling_restart", {}),
    ("health_tracker_transitions_and_thresholds", {}),
    ("health_fatal_classification", {}),
    ("resume_tokens_validation", {}),
]


def _id(case):
    name, params = case
    return name + "".join(f"[{k}={v}]" for k, v in params.items())


@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_fleet_router_scenario_matches_jax(case, tmp_path):
    name, params = case
    want = unit_scenario(ROUTER, f"test_{name}", "jax", tmp_path, **params)
    got = unit_scenario(ROUTER, f"test_{name}", "port", tmp_path, **params)
    assert got == want


def test_killed_and_restarted_engines_are_released(tmp_path):
    """Nothing of the fleet keeps a dropped engine reachable, and the pool
    returns it at once (on the card its KV arena, step graphs and graph
    pool): right after a kill, and after a rolling restart, the replaced
    engine is gone — with the prefix directory's listeners, per-replica
    anatomy, metrics, a tracer and the host KV tier all attached."""
    import weakref

    from torch_serving_backends import make_backends
    be = make_backends()["port"]
    fleet, telemetry = be.fleet, be.telemetry
    made = []

    def factory():
        eng = be.engine()
        made.append(weakref.ref(eng))
        return eng

    clock = be.serving.VirtualClock()
    directory = fleet.PrefixDirectory(page_size=8)
    pool = fleet.ReplicaPool(factory, 3, clock=clock, prefix_directory=directory, anatomy=True,
                             metrics=telemetry.MetricsRegistry(), tracer=telemetry.Tracer(clock=clock), kv_tier=True)
    router = fleet.Router(pool, fleet.PrefixDirectoryPolicy(directory))
    released = {}
    real_kill = pool.kill

    def kill(rid, reason="killed"):
        ref = made[rid]
        out = real_kill(rid, reason)
        released["kill"] = ref() is None
        return out
    pool.kill = kill
    prefix = list(range(1, 17))
    reqs = fleet.FleetSimulator(router).run(
        [dict(prompt=prefix + [40 + i], max_new_tokens=8, arrival_ts=0.3 * i) for i in range(8)],
        schedule=[(0.6, "kill", 0), (2.5, "recover", 0), (3.0, "drain", 1), (3.5, "restart", 1)])
    assert all(r.state is fleet.FleetState.DONE for r in reqs)
    assert released["kill"]
    assert made[1]() is None                       # replaced by the rolling restart
    assert len(made) == 5 and all(made[i]() is not None for i in (2, 3, 4))
