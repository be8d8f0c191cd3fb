"""The port's fleet telemetry and resilience primitives
(``deepspeed_tpu_torch/telemetry/{metrics,slo,export,flight_recorder}.py``,
``resilience/{watchdog,atomic_io}.py``, and the fleet's anatomy and trace)
against the JAX package, scenario by scenario.

Each scenario is a test function of ``tests/unit/telemetry/
test_tracer_metrics.py``, ``test_flight_recorder.py``, ``test_fleet_trace.py``,
``tests/unit/inference/test_fleet_anatomy.py`` or ``tests/unit/resilience/
test_atomic_io_retry_watchdog.py`` run unchanged over both packages
(``torch_serving_backends.unit_scenario``).  Counters, gauges, histograms
and the registry's snapshots, the flight recorder's ring and dumps, SLO burn
alerts, the watchdog, atomic writes, the tenants' KV pages and the pool's
per-replica anatomy, and a client trace across a failover must be equal
across the two packages, span by span.

The replica-side ``ctrl/fence`` instant of ``test_flight_recorder.py:431``
is compared across the two packages here rather than against that test's
list: the JAX test still expects ``["active", "queued"]`` while the JAX
frontend records ``parked`` too (``deepspeed_tpu/serving/engine.py:1163``),
and the port follows the frontend.
"""

import pytest
from torch_serving_backends import plain, span_view, unit_fixture, unit_module, unit_scenario
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse fixture)

METRICS = "telemetry/test_tracer_metrics.py"
RECORDER = "telemetry/test_flight_recorder.py"
TRACE = "telemetry/test_fleet_trace.py"
ANATOMY = "inference/test_fleet_anatomy.py"
WATCHDOG = "resilience/test_atomic_io_retry_watchdog.py"
CASES = [
    (METRICS, "counter_and_gauge"),
    (METRICS, "histogram_quantiles_without_sample_retention"),
    (METRICS, "histogram_edge_cases"),
    (METRICS, "registry_get_or_create_and_kind_collision"),
    (METRICS, "histogram_window_summarizes_only_new_samples"),
    (METRICS, "registry_snapshot_since_counters_deltas_and_new_metrics"),
    (RECORDER, "ring_bound_and_dropped_counts"),
    (RECORDER, "dump_writes_valid_chrome_trace_and_ring_only_mode"),
    (RECORDER, "burn_rate_fires_on_both_windows_and_clears_with_hysteresis"),
    (TRACE, "client_trace_id_survives_failover_and_links_dead_span"),
    (ANATOMY, "tenant_kv_pages_sum_to_arena_pages_in_use"),
    (ANATOMY, "pool_anatomy_per_replica_and_fleet_gauges"),
    (WATCHDOG, "watchdog_passes_through_results_and_errors"),
    (WATCHDOG, "watchdog_classifies_hang_as_device_loss"),
    (WATCHDOG, "atomic_write_publishes_and_leaves_no_debris"),
    (WATCHDOG, "torn_write_preserves_old_content"),
    (WATCHDOG, "manifest_roundtrip_and_corruption_detection"),
]


@pytest.mark.parametrize("case", CASES, ids=[f"{path.split('/')[1][5:-3]}:{name}" for path, name in CASES])
def test_fleet_telemetry_scenario_matches_jax(case, tmp_path):
    path, name = case
    want = unit_scenario(path, f"test_{name}", "jax", tmp_path)
    got = unit_scenario(path, f"test_{name}", "port", tmp_path)
    assert got == want


def _replica_fence(package, tmp_path):
    """``test_recorder_without_tracer_still_records_replica_fence`` over one
    package, returning the fence instants it records (the JAX test's other
    assertions kept)."""
    m = unit_module(RECORDER, package)
    trained_params = unit_fixture(RECORDER, package, "trained_params", tmp_path)
    clock = m.VirtualClock()
    recorder = m.FlightRecorder(clock=clock, max_per_track=64)
    transport = m.ControlTransport(clock, partitions=[m.PartitionWindow("cut", 6.0, 30.0, (("router", 0), ))])
    pool = m.ReplicaPool(m._factory(trained_params), 2, clock=clock, transport=transport)
    router = m.Router(pool, m.make_policy("least_outstanding"), transport=transport, recorder=recorder,
                      lease_config=m.LeaseConfig(suspect_after=2.0, lease=6.0))
    arrivals = [dict(prompt=m.PROMPTS[0], max_new_tokens=16, arrival_ts=0.0),
                dict(prompt=m.PROMPTS[1], max_new_tokens=16, arrival_ts=34.0)]
    reqs = m.FleetSimulator(router).run(arrivals)
    assert all(r.state is m.FleetState.DONE for r in reqs)
    assert router.summary()["control_plane"]["lease_expirations"] == 1
    fences = recorder.track("ctrl/replica0")
    assert [s.name for s in fences] == ["ctrl/fence"], recorder.summary()
    pool._attach_engine(0)
    assert pool.replica(0).serve.recorder is recorder
    out = plain({"fences": [span_view(s) for s in fences], "summary": router.summary(),
                 "recorder": recorder.summary(), "tokens": [r.tokens for r in reqs]})
    del m._RECORDED[:]
    return out


def test_replica_fence_attrs_match_jax(tmp_path):
    want = _replica_fence("jax", tmp_path)
    got = _replica_fence("port", tmp_path)
    assert got == want
    assert sorted(got["fences"][0]["attrs"]) == ["active", "parked", "queued"]
