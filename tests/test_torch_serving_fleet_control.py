"""The port's fleet control plane (``deepspeed_tpu_torch/serving/fleet``:
the seeded lossy control transport, leases and fencing, adaptive leases,
the autoscaler, the overload ladder and tenants) against the JAX package,
scenario by scenario.

Each scenario is a test function of ``tests/unit/inference/
test_fleet_transport.py``, ``test_control_loops.py`` or ``test_autoscale.py``
run unchanged over both packages (``torch_serving_backends.unit_scenario``:
the module's own tiny float32 Llama, helpers and assertions on the JAX
fixture's weights).  The pure state machines — the transport's delivery
schedule under loss, duplication and reordering, the lease view and its
fencing epochs, adaptive lease resizing, tenant stride weights and the
overload ladder — must give the same histories, stats and decisions in both
packages; the fleet scenarios the same tokens, request states and
histories, ``router.summary()``, health history, page accounting, metrics
snapshot and clock.  One scenario is this file's own: the ladder's
``no_spec`` rung over speculative engines, which the JAX tests check only
on the controller.
"""

import pytest
from torch_serving_backends import assert_clean, make_backends, plain, unit_scenario
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse fixture)

TRANSPORT = "inference/test_fleet_transport.py"
CONTROL = "inference/test_control_loops.py"
AUTOSCALE = "inference/test_autoscale.py"
CASES = [
    (TRANSPORT, "transport_deterministic_schedule"),
    (TRANSPORT, "lease_view_transitions_and_fencing_epochs"),
    (TRANSPORT, "perfect_transport_matches_direct_fleet"),
    (TRANSPORT, "lossy_transport_still_serves_goldens"),
    (TRANSPORT, "kill_recover_inside_lease_window_generation_fences"),
    (TRANSPORT, "publish_gap_detected_and_resynced"),
    (TRANSPORT, "migration_chunks_ack_retry_idempotent"),
    (CONTROL, "adaptive_lease_widens_clamps_and_tightens"),
    (CONTROL, "adaptive_lease_detects_real_kill_within_band"),
    (AUTOSCALE, "tenant_registry_stride_weights"),
    (AUTOSCALE, "autoscaler_scales_up_then_down"),
    (AUTOSCALE, "scale_down_drains_before_parking"),
    (AUTOSCALE, "overload_ladder_steps_symmetrically"),
    (AUTOSCALE, "brownout_cap_and_shed_at_admission"),
]


@pytest.mark.parametrize("case", CASES, ids=[f"{path.split('/')[1][5:-3]}:{name}" for path, name in CASES])
def test_fleet_control_scenario_matches_jax(case, tmp_path):
    path, name = case
    want = unit_scenario(path, f"test_{name}", "jax", tmp_path)
    got = unit_scenario(path, f"test_{name}", "port", tmp_path)
    assert got == want


PROMPTS = [[5, 9, 2, 7, 1], [3, 3, 8, 1], [2, 4, 6, 8, 10, 12], [13, 1, 1, 2]]


def _no_spec_rung(be):
    """Rung 2 of the overload ladder (``no_spec``) over two speculative
    replicas: dispatches made on the rung opt out of speculation through
    the engine's ``set_spec`` (no verify round runs), those made after the
    ladder steps down speculate again, and every output equals the
    spec-off ``generate`` golden."""
    fleet = be.fleet
    golden = be.generate(PROMPTS, 12)
    out = {}
    for rung in (2, 0):
        pool = fleet.ReplicaPool(lambda: be.engine(spec=be.v2.SpecConfig(max_draft=4)), 2,
                                 clock=be.serving.VirtualClock())
        overload = fleet.OverloadController(fleet.OverloadConfig())
        router = fleet.Router(pool, fleet.make_policy("round_robin"), overload=overload)
        overload.rung = rung
        assert overload.spec_disabled == (rung == 2)
        reqs = fleet.FleetSimulator(router).run(
            [dict(prompt=p, max_new_tokens=12, arrival_ts=0.5 * i) for i, p in enumerate(PROMPTS)])
        assert [r.state for r in reqs] == [fleet.FleetState.DONE] * len(PROMPTS)
        assert [r.tokens for r in reqs] == golden
        proposed = [rep.serve.engine.spec_stats.proposed for rep in pool.replicas.values()]
        assert (sum(proposed) == 0) == (rung == 2), proposed
        for rep in pool.replicas.values():
            assert_clean(rep.serve.engine)
        out[rung] = plain({"summary": router.summary(), "proposed": proposed,
                           "tokens": [r.tokens for r in reqs], "health": pool.health.history})
    return out


def test_no_spec_rung_on_spec_engines_matches_jax():
    backends = make_backends(max_pos=128)
    assert _no_spec_rung(backends["port"]) == _no_spec_rung(backends["jax"])
