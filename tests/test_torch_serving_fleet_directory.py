"""The port's fleet prefix directory and fleet KV moves
(``deepspeed_tpu_torch/serving/fleet/prefix_directory.py``, the router's
prefix import, disaggregated migration and failover KV reuse) against the
JAX package, scenario by scenario.

Each scenario is a test function of ``tests/unit/inference/
test_prefix_directory.py``, ``test_kv_migration.py`` or ``test_kv_tier.py``
run unchanged over both packages (``torch_serving_backends.unit_scenario``:
the module's own tiny float32 Llama, helpers and assertions on the JAX
fixture's weights).  Directory bookkeeping and its host tier (which must
give the same depths and stats in both packages: the digests are
``iter_prefix_chain_hashes``, which the port computes identically), the
zero-probe dispatch, the directory-vs-probe oracle, a saturated warm
replica's prefix imported onto a cold one, the brownout rung pausing
imports, engine-level prefix export/import, the diurnal arrival generator,
a disaggregated fleet, the failover reuse of exported KV and role
factories across a recovery.  Tokens, request states and histories,
``router.summary()``, the health history, page accounting, the metrics
snapshot and the clock must be equal across the two packages.
"""

import pytest
from torch_serving_backends import unit_scenario
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse fixture)

DIRECTORY = "inference/test_prefix_directory.py"
MIGRATION = "inference/test_kv_migration.py"
TIER = "inference/test_kv_tier.py"
CASES = [
    (DIRECTORY, "publish_extend_retract_ordering"),
    (DIRECTORY, "routes_to_warm_replica_with_zero_probe_calls"),
    (DIRECTORY, "directory_agrees_with_probe_oracle"),
    (DIRECTORY, "saturated_warm_target_imports_prefix_onto_cold_replica"),
    (DIRECTORY, "brownout_pauses_prefix_imports"),
    (DIRECTORY, "export_import_prefix_roundtrip_and_dedup"),
    (DIRECTORY, "diurnal_arrivals_deterministic_and_modulated"),
    (TIER, "directory_tiered_depths_and_host_routing"),
    (MIGRATION, "disaggregated_fleet_identical_outputs"),
    (MIGRATION, "failover_reuses_exported_kv_on_target_death"),
    (MIGRATION, "role_factories_survive_recover"),
]


@pytest.mark.parametrize("case", CASES, ids=[f"{path.split('/')[1][5:-3]}:{name}" for path, name in CASES])
def test_fleet_directory_scenario_matches_jax(case, tmp_path):
    path, name = case
    want = unit_scenario(path, f"test_{name}", "jax", tmp_path)
    got = unit_scenario(path, f"test_{name}", "port", tmp_path)
    assert got == want
