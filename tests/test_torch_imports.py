"""Import hygiene of the PyTorch port: ``deepspeed_tpu_torch`` and
``chip_smoke.py`` load neither JAX nor flax nor pydantic nor transformers nor
safetensors (absent where the card is) nor any module of the JAX package
``deepspeed_tpu`` (whose ``__init__`` imports JAX)."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SLICE_MODULES = [
    "deepspeed_tpu_torch",
    "deepspeed_tpu_torch.utils.logging",
    "deepspeed_tpu_torch.accelerator",
    "deepspeed_tpu_torch.models.llama",
    "deepspeed_tpu_torch.models.llama_cache",
    "deepspeed_tpu_torch.models.convert",
    "deepspeed_tpu_torch.models.falcon",
    "deepspeed_tpu_torch.models.opt",
    "deepspeed_tpu_torch.models.phi",
    "deepspeed_tpu_torch.models.cache_zoo",
    "deepspeed_tpu_torch.models.mixtral",
    "deepspeed_tpu_torch.models.mixtral_cache",
    "deepspeed_tpu_torch.models.qwen2_moe",
    "deepspeed_tpu_torch.moe",
    "deepspeed_tpu_torch.moe.sharded_moe",
    "deepspeed_tpu_torch.moe.experts",
    "deepspeed_tpu_torch.moe.mappings",
    "deepspeed_tpu_torch.moe.layer",
    "deepspeed_tpu_torch.ops.paged_attention",
    "deepspeed_tpu_torch.ops.attention",
    "deepspeed_tpu_torch.ops.flash_attention",
    "deepspeed_tpu_torch.ops.adam",
    "deepspeed_tpu_torch.ops.optimizer",
    "deepspeed_tpu_torch.ops.sparse_attention",
    "deepspeed_tpu_torch.ops.sparse_attention.sparsity_config",
    "deepspeed_tpu_torch.ops.sparse_attention.sparse_attention_utils",
    "deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention",
    "deepspeed_tpu_torch.ops.sparse_attention.kernel",
    "deepspeed_tpu_torch.runtime",
    "deepspeed_tpu_torch.runtime.constants",
    "deepspeed_tpu_torch.runtime.config",
    "deepspeed_tpu_torch.runtime.lr_schedules",
    "deepspeed_tpu_torch.runtime.fp16.loss_scaler",
    "deepspeed_tpu_torch.runtime.engine",
    "deepspeed_tpu_torch.runtime.zero",
    "deepspeed_tpu_torch.runtime.zero.partition",
    "deepspeed_tpu_torch.runtime.zero.partitioned",
    "deepspeed_tpu_torch.runtime.zero.partition_parameters",
    "deepspeed_tpu_torch.runtime.zero.mics",
    "deepspeed_tpu_torch.runtime.zero.tiling",
    "deepspeed_tpu_torch.runtime.sparse_tensor",
    "deepspeed_tpu_torch.module_inject.tp_rules",
    "deepspeed_tpu_torch.utils.groups",
    "deepspeed_tpu_torch.utils.tensor_fragment",
    "deepspeed_tpu_torch.axes",
    "deepspeed_tpu_torch.ops.op_builder",
    "deepspeed_tpu_torch.inference.v2",
    "deepspeed_tpu_torch.inference.v2.ragged",
    "deepspeed_tpu_torch.inference.v2.scheduler",
    "deepspeed_tpu_torch.inference.v2.engine_v2",
    "deepspeed_tpu_torch.inference.v2.checkpoint_io",
    "deepspeed_tpu_torch.inference.v2.engine_factory",
    "deepspeed_tpu_torch.inference.v2.model_implementations",
    "deepspeed_tpu_torch.comm",
    "deepspeed_tpu_torch.comm.comm",
    "deepspeed_tpu_torch.comm.mesh",
    "deepspeed_tpu_torch.ops.quantizer",
    "deepspeed_tpu_torch.ops.quant_kernels",
    "deepspeed_tpu_torch.runtime.comm",
    "deepspeed_tpu_torch.runtime.comm.compressed",
    "deepspeed_tpu_torch.resilience",
    "deepspeed_tpu_torch.resilience.events",
    "deepspeed_tpu_torch.resilience.fault_injection",
    "deepspeed_tpu_torch.resilience.retry",
    "deepspeed_tpu_torch.resilience.atomic_io",
    "deepspeed_tpu_torch.resilience.watchdog",
    "deepspeed_tpu_torch.telemetry",
    "deepspeed_tpu_torch.telemetry.trace",
    "deepspeed_tpu_torch.telemetry.step_anatomy",
    "deepspeed_tpu_torch.telemetry.spans",
    "deepspeed_tpu_torch.telemetry.metrics",
    "deepspeed_tpu_torch.telemetry.slo",
    "deepspeed_tpu_torch.telemetry.export",
    "deepspeed_tpu_torch.telemetry.flight_recorder",
    "deepspeed_tpu_torch.serving",
    "deepspeed_tpu_torch.serving.request",
    "deepspeed_tpu_torch.serving.clock",
    "deepspeed_tpu_torch.serving.metrics",
    "deepspeed_tpu_torch.serving.admission",
    "deepspeed_tpu_torch.serving.kv_pressure",
    "deepspeed_tpu_torch.serving.engine",
    "deepspeed_tpu_torch.serving.kvtransfer",
    "deepspeed_tpu_torch.serving.kvtransfer.snapshot",
    "deepspeed_tpu_torch.serving.kvtier",
    "deepspeed_tpu_torch.serving.kvtier.tier",
    "deepspeed_tpu_torch.serving.sessions",
    "deepspeed_tpu_torch.serving.sessions.session",
    "deepspeed_tpu_torch.serving.sessions.manager",
    "deepspeed_tpu_torch.serving.fleet",
    "deepspeed_tpu_torch.serving.fleet.tenancy",
    "deepspeed_tpu_torch.serving.fleet.health",
    "deepspeed_tpu_torch.serving.fleet.transport",
    "deepspeed_tpu_torch.serving.fleet.pool",
    "deepspeed_tpu_torch.serving.fleet.policies",
    "deepspeed_tpu_torch.serving.fleet.prefix_directory",
    "deepspeed_tpu_torch.serving.fleet.router",
    "deepspeed_tpu_torch.serving.fleet.autoscale",
    "deepspeed_tpu_torch.serving.fleet.sim",
    "deepspeed_tpu_torch.telemetry.event_registry",
    "deepspeed_tpu_torch.utils.timer",
    "deepspeed_tpu_torch.utils.zero_to_fp32",
    "deepspeed_tpu_torch.monitor",
    "deepspeed_tpu_torch.monitor.monitor",
    "deepspeed_tpu_torch.runtime.dataloader",
    "deepspeed_tpu_torch.runtime.progressive_layer_drop",
    "deepspeed_tpu_torch.runtime.bf16_optimizer",
    "deepspeed_tpu_torch.runtime.fp16.fused_optimizer",
    "deepspeed_tpu_torch.runtime.checkpoint_engine",
    "deepspeed_tpu_torch.checkpoint",
    "deepspeed_tpu_torch.checkpoint.engine",
    "deepspeed_tpu_torch.checkpoint.zero_to_fp32",
    "deepspeed_tpu_torch.ops.lamb",
    "deepspeed_tpu_torch.ops.lion",
    "deepspeed_tpu_torch.ops.adagrad",
    "deepspeed_tpu_torch.models.gpt_family",
    "deepspeed_tpu_torch.models.gpt2",
    "deepspeed_tpu_torch.models.bert",
    "deepspeed_tpu_torch.models.clip",
    "deepspeed_tpu_torch.ops.transformer",
    "deepspeed_tpu_torch.inference.engine",
    "deepspeed_tpu_torch.inference.quantization",
    "deepspeed_tpu_torch.module_inject",
    "deepspeed_tpu_torch.module_inject.replace_module",
    "deepspeed_tpu_torch.profiling",
    "deepspeed_tpu_torch.profiling.config",
    "deepspeed_tpu_torch.profiling.flops_profiler",
    "deepspeed_tpu_torch.profiling.flops_profiler.profiler",
    "deepspeed_tpu_torch.runtime.activation_checkpointing",
    "deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing",
]

_PROBE = """
import importlib, json, sys
for name in ("jax", "jaxlib", "flax", "pydantic", "transformers", "safetensors"):
    sys.modules[name] = None          # any import of them raises ImportError
for m in {modules!r}:
    importlib.import_module(m)
print(json.dumps(sorted(k for k, v in sys.modules.items() if v is not None)))
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", _PROBE.format(modules=SLICE_MODULES)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    loaded = json.loads(res.stdout.strip().splitlines()[-1])
    assert not [m for m in loaded if m == "deepspeed_tpu" or m.startswith("deepspeed_tpu.")]
    assert not [m for m in loaded
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "triton", "pydantic", "transformers", "safetensors")]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_and_chip_smoke_import_no_jax_package():
    files = [REPO / "chip_smoke.py", *sorted((REPO / "deepspeed_tpu_torch").rglob("*.py"))]
    for f in files:
        for mod in _imported_modules(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "pydantic", "transformers", "safetensors", "deepspeed_tpu"), \
                f"{f.relative_to(REPO)} imports {mod}"
