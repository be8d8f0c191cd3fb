"""Import hygiene of the PyTorch port: ``deepspeed_tpu_torch`` and
``chip_smoke.py`` load neither JAX nor flax nor pydantic (absent where the
card is) nor any module of the JAX package ``deepspeed_tpu`` (whose
``__init__`` imports JAX)."""

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
    "deepspeed_tpu_torch.ops.op_builder",
    "deepspeed_tpu_torch.inference.v2",
    "deepspeed_tpu_torch.inference.v2.ragged",
    "deepspeed_tpu_torch.inference.v2.scheduler",
    "deepspeed_tpu_torch.inference.v2.engine_v2",
]

_PROBE = """
import importlib, json, sys
for name in ("jax", "jaxlib", "flax", "pydantic"):
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
    assert not [m for m in loaded if m.split(".")[0] in ("jax", "jaxlib", "flax", "triton", "pydantic")]


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
            assert root not in ("jax", "jaxlib", "flax", "pydantic", "deepspeed_tpu"), \
                f"{f.relative_to(REPO)} imports {mod}"
