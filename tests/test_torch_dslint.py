"""The port passes the repo's lint checkers that apply to it: crash
transparency, the event registry, atomic writes, KV lifetimes, state
machines and fault sites (``scripts/dslint.py``).  The ``determinism``
checker is left out: its clock allowlist names the JAX package's paths."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CHECKERS = "crash-transparency,event-registry,atomic-write,kv-lifetime,state-machine,fault-sites"


def test_port_is_lint_clean():
    out = subprocess.run([sys.executable, "scripts/dslint.py", "--checkers", CHECKERS, "deepspeed_tpu_torch"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert " 0 finding(s)" in out.stdout, out.stdout
