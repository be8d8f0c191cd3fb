"""Pluggable checkpoint engines (port of
``deepspeed_tpu/runtime/checkpoint_engine.py``; ref:
``runtime/checkpoint_engine/{checkpoint_engine.py, torch_checkpoint_engine.py,
nebula_checkpoint_engine.py}``).

The state tree is a nest of dicts and lists of tensors and Python scalars,
written with ``torch.save`` as one file, ``<path>/train_state.pt``, and read
with ``torch.load(..., weights_only=True)``.  Tensors keep their dtype (bf16
included).  The port writes no orbax: ``CheckpointEngine`` is the
synchronous engine in place of ``OrbaxCheckpointEngine``.

* ``CheckpointEngine`` — ``save`` writes the file (temp + fsync + rename,
  so a crash leaves no half file under the final name) before it returns.
* ``AsyncCheckpointEngine`` — the Nebula-style engine: ``save`` copies every
  tensor to host memory **before it returns**, then a background writer
  thread serialises the copy; ``commit()`` waits until every pending write
  is durable (and re-raises a writer's error).  The copy is what makes the
  save safe against the next step: the port's optimizers update the master
  and the moments in place, so a writer reading the live tensors would
  record a state that never existed.

The fault sites are JAX's: ``ckpt.state_save`` is polled inside the retried
save, ``ckpt.state_restore`` inside the retried load.
"""

import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, List, Optional

import torch

from ..resilience import fault_injection as fi
from ..resilience.retry import RetryPolicy, retry_call
from ..utils.logging import log_dist

# transient-I/O absorption for the state writes (NFS hiccups, EIO);
# InjectedCrash — simulated process death — is NOT an OSError and passes
# straight through (resilience/retry.py)
_IO_RETRY = RetryPolicy(max_attempts=3, base_delay_s=0.05, max_delay_s=1.0,
                        budget_s=5.0)

#: the one file of a state tree inside its ``<tag>/state`` directory
STATE_FILE = "train_state.pt"


def to_host(tree: Any) -> Any:
    """A copy of ``tree`` with every tensor copied into host memory (a new
    tensor even for one already on the CPU)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def _write(state_dict, path: str) -> None:
    """``torch.save`` into ``<path>/train_state.pt`` through a temp file,
    fsynced and renamed (the directory fsynced after)."""
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, STATE_FILE)
    tmp = f"{final}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            torch.save(state_dict, f)
            f.flush()
            os.fsync(f.fileno())
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    os.replace(tmp, final)
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointEngine:
    """Synchronous save/load (ref: torch_checkpoint_engine.py)."""

    def __init__(self, config_params=None):
        self.config = config_params

    def save(self, state_dict, path: str):

        def _save():
            fi.check("ckpt.state_save")
            _write(state_dict, path)

        retry_call(_save, _IO_RETRY, site="ckpt.state_save")
        return path

    def load(self, path: str, map_location=None):

        def _load():
            fi.check("ckpt.state_restore")
            return torch.load(os.path.join(path, STATE_FILE), map_location=map_location, weights_only=True)

        return retry_call(_load, _IO_RETRY, site="ckpt.state_restore")

    def commit(self, tag):
        return True


class AsyncCheckpointEngine(CheckpointEngine):
    """Background save (ref: nebula_checkpoint_engine.py — Nebula's
    async/tiered persistence; ``commit()`` == Nebula's commit barrier)."""

    def __init__(self, config_params=None):
        super().__init__(config_params)
        self._writer = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-writer")
        self._pending: List[Future] = []
        self._lock = threading.Lock()

    def save(self, state_dict, path: str):

        def _issue():
            fi.check("ckpt.state_save")
            host = to_host(state_dict)   # the state at the call, before the next step mutates it
            with self._lock:
                self._pending.append(self._writer.submit(_write, host, path))

        retry_call(_issue, _IO_RETRY, site="ckpt.state_save")
        return path  # returns once the host copy is taken; the write streams in the background

    def load(self, path: str, map_location=None):
        self.commit("load")
        return super().load(path, map_location=map_location)

    def commit(self, tag):
        with self._lock:
            pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()   # re-raises a failed write
        if pending:
            log_dist(f"async checkpoint {tag} committed", ranks=[0])
        return True


_ASYNC_SINGLETON: Optional[AsyncCheckpointEngine] = None


def make_checkpoint_engine(name: Optional[str] = None, config_params=None) -> CheckpointEngine:
    """'orbax'/'torch' → sync; 'async'/'nebula' → async.  The async engine is
    a process-wide singleton: successive saves serialise through its one
    writer thread, and ``wait_for_pending_saves`` fences them all."""
    global _ASYNC_SINGLETON
    name = (name or "torch").lower()
    if name in ("async", "nebula"):
        if _ASYNC_SINGLETON is None:
            _ASYNC_SINGLETON = AsyncCheckpointEngine(config_params)
        return _ASYNC_SINGLETON
    return CheckpointEngine(config_params)


def wait_for_pending_saves():
    """Barrier for any in-flight async save (call before restoring or at
    process exit — the Nebula commit fence)."""
    if _ASYNC_SINGLETON is not None:
        _ASYNC_SINGLETON.commit("pending")
