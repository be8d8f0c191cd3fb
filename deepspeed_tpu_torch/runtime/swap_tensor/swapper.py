"""Tensor swapping to NVMe/disk through the port's async-IO engine (port of
``deepspeed_tpu/runtime/swap_tensor/swapper.py``; ref:
``deepspeed/runtime/swap_tensor/`` — ``partitioned_optimizer_swapper.py``,
``async_swapper.py``, ``aio_config.py``).

A tree of tensors (nested dicts and lists, ``torch.utils._pytree``) is
flattened and each leaf streamed to its own region of one file per key
through ``ops/aio`` (the C++ thread pool).  ``swap_out_async`` and
``swap_in_async`` return handles, so the caller overlaps the swap traffic of
sub-group *i±1* with the update of sub-group *i*.  A leaf that lives on a
CUDA device is copied to host memory first; read buffers are pinned when
``pin_memory`` is set (the upload that follows is then an async copy).

The ``swap.write``/``swap.read`` fault probes sit at each issue, under JAX's
retry policy: a transient failure at issue is retried with backoff; the
blocking ``swap_out``/``swap_in`` retry the whole issue-and-wait cycle under
one policy (the inner issue retry is off, so a chaos plan's hit counts stay
predictable).
"""

import dataclasses
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ...resilience import fault_injection as fi
from ...resilience.retry import RetryPolicy, retry_call

# swap I/O sits on the training critical path: retries are short and few —
# a persistently failing disk should surface fast, not stall the step
_SWAP_RETRY = RetryPolicy(max_attempts=3, base_delay_s=0.01, max_delay_s=0.25, budget_s=2.0)

#: every leaf's region starts at a multiple of this (``O_DIRECT``'s alignment)
ALIGN = 4096


@dataclasses.dataclass(frozen=True)
class AioSwapConfig:
    """ref: runtime/swap_tensor/aio_config.py (block_size/queue_depth/
    thread_count; single_submit/overlap_events are implicit in the thread
    pool)."""
    block_size: int = 1 << 20
    queue_depth: int = 32
    thread_count: int = 4
    use_o_direct: bool = False


def _host_leaf(x) -> torch.Tensor:
    """A leaf as a contiguous host tensor (numpy arrays are taken as they are)."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x))
    return x.detach().to("cpu").contiguous()


class SwapInHandle:
    """A pending swap-in; ``wait()`` returns the rebuilt tree (host tensors)."""

    def __init__(self, aio, buffers: List[torch.Tensor], spec, shapes):
        self._aio = aio
        self._buffers = buffers
        self._spec = spec
        self._shapes = shapes
        self._result = None

    def wait(self):
        if self._result is None:
            self._aio.wait()
            leaves = [b.view(s) for b, s in zip(self._buffers, self._shapes)]
            self._result = pytree.tree_unflatten(leaves, self._spec)
            self._buffers = []
        return self._result


class SwapOutHandle:

    def __init__(self, aio):
        self._aio = aio
        self._done = False

    def wait(self):
        if not self._done:
            self._aio.wait()
            self._done = True


class TensorSwapper:
    """Tree <-> disk: one file per key, its leaves at 4096-aligned offsets;
    the manifest (in memory) holds their shapes, dtypes and offsets."""

    def __init__(self, swap_dir, config: AioSwapConfig = AioSwapConfig(), pin_memory: bool = False):
        from ...ops.aio import AsyncIOHandle
        self.dir = Path(swap_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.config = config
        self.pin_memory = pin_memory
        self._aio_factory = lambda: AsyncIOHandle(config.block_size, config.queue_depth, config.thread_count,
                                                  config.use_o_direct)
        self._manifests: Dict[str, dict] = {}

    def _path(self, key: str) -> Path:
        return self.dir / f"{key}.swp"

    @staticmethod
    def _align(n: int) -> int:
        return -(-n // ALIGN) * ALIGN

    def manifest_for(self, key: str, spec, shapes, dtypes) -> None:
        """Register ``key``'s layout without writing (a resume from files a
        previous run wrote with the same layout)."""
        offsets, off = [], 0
        for s, d in zip(shapes, dtypes):
            offsets.append(off)
            off += self._align(max(1, int(np.prod(s))) * torch.empty((), dtype=d).element_size())
        self._manifests[key] = {"spec": spec, "shapes": [tuple(s) for s in shapes], "dtypes": list(dtypes),
                                "offsets": offsets}

    def swap_out_async(self, key: str, tree, _retry: bool = True) -> SwapOutHandle:
        leaves, spec = pytree.tree_flatten(tree)
        host = [_host_leaf(x) for x in leaves]
        self.manifest_for(key, spec, [tuple(t.shape) for t in host], [t.dtype for t in host])
        offsets = self._manifests[key]["offsets"]
        path = self._path(key)

        def _issue_writes():
            # issue-time transients retried with backoff (the re-issue
            # rewrites every leaf region, so a half-issued first attempt is
            # harmless); failures surfacing in the handle's wait() propagate
            fi.check("swap.write")
            aio = self._aio_factory()
            for t, o in zip(host, offsets):
                aio.async_pwrite(t.reshape(-1), path, o)
            return aio

        aio = retry_call(_issue_writes, _SWAP_RETRY, site="swap.write") if _retry else _issue_writes()
        return SwapOutHandle(aio)

    def swap_out(self, key: str, tree) -> None:
        retry_call(lambda: self.swap_out_async(key, tree, _retry=False).wait(), _SWAP_RETRY, site="swap.write")

    def swap_in_async(self, key: str, _retry: bool = True) -> SwapInHandle:
        m = self._manifests[key]
        path = self._path(key)

        def _issue_reads():
            # fresh buffers per attempt, so a torn first attempt cannot leak
            # into the returned handle
            fi.check("swap.read")
            aio = self._aio_factory()
            buffers = []
            for shape, dtype, off in zip(m["shapes"], m["dtypes"], m["offsets"]):
                buf = torch.empty(max(1, int(np.prod(shape))) if shape else 1, dtype=dtype,
                                  pin_memory=self.pin_memory)
                aio.async_pread(buf, path, off)
                buffers.append(buf)
            return aio, buffers

        aio, buffers = retry_call(_issue_reads, _SWAP_RETRY, site="swap.read") if _retry else _issue_reads()
        return SwapInHandle(aio, buffers, m["spec"], m["shapes"])

    def swap_in(self, key: str):
        return retry_call(lambda: self.swap_in_async(key, _retry=False).wait(), _SWAP_RETRY, site="swap.read")

    def release(self, key: str) -> None:
        self._manifests.pop(key, None)
        p = self._path(key)
        if p.exists():
            p.unlink()

    def swapped_keys(self):
        return list(self._manifests)

    def teardown(self):
        for k in list(self._manifests):
            self.release(k)


class PartitionedOptimizerSwapper:
    """Optimizer-state sub-group swapping (ref: partitioned_optimizer_swapper
    .py + pipelined_optimizer_swapper.py).  The caller steps the sub-groups
    in order; ``prefetch_group`` overlaps the next group's read with the
    current group's update, and a group's write lands before its next read."""

    def __init__(self, swap_dir, config: AioSwapConfig = AioSwapConfig(), pin_memory: bool = False):
        self.swapper = TensorSwapper(swap_dir, config, pin_memory=pin_memory)
        self._pending_in: Dict[int, SwapInHandle] = {}
        self._pending_out: Dict[int, SwapOutHandle] = {}

    def swap_out_group(self, group_id: int, state_tree, blocking: bool = False):
        h = self.swapper.swap_out_async(f"optgroup_{group_id}", state_tree)
        if blocking:
            h.wait()
        else:
            self._pending_out[group_id] = h

    def prefetch_group(self, group_id: int):
        if group_id not in self._pending_in:
            if group_id in self._pending_out:   # the write must land before the read
                self._pending_out.pop(group_id).wait()
            self._pending_in[group_id] = self.swapper.swap_in_async(f"optgroup_{group_id}")

    def swap_in_group(self, group_id: int):
        self.prefetch_group(group_id)
        return self._pending_in.pop(group_id).wait()

    def flush_writes(self):
        for h in self._pending_out.values():
            h.wait()
        self._pending_out.clear()

    def drop_reads(self) -> None:
        """Wait out and drop any prefetched reads (their data would predate
        a rewrite)."""
        for h in self._pending_in.values():
            h.wait()
        self._pending_in.clear()
