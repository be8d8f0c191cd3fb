"""Pipelined NVMe optimizer-state swapping (ZeRO-Infinity's in-step path;
port of ``deepspeed_tpu/runtime/swap_tensor/pipelined_optimizer_swapper.py``;
ref: ``deepspeed/runtime/swap_tensor/pipelined_optimizer_swapper.py``).

The float32 master and the Adam moments live in swap files under
``nvme_path``, one per byte-balanced group of parameter leaves, read and
written through the port's async-IO engine (``ops/aio``, under
``swapper.PartitionedOptimizerSwapper``).  The update is double-buffered:
while group *g* updates on the device, group *g+1*'s read and group *g-1*'s
write are in flight on the aio threads, and the last writes drain while the
next step's forward and backward run.  Per group: the read lands in host
buffers (pinned on CUDA), is copied to the device, Adam updates it there
(the new compute-dtype parameters written into the engine's in place), the
state comes back to host buffers and its write is issued.

The files outlive the process: ``pipelined_meta.json`` (written atomically)
records the partition, and an optimizer built over a model with the same
partition reuses the files (a resume; the checkpoint holds the parameters
and the step).  ``events`` records the issue order (prefetch, update,
write-back) so tests can check the overlap without depending on disk
timing; ``instrumentation`` timestamps every phase, and
``step(serialize=True)`` runs the fenced probe sweep (per-group read,
compute and write seconds), the same surface as ``HostStreamedOptimizer``.
Selected by ``offload_optimizer: {device: nvme, nvme_path: ...}``.
"""

import json
from collections import deque
from typing import List, Optional, Sequence

import torch
from torch.utils import _pytree as pytree

from ...ops.adam import adam_update_
from ...utils.logging import log_dist
from .host_streamed_optimizer import byte_balanced_groups
from .overlap_instrumentation import OverlapInstrumentation, now
from .swapper import AioSwapConfig, PartitionedOptimizerSwapper

_NAMES = ("master", "mu", "nu")


class PipelinedNVMeOptimizer:
    """The float32 master and Adam moments on disk in ``n_groups``
    sub-groups; ``step`` runs the double-buffered update (see the module
    docstring).  ``params`` are the engine's compute-dtype parameters
    (updated in place); ``hyper`` is ``ops.adam.adam_hyper``'s."""

    def __init__(self, hyper: dict, params: Sequence[torch.Tensor], nvme_path: str, n_groups: int = 4,
                 compute_dtype: torch.dtype = torch.bfloat16, aio: AioSwapConfig = AioSwapConfig()):
        self.hyper = hyper
        self.params = list(params)
        self.compute_dtype = compute_dtype
        self.device = self.params[0].device
        self.cuda = self.device.type == "cuda"
        self.swapper = PartitionedOptimizerSwapper(nvme_path, aio, pin_memory=self.cuda)
        # bounded ring: tests read the double-buffer issue order; a long run
        # must not accumulate host memory
        self.events = deque(maxlen=512)
        self.instrumentation = OverlapInstrumentation()
        self.groups = byte_balanced_groups([p.numel() for p in self.params], n_groups)
        self.n_groups = len(self.groups)
        #: bytes read and written by the aio engine since the last reset
        self.bytes_read = self.bytes_written = 0

        shapes = [[list(self.params[i].shape) for i in idxs] for idxs in self.groups]
        meta_path = self.swapper.swapper.dir / "pipelined_meta.json"
        if self._try_resume(meta_path, shapes):
            log_dist(f"PipelinedNVMeOptimizer: resumed {self.n_groups} sub-groups from {nvme_path}", ranks=[0])
            return
        # the float32 master from the parameters and zero moments, written
        # group by group: never resident in full
        for g, idxs in enumerate(self.groups):
            master = [self.params[i].detach().float().cpu() for i in idxs]
            self._swap_out(g, master, [torch.zeros_like(m) for m in master], [torch.zeros_like(m) for m in master],
                           blocking=True)
        from ...resilience.atomic_io import atomic_write_json
        atomic_write_json(str(meta_path), {"groups": shapes})   # a resume never sees half a manifest
        log_dist(f"PipelinedNVMeOptimizer: {len(self.params)} leaves in {self.n_groups} sub-groups on {nvme_path}",
                 ranks=[0])

    def _try_resume(self, meta_path, shapes) -> bool:
        """Rebuild the swap manifests from the persisted partition when the
        files on disk match this model's exactly."""
        if not meta_path.exists():
            return False
        try:
            with open(meta_path) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            return False
        if meta.get("groups") != shapes:
            log_dist(f"PipelinedNVMeOptimizer: swap files at {meta_path.parent} belong to another partition — "
                     "reinitializing", ranks=[0])
            return False
        ts = self.swapper.swapper
        for g, group_shapes in enumerate(shapes):
            key = f"optgroup_{g}"
            if not ts._path(key).exists():
                return False
            n = len(group_shapes)
            _, spec = pytree.tree_flatten({name: [torch.empty(0)] * n for name in _NAMES})
            ts.manifest_for(key, spec, [tuple(s) for s in group_shapes] * 3, [torch.float32] * (3 * n))
        return True

    def _swap_out(self, g: int, master, mu, nu, blocking: bool) -> None:
        self.bytes_written += sum(t.numel() * 4 for t in (*master, *mu, *nu))
        self.swapper.swap_out_group(g, {"master": master, "mu": mu, "nu": nu}, blocking=blocking)

    def _swap_in(self, g: int) -> dict:
        sub = self.swapper.swap_in_group(g)
        self.bytes_read += sum(t.numel() * 4 for name in _NAMES for t in sub[name])
        return sub

    def pending_writes(self) -> int:
        return len(self.swapper._pending_out)

    def prefetch(self, g: int) -> bool:
        """Issue group ``g``'s read on the aio threads (idempotent: the
        swapper tracks pending reads).  The engine calls it right after it
        dispatches the forward and backward, so the first reads overlap the
        backward."""
        if not (0 <= g < self.n_groups) or g in self.swapper._pending_in:
            return False
        self.events.append(("prefetch_issue", g))
        self.instrumentation.record("upload_issue", g)
        self.swapper.prefetch_group(g)
        return True

    def _update(self, g: int, sub: dict, grads, count: int, scale: torch.Tensor):
        """Group ``g``'s state to the device, Adam, the parameters written,
        the state back to host buffers (the device's copy is this tier's
        compute fence)."""
        dev = [[t.to(self.device, non_blocking=True) for t in sub[name]] for name in _NAMES]
        master, mu, nu = dev
        g32 = torch._foreach_mul([grads[i].float() for i in self.groups[g]], scale)
        adam_update_(master, g32, mu, nu, count + 1, self.hyper)
        with torch.no_grad():
            for i, m in zip(self.groups[g], master):
                self.params[i].copy_(m)
        host = [[t.to("cpu") for t in ts] for ts in dev] if self.cuda else [[t.clone() for t in ts] for ts in dev]
        return host

    def step(self, grads: Sequence[torch.Tensor], count: int, scale: torch.Tensor, serialize: bool = False,
             flush: bool = False) -> List[torch.Tensor]:
        """The double-buffered update sweep; the parameters are updated in
        place and returned.  ``serialize=True`` is the probe (a fence after
        every phase, blocking writes); ``flush=True`` drains the last writes
        and records the pipelined wall time."""
        if self.cuda and (serialize or flush):
            torch.cuda.current_stream(self.device).synchronize()
        t0 = now()
        per_group = []
        if not serialize:   # the probe keeps the reads sequential for attribution
            self.prefetch(0)
        for g in range(self.n_groups):
            if not serialize:
                self.prefetch(g + 1)   # the next group's read rides the aio threads under this update
            tg0 = now()
            sub = self._swap_in(g)
            tg1 = self.instrumentation.record("upload_done", g)
            self.instrumentation.record("compute_issue", g)
            host = self._update(g, sub, grads, count, scale)
            tg2 = self.instrumentation.record("compute_done", g)
            self.events.append(("update_done", g))
            # the write drains while group g+1 updates, and the last groups'
            # writes while the next step's forward and backward run
            self._swap_out(g, *host, blocking=serialize)
            self.events.append(("writeback_issue", g))
            tg3 = self.instrumentation.record("download_issue", g)
            if serialize:
                per_group.append({"upload_s": tg1 - tg0, "compute_s": tg2 - tg1, "download_s": tg3 - tg2})
        if serialize:
            self.instrumentation.set_probe(per_group, wall_s=now() - t0)
        elif flush:
            self.swapper.flush_writes()
            done = self.instrumentation.events_of("compute_done")
            self.instrumentation.set_step(now() - t0,
                                          compute_done_ts=[done[g] for g in range(self.n_groups) if g in done])
        return self.params

    def overlap_report(self):
        """The measured-overlap report; None until a probe sweep has run."""
        return self.instrumentation.report()

    # ------------------------------------------------------------ state

    def leaves(self, which: str) -> List[torch.Tensor]:
        """The state ``which`` (``master``, ``mu``, ``nu``) read whole, in
        the parameters' order (host tensors)."""
        self.swapper.flush_writes()
        self.swapper.drop_reads()
        out: List[Optional[torch.Tensor]] = [None] * len(self.params)
        for g, idxs in enumerate(self.groups):
            sub = self.swapper.swap_in_group(g)
            for i, t in zip(idxs, sub[which]):
                out[i] = t
        return out

    def load_leaves(self, master: Sequence[torch.Tensor], mu: Optional[Sequence[torch.Tensor]] = None,
                    nu: Optional[Sequence[torch.Tensor]] = None) -> None:
        """Rewrite the files from whole state (the parameters' order);
        moments left out are zeroed."""
        self.swapper.flush_writes()
        self.swapper.drop_reads()
        for g, idxs in enumerate(self.groups):
            m = [master[i].detach().float().cpu().reshape(self.params[i].shape) for i in idxs]
            a = [mu[i].detach().float().cpu().reshape(self.params[i].shape) for i in idxs] if mu is not None \
                else [torch.zeros_like(x) for x in m]
            b = [nu[i].detach().float().cpu().reshape(self.params[i].shape) for i in idxs] if nu is not None \
                else [torch.zeros_like(x) for x in m]
            self._swap_out(g, m, a, b, blocking=True)

    def resync_master_from_params(self, params: Sequence[torch.Tensor]) -> None:
        """Rewrite the master from the parameters and zero the moments (a
        load whose swap files belong to another training state)."""
        self.load_leaves([p.detach() for p in params])

    def master_matches_params(self, params: Sequence[torch.Tensor], compute_dtype) -> bool:
        """One leaf per group: the disk master cast to the compute dtype
        equals the live parameter (the true-resume case)."""
        self.swapper.flush_writes()
        self.swapper.drop_reads()
        for g, idxs in enumerate(self.groups):
            disk = self.swapper.swap_in_group(g)["master"][0].to(compute_dtype)
            live = params[idxs[0]].detach().to("cpu")
            if disk.shape != live.shape or not torch.equal(disk, live):
                return False
        return True

    def state_dict_host(self):
        """The whole optimizer state on the host (checkpointing)."""
        self.swapper.flush_writes()
        self.swapper.drop_reads()
        return [self.swapper.swap_in_group(g) for g in range(self.n_groups)]

    def teardown(self):
        self.swapper.flush_writes()
        self.swapper.drop_reads()
        self.swapper.swapper.teardown()
