"""Grouped host-streamed optimizer states (ZeRO-Infinity's CPU tier; port
of ``deepspeed_tpu/runtime/swap_tensor/host_streamed_optimizer.py``; ref:
``deepspeed/runtime/zero/stage_1_and_2.py`` CPU offload).

The float32 master and the Adam moments live in host memory (one
``HostArena``, page-locked on CUDA), partitioned into byte-balanced
contiguous groups of parameter leaves.  The update touches them a group at
a time through a double-buffered staging arena on the device, never holding
the whole state beside the model.  Per group:

  upload(g)   host -> device copy of its master and moments into a staging
              slot, on the upload stream;
  compute(g)  Adam over the slot on the compute stream (after the upload's
              event), the new compute-dtype parameters written into the
              engine's parameters in place;
  download(g) device -> host copy of the updated state on the download
              stream (after the compute's event).

At most ``max_staged`` (default 2) slots are live: upload(g+1) is issued
before compute(g), so it rides under compute(g); download(g) drains under
compute(g+1); the host fences one group behind the front (on compute(g-1)'s
event before leaving iteration g), which bounds the slots and timestamps
each group's completion.  A slot is reused (the JAX version donates it): its
next upload waits for its last download's event, and a group's upload waits
for that group's previous download, so the host copy it reads is the last
one written.  The engine calls ``prefetch(0)``/``prefetch(1)`` right after it
dispatches the forward and backward, so the first uploads run under the
backward.

``instrumentation`` (``overlap_instrumentation.py``) records timestamped
events every step; ``step(..., serialize=True)`` runs a fenced probe sweep
(per-group upload/compute/download seconds) and ``overlap_report()``
combines them into the overlap fraction and the transfer/compute bound.

On the CPU (the tests) host and device are one memory: the copies are plain
copies, the streams the default one, and the code path is the same.
Selected by ``offload_optimizer: {device: cpu, pipeline_read (or
pipeline_write): true}`` on one data-parallel rank with an Adam-family
optimizer and static unity scaling (``buffer_count`` groups); otherwise the
engine warns and takes the host-optimizer tier, as JAX does.
"""

import contextlib
import os
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ...ops.adam import adam_update_
from ...utils.logging import log_dist
from ..zero.offload import HostArena
from .overlap_instrumentation import OverlapInstrumentation, now


def byte_balanced_groups(numels: Sequence[int], n_groups: int) -> List[List[int]]:
    """Contiguous leaf groups of about equal float32 bytes (JAX's partition):
    a group closes once it reaches its share, the last takes the rest."""
    sizes = [int(n) * 4 for n in numels]
    target = max(1, sum(sizes) // max(1, n_groups))
    groups: List[List[int]] = []
    cur, acc = [], 0
    for i, s in enumerate(sizes):
        cur.append(i)
        acc += s
        if acc >= target and len(groups) < n_groups - 1:
            groups.append(cur)
            cur, acc = [], 0
    if cur:
        groups.append(cur)
    return groups


class _Streams:
    """The upload and download streams on CUDA; on the CPU none (every
    copy is synchronous on the one memory)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device
        self.upload = torch.cuda.Stream(device) if self.cuda else None
        self.download = torch.cuda.Stream(device) if self.cuda else None

    def on(self, stream):
        return torch.cuda.stream(stream) if self.cuda else contextlib.nullcontext()

    def event(self, stream=None):
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record(stream if stream is not None else torch.cuda.current_stream(self.device))
        return ev

    def record(self, t: torch.Tensor, stream) -> None:
        """``t`` (allocated on the compute stream) is used on ``stream``: the
        caching allocator must not hand its memory out before that work ends."""
        if self.cuda:
            t.record_stream(stream)

    def wait(self, stream, ev) -> None:
        if ev is not None:
            (stream if stream is not None else torch.cuda.current_stream(self.device)).wait_event(ev)

    @staticmethod
    def sync(ev) -> None:
        if ev is not None:
            ev.synchronize()


class HostStreamedOptimizer:
    """The float32 master and Adam moments in host memory, updated by a
    double-buffered upload/compute/download pipeline of per-group updates
    (see the module docstring).  ``params`` are the engine's compute-dtype
    parameters (updated in place); ``hyper`` is ``ops.adam.adam_hyper``'s."""

    def __init__(self, hyper: dict, params: Sequence[torch.Tensor], n_groups: int = 8,
                 compute_dtype: torch.dtype = torch.bfloat16, max_staged: int = 2):
        self.hyper = hyper
        self.params = list(params)
        self.compute_dtype = compute_dtype
        self.device = self.params[0].device
        self.streams = _Streams(self.device)
        #: host and device are distinct memories (CUDA), not the CPU's one
        self.host_tier_distinct = self.streams.cuda
        self.events = deque(maxlen=512)
        self.instrumentation = OverlapInstrumentation()
        self.max_staged = max(1, int(max_staged))
        self.groups = byte_balanced_groups([p.numel() for p in self.params], n_groups)
        self.n_groups = len(self.groups)

        numel = sum(p.numel() for p in self.params)
        self.arena = HostArena(3 * numel, torch.float32, pin=self.streams.cuda)
        self._master: List[List[torch.Tensor]] = []
        self._mu: List[List[torch.Tensor]] = []
        self._nu: List[List[torch.Tensor]] = []
        with torch.no_grad():
            for idxs in self.groups:
                self._master.append([self.arena.take(self.params[i].shape).copy_(self.params[i]) for i in idxs])
                self._mu.append([self.arena.take(self.params[i].shape).zero_() for i in idxs])
                self._nu.append([self.arena.take(self.params[i].shape).zero_() for i in idxs])
        # the staging arena on the device: max_staged slots of the largest group
        biggest = max(sum(self.params[i].numel() for i in idxs) for idxs in self.groups)
        self._slots = [torch.empty(3 * biggest, dtype=torch.float32, device=self.device)
                       for _ in range(self.max_staged)]
        self._slot_free_ev = [None] * self.max_staged      # the slot's last download
        self._free_slots = list(range(self.max_staged))
        self._staged: Dict[int, tuple] = {}                # group -> (slot, upload event)
        self._downloaded: Dict[int, object] = {}           # group -> its last download's event
        self._compute_ev: Dict[int, object] = {}
        gb = numel * 12 / 1e9
        log_dist(f"HostStreamedOptimizer: {len(self.params)} leaves in {self.n_groups} groups, {gb:.2f} GB float32 "
                 f"state in host memory, {3 * biggest * 4 / 1e9:.2f} GB device staging per slot "
                 f"(x{self.max_staged})", ranks=[0])

    # ------------------------------------------------------------- pipeline

    def _slot_views(self, slot: int, g: int):
        flat, off = self._slots[slot], 0
        out = []
        for _ in range(3):
            views = []
            for i in self.groups[g]:
                n = self.params[i].numel()
                views.append(flat[off:off + n].view(self.params[i].shape))
                off += n
            out.append(views)
        return out

    def prefetch(self, g: int) -> bool:
        """Issue group ``g``'s upload into a free staging slot.  Bounded: it
        refuses while ``max_staged`` slots are live, and is a no-op for a
        group already staged."""
        if not (0 <= g < self.n_groups) or g in self._staged or not self._free_slots:
            return False
        slot = self._free_slots.pop(0)
        self.events.append(("upload_issue", g))
        self.instrumentation.record("upload_issue", g)
        st = self.streams
        with st.on(st.upload):
            st.wait(st.upload, self._slot_free_ev[slot])      # the slot's last download has read it
            st.wait(st.upload, self._downloaded.get(g))       # this group's host copy is the newest
            st.record(self._slots[slot], st.upload)
            for dst, src in zip(self._slot_views(slot, g), (self._master[g], self._mu[g], self._nu[g])):
                for d, s in zip(dst, src):
                    d.copy_(s, non_blocking=True)
            self._staged[g] = (slot, st.event(st.upload))
        return True

    def _take_staged(self, g: int):
        """Consume group ``g``'s staging slot for its update.  Taking a slot
        twice raises (its buffers are being reused)."""
        staged = self._staged.pop(g, None)
        if staged is None:
            raise RuntimeError(f"HostStreamedOptimizer: staging slot for group {g} was never uploaded or was "
                               "already consumed — a second take would read a slot being reused")
        return staged

    def _compute(self, g: int, slot: int, upload_ev, grads, count, scale) -> None:
        st = self.streams
        st.wait(None, upload_ev)
        self.events.append(("compute_issue", g))
        self.instrumentation.record("compute_issue", g)
        master, mu, nu = self._slot_views(slot, g)
        g32 = torch._foreach_mul([grads[i].float() for i in self.groups[g]], scale)
        adam_update_(master, g32, mu, nu, count + 1, self.hyper)
        with torch.no_grad():
            for i, m in zip(self.groups[g], master):
                self.params[i].copy_(m)
        self._compute_ev[g] = st.event()

    def _download(self, g: int, slot: int) -> None:
        st = self.streams
        self.events.append(("download_issue", g))
        self.instrumentation.record("download_issue", g)
        with st.on(st.download):
            st.wait(st.download, self._compute_ev.get(g))
            st.record(self._slots[slot], st.download)
            for src, dst in zip(self._slot_views(slot, g), (self._master[g], self._mu[g], self._nu[g])):
                for s, d in zip(src, dst):
                    d.copy_(s, non_blocking=True)
            ev = st.event(st.download)
        self._downloaded[g] = ev
        self._slot_free_ev[slot] = ev
        self._free_slots.append(slot)

    def _fence_compute(self, g: int) -> float:
        self.streams.sync(self._compute_ev.get(g))
        self.events.append(("update_done", g))
        return self.instrumentation.record("compute_done", g)

    def wait_downloads(self) -> None:
        for ev in self._downloaded.values():
            self.streams.sync(ev)

    def pending_writes(self) -> int:
        return 0   # host tensors: durable once their download lands

    def step(self, grads: Sequence[torch.Tensor], count: int, scale: torch.Tensor, serialize: bool = False,
             flush: bool = False) -> List[torch.Tensor]:
        """One update sweep over the groups: Adam at 1-based step ``count +
        1`` on ``grads`` (the engine's, in the parameters' order) times
        ``scale`` (a 0-d float32 tensor: 1/gas and the clip).  The
        parameters are updated in place and returned.

        Pipelined by default: the last group's compute and every download
        are left in flight (they drain under the next forward);
        ``flush=True`` fences them and records the pipelined wall time.
        ``serialize=True`` is the instrumentation probe: a fence after every
        phase (same updates, same order)."""
        if serialize:
            return self._step_serialized(grads, count, scale)
        t_entry = now()
        if self.streams.cuda:   # the gradients: the backward is on the compute stream
            torch.cuda.current_stream(self.device).synchronize()
        t0 = now()
        bwd_wait_s = t0 - t_entry
        prefetch_wait_s = None
        self.prefetch(0)
        if 0 in self._staged:
            tw = now()
            self.streams.sync(self._staged[0][1])
            prefetch_wait_s = now() - tw
        compute_done_ts: List[float] = []
        prev = None
        for g in range(self.n_groups):
            self.prefetch(g + 1)
            slot, up_ev = self._take_staged(g)
            self._compute(g, slot, up_ev, grads, count, scale)
            self._download(g, slot)
            self.prefetch(g + 1)    # a refused prefetch (max_staged 1) gets its slot now
            if prev is not None:
                compute_done_ts.append(self._fence_compute(prev))
            prev = g
        if flush and prev is not None:
            compute_done_ts.append(self._fence_compute(prev))
            self.wait_downloads()
            self.instrumentation.set_step(now() - t0, bwd_wait_s=bwd_wait_s, prefetch_wait_s=prefetch_wait_s,
                                          compute_done_ts=compute_done_ts)
        return self.params

    def _step_serialized(self, grads, count, scale) -> List[torch.Tensor]:
        if self.streams.cuda:
            torch.cuda.current_stream(self.device).synchronize()
        # slots staged by a backward-phase prefetch would blur the upload
        # attribution: drop them (they are uploaded again, fenced)
        for g, (slot, ev) in list(self._staged.items()):
            self.streams.sync(ev)
            self._free_slots.append(slot)
        self._staged.clear()
        self.wait_downloads()
        t_sweep0 = now()
        per_group = []
        for g in range(self.n_groups):
            t0 = now()
            self.prefetch(g)
            slot, up_ev = self._take_staged(g)
            self.streams.sync(up_ev)
            t1 = self.instrumentation.record("upload_done", g)
            self._compute(g, slot, None, grads, count, scale)
            t2 = self._fence_compute(g)
            self._download(g, slot)
            self.streams.sync(self._downloaded[g])
            t3 = self.instrumentation.record("download_done", g)
            per_group.append({"upload_s": t1 - t0, "compute_s": t2 - t1, "download_s": t3 - t2})
        self.instrumentation.set_probe(per_group, wall_s=now() - t_sweep0)
        return self.params

    def overlap_report(self):
        """The measured-overlap report (``overlap_instrumentation.report``);
        None until a ``serialize=True`` probe sweep has run."""
        rep = self.instrumentation.report()
        if rep is not None:
            rep["host_tier_distinct"] = self.host_tier_distinct
            rep["max_staged"] = self.max_staged
        return rep

    # ------------------------------------------------------------ state

    def host_bytes(self) -> int:
        return self.arena.nbytes

    def staging_bytes(self) -> int:
        return sum(s.numel() * 4 for s in self._slots)

    def _settle(self) -> None:
        """No update in flight: staged slots dropped, downloads landed."""
        for g, (slot, ev) in list(self._staged.items()):
            self.streams.sync(ev)
            self._free_slots.append(slot)
        self._staged.clear()
        self.wait_downloads()

    def leaves(self, which: str) -> List[torch.Tensor]:
        """The host tensors of ``which`` (``master``, ``mu`` or ``nu``) in
        the parameters' order."""
        self._settle()
        store = {"master": self._master, "mu": self._mu, "nu": self._nu}[which]
        out: List[Optional[torch.Tensor]] = [None] * len(self.params)
        for g, idxs in enumerate(self.groups):
            for i, t in zip(idxs, store[g]):
                out[i] = t
        return out

    @torch.no_grad()
    def load_leaves(self, master: Sequence[torch.Tensor], mu: Optional[Sequence[torch.Tensor]] = None,
                    nu: Optional[Sequence[torch.Tensor]] = None) -> None:
        """Write whole state (the parameters' order); moments left out are zeroed."""
        for name, values in (("master", master), ("mu", mu), ("nu", nu)):
            for t, v in zip(self.leaves(name), values if values is not None else [None] * len(self.params)):
                t.copy_(v.reshape(t.shape)) if v is not None else t.zero_()

    def master_matches_params(self, params: Sequence[torch.Tensor], compute_dtype) -> bool:
        """One leaf per group, compared in the compute dtype (the parameters
        were cast from exactly this master on a true resume)."""
        master = self.leaves("master")
        for idxs in self.groups:
            i = idxs[0]
            host = master[i].to(compute_dtype)
            live = params[i].detach().to("cpu")
            if host.shape != live.shape or not torch.equal(host, live):
                return False
        return True

    def resync_master_from_params(self, params: Sequence[torch.Tensor]) -> None:
        self.load_leaves([p.detach().float().cpu() for p in params])

    def state_dict_host(self):
        self._settle()
        return [{"master": [t.clone() for t in self._master[g]], "mu": [t.clone() for t in self._mu[g]],
                 "nu": [t.clone() for t in self._nu[g]]} for g in range(self.n_groups)]

    # host state lives in process memory: the engine persists it into the
    # checkpoint's tag directory through the extra-state callback, inside
    # the durability fence (covered by the tag's crc32 manifest, written
    # before ``latest`` is published)
    def save_state(self, directory: str) -> None:
        from ...resilience.atomic_io import atomic_savez
        self._settle()
        for g in range(self.n_groups):
            arrs = {}
            for name, store in (("master", self._master), ("mu", self._mu), ("nu", self._nu)):
                for i, t in enumerate(store[g]):
                    arrs[f"{name}_{i}"] = t.numpy()
            atomic_savez(os.path.join(directory, f"host_opt_group{g}.npz"), arrs, site="host_opt.save")

    def load_state(self, directory: str) -> bool:
        """Restore what ``save_state`` wrote; False when the files are
        absent, torn or corrupt (the tag's checksum manifest, or the archive
        read), or shaped for another partition.  The live state is replaced
        only once every group has been read."""
        import zipfile

        from ...resilience import events
        from ...resilience import fault_injection as fi
        from ...resilience.atomic_io import verify_manifest
        from ...resilience.retry import RetryPolicy, retry_call
        from ...utils.logging import logger
        retry_call(lambda: fi.check("host_opt.load"),
                   RetryPolicy(max_attempts=3, base_delay_s=0.01, max_delay_s=0.25, budget_s=2.0),
                   site="host_opt.load")
        if not all(os.path.exists(os.path.join(directory, f"host_opt_group{g}.npz")) for g in range(self.n_groups)):
            return False
        errors = verify_manifest(directory, match=lambda rel: rel.startswith("host_opt_group"))
        if errors:
            logger.warning(f"host-streamed offload: rejecting host_opt_group*.npz state at {directory} — checksum "
                           f"manifest failed: {errors[0]}")
            events.emit("resilience/host_opt_reject")
            return False
        loads = []
        for g in range(self.n_groups):
            path = os.path.join(directory, f"host_opt_group{g}.npz")
            try:
                with np.load(path) as z:
                    grp = {name: [z[f"{name}_{i}"] for i in range(len(self.groups[g]))]
                           for name in ("master", "mu", "nu")}
            except (OSError, ValueError, KeyError, zipfile.BadZipFile, EOFError) as e:
                logger.warning(f"host-streamed offload: rejecting truncated/corrupt {path}: {e}")
                events.emit("resilience/host_opt_reject")
                return False
            if any(tuple(a.shape) != tuple(t.shape) for a, t in zip(grp["master"], self._master[g])):
                return False
            loads.append(grp)
        self._settle()
        with torch.no_grad():
            for g, grp in enumerate(loads):
                for name, store in (("master", self._master), ("mu", self._mu), ("nu", self._nu)):
                    for t, a in zip(store[g], grp[name]):
                        t.copy_(torch.from_numpy(a))
        return True

    def teardown(self) -> None:
        self._settle()
        self._master = self._mu = self._nu = []
        self._slots = []
        self.arena.release()
