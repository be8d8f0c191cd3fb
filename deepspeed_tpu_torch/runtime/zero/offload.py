"""Host memory for the offload tiers, and the host-optimizer tier
(ZeRO-Offload's CPU Adam; JAX ``runtime/engine.py`` ``_materialize_state``
:552-559, ``_offload_streamed_update`` :856-899).

``HostArena`` is one flat host tensor that the tiers cut their tensors from.
On CUDA it is page-locked with ``cudaHostRegister`` at its exact size (torch's
pinned caching allocator rounds each block up to a power of two, which would
pin up to twice the state), so the copies between it and the card are
asynchronous DMA.  A failed registration raises: nothing falls back to
pageable memory.  On the CPU host and device are one memory and the arena is
a plain tensor.

``HostOffloadOptimizer`` is ``offload_optimizer: {device: cpu}`` (and the
tier JAX falls back to from the streamed ones): the float32 tensors the
optimizer updates (the master, or in float32 training a host copy of the
parameters) and its moments live in host arenas, and the optimizer, any of
the engine's, steps them on the host CPU.  The engine computes the gradients
and their norm on the device as always; then, chunk by chunk of at most
``CHUNK_BYTES`` (so the host step's temporaries stay bounded), the chunk's
float32 gradients go device -> host into a pinned staging buffer, the
optimizer steps the chunk's tensors, and the new values go host -> device:
cast to the compute dtype on the host first (half the bytes on the bus), or
copied as they are in float32.  Every chunk is the same optimizer step (its
step count is taken once).  Over several data-parallel ranks the tier holds
this rank's slices (``runtime/zero/partitioned.py``), and the engine
refreshes the parameters from them as it does on the device.
"""

import time
from typing import List, Optional, Sequence

import torch

#: the host step's chunk: the bytes of float32 tensors stepped at a time
CHUNK_BYTES = 256 << 20


class HostArena:
    """``numel`` elements of ``dtype`` in one host tensor, page-locked on
    CUDA (``pin``) by one ``cudaHostRegister`` (a copy may not span two
    registrations); its pages are first faulted in by a fill on every
    intra-op thread.  ``take(shape)`` cuts the next view."""

    def __init__(self, numel: int, dtype: torch.dtype, pin: bool):
        self.flat = torch.empty(max(1, numel), dtype=dtype)
        self.nbytes = self.flat.numel() * self.flat.element_size()
        self.pinned = False
        self._off = 0
        if pin:
            self.flat.zero_()
            torch.cuda.check_error(torch.cuda.cudart().cudaHostRegister(self.flat.data_ptr(), self.nbytes, 0))
            self.pinned = True

    def take(self, shape) -> torch.Tensor:
        n = 1
        for d in shape:
            n *= int(d)
        if self._off + n > self.flat.numel():
            raise ValueError(f"host arena of {self.flat.numel()} elements is full")
        view = self.flat[self._off:self._off + n].view(tuple(shape))
        self._off += n
        return view

    def release(self) -> None:
        if self.pinned:
            self.pinned = False
            torch.cuda.check_error(torch.cuda.cudart().cudaHostUnregister(self.flat.data_ptr()))

    def __del__(self):
        try:
            self.release()
        except Exception:   # interpreter shutdown: the runtime may be gone
            pass


def _chunks(tensors: Sequence[torch.Tensor], limit: int) -> List[List[int]]:
    """Consecutive index groups of at most ``limit`` bytes (a larger tensor alone)."""
    out, cur, acc = [], [], 0
    for i, t in enumerate(tensors):
        nb = t.numel() * 4
        if cur and acc + nb > limit:
            out.append(cur)
            cur, acc = [], 0
        cur.append(i)
        acc += nb
    if cur:
        out.append(cur)
    return out


class HostOffloadOptimizer:
    """The host-optimizer tier over copies of the engine's float32
    ``targets`` (see the module docstring).  ``writeback[i]`` is the tensor
    host tensor ``i`` is copied into after the step (the compute-dtype
    parameter, or the float32 parameter or its slice), None where the engine
    refreshes the parameters from the host tensors itself (a partitioned
    master)."""

    def __init__(self, targets: Sequence[torch.Tensor], writeback: Sequence[Optional[torch.Tensor]],
                 device: torch.device):
        self.device = device
        self.pin = device.type == "cuda"
        self.arena = HostArena(sum(t.numel() for t in targets), torch.float32, self.pin)
        with torch.no_grad():
            self.host: List[torch.Tensor] = [self.arena.take(t.shape).copy_(t) for t in targets]
        self.writeback = list(writeback)
        self.chunks = _chunks(self.host, CHUNK_BYTES)
        biggest = max(sum(self.host[i].numel() for i in c) for c in self.chunks)
        #: pinned staging of one chunk: its float32 gradients in, its
        #: compute-dtype (or float32) values out
        self._grad_stage = HostArena(biggest, torch.float32, self.pin)
        out = {w.dtype for w in self.writeback if w is not None}
        if len(out) > 1:
            raise ValueError(f"the host tier writes back one dtype, got {sorted(map(str, out))}")
        self._out_stage = HostArena(biggest, out.pop(), self.pin) if out else None
        self.state_arena: Optional[HostArena] = None
        #: the last step's seconds: gradients device -> host, the host
        #: optimizer, values host -> device
        self.last_split = {"d2h_s": 0.0, "host_opt_s": 0.0, "h2d_s": 0.0}

    def init_optimizer_state(self, optimizer) -> None:
        """The optimizer's state tensors, zeros, cut from one host arena."""
        names = optimizer.STATE_NAMES
        self.state_arena = HostArena(len(names) * sum(t.numel() for t in self.host), torch.float32, self.pin)
        optimizer.init_state(lambda p: self.state_arena.take(p.shape).zero_())

    def host_bytes(self) -> dict:
        """Bytes of host memory by use (pinned on CUDA)."""
        state = self.state_arena.nbytes if self.state_arena is not None else 0
        out = self._out_stage.nbytes if self._out_stage is not None else 0
        return {"targets": self.arena.nbytes, "state": state, "staging": self._grad_stage.nbytes + out}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    @torch.no_grad()
    def step(self, optimizer, grads: Sequence[torch.Tensor], found_inf: Optional[torch.Tensor]) -> None:
        """One optimizer step of the host tensors on the device ``grads``
        (float32, the targets' layout); the new values written back."""
        split = {"d2h_s": 0.0, "host_opt_s": 0.0, "h2d_s": 0.0}
        fi = found_inf.to("cpu") if found_inf is not None else None
        count, device_step = optimizer.step_count, optimizer._device_step
        for idxs in self.chunks:
            t0 = time.perf_counter()
            stage, off = self._grad_stage.flat, 0
            views = []
            for i in idxs:
                n = self.host[i].numel()
                v = stage[off:off + n].view(self.host[i].shape)
                v.copy_(grads[i], non_blocking=True)
                views.append(v)
                off += n
            self._sync()
            t1 = time.perf_counter()
            for i, v in zip(idxs, views):
                self.host[i].grad = v
            optimizer.step_count, optimizer._device_step = count, device_step   # every chunk is one step
            if fi is None:
                optimizer.step()
            else:
                optimizer.step(found_inf=fi)
            for i in idxs:
                self.host[i].grad = None
            t2 = time.perf_counter()
            back = [i for i in idxs if self.writeback[i] is not None]
            if back:
                out = self._out_stage.flat
                off = 0
                for i in back:
                    n = self.host[i].numel()
                    v = out[off:off + n].view(self.host[i].shape)
                    v.copy_(self.host[i])
                    self.writeback[i].copy_(v.view(self.writeback[i].shape), non_blocking=True)
                    off += n
                self._sync()
            t3 = time.perf_counter()
            split["d2h_s"] += t1 - t0
            split["host_opt_s"] += t2 - t1
            split["h2d_s"] += t3 - t2
        self.last_split = split
