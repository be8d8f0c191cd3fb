"""The serving engine's step programs: one per key of
``InferenceEngineV2.step_shape_set`` — the counterpart of the JAX engine's
compiled step programs (``deepspeed_tpu/inference/v2/engine_v2.py:492-646``).

XLA compiles each (batch, chunk) program once and dispatches it as one
executable; on the card that program is a captured CUDA graph
(:class:`GraphStep`): one replay issues every kernel of the step, where the
eager engine issued each of them from Python (a Llama-3-8B decode round is
~700 kernels).  On the CPU (the tests) a program runs its step eagerly
(:class:`EagerStep`).  Both take the step's packed host arrays (the int32
numpy arrays of ``RaggedBatch``) and return its tokens as a fresh tensor.
"""

import contextlib
import time
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from ...ops.flash_attention import flash_dkv_cuda, flash_dq_cuda, flash_fwd_cuda
from ...ops.paged_attention import paged_attention_cuda
from ...ops.quant_kernels import dequantize_int4_cuda, dequantize_int8_cuda, quantize_int4_cuda, quantize_int8_cuda
from ...ops.sparse_attention.kernel import sparse_attn_dkv_cuda, sparse_attn_dq_cuda, sparse_attn_fwd_cuda

#: every launch counter of the port's kernel wrappers (each wrapper's
#: ``launches``, and K3's ``split_calls``).  A capture runs the step's
#: Python once, so whichever of them the step bumps must be taken out of the
#: capture and re-added per replay; a counter missing here would be
#: miscounted under replay.  A new kernel wrapper joins this list;
#: ``tests/test_torch_step_set.py`` fails while one is missing.
KERNEL_COUNTERS = tuple((fn, "launches") for fn in (
    paged_attention_cuda, flash_fwd_cuda, flash_dq_cuda, flash_dkv_cuda, sparse_attn_fwd_cuda, sparse_attn_dq_cuda,
    sparse_attn_dkv_cuda, quantize_int8_cuda, dequantize_int8_cuda, quantize_int4_cuda,
    dequantize_int4_cuda)) + ((paged_attention_cuda, "split_calls"), )


class ReplayCounts:
    """The launch accounting of one captured graph.  Capturing runs the
    step's Python once, which bumps the counters (the engine's
    ``forward_calls`` and ``KERNEL_COUNTERS``) although no kernel runs;
    :meth:`capturing` takes those increments back out and keeps them as the
    graph's deltas, and :meth:`replayed` adds the deltas once per replay,
    where the kernels do run.  ``added`` sums what this graph's replays
    added, counter by counter."""

    def __init__(self, engine):
        self.engine = engine
        self.deltas: Tuple[int, ...] = ()
        self.added: Tuple[int, ...] = (0, ) * (1 + len(KERNEL_COUNTERS))

    def _read(self) -> Tuple[int, ...]:
        return (self.engine.forward_calls, ) + tuple(getattr(fn, name) for fn, name in KERNEL_COUNTERS)

    def _write(self, values: Sequence[int]) -> None:
        self.engine.forward_calls = values[0]
        for (fn, name), v in zip(KERNEL_COUNTERS, values[1:]):
            setattr(fn, name, v)

    def get(self, fn, name: str = "launches") -> int:
        """What this graph's replays added to one kernel counter."""
        return self.added[1 + KERNEL_COUNTERS.index((fn, name))]

    @contextlib.contextmanager
    def capturing(self):
        before = self._read()
        try:
            yield
        finally:
            after = self._read()
            self._write(before)
        self.deltas = tuple(a - b for a, b in zip(after, before))

    def replayed(self) -> None:
        self._write([v + d for v, d in zip(self._read(), self.deltas)])
        self.added = tuple(a + d for a, d in zip(self.added, self.deltas))


def warm_run(fn: Callable, inputs: Sequence[torch.Tensor], generator: torch.Generator) -> None:
    """Run a step function once on an all-padding batch (its KV writes land
    in the null page 0), leaving the sampling generator where it was."""
    state = generator.get_state()
    fn(*inputs)
    generator.set_state(state)


class GraphSpace:
    """What all of one engine's step graphs share: the side stream they are
    captured on and the memory pool they are captured into (they replay one
    after another on one stream)."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()


class EagerStep:
    """A step program that runs its step eagerly: the CPU route."""

    def __init__(self, fn: Callable, device: torch.device):
        self.fn, self.device = fn, device

    def run(self, arrays: Sequence[np.ndarray]) -> torch.Tensor:
        return self.fn(*(torch.from_numpy(a).to(self.device) for a in arrays))

    def warm(self, padding: Sequence[np.ndarray], generator: torch.Generator) -> None:
        """One all-padding dispatch: what building the key means here."""
        warm_run(self.fn, [torch.from_numpy(a).to(self.device) for a in padding], generator)


def _arena_ptrs(cache) -> List[int]:
    return [t.data_ptr() for t in cache]


class GraphStep:
    """One step-set key captured as a CUDA graph on the engine's device.

    The inputs live in one static int32 buffer (tokens, start_pos,
    block_tables, chunk_lens, in that order) filled before each replay by
    one host-to-device copy from a pinned staging buffer of this key; the
    copy stays outside the graph.  An event recorded after that copy guards
    the staging buffer: the host writes it again only once the copy of the
    previous replay has left it.

    Before the capture, the step runs once eagerly on the capture stream
    over an all-padding batch (all-null block tables, chunk_lens 0: its KV
    writes land in the null page 0), which creates the cuBLAS workspace of
    that stream and loads and opts in K3's library outside the capture.
    The graph then captures the step's kernels (writing the engine's KV
    arena in place, as the eager step does) on the engine's
    :class:`GraphSpace`.  A categorical sampler registers the engine's generator
    with the graph, so each replay draws fresh numbers from it.

    A capture or replay error is raised; nothing falls back to the eager
    route.  ``run`` returns a copy of the static output, so a caller's
    tokens are never overwritten by a later replay.
    """

    def __init__(self, engine, space: GraphSpace, fn: Callable, padding: Sequence[np.ndarray]):
        dev = engine.device
        self.engine, self.device = engine, dev
        sizes = [a.size for a in padding]
        offsets = np.cumsum([0] + sizes)
        self._host = torch.zeros(int(offsets[-1]), dtype=torch.int32, pin_memory=True)
        self._static = torch.zeros(int(offsets[-1]), dtype=torch.int32, device=dev)
        host = self._host.numpy()
        self._host_views = [host[o:o + n].reshape(a.shape) for o, n, a in zip(offsets, sizes, padding)]
        self.inputs = [self._static[o:o + n].view(a.shape) for o, n, a in zip(offsets, sizes, padding)]
        self._copied = torch.cuda.Event()
        self.counts = ReplayCounts(engine)
        self._arena = _arena_ptrs(engine.cache)
        self.graph = torch.cuda.CUDAGraph()
        if not engine.econfig.greedy:
            self.graph.register_generator_state(engine.generator)
        stream = space.stream
        t0 = time.perf_counter()
        with torch.cuda.device(dev):
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                warm_run(fn, self.inputs, engine.generator)
            with self.counts.capturing(), torch.cuda.graph(self.graph, pool=space.pool, stream=stream):
                self.output = fn(*self.inputs)
            torch.cuda.current_stream(dev).wait_stream(stream)
        #: seconds of the warm run and the capture
        self.capture_s = time.perf_counter() - t0

    def run(self, arrays: Sequence[np.ndarray]) -> torch.Tensor:
        if _arena_ptrs(self.engine.cache) != self._arena:
            raise RuntimeError("the engine's KV arena is not the one this step graph was captured on")
        self._copied.synchronize()
        for view, a in zip(self._host_views, arrays):
            view[...] = a
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device)
            self._static.copy_(self._host, non_blocking=True)
            self._copied.record(stream)
            self.graph.replay()
            self.counts.replayed()
            return self.output.clone()


def padding_arrays(shapes: Sequence[Tuple[int, ...]]) -> List[np.ndarray]:
    """An all-padding batch of the given input shapes: zero tokens and
    positions, all-null block tables, chunk_lens 0."""
    return [np.zeros(s, np.int32) for s in shapes]
