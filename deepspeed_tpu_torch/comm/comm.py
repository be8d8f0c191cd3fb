"""``deepspeed_tpu_torch.comm``: the ``deepspeed.comm``-style functional API
over ``torch.distributed`` (port of ``deepspeed_tpu/comm/comm.py:42-96,
104-196, 277-345``; ref: ``deepspeed/comm/comm.py``).

* Bootstrap: ``init_distributed`` creates the default process group from
  its arguments or from the launcher's environment (``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``, ``LOCAL_RANK``).  The
  backend is the one the caller names, else NCCL where a GPU is visible and
  gloo where none is.  NCCL takes one card per rank and raises when a host
  runs more ranks than it has cards; gloo serves CPU tensors and several
  ranks on one card, and takes CUDA tensors as they are (it copies them
  through host memory inside its own collectives).
* Collectives act in place on one tensor per rank, as ``torch.distributed``
  does.  ``ReduceOp.AVG`` is a sum divided by the world size, on every
  backend: gloo has no average, and it is how ``jax.lax.pmean`` reduces.
* Every collective records its payload bytes and host time into the
  ``CommsLogger`` when ``configure(enabled=True)`` turned it on
  (ref: ``utils/comms_logging.py``), except inside ``unrecorded()``: there
  a caller records one aggregate for the collectives it runs (the training
  engine's step, which JAX runs inside one ``jit`` and logs as one entry).
  ``call_counts`` counts every collective's calls, recorded or not.
* Every collective takes a ``group`` (``None``: the default group), such as
  the expert groups of ``utils/groups.py``.  ``AllToAll`` is the autograd
  all-to-all of the MoE dispatch (ref: ``deepspeed/moe/sharded_moe.py``
  ``_AllToAll``): equal splits along dim 0, its backward the same
  all-to-all of the gradient; ``all_to_all_kinds`` counts its calls by the
  caller's label and direction.  The tensor-parallel layers'
  collectives (``module_inject/layers.py``, on the tensor group) are
  counted the same way in ``tensor_parallel_kinds``.
* ``reduce_scatter_tensor`` takes its route from the backend and the
  tensor's device (``REDUCE_SCATTER_ROUTES``): the process group's own
  collective, except gloo on CUDA tensors, which it takes but which run
  faster as ``all_to_all_single`` calls (of at most
  ``ALL_TO_ALL_CHUNK_BYTES`` each) and a sum of the received chunks in rank
  order (``chip_smoke.py`` phase 25 times both routes on the card;
  ``PERF.md`` §6).
"""

import collections
import contextlib
import datetime
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.logging import logger
from .mesh import MeshSpec

_COMMS_LOGGER = None
_UNRECORDED = 0   # depth of unrecorded() blocks
#: calls of each collective in this process, inside unrecorded() blocks too
call_counts = collections.Counter()
#: ``AllToAll`` calls by (label, "forward" or "backward")
all_to_all_kinds = collections.Counter()
#: the tensor-parallel collectives (``module_inject/layers.py``) by
#: (label, "forward" or "backward")
tensor_parallel_kinds = collections.Counter()


class CommsLogger:
    """Per-collective counters (ref: utils/comms_logging.py:67 CommsLogger):
    ``comms_dict[name][msg_size] = [count, total seconds]``."""

    def __init__(self, verbose: bool = False, debug: bool = False, prof_all: bool = True, prof_ops=None):
        self.verbose = verbose
        self.debug = debug
        self.prof_all = prof_all
        self.prof_ops = list(prof_ops or [])
        self.comms_dict = {}

    def append(self, raw_name, record_name, latency, msg_size):
        """One call of ``raw_name`` (``record_name`` is the reference's
        label for it; the counters are keyed by ``raw_name``, as JAX's)."""
        entry = self.comms_dict.setdefault(raw_name, {})
        sz = entry.setdefault(msg_size, [0, 0.0])
        sz[0] += 1
        sz[1] += latency
        if self.verbose:
            logger.info(f"comm op: {raw_name} | time (ms): {latency*1e3:.2f} | msg size: {msg_size}")

    def log_all(self, print_log: bool = True, show_straggler: bool = False):
        """One line per collective and message size, logged when
        ``print_log``; returns ``comms_dict`` (JAX ``comm.py:60``)."""
        lines = ["Comms summary:"]
        for op, sizes in self.comms_dict.items():
            for size, (count, total) in sorted(sizes.items()):
                lines.append(f"  {op:<24} size={size:<12} count={count:<6} total_ms={total*1e3:.2f}")
        if print_log:
            logger.info("\n".join(lines))
        return self.comms_dict


def configure(deepspeed_config=None, enabled: Optional[bool] = None, prof_all: Optional[bool] = None, prof_ops=None,
              verbose: Optional[bool] = None, debug: Optional[bool] = None) -> None:
    """Turn the comms logger on (ref: comm/comm.py:72 configure): a fresh
    ``CommsLogger`` records every collective from here on, when ``enabled``
    or the config's ``comms_logger`` block is; the keywords override the
    block's fields (JAX ``comm.py:70``)."""
    global _COMMS_LOGGER
    cfg = getattr(deepspeed_config, "comms_config", None)
    if enabled or (cfg is not None and cfg.enabled):
        pick = lambda value, field, default: value if value is not None else getattr(cfg, field, default)
        _COMMS_LOGGER = CommsLogger(verbose=pick(verbose, "verbose", False), debug=pick(debug, "debug", False),
                                    prof_all=pick(prof_all, "prof_all", True), prof_ops=pick(prof_ops, "prof_ops", []))


def comms_logger() -> Optional[CommsLogger]:
    return _COMMS_LOGGER


def log_summary(show_straggler: bool = False) -> dict:
    """The CommsLogger's summary (JAX ``comm.py:87``); ``{}`` and a warning
    when it is off."""
    if _COMMS_LOGGER is not None:
        return _COMMS_LOGGER.log_all(show_straggler=show_straggler)
    logger.warning("comms logging not enabled; call deepspeed_tpu_torch.comm.configure first")
    return {}


@contextlib.contextmanager
def unrecorded():
    """The collectives inside do not record themselves into the CommsLogger."""
    global _UNRECORDED
    _UNRECORDED += 1
    try:
        yield
    finally:
        _UNRECORDED -= 1


def _record(name: str, t0: float, nbytes: int) -> None:
    if _COMMS_LOGGER is not None and not _UNRECORDED:
        _COMMS_LOGGER.append(name, name, time.time() - t0, nbytes)


# --------------------------------------------------------------------------
# Process bootstrap
# --------------------------------------------------------------------------


def init_distributed(dist_backend: Optional[str] = None,
                     distributed_port: int = 29500,
                     verbose: bool = True,
                     timeout: Optional[float] = None,
                     init_method: Optional[str] = None,
                     rank: int = -1,
                     world_size: int = -1,
                     mesh_spec: Optional[MeshSpec] = None) -> None:
    """Create the default process group (ref: comm/comm.py:636
    init_distributed) unless one exists.

    ``rank``/``world_size`` default to the ``RANK``/``WORLD_SIZE`` the
    launcher exports (0 and 1 without them); ``init_method`` to
    ``tcp://MASTER_ADDR:MASTER_PORT`` (``127.0.0.1`` and
    ``distributed_port`` without them).  ``timeout`` is in seconds.
    ``mesh_spec``, when given, must fit the world (its data and expert axes)."""
    world = world_size if world_size > 0 else int(os.environ.get("WORLD_SIZE", 1))
    if mesh_spec is not None:
        mesh_spec.resolve(world)
    if is_initialized():
        return
    rank = rank if rank >= 0 else int(os.environ.get("RANK", 0))
    if init_method is None:
        addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
        init_method = f"tcp://{addr}:{os.environ.get('MASTER_PORT', distributed_port)}"
    backend = dist_backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        cards = torch.cuda.device_count()
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if cards == 0:
            raise RuntimeError("dist_backend 'nccl' needs a CUDA GPU; use 'gloo' on the CPU")
        if local_world > cards:
            raise RuntimeError(f"dist_backend 'nccl' takes one card per rank: {local_world} ranks on this host, "
                               f"{cards} visible card(s); name dist_backend='gloo' to run several ranks on one card")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % cards)))
    kwargs = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world, **kwargs)
    if verbose:
        logger.info(f"torch.distributed: backend {backend}, rank {rank} of {world}, {init_method}")


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank(group=None) -> int:
    return dist.get_rank(group) if is_initialized() else 0


def get_world_size(group=None) -> int:
    return dist.get_world_size(group) if is_initialized() else 1


def get_backend(group=None) -> Optional[str]:
    return dist.get_backend(group) if is_initialized() else None


def get_local_rank() -> int:
    """This rank's index on its host: the launcher's ``LOCAL_RANK`` (0 without it)."""
    return int(os.environ.get("LOCAL_RANK", 0))


def get_world_group():
    """The group of every rank (JAX's ``ZERO_AXES``): the default group."""
    return dist.group.WORLD if is_initialized() else None


def get_all_ranks_from_group(group=None) -> list:
    """The global ranks of ``group``, in its rank order."""
    if not is_initialized():
        return [0]
    return dist.get_process_group_ranks(group if group is not None else dist.group.WORLD)


def has_all_gather_into_tensor() -> bool:
    return True


def has_reduce_scatter_tensor() -> bool:
    return True


def barrier(group=None) -> None:
    dist.barrier(group=group)


# --------------------------------------------------------------------------
# Collectives
# --------------------------------------------------------------------------


class ReduceOp:
    SUM = "sum"
    AVG = "avg"
    MAX = "max"


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.AVG: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_reduce(tensor: torch.Tensor, op: str = ReduceOp.SUM, group=None) -> torch.Tensor:
    """Reduce ``tensor`` over the group, in place; AVG is SUM / world, a
    true divide as ``jax.lax.pmean``'s (by a tensor: CUDA turns a divide by a
    Python number into a product with its reciprocal)."""
    if op not in _TORCH_OPS:
        raise ValueError(f"Unsupported reduce op {op}")
    t0 = time.time()
    dist.all_reduce(tensor, op=_TORCH_OPS[op], group=group)
    call_counts["all_reduce"] += 1
    if op == ReduceOp.AVG:
        tensor.div_(torch.full_like(tensor, get_world_size(group)))
    _record("all_reduce", t0, _nbytes(tensor))
    return tensor


def all_gather_into_tensor(output_tensor: torch.Tensor, tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``tensor``, concatenated along dim 0 in rank order."""
    t0 = time.time()
    dist.all_gather_into_tensor(output_tensor, tensor, group=group)
    call_counts["all_gather_into_tensor"] += 1
    _record("all_gather_into_tensor", t0, _nbytes(tensor))
    return output_tensor


def all_to_all_single(output: torch.Tensor, tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Chunk ``d`` of ``tensor`` (dim 0 split in world equal parts) goes to
    rank ``d``; chunk ``s`` of ``output`` came from rank ``s``."""
    t0 = time.time()
    dist.all_to_all_single(output, tensor, group=group)
    call_counts["all_to_all_single"] += 1
    _record("all_to_all_single", t0, _nbytes(tensor))
    return output


#: the most bytes of a reduce-scatter's buffer that its all-to-all route
#: sends at once: gloo stages a CUDA tensor's send and receive copies in
#: pinned host memory and keeps them cached (a bank's 2.8 GB gradient buffer
#: left 8 GB a rank; four ranks of phase 25 ran the host out of memory)
ALL_TO_ALL_CHUNK_BYTES = 1 << 28
#: (backend, device type) → how ``reduce_scatter_tensor`` runs: "native"
#: (the process group's reduce-scatter) or "all_to_all" (an all-to-all of
#: the chunks, then their sum in rank order; SUM and AVG only)
REDUCE_SCATTER_ROUTES = {("gloo", "cpu"): "native", ("gloo", "cuda"): "all_to_all", ("nccl", "cuda"): "native"}


def reduce_scatter_tensor(output: torch.Tensor, tensor: torch.Tensor, op: str = ReduceOp.SUM,
                          group=None) -> torch.Tensor:
    """Chunk ``r`` of ``tensor`` (dim 0 split in world equal parts), reduced
    over the ranks, into ``output`` on rank ``r`` (JAX ``comm.py:305``)."""
    if op not in _TORCH_OPS:
        raise ValueError(f"Unsupported reduce op {op}")
    t0 = time.time()
    route = REDUCE_SCATTER_ROUTES.get((get_backend(group), tensor.device.type), "native")
    if route == "all_to_all" and op != ReduceOp.MAX:
        world = get_world_size(group)
        sent, out = tensor.view(world, -1), output.view(-1)
        step = max(1, ALL_TO_ALL_CHUNK_BYTES // (world * tensor.element_size()))
        for c0 in range(0, sent.shape[1], step):
            received = torch.empty_like(sent[:, c0:c0 + step])
            dist.all_to_all_single(received, sent[:, c0:c0 + step].contiguous(), group=group)
            out[c0:c0 + step].copy_(received[0])
            for chunk in received[1:]:
                out[c0:c0 + step].add_(chunk)
    else:
        dist.reduce_scatter_tensor(output, tensor, op=_TORCH_OPS[op], group=group)
    call_counts["reduce_scatter_tensor"] += 1
    if op == ReduceOp.AVG:
        output.div_(torch.full_like(output, get_world_size(group)))
    _record("reduce_scatter_tensor", t0, _nbytes(tensor))
    return output


class AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over ``group`` as an autograd function: chunk
    ``j`` of dim 0 goes to the group's rank ``j``; the backward sends the
    gradient's chunks back the same way (ref: ``sharded_moe.py``
    ``_AllToAll``).  Not recorded into the CommsLogger (JAX's runs inside
    the jitted step)."""

    @staticmethod
    def forward(ctx, x, group, kind):
        ctx.group, ctx.kind = group, kind
        return _all_to_all(x, group, kind, "forward")

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group, ctx.kind, "backward"), None, None


def _all_to_all(x: torch.Tensor, group, kind: str, direction: str) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    with unrecorded():
        all_to_all_single(out, x, group=group)
    all_to_all_kinds[(kind, direction)] += 1
    return out


def broadcast(tensor: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    t0 = time.time()
    dist.broadcast(tensor, src=src, group=group)
    call_counts["broadcast"] += 1
    _record("broadcast", t0, _nbytes(tensor))
    return tensor
