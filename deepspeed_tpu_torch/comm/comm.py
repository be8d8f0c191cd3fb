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


class CommsLogger:
    """Per-collective counters (ref: utils/comms_logging.py:67 CommsLogger):
    ``comms_dict[name][msg_size] = [count, total seconds]``."""

    def __init__(self, verbose: bool = False):
        self.verbose = verbose
        self.comms_dict = {}

    def append(self, name, latency, msg_size):
        entry = self.comms_dict.setdefault(name, {})
        sz = entry.setdefault(msg_size, [0, 0.0])
        sz[0] += 1
        sz[1] += latency
        if self.verbose:
            logger.info(f"comm op: {name} | time (ms): {latency*1e3:.2f} | msg size: {msg_size}")


def configure(enabled: bool = False, verbose: bool = False) -> None:
    """Turn the comms logger on (ref: comm/comm.py:72 configure): a fresh
    ``CommsLogger`` records every collective from here on."""
    global _COMMS_LOGGER
    if enabled:
        _COMMS_LOGGER = CommsLogger(verbose=verbose)


def comms_logger() -> Optional[CommsLogger]:
    return _COMMS_LOGGER


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
        _COMMS_LOGGER.append(name, time.time() - t0, nbytes)


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
    ``mesh_spec``, when given, must fit the world (data parallel only)."""
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


def broadcast(tensor: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    t0 = time.time()
    dist.broadcast(tensor, src=src, group=group)
    call_counts["broadcast"] += 1
    _record("broadcast", t0, _nbytes(tensor))
    return tensor
