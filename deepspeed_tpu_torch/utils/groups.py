"""Process-group lookups (port of ``deepspeed_tpu/utils/groups.py``; ref:
``deepspeed/utils/groups.py``).

The JAX package answers these queries with mesh axis names; the port
answers with ``torch.distributed`` process groups over the ranks of the
global mesh (``comm/mesh.py``: rank ``d·ep + e`` at data ``d``, expert
``e``):

* the data-parallel group is the whole world (``None``, the default group,
  to every ``comm`` collective), since JAX's batch and ZeRO axes include
  ``expert``;
* the expert-parallel group of a rank is the ranks that share its ``d``
  (consecutive ranks: the dispatch all-to-all runs inside it), and its
  expert-data-parallel group the ranks that share its ``e`` (an expert
  bank's replicas: its gradients are reduced inside it).  At ``expert`` 1
  the latter is the world (``None``).

``create_expert_groups`` makes both families once per world and expert
size, on every rank in one order (``dist.new_group`` is collective): the
training engine calls it at ``expert`` > 1; otherwise the first call of
``get_expert_parallel_group`` does, which every rank must then make.  The
model, tensor, sequence and pipeline axes have size 1 and no group of
their own (``None``).
"""

from typing import Dict, List, Optional

import torch.distributed as dist

from ..comm import comm
from ..comm.mesh import (DATA_AXIS, EXPERT_AXIS, PIPE_AXIS, SEQ_AXIS, TENSOR_AXIS, ZERO_AXES, axis_size,
                         get_global_mesh)

#: (the world group, expert size) → {"ep": [group per d], "ed": [group per e]};
#: the world group is held so that a new process group never matches a stale entry
_GROUPS: Dict[tuple, dict] = {}


def _size(*axes) -> int:
    return axis_size(get_global_mesh(), *axes)


def _coords() -> Dict[str, int]:
    return get_global_mesh().coords(comm.get_rank())


def expert_ranks(mesh, axis: str, rank: int) -> List[int]:
    """The ranks that share every coordinate of ``rank`` but ``axis``'s
    (the ``expert`` axis: its expert-parallel group; ``data``: its
    expert-data-parallel group), in the order of that coordinate."""
    at = mesh.coords(rank)
    return [mesh.rank({**at, axis: i}) for i in range(mesh.shape.get(axis, 1))]


def create_expert_groups() -> Optional[dict]:
    """The expert-parallel and expert-data-parallel groups of the global
    mesh (made once per world and expert size; None on one rank)."""
    if comm.get_world_size() == 1:
        return None
    mesh = get_global_mesh()
    ep = mesh.shape.get(EXPERT_AXIS, 1)
    world = dist.group.WORLD
    for (w, n), made in _GROUPS.items():
        if w is world and n == ep:
            return made
    made = {"ep": [], "ed": []}
    data = mesh.shape.get(DATA_AXIS, 1)
    for d in range(data):      # every rank makes every group, in one order
        made["ep"].append(dist.new_group(expert_ranks(mesh, EXPERT_AXIS, mesh.rank({DATA_AXIS: d}))))
    if ep > 1:
        for e in range(ep):
            made["ed"].append(dist.new_group(expert_ranks(mesh, DATA_AXIS, mesh.rank({EXPERT_AXIS: e}))))
    for key in [k for k in _GROUPS if k[0] is not world]:
        del _GROUPS[key]       # groups of an earlier process group are gone with it
    _GROUPS[(world, ep)] = made
    return made


def get_data_parallel_group() -> Optional[object]:
    """ref: groups._get_data_parallel_group: the default process group."""
    return None


def get_data_parallel_world_size() -> int:
    return _size(*ZERO_AXES)


def get_data_parallel_rank() -> int:
    return comm.get_rank()


def get_model_parallel_group() -> Optional[object]:
    """ref: groups._get_model_parallel_group (size 1: no group)."""
    return None


def get_model_parallel_world_size() -> int:
    return _size(TENSOR_AXIS)


def get_tensor_model_parallel_group() -> Optional[object]:
    return None


def get_tensor_model_parallel_world_size() -> int:
    return _size(TENSOR_AXIS)


def get_expert_parallel_group(name=None) -> Optional[object]:
    """ref: groups._get_expert_parallel_group: this rank's expert group
    (None on one rank)."""
    made = create_expert_groups()
    return None if made is None else made["ep"][_coords()[DATA_AXIS]]


def get_expert_parallel_world_size(name=None) -> int:
    return _size(EXPERT_AXIS)


def get_expert_parallel_rank(name=None) -> int:
    """ref: groups._get_expert_parallel_rank: this rank's ``e``."""
    return _coords()[EXPERT_AXIS]


def get_expert_data_parallel_group(name=None) -> Optional[object]:
    """The data-parallel axes without the expert axis: the ranks that hold
    the same experts (the default group at ``expert`` 1)."""
    if _size(EXPERT_AXIS) == 1:
        return None
    made = create_expert_groups()
    return None if made is None else made["ed"][_coords()[EXPERT_AXIS]]


def get_expert_data_parallel_world_size(name=None) -> int:
    return _size(*(a for a in ZERO_AXES if a != EXPERT_AXIS))


def get_expert_data_parallel_rank(name=None) -> int:
    """This rank's place in its expert-data-parallel group (its ``d``)."""
    return _coords()[DATA_AXIS]


def get_sequence_parallel_group() -> Optional[object]:
    """ref: groups._get_sequence_parallel_group (size 1: no group)."""
    return None


def get_sequence_parallel_world_size() -> int:
    return _size(SEQ_AXIS)


def get_pipeline_parallel_group() -> Optional[object]:
    return None


def get_pipeline_parallel_world_size() -> int:
    return _size(PIPE_AXIS)
