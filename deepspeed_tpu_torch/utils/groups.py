"""Process-group lookups (port of ``deepspeed_tpu/utils/groups.py``; ref:
``deepspeed/utils/groups.py``).

The JAX package answers these queries with mesh axis names; the port
answers with ``torch.distributed`` process groups over the ranks of the
global mesh (``comm/mesh.py``: rank ``d·ep + e`` at data ``d``, expert
``e``; rank ``d·N + t`` at data ``d``, tensor ``t``).  A group over some
axes is the ranks that share every other coordinate (``axis_ranks``):

* the data-parallel group is the ranks that share the tensor coordinate
  (JAX's ``ZERO_AXES``): the whole world (``None``, the default group, to
  every ``comm`` collective) at ``tensor`` 1, since JAX's batch and ZeRO
  axes include ``expert``; at ``tensor`` N the D ranks of one ``t``;
* the tensor (model) parallel group of a rank is the N consecutive ranks
  that share its ``d`` (``None`` at ``tensor`` 1);
* the expert-parallel group of a rank is the ranks that share its ``d``
  and ``t`` (consecutive ranks at ``tensor`` 1, T apart at ``tensor`` T:
  the dispatch all-to-all runs inside it), and its expert-data-parallel
  group the ranks that share its ``e`` and ``t`` (an expert bank's
  replicas: its gradients are reduced inside it).  At ``expert`` 1 the
  latter is the data-parallel group.

``dist.new_group`` is collective: the groups over some axes are made all
at once, on every rank in one order, at their first lookup (which every
rank must then make) — the engines look them up at construction.  The
sequence and pipeline axes have size 1 and no group of their own
(``None``).
"""

from typing import Dict, List, Optional, Sequence, Tuple

import torch.distributed as dist

from ..comm import comm
from ..comm.mesh import (DATA_AXIS, EXPERT_AXIS, MESH_AXES, PIPE_AXIS, SEQ_AXIS, TENSOR_AXIS, ZERO_AXES, Mesh,
                         axis_size, get_global_mesh)

#: (the world group, the mesh's sizes, the axes) → {member ranks: process group};
#: the world group is held so that a new process group never matches a stale entry
_GROUPS: Dict[tuple, Dict[Tuple[int, ...], object]] = {}


def _size(*axes) -> int:
    return axis_size(get_global_mesh(), *axes)


def _coords() -> Dict[str, int]:
    return get_global_mesh().coords(comm.get_rank())


def axis_ranks(mesh: Mesh, axes: Sequence[str], rank: int) -> List[int]:
    """The ranks that share every coordinate of ``rank`` but those of
    ``axes``, in rank order (``expert``: its expert-parallel group;
    ``data``: its expert-data-parallel group; ``tensor``: its tensor group;
    ``ZERO_AXES``: its data-parallel group)."""
    at = mesh.coords(rank)
    world = axis_size(mesh, *MESH_AXES)
    return [r for r in range(world) if all(mesh.coords(r)[a] == at[a] for a in MESH_AXES if a not in axes)]


def expert_ranks(mesh, axis: str, rank: int) -> List[int]:
    """``axis_ranks`` over the one axis ``axis``."""
    return axis_ranks(mesh, (axis, ), rank)


def axis_group(axes: Sequence[str]) -> Optional[object]:
    """This rank's process group over ``axes`` of the global mesh (see the
    module docstring); None on one rank, or when the group is the world."""
    world_size = comm.get_world_size()
    if world_size == 1:
        return None
    mesh = get_global_mesh()
    mine = tuple(axis_ranks(mesh, axes, comm.get_rank()))
    if len(mine) == world_size:
        return None
    world = dist.group.WORLD
    key = (world, tuple(sorted(mesh.shape.items())), tuple(axes))
    made = _GROUPS.get(key)
    if made is None:
        for k in [k for k in _GROUPS if k[0] is not world]:
            del _GROUPS[k]       # groups of an earlier process group are gone with it
        made = {}
        for r in range(world_size):      # every rank makes every group, in one order
            members = tuple(axis_ranks(mesh, axes, r))
            if members not in made:
                made[members] = dist.new_group(list(members))
        _GROUPS[key] = made
    return made[mine]


def create_expert_groups() -> None:
    """Make the expert-parallel and expert-data-parallel groups of the
    global mesh on every rank (the training engine calls it at ``expert`` > 1)."""
    if comm.get_world_size() > 1:
        axis_group((EXPERT_AXIS, ))
        axis_group((DATA_AXIS, ))


def create_tensor_groups() -> None:
    """Make the tensor groups and the data-parallel groups of the global
    mesh on every rank (the engines call it at ``tensor`` > 1)."""
    if comm.get_world_size() > 1:
        axis_group((TENSOR_AXIS, ))
        axis_group(ZERO_AXES)


def get_data_parallel_group() -> Optional[object]:
    """ref: groups._get_data_parallel_group: the ranks that share this
    rank's tensor coordinate (JAX's ``ZERO_AXES``); None, the default group,
    at ``tensor`` 1."""
    return axis_group(ZERO_AXES)


def get_data_parallel_world_size() -> int:
    return _size(*ZERO_AXES)


def get_data_parallel_rank() -> int:
    """This rank's place in its data-parallel group."""
    return comm.get_rank() // _size(TENSOR_AXIS)


def get_model_parallel_group() -> Optional[object]:
    """ref: groups._get_model_parallel_group: the tensor group (no pipeline axis)."""
    return get_tensor_model_parallel_group()


def get_model_parallel_world_size() -> int:
    return _size(TENSOR_AXIS)


def get_model_parallel_rank() -> int:
    return get_tensor_model_parallel_rank()


def get_tensor_model_parallel_group() -> Optional[object]:
    """The N consecutive ranks that share this rank's data coordinate
    (None at ``tensor`` 1)."""
    return axis_group((TENSOR_AXIS, )) if _size(TENSOR_AXIS) > 1 else None


def get_tensor_model_parallel_world_size() -> int:
    return _size(TENSOR_AXIS)


def get_tensor_model_parallel_rank() -> int:
    """This rank's ``t``."""
    return _coords()[TENSOR_AXIS]


def get_expert_parallel_group(name=None) -> Optional[object]:
    """ref: groups._get_expert_parallel_group: this rank's expert group
    (None on one rank)."""
    return axis_group((EXPERT_AXIS, ))


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
    return axis_group((DATA_AXIS, ))


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
