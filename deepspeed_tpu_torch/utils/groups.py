"""Process-group lookups (port of ``deepspeed_tpu/utils/groups.py``; ref:
``deepspeed/utils/groups.py``).

The JAX package answers these queries with mesh axis names; the port has
the data axis only, which is the default ``torch.distributed`` process
group.  The data-parallel (and expert-data-parallel) group is therefore the
default group (``None`` to every ``comm`` collective, as to
``torch.distributed``'s); the model, tensor, expert, sequence and pipeline
axes have size 1 and no group of their own (``None``).
"""

from typing import Optional

from ..comm import comm
from ..comm.mesh import EXPERT_AXIS, PIPE_AXIS, SEQ_AXIS, TENSOR_AXIS, ZERO_AXES, axis_size, get_global_mesh


def _size(*axes) -> int:
    return axis_size(get_global_mesh(), *axes)


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
    """ref: groups._get_expert_parallel_group (size 1: no group)."""
    return None


def get_expert_parallel_world_size(name=None) -> int:
    return _size(EXPERT_AXIS)


def get_expert_data_parallel_group(name=None) -> Optional[object]:
    """The data-parallel axes without the expert axis: the default group."""
    return None


def get_expert_data_parallel_world_size(name=None) -> int:
    return _size(*(a for a in ZERO_AXES if a != EXPERT_AXIS))


def get_sequence_parallel_group() -> Optional[object]:
    """ref: groups._get_sequence_parallel_group (size 1: no group)."""
    return None


def get_sequence_parallel_world_size() -> int:
    return _size(SEQ_AXIS)


def get_pipeline_parallel_group() -> Optional[object]:
    return None


def get_pipeline_parallel_world_size() -> int:
    return _size(PIPE_AXIS)

