"""The parallelism axes of the port (after ``deepspeed_tpu/comm/mesh.py``).

The JAX package builds one named device mesh whose axes carry every degree
of parallelism (``pipe``, ``data``, ``expert``, ``seq``, ``tensor``).  The
port has data parallelism only: the ``data`` axis is the default
``torch.distributed`` process group, one rank per data-parallel replica.
A ``MeshSpec`` that asks for any other axis above 1 raises.

``Mesh`` stands for the JAX mesh where only its axis sizes are read (the
ZeRO partition rules, ``runtime/zero``): ``get_global_mesh()`` is the
data-only mesh over the process group, every other axis of size 1.
ZeRO partitions over ``ZERO_AXES``, as in JAX.
"""

import dataclasses
from typing import Dict, Tuple

import torch.distributed as dist

PIPE_AXIS = "pipe"
DATA_AXIS = "data"
EXPERT_AXIS = "expert"
SEQ_AXIS = "seq"
TENSOR_AXIS = "tensor"
MESH_AXES = (PIPE_AXIS, DATA_AXIS, EXPERT_AXIS, SEQ_AXIS, TENSOR_AXIS)
#: the axes over which ZeRO partitions parameters, gradients and optimizer state
ZERO_AXES = (DATA_AXIS, EXPERT_AXIS, SEQ_AXIS)

ROADMAP_MULTI_DEVICE = ("ROADMAP Queue 1 item 6, multi-device training (MoE over several ranks, pipeline/tensor/"
                        "sequence/expert parallel)")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Sizes of the mesh axes; ``data=-1`` takes every rank."""
    pipe: int = 1
    data: int = -1
    expert: int = 1
    seq: int = 1
    tensor: int = 1

    def resolve(self, world_size: int) -> Tuple[int, int, int, int, int]:
        """The axis sizes over ``world_size`` ranks, in ``MESH_AXES`` order."""
        others = {a: getattr(self, a) for a in MESH_AXES if a != DATA_AXIS}
        wide = {a: n for a, n in others.items() if n != 1}
        if wide:
            raise NotImplementedError(f"mesh axes {wide}: the port has data parallelism only; pipeline, expert, "
                                      f"sequence and tensor parallelism are not ported ({ROADMAP_MULTI_DEVICE})")
        data = world_size if self.data == -1 else self.data
        if data != world_size:
            raise ValueError(f"Mesh {self} does not cover {world_size} ranks (data={data})")
        return (1, data, 1, 1, 1)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The sizes of the mesh axes (JAX ``Mesh.shape``), by axis name."""
    shape: Dict[str, int]


def get_global_mesh() -> Mesh:
    """The data-only mesh over the default process group (one rank without
    one): ``data`` is the world size, every other axis 1."""
    return Mesh({**dict.fromkeys(MESH_AXES, 1), DATA_AXIS: dp_world_size()})


def axis_size(mesh: Mesh, *axes: str) -> int:
    """The product of the sizes of ``axes`` (absent axes count 1)."""
    n = 1
    for a in axes:
        n *= mesh.shape.get(a, 1)
    return n


def dp_world_size() -> int:
    """The data-parallel degree: the default process group's world size, 1
    without a process group."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
