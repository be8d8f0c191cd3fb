"""The parallelism axes of the port (after ``deepspeed_tpu/comm/mesh.py``).

The JAX package builds one named device mesh whose axes carry every degree
of parallelism (``pipe``, ``data``, ``expert``, ``seq``, ``tensor``).  The
port has data, expert and tensor parallelism: the ranks of the default
``torch.distributed`` process group are the devices of JAX's mesh, in its
order (``MESH_AXES`` row-major, the last axis fastest), so at ``data`` D ×
``expert`` ep rank ``d·ep + e`` sits at coordinate (d, e) and an expert
group is ep consecutive ranks; at ``data`` D × ``tensor`` N rank ``d·N + t``
sits at (d, t) and a tensor group is N consecutive ranks; at ``data`` D ×
``expert`` E × ``tensor`` T rank ``(d·E + e)·T + t`` sits at (d, e, t), so an
expert group's ranks are T apart.  A ``MeshSpec``
that asks for ``pipe`` or ``seq`` above 1 raises.

The data-parallel degree is the process group's ranks over the model axes,
``world // (pipe·tensor·seq)`` (JAX ``runtime/config.py:468-476``);
``process_world_size`` is the process group's ranks.

``Mesh`` stands for the JAX mesh where only its axis sizes are read (the
ZeRO partition rules, ``runtime/zero``; the groups, ``utils/groups.py``):
``get_global_mesh()`` is the mesh the training engine set
(``set_global_mesh``, as JAX's engine sets its own), else the data-only
mesh over the process group.  ZeRO partitions over ``ZERO_AXES`` and a
batch is split over ``BATCH_AXES``, as in JAX.
"""

import dataclasses
from typing import Dict, Optional, Tuple

import torch.distributed as dist

PIPE_AXIS = "pipe"
DATA_AXIS = "data"
EXPERT_AXIS = "expert"
SEQ_AXIS = "seq"
TENSOR_AXIS = "tensor"
MESH_AXES = (PIPE_AXIS, DATA_AXIS, EXPERT_AXIS, SEQ_AXIS, TENSOR_AXIS)
#: the axes over which ZeRO partitions parameters, gradients and optimizer state
ZERO_AXES = (DATA_AXIS, EXPERT_AXIS, SEQ_AXIS)
#: the axes over which a data batch is split
BATCH_AXES = (DATA_AXIS, EXPERT_AXIS)

ROADMAP_MULTI_DEVICE = "ROADMAP Queue 1 item 6, multi-device training (pipeline/tensor/sequence parallel)"
#: what of MoE over several ranks still raises
ROADMAP_EXPERT_PARALLEL = "ROADMAP Queue 1 item 6.1, MoE over several ranks"
#: what of tensor parallelism still raises (its part 6.2.5)
ROADMAP_TENSOR_PARALLEL = "ROADMAP Queue 1 item 6.2, tensor parallelism (its part 6.2.5, what is left)"
#: pipeline parallelism
ROADMAP_PIPELINE = "ROADMAP Queue 1 item 6.4, pipeline parallelism"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Sizes of the mesh axes; ``data=-1`` takes the ranks the others leave."""
    pipe: int = 1
    data: int = -1
    expert: int = 1
    seq: int = 1
    tensor: int = 1

    def resolve(self, world_size: int) -> Tuple[int, int, int, int, int]:
        """The axis sizes over ``world_size`` ranks, in ``MESH_AXES`` order
        (JAX ``MeshSpec.resolve``, its divisibility rule and its errors)."""
        wide = {a: getattr(self, a) for a in (PIPE_AXIS, SEQ_AXIS) if getattr(self, a) != 1}
        if wide:
            raise NotImplementedError(f"mesh axes {wide}: the port has data, expert and tensor parallelism; "
                                      f"pipeline and sequence parallelism are not ported ({ROADMAP_MULTI_DEVICE})")
        fixed = self.pipe * self.expert * self.seq * self.tensor
        data = self.data
        if data == -1:
            if world_size % fixed != 0:
                raise ValueError(f"{world_size} devices not divisible by pipe*expert*seq*tensor={fixed}")
            data = world_size // fixed
        if self.pipe * data * self.expert * self.seq * self.tensor != world_size:
            raise ValueError(f"Mesh {self} does not cover {world_size} devices (pipe={self.pipe} data={data} "
                             f"expert={self.expert} seq={self.seq} tensor={self.tensor})")
        return (self.pipe, data, self.expert, self.seq, self.tensor)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The sizes of the mesh axes (JAX ``Mesh.shape``), by axis name."""
    shape: Dict[str, int]

    def coords(self, rank: int) -> Dict[str, int]:
        """The coordinate of ``rank`` on every axis: JAX lays its devices
        out ``MESH_AXES`` row-major, the last axis fastest."""
        out = {}
        for a in reversed(MESH_AXES):
            n = self.shape.get(a, 1)
            out[a] = rank % n
            rank //= n
        return out

    def rank(self, coords: Dict[str, int]) -> int:
        """The rank at ``coords`` (absent axes at 0)."""
        r = 0
        for a in MESH_AXES:
            r = r * self.shape.get(a, 1) + coords.get(a, 0)
        return r


def create_mesh(spec: Optional[MeshSpec] = None, world_size: Optional[int] = None) -> Mesh:
    """The mesh of ``spec`` over ``world_size`` ranks (the process group's by default)."""
    spec = spec or MeshSpec()
    sizes = spec.resolve(process_world_size() if world_size is None else world_size)
    return Mesh(dict(zip(MESH_AXES, sizes)))


_GLOBAL_MESH: Optional[Mesh] = None


def set_global_mesh(mesh: Optional[Mesh]) -> None:
    """Install the mesh ``get_global_mesh`` returns (None: the data-only mesh)."""
    global _GLOBAL_MESH
    _GLOBAL_MESH = mesh


def get_global_mesh() -> Mesh:
    """The mesh the engine set, while it covers the process group's ranks;
    else the data-only mesh over them (one rank without a process group)."""
    world = process_world_size()
    if _GLOBAL_MESH is not None and axis_size(_GLOBAL_MESH, *MESH_AXES) == world:
        return _GLOBAL_MESH
    return Mesh({**dict.fromkeys(MESH_AXES, 1), DATA_AXIS: world})


def axis_size(mesh: Mesh, *axes: str) -> int:
    """The product of the sizes of ``axes`` (absent axes count 1)."""
    n = 1
    for a in axes:
        n *= mesh.shape.get(a, 1)
    return n


def _mpu_degree(mpu, names, default: int = 1) -> int:
    """The first accessor of ``names`` that ``mpu`` has (Megatron renamed
    them across versions), called; ``default`` when none is there."""
    for n in names:
        fn = getattr(mpu, n, None)
        if callable(fn):
            return int(fn())
    return default


def mesh_from_mpu(mpu, world_size: Optional[int] = None) -> Mesh:
    """The mesh of an outside Megatron-style ``mpu``'s grid (JAX
    ``mesh_from_mpu``, ``comm/mesh.py:122-147``): its tensor degree on
    ``tensor``, its data degree on ``data`` (the ranks the others leave when
    it gives none).  A grid the process group's ranks cannot hold raises
    JAX's ``ValueError`` ("needs"); pipeline stages raise naming ROADMAP
    item 6.4; a grid smaller than the process group raises ``MeshSpec``'s
    error (the port's groups span every rank)."""
    tp = _mpu_degree(mpu, ("get_tensor_model_parallel_world_size", "get_model_parallel_world_size"))
    pp = _mpu_degree(mpu, ("get_pipeline_model_parallel_world_size", "get_pipe_parallel_world_size"))
    dp = _mpu_degree(mpu, ("get_data_parallel_world_size", ), default=-1)
    n = process_world_size() if world_size is None else world_size
    need = tp * pp * (dp if dp > 0 else 1)
    if need > n:
        raise ValueError(f"mpu grid tp={tp} pp={pp} dp={dp} needs {need} devices, have {n}")
    if pp > 1:
        raise NotImplementedError(f"mpu grid with {pp} pipeline stages ({ROADMAP_PIPELINE})")
    return create_mesh(MeshSpec(data=dp if dp > 0 else -1, tensor=tp), n)


def process_world_size() -> int:
    """The ranks of the default process group (the data-parallel degree
    times the tensor degree); 1 without a process group."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
