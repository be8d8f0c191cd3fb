"""ZeRO stages as partitions of each tensor over the data-parallel ranks
(port of ``deepspeed_tpu/runtime/zero/partition.py``).

The JAX package makes each stage a sharding of every leaf over the ZeRO
mesh axes and lets GSPMD insert the collectives:

  stage 0 — parameters, gradients and optimizer state replicated;
  stage 1 — the float32 master and the moments sharded;
  stage 2 — the gradients too (reduce-scattered onto the state's shards);
  stage 3 — the parameters too (``module_inject/tp_rules.py``).

The port keeps the rule and gives each tensor a ``Partition``: its JAX
leaf's partition spec (per dim, the mesh axes it is sharded over) on the
mesh's axis sizes.  The rank at mesh coordinate c holds, on each sharded
dim, the slice whose index is c's mixed radix over that dim's axes (the
first axis slowest), as JAX places a ``PartitionSpec``: at data 2 ×
expert 2 a dim over ``(data, expert)`` gives rank ``d·2 + e`` its slice,
an expert dim over ``(expert, data)`` gives it slice ``e·2 + d``.  The rule
reads the JAX leaf's shape, not the port tensor's: a flax kernel is the
transpose of an ``nn.Linear`` weight (``q_proj`` is ``[E, H, D]`` in JAX
and ``[H·D, E]`` here), and the first divisible dim of ``o_proj``'s
``[H, D, E]`` may be the head dim.  Each tensor's JAX leaf comes from
``models/convert.py`` (``jax_leaves``), as the JAX package partitions its
unrolled tree (``scan_layers=False``): one leaf per port tensor.

An expert bank under expert parallelism is itself one rank's slice over
the ``expert`` axis (``held``), and so is a tensor-parallel layer's weight
over the ``tensor`` axis, and a bank cut both ways over both: ``Partition.within_held`` is the partition of
that port tensor over the remaining axes, on the ranks that hold the same
slice (``group="expert_data"``, ranked by their ``d``, for a bank; at
``tensor`` > 1 every tensor's, held or replicated on the tensor axis, is
over the data-parallel group of its ``t``, ``group="data"``, ranked by
their ``d``).  That is the partition ``runtime/zero/partitioned.py`` moves
between the ranks; its slices are views of the port tensor (``jax_view``
then ``local``).
"""

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from ...comm.mesh import EXPERT_AXIS, MESH_AXES, TENSOR_AXIS, ZERO_AXES, Mesh, axis_size

#: a partition spec: per dim of the JAX leaf, the mesh axes it is sharded
#: over (a tuple, empty where the dim is whole)
Spec = Tuple[Tuple[str, ...], ...]


def _sizes(mesh: Mesh) -> Tuple[Tuple[str, int], ...]:
    return tuple((a, mesh.shape.get(a, 1)) for a in MESH_AXES)


@dataclasses.dataclass(frozen=True)
class Partition:
    """How one port tensor is split over the ranks.

    ``shape`` is the port tensor's, ``jax_shape`` its JAX leaf's
    (``transposed``: the port tensor is the leaf's transpose, reshaped);
    ``spec`` the leaf's partition spec, ``world`` the number of distinct
    slices; ``mesh`` the axis sizes; ``held`` the axes over which the port tensor is already one rank's
    slice; ``group`` the ranks ``local``'s rank counts in (None: all of
    them; ``"expert_data"``: those holding the same experts; ``"data"``:
    the data-parallel group, those of one tensor coordinate)."""
    name: str
    shape: Tuple[int, ...]
    jax_shape: Tuple[int, ...]
    transposed: bool
    spec: Spec
    world: int
    mesh: Tuple[Tuple[str, int], ...]
    held: Tuple[str, ...] = ()
    group: Optional[str] = None

    @property
    def dims(self) -> Tuple[int, ...]:
        """The sharded dims of the JAX leaf."""
        return tuple(d for d, axes in enumerate(self.spec) if axes)

    @property
    def dim(self) -> Optional[int]:
        """The first sharded dim of the JAX leaf, None when the tensor is whole on every rank."""
        return self.dims[0] if self.dims else None

    @property
    def sharded(self) -> bool:
        return self.dim is not None and self.world > 1

    def _size(self, axes: Sequence[str]) -> int:
        sizes = dict(self.mesh)
        return math.prod(sizes.get(a, 1) for a in axes)

    @property
    def local_shape(self) -> Tuple[int, ...]:
        if not self.sharded:
            return self.jax_shape
        return tuple(n // self._size(axes) for n, axes in zip(self.jax_shape, self.spec))

    @property
    def local_numel(self) -> int:
        return math.prod(self.local_shape)

    def jax_view(self, t: torch.Tensor) -> torch.Tensor:
        """The port tensor ``t`` seen as the JAX leaf (a view)."""
        return (t.t() if self.transposed else t).reshape(self.jax_shape)

    def port_view(self, j: torch.Tensor) -> torch.Tensor:
        """The JAX-shaped ``j`` seen as the port tensor."""
        if self.transposed:
            return j.reshape(self.shape[1], self.shape[0]).t()
        return j.reshape(self.shape)

    def index(self, d: int, rank: int) -> int:
        """Which slice of dim ``d`` ``rank`` holds: its coordinates' mixed
        radix over the dim's axes, the first slowest."""
        mesh = Mesh(dict(self.mesh))
        at = mesh.coords(rank)
        i = 0
        for a in self.spec[d]:
            i = i * mesh.shape.get(a, 1) + at[a]
        return i

    def local(self, j: torch.Tensor, rank: int) -> torch.Tensor:
        """Rank ``rank``'s slice of the JAX-shaped ``j`` (a view; all of it
        when the tensor is whole); ``rank`` counts in ``group``."""
        if not self.sharded:
            return j
        for d in self.dims:
            n = self.jax_shape[d] // self._size(self.spec[d])
            j = j.narrow(d, self.index(d, rank) * n, n)
        return j

    def within_held(self) -> "Partition":
        """The partition of the port tensor over the axes it does not hold
        (itself when it holds none and the tensor axis is 1): its JAX shape
        is this rank's slice over ``held``, its ranks those that share the
        held coordinates and the tensor coordinate."""
        sizes = dict(self.mesh)
        drop = set(self.held) | ({TENSOR_AXIS} if sizes.get(TENSOR_AXIS, 1) > 1 else set())
        if not drop:
            return self
        jax_shape = tuple(n // math.prod(sizes[a] for a in axes if a in self.held)
                          for n, axes in zip(self.jax_shape, self.spec))
        spec = tuple(tuple(a for a in axes if a not in drop) for axes in self.spec)
        mesh = tuple((a, 1 if a in drop else n) for a, n in self.mesh)
        world = math.prod(dict(mesh)[a] for axes in spec for a in axes)
        group = "expert_data" if EXPERT_AXIS in self.held else "data"
        return Partition(self.name, self.shape, jax_shape, self.transposed, spec, world, mesh, (), group)


def _active(mesh: Mesh, zero_axes: Sequence[str]) -> Tuple[str, ...]:
    return tuple(a for a in zero_axes if mesh.shape.get(a, 1) > 1)


def zero_shard_spec(spec: Spec, shape: Tuple[int, ...], mesh: Mesh, zero_axes=ZERO_AXES) -> Spec:
    """Add the ZeRO axes to a spec (JAX ``zero_shard_spec`` :39).  A dim
    that carries some of them already (an expert bank's ``expert`` dim, an
    hpZ parameter) is extended with those no dim uses, if the extended
    group divides it, else they go on the first whole dim they divide (a
    spec that uses them all is kept).  Otherwise the first whole dim
    divisible by their size (and at least as large) is sharded over them;
    if none divides, the tensor stays whole."""
    axes = _active(mesh, zero_axes)
    if not axes:
        return spec
    entries = list(spec)
    used = {a for entry in entries for a in entry}
    for d, cur in enumerate(entries):
        if not any(a in axes for a in cur):
            continue
        missing = tuple(a for a in axes if a not in used)
        if not missing:
            return spec
        full = cur + missing
        if shape[d] % axis_size(mesh, *full) == 0:
            entries[d] = full
            return tuple(entries)
        msize = axis_size(mesh, *missing)
        for d2, n in enumerate(shape):
            if not entries[d2] and n % msize == 0 and n >= msize:
                entries[d2] = missing
                return tuple(entries)
        return spec
    size = axis_size(mesh, *axes)
    for d, n in enumerate(shape):
        if not spec[d] and n % size == 0 and n >= size:
            return spec[:d] + (axes, ) + spec[d + 1:]
    return spec


def _shard_like(parts: Dict[str, Partition], mesh: Mesh, add_zero: bool, zero_axes) -> Dict[str, Partition]:
    out = {}
    for name, p in parts.items():
        spec = zero_shard_spec(p.spec, p.jax_shape, mesh, zero_axes) if add_zero else p.spec
        used = tuple(a for entry in spec for a in entry)
        out[name] = dataclasses.replace(p, spec=spec, world=axis_size(mesh, *used))
    return out


def master_and_optstate_shardings(param_parts: Dict[str, Partition], mesh: Mesh, stage: int,
                                  zero_axes=ZERO_AXES) -> Dict[str, Partition]:
    """The partition of the float32 master and the moments: the ZeRO axes
    added from stage 1 (JAX :102)."""
    return _shard_like(param_parts, mesh, stage >= 1, zero_axes)


def grad_shardings(param_parts: Dict[str, Partition], mesh: Mesh, stage: int,
                   zero_axes=ZERO_AXES) -> Dict[str, Partition]:
    """The partition the reduced gradients land in: the ZeRO axes added
    from stage 2 (JAX :113); below, the gradients are summed whole."""
    return _shard_like(param_parts, mesh, stage >= 2, zero_axes)


def estimate_partitioned_bytes(parts: Sequence[Partition], dtype_bytes: int = 4) -> int:
    """The bytes one rank holds of the tensors ``parts`` (JAX :121, which
    divides every tensor by the mesh's device count; here a whole tensor
    counts whole)."""
    return sum(p.local_numel * dtype_bytes for p in parts)
