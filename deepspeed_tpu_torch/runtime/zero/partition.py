"""ZeRO stages as partitions of each tensor over the data-parallel ranks
(port of ``deepspeed_tpu/runtime/zero/partition.py``).

The JAX package makes each stage a sharding of every leaf over the ``data``
mesh axis and lets GSPMD insert the collectives:

  stage 0 — parameters, gradients and optimizer state replicated;
  stage 1 — the float32 master and the moments sharded;
  stage 2 — the gradients too (reduce-scattered onto the state's shards);
  stage 3 — the parameters too (``module_inject/tp_rules.py``).

The port keeps the rule and gives each tensor a ``Partition``: the dim of
its JAX leaf that is sharded (or none) over ``world`` ranks.  Rank r holds
the r-th of ``world`` equal slices of the JAX leaf along that dim.  The rule
reads the JAX leaf's shape, not the port tensor's: a flax kernel is the
transpose of an ``nn.Linear`` weight (``q_proj`` is ``[E, H, D]`` in JAX
and ``[H·D, E]`` here), and the first divisible dim of ``o_proj``'s
``[H, D, E]`` may be the head dim.  Each tensor's JAX leaf comes from
``models/convert.py`` (``jax_leaves``), as the JAX package partitions its
unrolled tree (``scan_layers=False``): one leaf per port tensor.

A slice is a view of the port tensor (``Partition.jax_view`` then
``local``); ``runtime/zero/partitioned.py`` moves them between the ranks.
"""

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from ...comm.mesh import ZERO_AXES, Mesh, axis_size

#: a partition spec: per dim of the JAX leaf, the mesh axes it is sharded
#: over (a tuple, empty where the dim is whole)
Spec = Tuple[Tuple[str, ...], ...]


@dataclasses.dataclass(frozen=True)
class Partition:
    """How one port tensor is split over the ranks.

    ``shape`` is the port tensor's, ``jax_shape`` its JAX leaf's
    (``transposed``: the port tensor is the leaf's transpose, reshaped);
    ``spec`` the leaf's partition spec, ``world`` the number of slices."""
    name: str
    shape: Tuple[int, ...]
    jax_shape: Tuple[int, ...]
    transposed: bool
    spec: Spec
    world: int

    @property
    def dim(self) -> Optional[int]:
        """The sharded dim of the JAX leaf, None when the tensor is whole on every rank."""
        for d, axes in enumerate(self.spec):
            if axes:
                return d
        return None

    @property
    def sharded(self) -> bool:
        return self.dim is not None and self.world > 1

    @property
    def local_shape(self) -> Tuple[int, ...]:
        if not self.sharded:
            return self.jax_shape
        d = self.dim
        return self.jax_shape[:d] + (self.jax_shape[d] // self.world, ) + self.jax_shape[d + 1:]

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

    def local(self, j: torch.Tensor, rank: int) -> torch.Tensor:
        """Rank ``rank``'s slice of the JAX-shaped ``j`` (a view; all of it
        when the tensor is whole)."""
        if not self.sharded:
            return j
        n = self.jax_shape[self.dim] // self.world
        return j.narrow(self.dim, rank * n, n)


def _active(mesh: Mesh, zero_axes: Sequence[str]) -> Tuple[str, ...]:
    return tuple(a for a in zero_axes if mesh.shape.get(a, 1) > 1)


def zero_shard_spec(spec: Spec, shape: Tuple[int, ...], mesh: Mesh, zero_axes=ZERO_AXES) -> Spec:
    """Add the ZeRO axes to a spec (JAX ``zero_shard_spec`` :39): a spec
    that already carries them is kept; otherwise the first dim that is
    whole and divisible by their size (and at least as large) is sharded
    over them; if none divides, the tensor stays whole."""
    axes = _active(mesh, zero_axes)
    if not axes:
        return spec
    if any(a in axes for entry in spec for a in entry):
        return spec
    size = axis_size(mesh, *axes)
    for d, dim in enumerate(shape):
        if not spec[d] and dim % size == 0 and dim >= size:
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
