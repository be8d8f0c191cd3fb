"""The sharding rules of the parameters: logical axes → mesh axes (port of
the ZeRO-3 part of ``deepspeed_tpu/module_inject/tp_rules.py``).

At ZeRO stage 3 the JAX package shards every ``embed`` dim over the
data-parallel axes (``make_logical_rules`` :38-88), except on the
vocab-facing parameters (the embedding table and ``lm_head``), which shard
on their ``vocab`` dim and keep ``embed`` whole (``vocab_rules`` :70-88).
Below stage 3 the parameters are whole on every rank.  A dim that the
partition group's size does not divide cannot be sharded: JAX refuses the
layout when it places the arrays, and the port raises a ``ValueError``
naming the tensor, the dim and the size.

The port's mesh has the data axis only (``comm/mesh.py``), so the tensor
axis, which the JAX rules also place here, stays at 1.
"""

from typing import Dict, Sequence

from ..axes import EMBED, VOCAB
from ..comm.mesh import ROADMAP_MULTI_DEVICE, TENSOR_AXIS, ZERO_AXES, Mesh, axis_size
from ..models.convert import JaxLeaf
from ..runtime.zero.partition import Partition


def param_shardings(leaves: Dict[str, JaxLeaf], mesh: Mesh, zero_stage: int,
                    fsdp_axes: Sequence[str] = ZERO_AXES) -> Dict[str, Partition]:
    """The partition of each parameter (JAX ``param_shardings`` :100) from
    its JAX leaf; ``fsdp_axes`` restricts the stage-3 group (MiCS, hpZ)."""
    if mesh.shape.get(TENSOR_AXIS, 1) > 1:
        raise NotImplementedError(f"tensor parallelism ({TENSOR_AXIS}={mesh.shape[TENSOR_AXIS]}) is not ported "
                                  f"({ROADMAP_MULTI_DEVICE})")
    axes = tuple(a for a in fsdp_axes if mesh.shape.get(a, 1) > 1)
    fsdp = axes if zero_stage >= 3 and axes else ()
    size = axis_size(mesh, *fsdp)
    out = {}
    for name, leaf in leaves.items():
        target = VOCAB if VOCAB in leaf.logical else EMBED
        spec = tuple(fsdp if ax == target else () for ax in leaf.logical) if leaf.logical else \
            ((), ) * len(leaf.shape)
        for d, entry in enumerate(spec):
            if entry and leaf.shape[d] % size:
                raise ValueError(f"ZeRO stage 3 shards dim {d} ({leaf.logical[d]}, size {leaf.shape[d]}) of "
                                 f"{name!r} (JAX shape {leaf.shape}) over {size} ranks, which do not divide it")
        out[name] = Partition(name, leaf.port_shape, leaf.shape, leaf.transposed, spec, size if any(spec) else 1)
    return out
