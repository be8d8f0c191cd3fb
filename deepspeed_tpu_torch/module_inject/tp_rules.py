"""The sharding rules of the parameters: logical axes → mesh axes (port of
``deepspeed_tpu/module_inject/tp_rules.py``: ``make_logical_rules``
:38-67 and ``vocab_rules`` :70-88).

At ZeRO stage 3 the JAX package shards every ``embed`` dim over the
data-parallel axes (``make_logical_rules`` :38-88), except on the
vocab-facing parameters (the embedding table and ``lm_head``), which shard
on their ``vocab`` dim and keep ``embed`` whole (``vocab_rules`` :70-88).
Below stage 3 the parameters are whole on every rank.  The MoE rules
(:56-63), at every stage: an expert bank's ``experts`` dim is sharded over
the ``expert`` axis; its ``expert_embed`` dim takes the stage-3 axes
without ``expert`` (which its expert dim has taken); ``expert_mlp`` takes
the tensor axis and the router's ``experts_gate`` dim stays whole.  A dim
that the partition group's size does not divide cannot be sharded: JAX
refuses the layout when it places the arrays, and the port raises a
``ValueError`` naming the tensor, the dim and the size.

The tensor axis (the Megatron layout): at ``tensor`` > 1 the ``mlp``,
``heads`` and ``kv_heads`` dims go to ``tensor`` (q/k/v, gate and up are
column-parallel; o and down row-parallel, over their contraction dim), and
a vocab-facing leaf's ``vocab`` dim takes ``tensor`` first, then the
stage-3 axes, and an expert bank's ``expert_mlp`` dim takes ``tensor``
(JAX :62; ``w_gate``/``w_up`` column-, ``w_down`` row-parallel).  The
router's ``experts_gate`` dim and Qwen2-MoE's gates (no logical axes) stay
whole.  A q/k/v bias's JAX leaf carries no logical axes, so JAX keeps it
whole on every rank; the port holds its heads' slice, and its spec puts
``tensor`` on the leaf's heads dim (the port tensor's cut dim).

A parameter whose port tensor is one rank's slice is ``held`` over the
axes it is sliced on: an expert bank that holds this rank's experts only
(``moe.ExpertsFFN`` under expert parallelism) over ``expert``, a
tensor-parallel slice (``module_inject/layers.py``, the leaf's
``tp_dim``: a layer's weight, an expert bank's) over ``tensor``, a bank
cut both ways over ``(expert, tensor)``.  ZeRO then partitions the held
slice over the data axes left, within the ranks that share the held
coordinates (``Partition.within_held``).
"""

from typing import Dict, Sequence

from ..axes import EMBED, EXPERT_EMBED, EXPERT_MLP, EXPERTS, HEADS, KV_HEADS, MLP, VOCAB
from ..comm.mesh import EXPERT_AXIS, TENSOR_AXIS, ZERO_AXES, Mesh, axis_size
from ..models.convert import JaxLeaf
from ..runtime.zero.partition import Partition, _sizes


def param_shardings(leaves: Dict[str, JaxLeaf], mesh: Mesh, zero_stage: int,
                    fsdp_axes: Sequence[str] = ZERO_AXES) -> Dict[str, Partition]:
    """The partition of each parameter (JAX ``param_shardings`` :100) from
    its JAX leaf; ``fsdp_axes`` restricts the stage-3 group (MiCS, hpZ)."""
    axes = tuple(a for a in fsdp_axes if mesh.shape.get(a, 1) > 1)
    fsdp = axes if zero_stage >= 3 and axes else ()
    expert = (EXPERT_AXIS, ) if mesh.shape.get(EXPERT_AXIS, 1) > 1 else ()
    tensor = (TENSOR_AXIS, ) if mesh.shape.get(TENSOR_AXIS, 1) > 1 else ()
    rules = {EXPERTS: expert, EXPERT_EMBED: tuple(a for a in fsdp if a != EXPERT_AXIS), MLP: tensor, HEADS: tensor,
             KV_HEADS: tensor, EXPERT_MLP: tensor}
    out = {}
    for name, leaf in leaves.items():
        # a vocab-facing leaf shards its vocab dim (tensor, then the stage-3
        # axes) and keeps embed whole
        mapping = {**rules, VOCAB: tensor + fsdp} if VOCAB in leaf.logical else {**rules, EMBED: fsdp}
        spec = tuple(mapping.get(ax, ()) for ax in leaf.logical) if leaf.logical else ((), ) * len(leaf.shape)
        if tensor and leaf.tp_dim is not None and not any(TENSOR_AXIS in entry for entry in spec):
            # a slice of a leaf JAX keeps whole (a q/k/v bias [N, D], cut on
            # its leading heads dim like the port tensor [N·D])
            if leaf.transposed or leaf.tp_dim != 0:
                raise ValueError(f"{name!r}: a tensor slice of a leaf without a tensor axis is cut on dim "
                                 f"{leaf.tp_dim} of a {'transposed ' if leaf.transposed else ''}port tensor")
            spec = (tensor, ) + spec[1:]
        for d, entry in enumerate(spec):
            if entry and leaf.shape[d] % axis_size(mesh, *entry):
                raise ValueError(f"the layout shards dim {d} ({leaf.logical[d]}, size {leaf.shape[d]}) of {name!r} "
                                 f"(JAX shape {leaf.shape}) over {axis_size(mesh, *entry)} ranks, which do not "
                                 f"divide it")
        used = tuple(a for entry in spec for a in entry)
        held = expert if expert and leaf.port_shape[0] != leaf.shape[0] and EXPERTS in leaf.logical else ()
        if tensor and leaf.tp_dim is not None:
            held = held + tensor
        out[name] = Partition(name, leaf.port_shape, leaf.shape, leaf.transposed, spec, axis_size(mesh, *used),
                              _sizes(mesh), held)
    return out
