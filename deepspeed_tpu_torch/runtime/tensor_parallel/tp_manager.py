"""AutoTP's training manager (port of
``deepspeed_tpu/runtime/tensor_parallel/tp_manager.py``; ref:
``runtime/tensor_parallel/tp_manager.py:12`` ``TpTrainingManager`` and
``tensor_parallel/config.py:38`` ``TPTrainingConfig``).

The manager classifies each kernel of a parameter tree by AutoTP's name
heuristic (``module_inject/auto_tp.py:193`` ``tp_parser``): a module whose
dotted path ends in one of ``ROW_PARALLEL_PATTERNS`` (word-boundary
matched, so ``wo`` does not hit ``word_embeddings``) is row-parallel, its
first contraction dim sharded over ``tensor``; every other kernel of two or
more dims is column-parallel, its output heads dim (``[E, H, D]`` kernels)
or else its last dim sharded; the leading layer axis of a stacked
(scan-over-layers) tree is never sharded.  ``plan`` gives each leaf's JAX
``PartitionSpec`` as a tuple (an axis name or None per dim, ``()``
replicated), by the JAX path names (``model.layers.self_attn.q_proj.
kernel``); ``shardings`` gives the tree of ``runtime/zero.Partition``s.

The engine's own layout for the Llama family (``module_inject/tp_rules.py``
on the model's logical axes, the layers of ``module_inject/layers.py``)
does not need the manager: it covers trees without logical axes, as JAX's.
"""

import re
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from ...comm.mesh import TENSOR_AXIS, Mesh, axis_size
from ...utils.logging import log_dist
from ..zero.partition import Partition, _sizes

#: module-name suffixes that are ROW-parallel (contraction dim sharded, the
#: forward ends in the tensor all-reduce): the reference's AutoTP "allreduce
#: linears"
ROW_PARALLEL_PATTERNS = ("o_proj", "out_proj", "down_proj", "dense_4h_to_h", "attention.dense", "fc2", "wo")


@dataclass
class TPTrainingConfig:
    """ref: ``tensor_parallel/config.py:38``."""
    autotp_size: int = 1
    tensor_parallel: Optional[Dict] = None
    injection_policy_tuple: Optional[Tuple] = None
    keep_module_on_host: bool = False
    tp_grain_size: int = 1


def _is_row(path: str) -> bool:
    return any(re.search(rf"(^|\.){re.escape(p)}(\.|$)", path) for p in ROW_PARALLEL_PATTERNS)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf) if isinstance(leaf, (tuple, list)) else ()


class TpTrainingManager:
    """ref: ``tp_manager.py:12``: builds the tensor-parallel sharding plan."""

    def __init__(self, model=None, tp_size: int = 1, dtype=None, config: Optional[TPTrainingConfig] = None):
        self.module = model
        self.tp_size = config.autotp_size if config and config.autotp_size > 1 else tp_size
        self.config = config or TPTrainingConfig(autotp_size=self.tp_size)

    def plan(self, abs_params: Dict[str, Any], mesh: Mesh) -> Dict[str, Tuple[Optional[str], ...]]:
        """Dotted path → the leaf's spec (an axis name or None per dim; ``()``
        replicated), for every leaf of the nested dict ``abs_params`` (leaves
        with a ``shape``: tensors, arrays, or shape tuples)."""
        tp = mesh.shape.get(TENSOR_AXIS, 1)
        out: Dict[str, Tuple[Optional[str], ...]] = {}

        def walk(tree, prefix=()):
            if isinstance(tree, dict):
                for k, v in tree.items():
                    walk(v, prefix + (str(k), ))
                return
            path = ".".join(prefix)
            shape = _shape(tree)
            # scan-over-layers trees stack a leading layer axis: never shard it
            stacked = "layers" in prefix and len(shape) >= 3
            base = 1 if stacked else 0
            eff = shape[base:]
            spec = [None] * len(shape)
            if tp <= 1 or len(eff) < 2:
                out[path] = ()
                return
            if _is_row(path):
                # row-parallel: the first contraction dim (heads of [H, D, E] kernels)
                if eff[0] % tp == 0:
                    spec[base] = TENSOR_AXIS
            else:
                # column-parallel: the output heads dim of [E, H, D] kernels, else the last dim
                tgt = base + 1 if len(eff) >= 3 else len(shape) - 1
                if shape[tgt] % tp == 0:
                    spec[tgt] = TENSOR_AXIS
                elif shape[-1] % tp == 0:
                    spec[-1] = TENSOR_AXIS
            out[path] = tuple(spec)

        walk(abs_params)
        n_row = sum(1 for s in out.values() if s and s[0] == TENSOR_AXIS)
        log_dist(f"TpTrainingManager: tp={tp}, {n_row} row-parallel / {len(out) - n_row} col-or-replicated params",
                 ranks=[0])
        return out

    def shardings(self, abs_params: Dict[str, Any], mesh: Mesh):
        """The tree of ``abs_params`` with each leaf's ``Partition`` over
        ``mesh`` (its shape as the leaf's; the rank at coordinate t holds
        slice t of its sharded dim)."""
        plan = self.plan(abs_params, mesh)

        def to_part(tree, prefix=()):
            if isinstance(tree, dict):
                return {k: to_part(v, prefix + (str(k), )) for k, v in tree.items()}
            path = ".".join(prefix)
            shape = _shape(tree)
            spec = tuple(() if a is None else (a, ) for a in plan[path]) or ((), ) * len(shape)
            used = tuple(a for entry in spec for a in entry)
            return Partition(path, shape, shape, False, spec, axis_size(mesh, *used), _sizes(mesh))

        return to_part(abs_params)
