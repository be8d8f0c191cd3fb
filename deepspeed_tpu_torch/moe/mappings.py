"""MoE ↔ tensor-parallel token mappings (port of
``deepspeed_tpu/moe/mappings.py``; ref: ``deepspeed/moe/mappings.py``).

Under tensor parallelism each rank holds every token, so before the
experts a rank keeps its 1/tp slice of the tokens (``drop_tokens``) and
after the combine the slices are gathered back (``gather_tokens``).  At size 1
both are the identity; MoE over tensor-parallel ranks is the second part
of ROADMAP item 6.2, and a larger size raises.
"""

import torch

from ..comm.mesh import ROADMAP_TENSOR_PARALLEL


def _check(tensor_parallel_size: int) -> None:
    if tensor_parallel_size != 1:
        raise NotImplementedError(f"MoE token mappings over {tensor_parallel_size} tensor-parallel ranks are not "
                                  f"ported ({ROADMAP_TENSOR_PARALLEL})")


def drop_tokens(x: torch.Tensor, dim: int = 1, tensor_parallel_size: int = 1) -> torch.Tensor:
    """This rank's slice of the token dim ``dim`` (ref ``mappings.py:113``)."""
    _check(tensor_parallel_size)
    return x


def gather_tokens(x: torch.Tensor, dim: int = 1, tensor_parallel_size: int = 1) -> torch.Tensor:
    """The token dim ``dim`` gathered over the ranks (ref ``mappings.py:105``)."""
    _check(tensor_parallel_size)
    return x
