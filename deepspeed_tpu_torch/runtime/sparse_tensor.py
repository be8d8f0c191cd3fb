"""Sparse gradient container (port of ``deepspeed_tpu/runtime/sparse_tensor.py``;
ref: ``runtime/sparse_tensor.py`` ``SparseTensor`` and the engine's
``sparse_allreduce``).

The index/value form of a row-sparse tensor (an embedding's gradient): the
indices of its nonzero rows and those rows.  ``sparse_allreduce``
concatenates every rank's pairs in rank order, an all-gather of the indices
and of the values over the process group (JAX :60-66).  A rank's count of
rows may differ from another's: the counts are gathered first, each rank's
pairs padded to the largest, gathered, and the padding cut away.
"""

import math
from typing import Optional, Tuple

import torch

from ..comm import comm


class SparseTensor:
    """ref: runtime/sparse_tensor.py:SparseTensor."""

    def __init__(self, dense_tensor: Optional[torch.Tensor] = None, indices: Optional[torch.Tensor] = None,
                 values: Optional[torch.Tensor] = None, dense_size=None):
        if dense_tensor is not None:
            rows = (dense_tensor != 0).reshape(dense_tensor.shape[0], -1).any(dim=1)
            self.indices = torch.nonzero(rows).reshape(-1)
            self.values = dense_tensor[self.indices]
            self.dense_size = tuple(dense_tensor.shape)
        else:
            self.indices = indices
            self.values = values
            self.dense_size = tuple(dense_size)

    @staticmethod
    def type() -> str:
        return "deepspeed_tpu_torch.runtime.sparse_tensor.SparseTensor"

    def to_coo_tensor(self) -> torch.Tensor:
        return torch.sparse_coo_tensor(self.indices[None, :], self.values, self.dense_size, check_invariants=True)

    def to_dense(self) -> torch.Tensor:
        out = self.values.new_zeros(self.dense_size)
        return out.index_add_(0, self.indices, self.values)

    def sparse_size(self) -> Tuple[int, int]:
        """``(elements held, elements of the dense tensor)``."""
        return self.values.numel() + self.indices.numel(), math.prod(self.dense_size)


def sparse_allreduce(st: SparseTensor, group=None) -> SparseTensor:
    """Every rank's ``(indices, values)`` concatenated in rank order (ref:
    engine.py:2719 sparse_allreduce; JAX :60)."""
    world = comm.get_world_size(group)
    if world == 1:
        return SparseTensor(indices=st.indices, values=st.values, dense_size=st.dense_size)
    count = torch.tensor([st.indices.numel()], dtype=torch.int64, device=st.indices.device)
    counts = count.new_empty(world)
    comm.all_gather_into_tensor(counts, count, group=group)
    n = int(counts.max())
    row = st.values.shape[1:]
    idx = st.indices.new_zeros(n)
    idx[:st.indices.numel()] = st.indices
    vals = st.values.new_zeros((n, ) + tuple(row))
    vals[:st.values.shape[0]] = st.values
    all_idx = idx.new_empty(world * n)
    all_vals = vals.new_empty((world * n, ) + tuple(row))
    comm.all_gather_into_tensor(all_idx, idx, group=group)
    comm.all_gather_into_tensor(all_vals, vals.contiguous(), group=group)
    keep = torch.cat([torch.arange(r * n, r * n + int(c), device=all_idx.device) for r, c in enumerate(counts.tolist())])
    return SparseTensor(indices=all_idx[keep], values=all_vals[keep], dense_size=st.dense_size)
