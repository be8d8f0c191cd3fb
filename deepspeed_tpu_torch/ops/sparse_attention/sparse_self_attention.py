"""Block-sparse self-attention: the gather-based golden and the
``SparseSelfAttention`` wrapper (port of
``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``).

ref: deepspeed/ops/sparse_attention/sparse_self_attention.py.  For each
(head, query block row) the golden gathers the key/value blocks the static
layout admits and runs a dense ``[block × L·block]`` attention on them; per
head rows with fewer admitted blocks are padded to the widest row L and the
padding is masked.  It is differentiable through autograd and takes a
``key_padding_mask``.  The kernel path (``kernel.py``, K6a–c on a GPU)
computes the same function without the gather.
"""

import math
from typing import Optional

import numpy as np
import torch

from .kernel import SparseLayout, sparse_attention_kernel
from .sparsity_config import SparsityConfig


def _row_gather_maps(layout: np.ndarray):
    """layout [H, nb, nb] → cols [H, nb, L] int32 (active col-block ids,
    ascending, padded with 0), valid [H, nb, L] bool; L is the widest row."""
    h, nb, _ = layout.shape
    nz = np.asarray(layout) != 0
    counts = nz.sum(-1)
    width = max(int(counts.max()), 1)
    cols = np.zeros((h, nb, width), np.int32)
    valid = np.zeros((h, nb, width), bool)
    hh, rr, cc = np.nonzero(nz)
    starts = np.cumsum(counts.reshape(-1)) - counts.reshape(-1)
    slot = np.arange(cc.size) - starts[hh * nb + rr]
    cols[hh, rr, slot] = cc
    valid[hh, rr, slot] = True
    return cols, valid


def sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, layout: np.ndarray, block: int,
                     causal: bool = False, scale: Optional[float] = None, key_padding_mask=None) -> torch.Tensor:
    """q, k, v: [B, H, S, D] → [B, H, S, D] attending only where layout = 1.

    ``layout``: static [H, nb, nb] 0/1 (nb = S / block).  ``causal`` applies
    token-level causality *within* the admitted blocks (the layout itself
    should already be lower-triangular for unidirectional configs).
    ``key_padding_mask`` [B, S]: True keeps a key.  A row with no key left
    emits zeros.
    """
    b, h, s, d = q.shape
    nb = s // block
    layout = np.asarray(layout)
    assert layout.shape == (h, nb, nb), f"layout {layout.shape} != {(h, nb, nb)}"
    cols_np, valid_np = _row_gather_maps(layout)
    width = cols_np.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    dev = q.device
    cols = torch.from_numpy(cols_np).to(dev, torch.long)      # [H, nb, L]
    valid = torch.from_numpy(valid_np).to(dev)
    heads = torch.arange(h, device=dev)[:, None, None]

    def gather_blocks(x):
        # [B, H, S, D] → [B, H, nb, L·block, D]: per head the admitted blocks
        # of each row, never an nb×nb temporary
        return x.reshape(b, h, nb, block, d)[:, heads, cols].reshape(b, h, nb, width * block, d)

    qb = q.reshape(b, h, nb, block, d)
    scores = torch.einsum("bhrqd,bhrkd->bhrqk", qb, gather_blocks(k)) * scale   # [B, H, nb, block, L·block]

    # mask: padded blocks, optional causal within gathered keys, padding mask
    mask = valid.repeat_interleave(block, dim=-1)[None, :, :, None, :]
    if causal:
        ar = torch.arange(block, device=dev)
        q_pos = torch.arange(nb, device=dev)[:, None] * block + ar[None, :]            # [nb, block]
        k_pos = (cols[..., None] * block + ar).reshape(h, nb, width * block)            # [H, nb, L·block]
        mask = mask & (q_pos[None, None, :, :, None] >= k_pos[None, :, :, None, :])
    if key_padding_mask is not None:
        kp = torch.as_tensor(key_padding_mask, device=dev).to(torch.bool).reshape(b, nb, block)   # True = keep
        mask = mask & kp[:, cols].reshape(b, h, nb, width * block)[:, :, :, None, :]
    scores = torch.where(mask, scores, torch.finfo(scores.dtype).min)

    probs = torch.softmax(scores, dim=-1)
    # rows with zero admitted keys (fully masked) produce nan-free zeros
    probs = torch.where(mask.any(-1, keepdim=True), probs, 0.0)
    out = torch.einsum("bhrqk,bhrkd->bhrqd", probs, gather_blocks(v))
    return out.reshape(b, h, s, d)


class SparseSelfAttention:
    """Callable bound to a ``SparsityConfig`` (ref:
    sparse_self_attention.py:SparseSelfAttention, a torch module there; here,
    as in the JAX package, a layout cache and a functional apply).

    ``impl="kernel"`` (the default; JAX's ``"pallas"``) runs
    ``sparse_attention_kernel``: K6a–c on CUDA tensors, their plain versions
    on CPU tensors, with ``key_padding_mask`` read by the kernels.
    ``impl="plain"`` (JAX's ``"jnp"``) runs the gather-based golden
    ``sparse_attention``.  JAX defaults to ``"jnp"`` because off the TPU its
    kernel runs in the Pallas interpreter; here the kernel path is the one
    meant to run on the card, and the golden is never on it.
    """

    def __init__(self, sparsity_config: SparsityConfig, key_padding_mask_mode="add", attn_mask_mode="mul",
                 impl: str = "kernel"):
        if impl not in ("kernel", "plain"):
            raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
        self.impl = impl
        self.sparsity_config = sparsity_config
        self._layouts = {}
        self._sparse_layouts = {}

    def get_layout(self, seq_len: int) -> np.ndarray:
        if seq_len not in self._layouts:
            self._layouts[seq_len] = np.asarray(self.sparsity_config.make_layout(seq_len))
        return self._layouts[seq_len]

    def get_sparse_layout(self, seq_len: int) -> SparseLayout:
        """The layout of ``seq_len`` with its index tables, kept per device."""
        if seq_len not in self._sparse_layouts:
            self._sparse_layouts[seq_len] = SparseLayout(self.get_layout(seq_len), self.sparsity_config.block)
        return self._sparse_layouts[seq_len]

    def __call__(self, query, key, value, key_padding_mask=None, causal=None):
        s = query.shape[2]
        causal = (self.sparsity_config.attention == "unidirectional") \
            if causal is None and hasattr(self.sparsity_config, "attention") else bool(causal)
        block = self.sparsity_config.block
        if self.impl == "kernel":
            return sparse_attention_kernel(query, key, value, self.get_sparse_layout(s), block, causal=causal,
                                           key_padding_mask=key_padding_mask)
        return sparse_attention(query, key, value, self.get_layout(s), block, causal=causal,
                                key_padding_mask=key_padding_mask)
