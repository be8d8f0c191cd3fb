"""Helpers for integrating sparse attention into models (port of
``deepspeed_tpu/ops/sparse_attention/sparse_attention_utils.py``, on tensors).

ref: deepspeed/ops/sparse_attention/sparse_attention_utils.py
(SparseAttentionUtils: pad_to_block_size, unpad_sequence_output,
extend_position_embedding).
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F


def pad_to_block_size(block: int, input_ids: Optional[torch.Tensor], attention_mask=None, token_type_ids=None,
                      position_ids=None, inputs_embeds=None, pad_token_id: int = 0):
    """Right-pad sequence tensors (sequence on dim 1) to a multiple of the
    block size.  Returns ``(pad_len, input_ids, attention_mask,
    token_type_ids, position_ids, inputs_embeds)``, padded; ``input_ids``
    with ``pad_token_id``, the others with 0."""
    ref = input_ids if input_ids is not None else inputs_embeds
    pad_len = (-ref.shape[1]) % block

    def pad(x, value=0):
        if x is None or pad_len == 0:
            return x
        return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad_len), value=value)

    return (pad_len, pad(input_ids, pad_token_id), pad(attention_mask), pad(token_type_ids), pad(position_ids),
            pad(inputs_embeds))


def unpad_sequence_output(pad_len: int, sequence_output: torch.Tensor) -> torch.Tensor:
    """Drop the ``pad_len`` positions ``pad_to_block_size`` added."""
    if pad_len == 0:
        return sequence_output
    return sequence_output[:, :-pad_len]


def extend_position_embedding(pos_embedding: torch.Tensor, max_position: int) -> torch.Tensor:
    """Tile learned position embeddings ``[P, E]`` to ``max_position`` rows
    (a longer context than the model was trained on), or cut them."""
    cur = pos_embedding.shape[0]
    if max_position <= cur:
        return pos_embedding[:max_position]
    return pos_embedding.repeat(math.ceil(max_position / cur), 1)[:max_position]
