"""Block-sparse attention (port of ``deepspeed_tpu/ops/sparse_attention``;
ref: deepspeed/ops/sparse_attention/)."""

from .kernel import SparseLayout, sparse_attention_kernel
from .sparse_attention_utils import extend_position_embedding, pad_to_block_size, unpad_sequence_output
from .sparse_self_attention import SparseSelfAttention, sparse_attention
from .sparsity_config import (BigBirdSparsityConfig, BSLongformerSparsityConfig, DenseSparsityConfig,
                              FixedSparsityConfig, LocalSlidingWindowSparsityConfig, SparsityConfig,
                              VariableSparsityConfig, make_sparsity_config)
