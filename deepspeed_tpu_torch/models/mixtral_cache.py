"""Mixtral with paged KV cache (port of ``deepspeed_tpu/models/mixtral_cache.py``;
ref: ``inference/v2/model_implementations/mixtral``).

The Llama twin's contract (``hidden`` + ``logits``, the arena written in
place, K3 through ``paged_attention_core``) with the dense SwiGLU MLP
replaced by the top-k-routed expert bank, called with ``train=False`` as
JAX's twin calls it.  ``build_cache_model`` serves it dropless, as JAX's
does (``engine_v2.py:43-51``): capacity is every token of the step, the
layer's shapes are static and it syncs with no host, so the engine
captures the step as a CUDA graph.  The router's loss is dropped.
Names are the training model's (``mixtral.py``), so one state dict serves
both.  Over ``tensor_parallel`` N ranks the attention is the Llama twin's
tensor-parallel path and each expert's FFN is cut over the tensor axis: a
forward runs one all-reduce a layer for ``o_proj`` and one for the MoE
layer's combine.
"""

from torch import nn

from .llama_cache import LlamaAttentionCache, LlamaForCausalLMWithCache
from .mixtral import MixtralBlock, MixtralConfig


class MixtralBlockCache(MixtralBlock):

    def __init__(self, cfg: MixtralConfig, page_size: int = 16, device=None, tp_size: int = 1):
        super().__init__(cfg, device=device, tp_size=tp_size,
                         self_attn=LlamaAttentionCache(cfg.as_llama(), page_size, device=device, tp_size=tp_size))

    def forward(self, x, positions, pages, block_table, start_pos, chunk_lens=None):
        h = x + self.self_attn(self.input_layernorm(x), positions, pages, block_table, start_pos, chunk_lens)
        return h + self.block_sparse_moe(self.post_attention_layernorm(h), train=False)[0]


class MixtralForCausalLMWithCache(LlamaForCausalLMWithCache):
    """Chunked forward with paged KV over the MoE stack:
    ``model(input_ids, start_pos, block_table, cache, chunk_lens)`` → logits."""

    def _make_block(self, cfg, device, layer: int) -> nn.Module:
        return MixtralBlockCache(cfg, self.page_size, device=device, tp_size=self.tp.size)
