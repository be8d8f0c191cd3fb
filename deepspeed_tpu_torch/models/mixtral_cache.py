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
both.
"""

from torch import nn

from .llama_cache import LlamaAttentionCache, LlamaForCausalLMWithCache
from .mixtral import MixtralBlock, MixtralConfig


class MixtralBlockCache(MixtralBlock):

    def __init__(self, cfg: MixtralConfig, page_size: int = 16, device=None):
        super().__init__(cfg, device=device, self_attn=LlamaAttentionCache(cfg.as_llama(), page_size, device=device))

    def forward(self, x, positions, pages, block_table, start_pos, chunk_lens=None):
        h = x + self.self_attn(self.input_layernorm(x), positions, pages, block_table, start_pos, chunk_lens)
        return h + self.block_sparse_moe(self.post_attention_layernorm(h), train=False)[0]


class MixtralForCausalLMWithCache(LlamaForCausalLMWithCache):
    """Chunked forward with paged KV over the MoE stack:
    ``model(input_ids, start_pos, block_table, cache, chunk_lens)`` → logits."""

    def _make_block(self, cfg, device, layer: int) -> nn.Module:
        return MixtralBlockCache(cfg, self.page_size, device=device)
