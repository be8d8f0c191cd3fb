"""Paged-KV serving twins of the non-Llama families (port of
``deepspeed_tpu/models/cache_zoo.py``): Falcon, OPT, Phi and Qwen2-MoE.

Each twin serves one chunked forward for prefill, continuation and decode
as ``llama_cache.LlamaForCausalLMWithCache`` does: ``hidden(input_ids,
start_pos, block_table, cache, chunk_lens)`` → the last hidden states,
``logits(rows)`` → the LM head, the arena (one ``[P, page, 2, n_kv, D]``
tensor per layer) written in place, and attention through
``paged_attention_core`` (K3 on the card, its plain version on the CPU).

Parameter names mirror the JAX twin's tree with the layers unrolled (``h.{i}``
for Falcon, ``layers.{i}`` for OPT and Phi) and torch's ``[out, in]``
weights, so ``models/convert.py`` carries a JAX tree across and the HF
policies (``inference/v2/model_implementations/policies.py``) map a
checkpoint by name.  A twin's layer is its family's training block
(``falcon.FalconBlock``, ``opt.OPTBlock``, ``phi.PhiBlock``) over the paged
attention here, which keeps the training attention's projections, so the
training and serving models share their names.  LayerNorms
(``llama.LayerNorm``) compute in float32 and cast to the compute dtype, as
flax's do.

Falcon-RW's alibi slopes are a float32 ``[H]`` tensor the model makes once
on its device (``bind``), so a captured step graph reads the same tensor on
every replay; Mistral's window is the int ``cfg.sliding_window`` of the
Llama twin.

Over ``tensor_parallel`` N ranks each twin holds its training model's
slices (``models/{falcon,opt,phi}.py``: the heads, the MLP's up
projection and the vocab cut, the learned positions and the norms whole),
its arena holds the rank's kv heads, Falcon-RW's slopes are the rank's
heads' (``falcon.rank_alibi_slopes``, made in ``bind`` after the engine
has set the rank), and ``logits`` gathers the vocab slices over the tensor
group, as the Llama twin does.  Qwen2-MoE's twin is the Llama twin with its sparse (or, in a
mixed stack, dense) MLP per layer (JAX ``cache_zoo.py:321-380``); Mixtral's
is ``mixtral_cache.py``.  ``build_cache_model`` picks a config's twin, this
registry's or the Llama one, and serves Mixtral dropless.
"""

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..accelerator import DeviceLike, resolve_device
from ..module_inject.layers import gather_from_tensor_region
from .falcon import FalconAttention, FalconBlock, FalconConfig, FalconForCausalLM, rank_alibi_slopes
from .llama import LlamaConfig
from .llama_cache import LlamaAttentionCache, LlamaForCausalLMWithCache, paged_attention_core
from .mixtral import MixtralConfig
from .mixtral_cache import MixtralForCausalLMWithCache
from .opt import OPTAttention, OPTBlock, OPTConfig, OPTForCausalLM
from .phi import PhiAttention, PhiBlock, PhiConfig, PhiForCausalLM
from .qwen2_moe import Qwen2MoeBlock, Qwen2MoeConfig


def _positions(input_ids: torch.Tensor, start_pos: torch.Tensor) -> torch.Tensor:
    return start_pos.long()[:, None] + torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]


def _check_cache(cache, layers) -> None:
    if len(cache) != len(layers):
        raise ValueError(f"cache holds {len(cache)} layer arenas, model has {len(layers)} layers")


class _CacheTwin(nn.Module):
    """The interface every twin gives the engine: ``hidden`` + ``logits``
    split one forward so the engine takes the LM head over each row's last
    real token only; ``bind(device)`` makes what is not a weight."""

    def bind(self, device: torch.device) -> None:
        """Make the model's non-weight tensors on ``device`` (once; a model
        built on the meta device calls it after its state dict is loaded)."""

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """The training model's head over hidden rows: ``[..., V]``, the
        vocab slices gathered over the tensor group."""
        return gather_from_tensor_region(super().logits(x), self.tp, "logits")

    def forward(self, input_ids, start_pos, block_table, cache, chunk_lens=None) -> torch.Tensor:
        return self.logits(self.hidden(input_ids, start_pos, block_table, cache, chunk_lens))


# ------------------------------------------------------------------- falcon


class FalconAttentionCache(FalconAttention):
    """The training attention's projections over the paged arena."""

    def __init__(self, cfg: FalconConfig, page_size: int, device=None, tp_size: int = 1):
        super().__init__(cfg, device, tp_size=tp_size)
        self.page_size = page_size

    def forward(self, x, positions, pages, block_table, start_pos, chunk_lens, slopes):
        q, k, v = self.qkv(x, positions)
        return self.out(paged_attention_core(q, k, v, pages, block_table, start_pos, chunk_lens, self.page_size,
                                             attention_impl=self.cfg.attention_impl, alibi_slopes=slopes))


class FalconForCausalLMWithCache(_CacheTwin, FalconForCausalLM):
    """The training model's embedding and head over paged blocks."""

    def __init__(self, cfg: FalconConfig, page_size: int = 16, device: DeviceLike = "cuda", tensor_parallel: int = 1):
        self.page_size = page_size
        super().__init__(cfg, device=device, tensor_parallel=tensor_parallel)
        dev = resolve_device(device)
        #: Falcon-RW's float32 alibi slopes of the rank's heads on the model's device (``bind``)
        self.alibi_slopes: Optional[torch.Tensor] = None
        if dev.type != "meta":
            self.bind(dev)

    def _make_block(self, cfg: FalconConfig, device) -> nn.Module:
        return FalconBlock(cfg, device, FalconAttentionCache(cfg, self.page_size, device, tp_size=self.tp.size),
                           tp_size=self.tp.size)

    def bind(self, device: torch.device) -> None:
        """The rank's alibi slopes (after the engine has set the rank: the
        meta-built twin's ``bind`` runs after ``set_tensor_parallel_``)."""
        if self.cfg.alibi:
            self.alibi_slopes = rank_alibi_slopes(self.cfg, self.tp, device)

    def hidden(self, input_ids, start_pos, block_table, cache, chunk_lens=None) -> torch.Tensor:
        _check_cache(cache, self.h)
        if self.cfg.alibi and self.alibi_slopes is None:
            raise RuntimeError("FalconForCausalLMWithCache: call bind(device) after loading a meta-built model")
        positions = _positions(input_ids, start_pos)
        x = self.embed(input_ids)
        for layer, pages in zip(self.h, cache):
            x = layer(x, positions, pages, block_table, start_pos, chunk_lens, self.alibi_slopes)
        return x


# ---------------------------------------------------------------------- opt


class OPTAttentionCache(OPTAttention):
    """The training attention's projections over the paged arena."""

    def __init__(self, cfg: OPTConfig, page_size: int, device=None, tp_size: int = 1):
        super().__init__(cfg, device, tp_size=tp_size)
        self.page_size = page_size

    def forward(self, x, pages, block_table, start_pos, chunk_lens):
        q, k, v = self.qkv(x)
        return self.out(paged_attention_core(q, k, v, pages, block_table, start_pos, chunk_lens, self.page_size,
                                             attention_impl=self.cfg.attention_impl))


class OPTForCausalLMWithCache(_CacheTwin, OPTForCausalLM):
    """The training model's embeddings and head over paged blocks."""

    def __init__(self, cfg: OPTConfig, page_size: int = 16, device: DeviceLike = "cuda", tensor_parallel: int = 1):
        self.page_size = page_size
        super().__init__(cfg, device=device, tensor_parallel=tensor_parallel)

    def _make_block(self, cfg: OPTConfig, device) -> nn.Module:
        return OPTBlock(cfg, device, OPTAttentionCache(cfg, self.page_size, device, tp_size=self.tp.size),
                        tp_size=self.tp.size)

    def hidden(self, input_ids, start_pos, block_table, cache, chunk_lens=None) -> torch.Tensor:
        _check_cache(cache, self.layers)
        # pad-region positions may pass the learned table: clamp (JAX does)
        positions = torch.clamp(_positions(input_ids, start_pos), max=self.cfg.max_position_embeddings - 1)
        x = self.embed(input_ids, positions)
        for layer, pages in zip(self.layers, cache):
            x = layer(x, pages, block_table, start_pos, chunk_lens)
        return x


# ---------------------------------------------------------------------- phi


class PhiAttentionCache(PhiAttention):
    """The training attention's projections, ``qk_layernorm`` and partial
    rotary over the paged arena."""

    def __init__(self, cfg: PhiConfig, page_size: int, device=None, tp_size: int = 1):
        super().__init__(cfg, device, tp_size=tp_size)
        self.page_size = page_size

    def forward(self, x, positions, pages, block_table, start_pos, chunk_lens):
        q, k, v = self.qkv(x, positions)
        return self.out(paged_attention_core(q, k, v, pages, block_table, start_pos, chunk_lens, self.page_size,
                                             attention_impl=self.cfg.attention_impl))


class PhiForCausalLMWithCache(_CacheTwin, PhiForCausalLM):
    """The training model's embedding and head over paged blocks."""

    def __init__(self, cfg: PhiConfig, page_size: int = 16, device: DeviceLike = "cuda", tensor_parallel: int = 1):
        self.page_size = page_size
        super().__init__(cfg, device=device, tensor_parallel=tensor_parallel)

    def _make_block(self, cfg: PhiConfig, device) -> nn.Module:
        return PhiBlock(cfg, device, PhiAttentionCache(cfg, self.page_size, device, tp_size=self.tp.size),
                        tp_size=self.tp.size)

    def hidden(self, input_ids, start_pos, block_table, cache, chunk_lens=None) -> torch.Tensor:
        _check_cache(cache, self.layers)
        positions = _positions(input_ids, start_pos)
        x = self.embed(input_ids)
        for layer, pages in zip(self.layers, cache):
            x = layer(x, positions, pages, block_table, start_pos, chunk_lens)
        return x


# ---------------------------------------------------------------- qwen2-moe


class Qwen2MoeBlockCache(Qwen2MoeBlock):
    """A Qwen2-MoE layer over the paged arena: the sparse MLP, or the dense
    one in a mixed stack's ``mlp_only``/off-step layers."""

    def __init__(self, cfg: Qwen2MoeConfig, page_size: int, sparse: bool = True, device=None, tp_size: int = 1):
        super().__init__(cfg, sparse=sparse, device=device, tp_size=tp_size,
                         self_attn=LlamaAttentionCache(cfg.as_llama(), page_size, device=device, tp_size=tp_size))

    def forward(self, x, positions, pages, block_table, start_pos, chunk_lens=None):
        h = x + self.self_attn(self.input_layernorm(x), positions, pages, block_table, start_pos, chunk_lens)
        return h + self.mlp(self.post_attention_layernorm(h))


class Qwen2MoeForCausalLMWithCache(LlamaForCausalLMWithCache):
    """The Llama twin's forward over Qwen2-MoE layers (``layers.{i}``,
    each sparse or dense by ``cfg.layer_is_sparse(i)``); over
    ``tensor_parallel`` ranks one all-reduce a layer for ``o_proj`` and one
    for the sparse MLP's mixture and shared expert (``qwen2_moe.py``)."""

    def _make_block(self, cfg, device, layer: int) -> nn.Module:
        return Qwen2MoeBlockCache(cfg, self.page_size, sparse=cfg.layer_is_sparse(layer), device=device,
                                  tp_size=self.tp.size)


#: config class → its paged twin (JAX ``CACHE_MODEL_REGISTRY``, with Mixtral,
#: which JAX's ``build_cache_model`` picks by hand)
CACHE_MODEL_REGISTRY = {
    FalconConfig: FalconForCausalLMWithCache,
    OPTConfig: OPTForCausalLMWithCache,
    PhiConfig: PhiForCausalLMWithCache,
    Qwen2MoeConfig: Qwen2MoeForCausalLMWithCache,
    MixtralConfig: MixtralForCausalLMWithCache,
}


def build_cache_model(cfg, page_size: int, device: DeviceLike = "cuda", tensor_parallel: int = 1):
    """The paged twin of a config's family (JAX ``engine_v2.py:39-56``):
    ``CACHE_MODEL_REGISTRY``'s, else Llama.  Mixtral is served dropless: a
    config with ``drop_tokens`` is replaced by one without (capacity drops
    would zero routed tokens at random and leave HF's outputs).  Over
    ``tensor_parallel`` ranks a rank's slices of any family's twin."""
    if isinstance(cfg, MixtralConfig) and cfg.drop_tokens:
        cfg = dataclasses.replace(cfg, drop_tokens=False)
    kw = {"tensor_parallel": tensor_parallel} if tensor_parallel > 1 else {}
    for cfg_cls, model_cls in CACHE_MODEL_REGISTRY.items():
        if isinstance(cfg, cfg_cls):
            return model_cls(cfg, page_size=page_size, device=device, **kw)
    if not isinstance(cfg, LlamaConfig):
        raise TypeError(f"no paged twin for a {type(cfg).__name__}: the port serves LlamaConfig and "
                        f"{sorted(c.__name__ for c in CACHE_MODEL_REGISTRY)}")
    return LlamaForCausalLMWithCache(cfg, page_size=page_size, device=device, tensor_parallel=tensor_parallel)
