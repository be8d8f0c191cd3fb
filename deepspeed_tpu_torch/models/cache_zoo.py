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
checkpoint by name.  LayerNorms compute in float32 and cast to the compute
dtype, as flax's do.

Falcon-RW's alibi slopes are a float32 ``[H]`` tensor the model makes once
on its device (``bind``), so a captured step graph reads the same tensor on
every replay; Mistral's window is the int ``cfg.sliding_window`` of the
Llama twin.  Qwen2-MoE's twin is the Llama twin with its sparse (or, in a
mixed stack, dense) MLP per layer (JAX ``cache_zoo.py:321-380``); Mixtral's
is ``mixtral_cache.py``.  ``build_cache_model`` picks a config's twin, this
registry's or the Llama one, and serves Mixtral dropless.
"""

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..accelerator import DeviceLike, resolve_device
from .falcon import FalconConfig, alibi_slopes
from .llama import LlamaConfig, _linear, apply_rope, dense, rotary_embedding
from .llama_cache import LlamaAttentionCache, LlamaForCausalLMWithCache, paged_attention_core
from .mixtral import MixtralConfig
from .mixtral_cache import MixtralForCausalLMWithCache
from .opt import OPTConfig
from .phi import PhiConfig, apply_partial_rope
from .qwen2_moe import Qwen2MoeBlock, Qwen2MoeConfig


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: float32 statistics, scale (``weight``) and
    ``bias`` in ``param_dtype``, the result cast to the compute dtype."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype, param_dtype: torch.dtype, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=param_dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), (x.shape[-1], ), self.weight.float(), self.bias.float(),
                            self.eps).to(self.dtype)


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

    def forward(self, input_ids, start_pos, block_table, cache, chunk_lens=None) -> torch.Tensor:
        return self.logits(self.hidden(input_ids, start_pos, block_table, cache, chunk_lens))


# ------------------------------------------------------------------- falcon


class FalconAttentionCache(nn.Module):

    def __init__(self, cfg: FalconConfig, page_size: int, device=None):
        super().__init__()
        self.cfg, self.page_size = cfg, page_size
        h, kv, d, e = cfg.num_attention_heads, cfg.num_kv_heads, cfg.head_dim, cfg.hidden_size
        self.q_proj = _linear(cfg, e, h * d, cfg.bias, device)
        self.k_proj = _linear(cfg, e, kv * d, cfg.bias, device)
        self.v_proj = _linear(cfg, e, kv * d, cfg.bias, device)
        self.dense = _linear(cfg, h * d, e, cfg.bias, device)

    def forward(self, x, positions, pages, block_table, start_pos, chunk_lens, slopes):
        cfg = self.cfg
        b, s, _ = x.shape
        d = cfg.head_dim
        q = dense(x, self.q_proj, cfg.dtype).view(b, s, cfg.num_attention_heads, d)
        k = dense(x, self.k_proj, cfg.dtype).view(b, s, cfg.num_kv_heads, d)
        v = dense(x, self.v_proj, cfg.dtype).view(b, s, cfg.num_kv_heads, d)
        if not cfg.alibi:   # Falcon-RW: alibi in the attention instead of rotary
            cos, sin = rotary_embedding(positions, d, cfg.rope_theta)
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        out = paged_attention_core(q, k, v, pages, block_table, start_pos, chunk_lens, self.page_size,
                                   attention_impl=cfg.attention_impl, alibi_slopes=slopes)
        return dense(out.reshape(b, s, -1), self.dense, cfg.dtype)


class FalconBlockCache(nn.Module):
    """Falcon-7B: ``x + attn(ln(x)) + mlp(ln(x))`` off ``input_layernorm``;
    the new architecture with ``ln_attn`` and ``ln_mlp``; Falcon-RW:
    sequential ``h = x + attn(ln1(x)); h + mlp(ln2(h))``."""

    def __init__(self, cfg: FalconConfig, page_size: int, device=None):
        super().__init__()
        self.cfg = cfg
        ln = lambda: LayerNorm(cfg.hidden_size, cfg.layer_norm_epsilon, cfg.dtype, cfg.param_dtype, device)
        if not cfg.parallel_attn:
            self.input_layernorm, self.post_attention_layernorm = ln(), ln()
        elif cfg.num_ln_in_parallel_attn == 2:
            self.ln_attn, self.ln_mlp = ln(), ln()
        else:
            self.input_layernorm = ln()
        self.self_attention = FalconAttentionCache(cfg, page_size, device)
        ffn = cfg.ffn_hidden_size or 4 * cfg.hidden_size
        self.dense_h_to_4h = _linear(cfg, cfg.hidden_size, ffn, cfg.bias, device)
        self.dense_4h_to_h = _linear(cfg, ffn, cfg.hidden_size, cfg.bias, device)

    def mlp(self, x):
        dt = self.cfg.dtype
        return dense(F.gelu(dense(x, self.dense_h_to_4h, dt)), self.dense_4h_to_h, dt)

    def forward(self, x, positions, pages, block_table, start_pos, chunk_lens, slopes):
        cfg = self.cfg
        attn = lambda a_in: self.self_attention(a_in, positions, pages, block_table, start_pos, chunk_lens, slopes)
        if not cfg.parallel_attn:
            h = x + attn(self.input_layernorm(x))
            return h + self.mlp(self.post_attention_layernorm(h))
        if cfg.num_ln_in_parallel_attn == 2:
            attn_in, mlp_in = self.ln_attn(x), self.ln_mlp(x)
        else:
            attn_in = mlp_in = self.input_layernorm(x)
        return x + attn(attn_in) + self.mlp(mlp_in)


class FalconForCausalLMWithCache(_CacheTwin):

    def __init__(self, cfg: FalconConfig, page_size: int = 16, device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg, self.page_size = cfg, page_size
        self.word_embeddings = nn.utils.skip_init(nn.Embedding, cfg.vocab_size, cfg.hidden_size, device=dev,
                                                  dtype=cfg.param_dtype)
        self.h = nn.ModuleList([FalconBlockCache(cfg, page_size, dev) for _ in range(cfg.num_hidden_layers)])
        self.ln_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_epsilon, cfg.dtype, cfg.param_dtype, dev)
        self.lm_head = None if cfg.tie_word_embeddings else _linear(cfg, cfg.hidden_size, cfg.vocab_size, False, dev)
        #: Falcon-RW's float32 [H] alibi slopes on the model's device (``bind``)
        self.alibi_slopes: Optional[torch.Tensor] = None
        if dev.type != "meta":
            self.bind(dev)

    def bind(self, device: torch.device) -> None:
        if self.cfg.alibi and self.alibi_slopes is None:
            self.alibi_slopes = torch.from_numpy(alibi_slopes(self.cfg.num_attention_heads)).to(device)

    def hidden(self, input_ids, start_pos, block_table, cache, chunk_lens=None) -> torch.Tensor:
        _check_cache(cache, self.h)
        if self.cfg.alibi and self.alibi_slopes is None:
            raise RuntimeError("FalconForCausalLMWithCache: call bind(device) after loading a meta-built model")
        positions = _positions(input_ids, start_pos)
        x = F.embedding(input_ids.long(), self.word_embeddings.weight).to(self.cfg.dtype)
        for layer, pages in zip(self.h, cache):
            x = layer(x, positions, pages, block_table, start_pos, chunk_lens, self.alibi_slopes)
        return x

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ln_f(x)
        if self.lm_head is None:
            return x @ self.word_embeddings.weight.to(self.cfg.dtype).T
        return dense(x, self.lm_head, self.cfg.dtype)


# ---------------------------------------------------------------------- opt


class OPTAttentionCache(nn.Module):

    def __init__(self, cfg: OPTConfig, page_size: int, device=None):
        super().__init__()
        self.cfg, self.page_size = cfg, page_size
        e = cfg.hidden_size
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (_linear(cfg, e, e, True, device) for _ in range(4))

    def forward(self, x, pages, block_table, start_pos, chunk_lens):
        cfg = self.cfg
        b, s, _ = x.shape
        shape = (b, s, cfg.num_attention_heads, cfg.head_dim)
        q, k, v = (dense(x, p, cfg.dtype).view(shape) for p in (self.q_proj, self.k_proj, self.v_proj))
        out = paged_attention_core(q, k, v, pages, block_table, start_pos, chunk_lens, self.page_size,
                                   attention_impl=cfg.attention_impl)
        return dense(out.reshape(b, s, -1), self.out_proj, cfg.dtype)


class OPTBlockCache(nn.Module):
    """Pre-LN (``do_layer_norm_before``) or post-LN (OPT-350M) with a ReLU MLP."""

    def __init__(self, cfg: OPTConfig, page_size: int, device=None):
        super().__init__()
        self.cfg = cfg
        self.self_attn_layer_norm = LayerNorm(cfg.hidden_size, 1e-5, cfg.dtype, cfg.param_dtype, device)
        self.self_attn = OPTAttentionCache(cfg, page_size, device)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, 1e-5, cfg.dtype, cfg.param_dtype, device)
        self.fc1 = _linear(cfg, cfg.hidden_size, cfg.ffn_dim, True, device)
        self.fc2 = _linear(cfg, cfg.ffn_dim, cfg.hidden_size, True, device)

    def forward(self, x, pages, block_table, start_pos, chunk_lens):
        cfg = self.cfg
        pre = cfg.do_layer_norm_before
        h = x + self.self_attn(self.self_attn_layer_norm(x) if pre else x, pages, block_table, start_pos, chunk_lens)
        if not pre:
            h = self.self_attn_layer_norm(h)
        m = dense(F.relu(dense(self.final_layer_norm(h) if pre else h, self.fc1, cfg.dtype)), self.fc2, cfg.dtype)
        out = h + m
        return out if pre else self.final_layer_norm(out)


class OPTForCausalLMWithCache(_CacheTwin):

    def __init__(self, cfg: OPTConfig, page_size: int = 16, device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg, self.page_size = cfg, page_size
        proj = cfg.word_embed_proj_dim or cfg.hidden_size
        self.embed_tokens = nn.utils.skip_init(nn.Embedding, cfg.vocab_size, proj, device=dev, dtype=cfg.param_dtype)
        self.embed_positions = nn.utils.skip_init(nn.Embedding, cfg.max_position_embeddings + 2, cfg.hidden_size,
                                                  device=dev, dtype=cfg.param_dtype)
        self.project_in = self.project_out = None
        if cfg.word_embed_proj_dim:
            self.project_in = _linear(cfg, proj, cfg.hidden_size, False, dev)
            self.project_out = _linear(cfg, cfg.hidden_size, proj, False, dev)
        self.layers = nn.ModuleList([OPTBlockCache(cfg, page_size, dev) for _ in range(cfg.num_hidden_layers)])
        self.final_layer_norm = LayerNorm(cfg.hidden_size, 1e-5, cfg.dtype, cfg.param_dtype, dev) \
            if cfg.do_layer_norm_before else None
        self.lm_head = None if cfg.tie_word_embeddings else _linear(cfg, proj, cfg.vocab_size, False, dev)

    def hidden(self, input_ids, start_pos, block_table, cache, chunk_lens=None) -> torch.Tensor:
        cfg = self.cfg
        _check_cache(cache, self.layers)
        # pad-region positions may pass the learned table: clamp (JAX does)
        positions = torch.clamp(_positions(input_ids, start_pos), max=cfg.max_position_embeddings - 1)
        x = F.embedding(input_ids.long(), self.embed_tokens.weight).to(cfg.dtype)
        if self.project_in is not None:
            x = dense(x, self.project_in, cfg.dtype)
        x = x + F.embedding(positions + 2, self.embed_positions.weight).to(cfg.dtype)
        for layer, pages in zip(self.layers, cache):
            x = layer(x, pages, block_table, start_pos, chunk_lens)
        return x

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if self.final_layer_norm is not None:
            x = self.final_layer_norm(x)
        if self.project_out is not None:
            x = dense(x, self.project_out, cfg.dtype)
        if self.lm_head is None:
            return x @ self.embed_tokens.weight.to(cfg.dtype).T
        return dense(x, self.lm_head, cfg.dtype)


# ---------------------------------------------------------------------- phi


class PhiAttentionCache(nn.Module):

    def __init__(self, cfg: PhiConfig, page_size: int, device=None):
        super().__init__()
        self.cfg, self.page_size = cfg, page_size
        h, kv, d, e = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim, cfg.hidden_size
        self.q_proj = _linear(cfg, e, h * d, True, device)
        self.k_proj = _linear(cfg, e, kv * d, True, device)
        self.v_proj = _linear(cfg, e, kv * d, True, device)
        self.dense = _linear(cfg, h * d, e, True, device)
        if cfg.qk_layernorm:   # per head, over D, before the rotary (Phi-1/1.5)
            self.q_layernorm = LayerNorm(d, cfg.layer_norm_eps, cfg.dtype, cfg.param_dtype, device)
            self.k_layernorm = LayerNorm(d, cfg.layer_norm_eps, cfg.dtype, cfg.param_dtype, device)

    def forward(self, x, positions, pages, block_table, start_pos, chunk_lens):
        cfg = self.cfg
        b, s, _ = x.shape
        d = cfg.head_dim
        q = dense(x, self.q_proj, cfg.dtype).view(b, s, cfg.num_attention_heads, d)
        k = dense(x, self.k_proj, cfg.dtype).view(b, s, cfg.num_key_value_heads, d)
        v = dense(x, self.v_proj, cfg.dtype).view(b, s, cfg.num_key_value_heads, d)
        if cfg.qk_layernorm:
            q, k = self.q_layernorm(q), self.k_layernorm(k)
        cos, sin = rotary_embedding(positions, cfg.rotary_dim, cfg.rope_theta)
        q, k = apply_partial_rope(q, cos, sin, cfg.rotary_dim), apply_partial_rope(k, cos, sin, cfg.rotary_dim)
        out = paged_attention_core(q, k, v, pages, block_table, start_pos, chunk_lens, self.page_size,
                                   attention_impl=cfg.attention_impl)
        return dense(out.reshape(b, s, -1), self.dense, cfg.dtype)


class PhiBlockCache(nn.Module):
    """``x + attn(ln(x)) + mlp(ln(x))`` with a tanh-GELU MLP."""

    def __init__(self, cfg: PhiConfig, page_size: int, device=None):
        super().__init__()
        self.cfg = cfg
        self.input_layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype, cfg.param_dtype, device)
        self.self_attn = PhiAttentionCache(cfg, page_size, device)
        self.fc1 = _linear(cfg, cfg.hidden_size, cfg.intermediate_size, True, device)
        self.fc2 = _linear(cfg, cfg.intermediate_size, cfg.hidden_size, True, device)

    def forward(self, x, positions, pages, block_table, start_pos, chunk_lens):
        dt = self.cfg.dtype
        h = self.input_layernorm(x)
        attn = self.self_attn(h, positions, pages, block_table, start_pos, chunk_lens)
        mlp = dense(F.gelu(dense(h, self.fc1, dt), approximate="tanh"), self.fc2, dt)
        return x + attn + mlp


class PhiForCausalLMWithCache(_CacheTwin):

    def __init__(self, cfg: PhiConfig, page_size: int = 16, device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg, self.page_size = cfg, page_size
        self.embed_tokens = nn.utils.skip_init(nn.Embedding, cfg.vocab_size, cfg.hidden_size, device=dev,
                                               dtype=cfg.param_dtype)
        self.layers = nn.ModuleList([PhiBlockCache(cfg, page_size, dev) for _ in range(cfg.num_hidden_layers)])
        self.final_layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype, cfg.param_dtype, dev)
        self.lm_head = _linear(cfg, cfg.hidden_size, cfg.vocab_size, True, dev)

    def hidden(self, input_ids, start_pos, block_table, cache, chunk_lens=None) -> torch.Tensor:
        _check_cache(cache, self.layers)
        positions = _positions(input_ids, start_pos)
        x = F.embedding(input_ids.long(), self.embed_tokens.weight).to(self.cfg.dtype)
        for layer, pages in zip(self.layers, cache):
            x = layer(x, positions, pages, block_table, start_pos, chunk_lens)
        return x

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return dense(self.final_layernorm(x), self.lm_head, self.cfg.dtype)


# ---------------------------------------------------------------- qwen2-moe


class Qwen2MoeBlockCache(Qwen2MoeBlock):
    """A Qwen2-MoE layer over the paged arena: the sparse MLP, or the dense
    one in a mixed stack's ``mlp_only``/off-step layers."""

    def __init__(self, cfg: Qwen2MoeConfig, page_size: int, sparse: bool = True, device=None):
        super().__init__(cfg, sparse=sparse, device=device,
                         self_attn=LlamaAttentionCache(cfg.as_llama(), page_size, device=device))

    def forward(self, x, positions, pages, block_table, start_pos, chunk_lens=None):
        h = x + self.self_attn(self.input_layernorm(x), positions, pages, block_table, start_pos, chunk_lens)
        return h + self.mlp(self.post_attention_layernorm(h))


class Qwen2MoeForCausalLMWithCache(LlamaForCausalLMWithCache):
    """The Llama twin's forward over Qwen2-MoE layers (``layers.{i}``,
    each sparse or dense by ``cfg.layer_is_sparse(i)``)."""

    def _make_block(self, cfg, device, layer: int) -> nn.Module:
        return Qwen2MoeBlockCache(cfg, self.page_size, sparse=cfg.layer_is_sparse(layer), device=device)


#: config class → its paged twin (JAX ``CACHE_MODEL_REGISTRY``, with Mixtral,
#: which JAX's ``build_cache_model`` picks by hand)
CACHE_MODEL_REGISTRY = {
    FalconConfig: FalconForCausalLMWithCache,
    OPTConfig: OPTForCausalLMWithCache,
    PhiConfig: PhiForCausalLMWithCache,
    Qwen2MoeConfig: Qwen2MoeForCausalLMWithCache,
    MixtralConfig: MixtralForCausalLMWithCache,
}


def build_cache_model(cfg, page_size: int, device: DeviceLike = "cuda"):
    """The paged twin of a config's family (JAX ``engine_v2.py:39-56``):
    ``CACHE_MODEL_REGISTRY``'s, else Llama.  Mixtral is served dropless: a
    config with ``drop_tokens`` is replaced by one without (capacity drops
    would zero routed tokens at random and leave HF's outputs)."""
    if isinstance(cfg, MixtralConfig) and cfg.drop_tokens:
        cfg = dataclasses.replace(cfg, drop_tokens=False)
    for cfg_cls, model_cls in CACHE_MODEL_REGISTRY.items():
        if isinstance(cfg, cfg_cls):
            return model_cls(cfg, page_size=page_size, device=device)
    if not isinstance(cfg, LlamaConfig):
        raise TypeError(f"no paged twin for a {type(cfg).__name__}: the port serves LlamaConfig and "
                        f"{sorted(c.__name__ for c in CACHE_MODEL_REGISTRY)}")
    return LlamaForCausalLMWithCache(cfg, page_size=page_size, device=device)
