"""The Falcon family (port of ``deepspeed_tpu/models/falcon.py``): its config,
the attention and block, and the cache-free training model
``FalconForCausalLM`` (JAX ``:95-209``).

Three layouts, trained here and served by ``cache_zoo.FalconForCausalLMWithCache``
(which shares ``FalconBlock`` and the projections of ``FalconAttention``):
  * Falcon-7B: multi-query (one KV head), parallel attention and MLP off
    ONE ``input_layernorm``, rotary positions;
  * the new decoder architecture (Falcon-40B/180B): grouped KV heads, the
    parallel branches off ``ln_attn`` and ``ln_mlp`` (or one shared
    LayerNorm when ``num_ln_in_parallel_attn`` is 1);
  * Falcon-RW: sequential blocks (``parallel_attn=False``), per-head MHA,
    alibi position bias in place of rotary (``alibi_slopes``).

Rotary attention follows ``cfg.attention_impl`` (``"flash"``: K1/K2a/K2b on
the card; Falcon-7B's 71 query heads on one kv head take the kernels'
repeated-KV route).  Alibi runs the plain attention with the bias folded by
1/√D, and any other impl raises, as in JAX (no kernel takes alibi).
Parameter names mirror the JAX tree (``word_embeddings``, ``h.{i}.
self_attention.{q,k,v}_proj``, ``dense``, ``dense_h_to_4h``, ``ln_f``, ...).
"""

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..accelerator import DeviceLike, resolve_device
from ..ops.attention import reference_attention
from .llama import LayerNorm, _linear, apply_rope, block_runner, dense, get_attention_impl, hf_value, rotary_embedding


@dataclasses.dataclass(frozen=True)
class FalconConfig:
    vocab_size: int = 65024
    hidden_size: int = 4544
    num_hidden_layers: int = 32
    num_attention_heads: int = 71
    num_kv_heads: int = 1
    new_decoder_architecture: bool = False
    parallel_attn: bool = True
    num_ln_in_parallel_attn: int = 2  # new-arch: 2 = ln_attn + ln_mlp; 1 = shared (Falcon-11B)
    ffn_hidden_size: int = 0  # 0 → 4·hidden_size (HF default)
    alibi: bool = False  # Falcon-RW: alibi position bias instead of rotary
    bias: bool = False
    layer_norm_epsilon: float = 1e-5
    rope_theta: float = 10000.0
    max_position_embeddings: int = 2048
    tie_word_embeddings: bool = True
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    # "flash": K1/K2a/K2b in the training model, K3 in the serving twin, on a
    # GPU tensor (their plain versions on a CPU one); "reference" | "chunked"
    attention_impl: str = "flash"
    # per-block activation checkpointing of the training model (``llama.block_runner``)
    remat: bool = True
    remat_policy: str = "nothing_saveable"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def from_hf(hf_cfg, **overrides) -> "FalconConfig":
        """From an HF Falcon config (a ``config.json`` mapping or a
        namespace), with JAX's rules: the KV head count is ``num_kv_heads``
        in the new architecture, else 1 when ``multi_query`` (the default),
        else one per head; ``num_ln_in_parallel_attn`` unset is 2 in the new
        architecture, else 1."""
        new_arch = hf_value(hf_cfg, "new_decoder_architecture", False)
        heads = hf_value(hf_cfg, "num_attention_heads")
        if new_arch:
            kv = hf_value(hf_cfg, "num_kv_heads", heads)
        else:
            kv = 1 if hf_value(hf_cfg, "multi_query", True) else heads
        fields = dict(vocab_size=hf_value(hf_cfg, "vocab_size"),
                      hidden_size=hf_value(hf_cfg, "hidden_size"),
                      num_hidden_layers=hf_value(hf_cfg, "num_hidden_layers"),
                      num_attention_heads=heads,
                      num_kv_heads=kv,
                      new_decoder_architecture=new_arch,
                      num_ln_in_parallel_attn=hf_value(hf_cfg, "num_ln_in_parallel_attn", 2 if new_arch else 1),
                      parallel_attn=hf_value(hf_cfg, "parallel_attn", True),
                      ffn_hidden_size=hf_value(hf_cfg, "ffn_hidden_size", 0),
                      alibi=hf_value(hf_cfg, "alibi", False),
                      bias=hf_value(hf_cfg, "bias", False),
                      layer_norm_epsilon=hf_value(hf_cfg, "layer_norm_epsilon", 1e-5),
                      rope_theta=hf_value(hf_cfg, "rope_theta", 10000.0),
                      max_position_embeddings=hf_value(hf_cfg, "max_position_embeddings", 2048),
                      tie_word_embeddings=hf_value(hf_cfg, "tie_word_embeddings", True))
        fields.update(overrides)
        return FalconConfig(**fields)


def alibi_slopes(n_heads: int) -> np.ndarray:
    """The alibi slope of each head (HF ``build_alibi_tensor``): powers of
    2^(-8/m) for the closest power-of-two head count m, then every other
    slope of 2m for the extra heads.  float32 [n_heads]."""

    def pow2_slopes(n):
        start = 2.0**(-(2.0**-(math.log2(n) - 3)))
        return [start**(i + 1) for i in range(n)]

    if math.log2(n_heads).is_integer():
        return np.asarray(pow2_slopes(n_heads), np.float32)
    closest = 2**math.floor(math.log2(n_heads))
    extra = pow2_slopes(2 * closest)[0::2][:n_heads - closest]
    return np.asarray(pow2_slopes(closest) + extra, np.float32)


class FalconAttention(nn.Module):
    """The q/k/v and ``dense`` projections and the rotary, and the
    cache-free attention (the paged twin, ``cache_zoo.FalconAttentionCache``,
    shares the projections)."""

    def __init__(self, cfg: FalconConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h, kv, d, e = cfg.num_attention_heads, cfg.num_kv_heads, cfg.head_dim, cfg.hidden_size
        self.q_proj = _linear(cfg, e, h * d, cfg.bias, device)
        self.k_proj = _linear(cfg, e, kv * d, cfg.bias, device)
        self.v_proj = _linear(cfg, e, kv * d, cfg.bias, device)
        self.dense = _linear(cfg, h * d, e, cfg.bias, device)

    def qkv(self, x: torch.Tensor, positions: torch.Tensor):
        """x [B, S, E] → q [B, S, H, D], k/v [B, S, KV, D], rotated unless alibi."""
        cfg = self.cfg
        b, s, _ = x.shape
        d = cfg.head_dim
        q = dense(x, self.q_proj, cfg.dtype).view(b, s, cfg.num_attention_heads, d)
        k = dense(x, self.k_proj, cfg.dtype).view(b, s, cfg.num_kv_heads, d)
        v = dense(x, self.v_proj, cfg.dtype).view(b, s, cfg.num_kv_heads, d)
        if not cfg.alibi:   # Falcon-RW: alibi in the attention instead of rotary
            cos, sin = rotary_embedding(positions, d, cfg.rope_theta)
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        return q, k, v

    def out(self, attn: torch.Tensor) -> torch.Tensor:
        b, s = attn.shape[:2]
        return dense(attn.reshape(b, s, -1), self.dense, self.cfg.dtype)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, segment_ids: Optional[torch.Tensor] = None,
                slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        q, k, v = self.qkv(x, positions)
        if cfg.alibi:
            if cfg.attention_impl != "reference":
                raise NotImplementedError("alibi falcon requires attention_impl='reference' (no kernel takes alibi, "
                                          "as in JAX)")
            # HF adds alibi to the raw scores before the 1/√D scale; the plain
            # attention adds its bias after it, so the bias is folded by 1/√D
            bias = slopes[None, :, None, None] * positions.float()[:, None, None, :] / math.sqrt(cfg.head_dim)
            return self.out(reference_attention(q, k, v, True, segment_ids=segment_ids, attn_bias=bias))
        attn = get_attention_impl(cfg.attention_impl)
        return self.out(attn(q, k, v, causal=True, segment_ids=segment_ids))


class FalconBlock(nn.Module):
    """Falcon-7B: ``x + attn(ln(x)) + mlp(ln(x))`` off ``input_layernorm``;
    the new architecture with ``ln_attn`` and ``ln_mlp``; Falcon-RW:
    sequential ``h = x + attn(ln1(x)); h + mlp(ln2(h))``.  ``forward(x,
    *attn_args)`` hands ``attn_args`` to ``self_attention``: the cache-free
    one, or the paged twin's when given."""

    def __init__(self, cfg: FalconConfig, device=None, self_attention: Optional[nn.Module] = None):
        super().__init__()
        self.cfg = cfg
        ln = lambda: LayerNorm(cfg.hidden_size, cfg.layer_norm_epsilon, cfg.dtype, cfg.param_dtype, device)
        if not cfg.parallel_attn:
            self.input_layernorm, self.post_attention_layernorm = ln(), ln()
        elif cfg.num_ln_in_parallel_attn == 2:
            self.ln_attn, self.ln_mlp = ln(), ln()
        else:
            self.input_layernorm = ln()
        self.self_attention = self_attention if self_attention is not None else FalconAttention(cfg, device)
        ffn = cfg.ffn_hidden_size or 4 * cfg.hidden_size
        self.dense_h_to_4h = _linear(cfg, cfg.hidden_size, ffn, cfg.bias, device)
        self.dense_4h_to_h = _linear(cfg, ffn, cfg.hidden_size, cfg.bias, device)

    def mlp(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        return dense(F.gelu(dense(x, self.dense_h_to_4h, dt)), self.dense_4h_to_h, dt)

    def forward(self, x: torch.Tensor, *attn_args) -> torch.Tensor:
        cfg = self.cfg
        if not cfg.parallel_attn:
            h = x + self.self_attention(self.input_layernorm(x), *attn_args)
            return h + self.mlp(self.post_attention_layernorm(h))
        if cfg.num_ln_in_parallel_attn == 2:
            attn_in, mlp_in = self.ln_attn(x), self.ln_mlp(x)
        else:
            attn_in = mlp_in = self.input_layernorm(x)
        return x + self.self_attention(attn_in, *attn_args) + self.mlp(mlp_in)


class FalconForCausalLM(nn.Module):
    """Cache-free forward: ``input_ids`` [B, S] → logits [B, S, V] in the
    compute dtype; each block under ``cfg.remat``'s checkpoint.  The paged
    twin (``cache_zoo``) subclasses it with its own blocks (``_make_block``)
    and shares ``embed`` and ``logits``."""

    def __init__(self, cfg: FalconConfig, device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.word_embeddings = nn.utils.skip_init(nn.Embedding, cfg.vocab_size, cfg.hidden_size, device=dev,
                                                  dtype=cfg.param_dtype)
        self.h = nn.ModuleList([self._make_block(cfg, dev) for _ in range(cfg.num_hidden_layers)])
        self.ln_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_epsilon, cfg.dtype, cfg.param_dtype, dev)
        self.lm_head = None if cfg.tie_word_embeddings else _linear(cfg, cfg.hidden_size, cfg.vocab_size, False, dev)

    def _make_block(self, cfg: FalconConfig, device) -> nn.Module:
        return FalconBlock(cfg, device)

    @property
    def attention_bias_kind(self) -> Optional[str]:
        """The attention bias K1 does not take (the v1 engine's kernel
        injection refuses it): ``"alibi"`` for Falcon-RW."""
        return "alibi" if self.cfg.alibi else None

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(input_ids.long(), self.word_embeddings.weight).to(self.cfg.dtype)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """``ln_f`` and the head (tied: ``embed.attend``) over hidden rows."""
        x = self.ln_f(x)
        if self.lm_head is None:
            return x @ self.word_embeddings.weight.to(self.cfg.dtype).T
        return dense(x, self.lm_head, self.cfg.dtype)

    def forward(self, input_ids: torch.Tensor, positions: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        if positions is None:
            positions = torch.arange(input_ids.shape[1], device=input_ids.device).expand(input_ids.shape)
        slopes = torch.from_numpy(alibi_slopes(cfg.num_attention_heads)).to(input_ids.device) if cfg.alibi else None
        x = self.embed(input_ids)
        run = block_runner(cfg)
        for block in self.h:
            x = run(block, x, positions, segment_ids, slopes)
        return self.logits(x)
