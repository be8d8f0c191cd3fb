"""Llama-family causal LM (port of ``deepspeed_tpu/models/llama.py``).

What the serving slice needs: the config and presets, ``RMSNorm``, the
half-split rotary embedding, the MLP, and a cache-free forward
(``LlamaForCausalLM``) over the plain ``reference_attention`` — the engine
tests' golden.  The training step (flash kernels K1/K2, remat, the
hand-written loss VJP) comes with a later slice.

Numerics follow the JAX modules: weights live in ``param_dtype`` and are
cast to ``dtype`` at use (flax ``DenseGeneral``/``Embed`` promote the same
way); RMSNorm and RoPE compute in float32 and cast back; attention
accumulates in float32.

Parameter names mirror the JAX tree (``embed_tokens``, ``layers.{i}.
self_attn.{q,k,v,o}_proj``, ``input_layernorm``, ``post_attention_layernorm``,
``mlp.{gate,up,down}_proj``, ``norm``, ``lm_head``) so that
``models/convert.py`` maps one onto the other leaf by leaf, and the cache
twin (``llama_cache.py``) loads the same state dict.
"""

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..accelerator import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    max_position_embeddings: int = 8192
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    # paged attention of the serving path: "flash" runs the hand-written
    # CUDA kernel on a GPU tensor (its plain version on a CPU tensor);
    # "reference" always runs the plain PyTorch version
    attention_impl: str = "flash"
    attention_bias: bool = False  # qkv bias (Qwen2-style checkpoints)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


PRESETS = {
    "llama3-8b": LlamaConfig(vocab_size=128256, hidden_size=4096, intermediate_size=14336, num_hidden_layers=32,
                             num_attention_heads=32, num_key_value_heads=8),
    # the reference FastGen headline model (blogs/deepspeed-fastgen: Llama-2-70B
    # served TP-sharded over 4 GPUs)
    "llama2-70b": LlamaConfig(vocab_size=32000, hidden_size=8192, intermediate_size=28672,
                              num_hidden_layers=80, num_attention_heads=64, num_key_value_heads=8,
                              rope_theta=10000.0),
    "llama2-7b": LlamaConfig(vocab_size=32000, hidden_size=4096, intermediate_size=11008, num_hidden_layers=32,
                             num_attention_heads=32, num_key_value_heads=32, rope_theta=10000.0),
    "tiny": LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
                        rope_theta=10000.0),
    "125m": LlamaConfig(vocab_size=32000, hidden_size=768, intermediate_size=2048, num_hidden_layers=12,
                        num_attention_heads=12, num_key_value_heads=12, rope_theta=10000.0),
}


def _linear(cfg: LlamaConfig, fan_in: int, fan_out: int, bias: bool, device) -> nn.Linear:
    """An uninitialised ``nn.Linear`` in ``param_dtype``: weights come from
    ``load_state_dict`` (converted checkpoints) or ``init_weights_``."""
    return nn.utils.skip_init(nn.Linear, fan_in, fan_out, bias=bias, device=device, dtype=cfg.param_dtype)


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax ``DenseGeneral(dtype=...)``: input, kernel and bias promoted to
    the compute dtype, then one matmul (left to cuBLAS, as the JAX package
    leaves it to XLA)."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class RMSNorm(nn.Module):
    """float32 variance and scale, cast back to the compute dtype."""

    def __init__(self, hidden: int, eps: float = 1e-5, dtype=torch.bfloat16, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(hidden, device=device, dtype=param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        normed = x32 * torch.rsqrt(var + self.eps)
        return (normed * self.weight.float()).to(self.dtype)


def rotary_embedding(positions: torch.Tensor, head_dim: int, theta: float):
    """RoPE tables in float32: ``positions`` [B, S] → cos, sin [B, S, D/2]."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    inv_freq = 1.0 / (theta**exponent)
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Half-split rotation of x [B, S, N, D]: ``[x1·cos − x2·sin, x2·cos + x1·sin]``
    over the two halves of D (not the interleaved pairs layout)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """Plain softmax attention, q [B, Sq, H, D], k/v [B, Sk, KV, D], GQA by
    repeating each kv head over its query group; float32 logits, probs cast
    to v's dtype before the PV product."""
    _, sq, nh, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    if nkv != nh:
        k = k.repeat_interleave(nh // nkv, dim=2)
        v = v.repeat_interleave(nh // nkv, dim=2)
    logits = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * (1.0 / math.sqrt(hd))
    if causal:
        mask = torch.arange(sq, device=q.device)[:, None] >= torch.arange(sk, device=q.device)[None, :]
        logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bnqk,bknd->bqnd", probs.to(v.dtype), v)


class LlamaAttention(nn.Module):
    """Projections + RoPE shared by the cache-free and the paged forward."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        hd, e = cfg.head_dim, cfg.hidden_size
        self.q_proj = _linear(cfg, e, cfg.num_attention_heads * hd, cfg.attention_bias, device)
        self.k_proj = _linear(cfg, e, cfg.num_key_value_heads * hd, cfg.attention_bias, device)
        self.v_proj = _linear(cfg, e, cfg.num_key_value_heads * hd, cfg.attention_bias, device)
        self.o_proj = _linear(cfg, cfg.num_attention_heads * hd, e, False, device)

    def qkv(self, x: torch.Tensor, positions: torch.Tensor):
        """x [B, S, E] → post-RoPE q [B, S, H, D], k/v [B, S, KV, D]."""
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.head_dim
        q = dense(x, self.q_proj, cfg.dtype).view(b, s, cfg.num_attention_heads, hd)
        k = dense(x, self.k_proj, cfg.dtype).view(b, s, cfg.num_key_value_heads, hd)
        v = dense(x, self.v_proj, cfg.dtype).view(b, s, cfg.num_key_value_heads, hd)
        cos, sin = rotary_embedding(positions, hd, cfg.rope_theta)
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v

    def out(self, attn: torch.Tensor) -> torch.Tensor:
        b, s = attn.shape[:2]
        return dense(attn.reshape(b, s, -1), self.o_proj, self.cfg.dtype)

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        q, k, v = self.qkv(x, positions)
        return self.out(reference_attention(q, k, v, causal=True))


class LlamaMLP(nn.Module):

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.gate_proj = _linear(cfg, cfg.hidden_size, cfg.intermediate_size, False, device)
        self.up_proj = _linear(cfg, cfg.hidden_size, cfg.intermediate_size, False, device)
        self.down_proj = _linear(cfg, cfg.intermediate_size, cfg.hidden_size, False, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        return dense(F.silu(dense(x, self.gate_proj, dt)) * dense(x, self.up_proj, dt), self.down_proj, dt)


class LlamaBlock(nn.Module):

    def __init__(self, cfg: LlamaConfig, device=None, self_attn: Optional[nn.Module] = None):
        super().__init__()
        self.self_attn = self_attn if self_attn is not None else LlamaAttention(cfg, device=device)
        self.mlp = LlamaMLP(cfg, device=device)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype, cfg.param_dtype, device)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype, cfg.param_dtype,
                                                device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        h = x + self.self_attn(self.input_layernorm(x), positions)
        return h + self.mlp(self.post_attention_layernorm(h))


class LlamaForCausalLM(nn.Module):
    """Cache-free forward: ``input_ids`` [B, S] → logits [B, S, V] in the
    compute dtype.  Attention is always ``reference_attention``."""

    def __init__(self, cfg: LlamaConfig, device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed_tokens = nn.utils.skip_init(nn.Embedding, cfg.vocab_size, cfg.hidden_size, device=dev,
                                               dtype=cfg.param_dtype)
        self.layers = nn.ModuleList([self._make_block(cfg, dev) for _ in range(cfg.num_hidden_layers)])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype, cfg.param_dtype, dev)
        self.lm_head = None if cfg.tie_word_embeddings else _linear(cfg, cfg.hidden_size, cfg.vocab_size, False,
                                                                     dev)

    def _make_block(self, cfg: LlamaConfig, device) -> nn.Module:
        return LlamaBlock(cfg, device=device)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(input_ids.long(), self.embed_tokens.weight).to(self.cfg.dtype)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm + LM head (tied: ``embed.attend``) over hidden rows."""
        x = self.norm(x)
        if self.lm_head is None:
            return x.to(self.cfg.dtype) @ self.embed_tokens.weight.to(self.cfg.dtype).T
        return dense(x, self.lm_head, self.cfg.dtype)

    def forward(self, input_ids: torch.Tensor, positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        if positions is None:
            positions = torch.arange(input_ids.shape[1], device=input_ids.device).expand(input_ids.shape)
        x = self.embed(input_ids)
        for layer in self.layers:
            x = layer(x, positions)
        return self.logits(x)


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights from ``generator`` (on the model's device), after
    flax's initialisers: embeddings N(0, 0.02), projections N(0, 1/fan_in)
    (lecun normal, untruncated), norm scales 1, biases 0."""
    for mod in model.modules():
        if isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, 0.02, generator=generator)
        elif isinstance(mod, nn.Linear):
            mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.in_features), generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, RMSNorm):
            mod.weight.fill_(1.0)
    return model
