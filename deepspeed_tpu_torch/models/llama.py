"""Llama-family causal LM (port of ``deepspeed_tpu/models/llama.py``).

The config and presets, ``RMSNorm``, the half-split rotary embedding, the
MLP, the cache-free forward (``LlamaForCausalLM``) that the training step
runs, and the token-mean cross entropy with its hand-written gradient
(``causal_lm_loss``).  The paged serving twin (``llama_cache.py``) shares the
projections, the MLP and the norms.

Attention in the cache-free model follows ``cfg.attention_impl`` as in JAX
(``get_attention_impl``): ``"reference"`` (full scores) or ``"chunked"``
(query chunks, no [B, N, S, S] tensor), both in ``ops/attention.py``, or ``"flash"`` (``ops/flash_attention``:
the CUDA kernels K1/K2a/K2b on a GPU, their plain versions on the CPU).  In
the serving twin ``"flash"`` means the paged kernel K3, as in JAX.

``cfg.remat`` wraps each block in ``torch.utils.checkpoint`` under
``cfg.remat_policy`` (``nothing_saveable``, ``flash_saveable``,
``flash_only``; see ``remat_context_fn``).

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
import functools
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..accelerator import DeviceLike, resolve_device
from ..ops.attention import chunked_attention, reference_attention
from ..ops.flash_attention import flash_attention


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
    # cache-free model: "reference" | "chunked" | "flash" (get_attention_impl);
    # serving twin: "flash" runs the paged CUDA kernel K3 on a GPU tensor
    # (its plain version on a CPU tensor), "reference" the plain version
    attention_impl: str = "flash"
    attention_bias: bool = False  # qkv bias (Qwen2-style checkpoints)
    # per-block activation checkpointing of the cache-free model (training)
    remat: bool = True
    remat_policy: str = "nothing_saveable"

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


def get_attention_impl(name: str) -> Callable:
    """The attention function of the cache-free model (JAX ``llama.py:354``)."""
    if name == "reference":
        return reference_attention
    if name == "chunked":
        return chunked_attention
    if name == "flash":
        return flash_attention
    if name in ("ulysses", "fpdt", "ring"):
        raise NotImplementedError(f"attention_impl {name!r} is sequence-parallel attention over several devices: "
                                  "not ported yet (ROADMAP Queue 1, multi-device training)")
    raise ValueError(f"Unknown attention impl {name!r} (reference | chunked | flash)")


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

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        q, k, v = self.qkv(x, positions)
        attn = get_attention_impl(self.cfg.attention_impl)
        return self.out(attn(q, k, v, causal=True, segment_ids=segment_ids))


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

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = x + self.self_attn(self.input_layernorm(x), positions, segment_ids)
        return h + self.mlp(self.post_attention_layernorm(h))


def remat_context_fn(policy: str) -> Optional[Callable]:
    """The ``context_fn`` of ``torch.utils.checkpoint`` for a JAX remat
    policy name (``llama.py:126-142``), or None for full recompute.

    * ``nothing_saveable``: every activation of the block is recomputed in
      the backward (the forward attention kernel K1 included);
    * ``flash_saveable``: the outputs of the projection and MLP matmuls
      (``aten.mm``/``aten.addmm``: JAX's dots without batch dims) and of the
      flash forward op (``ds_torch::flash_fwd``: o and lse) are saved, so the
      backward launches K2a/K2b without relaunching K1;
    * ``flash_only``: only the flash forward's outputs are saved.
    """
    if policy == "nothing_saveable":
        return None
    from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

    saved = {torch.ops.ds_torch.flash_fwd.default}
    if policy == "flash_saveable":
        saved |= {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}
    elif policy != "flash_only":
        raise ValueError(f"unknown remat_policy {policy!r} (nothing_saveable | flash_saveable | flash_only)")

    def choose(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, choose)


class LlamaForCausalLM(nn.Module):
    """Cache-free forward: ``input_ids`` [B, S] → logits [B, S, V] in the
    compute dtype.  Attention follows ``cfg.attention_impl`` through
    ``get_attention_impl``."""

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

    def forward(self, input_ids: torch.Tensor, positions: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None, pld_scale=None) -> torch.Tensor:
        if pld_scale is not None:
            raise NotImplementedError("progressive layer drop is not ported (ROADMAP Queue 1, training features)")
        if positions is None:
            positions = torch.arange(input_ids.shape[1], device=input_ids.device).expand(input_ids.shape)
        x = self.embed(input_ids)
        remat = self.cfg.remat and torch.is_grad_enabled()
        if remat:
            from torch.utils.checkpoint import checkpoint
            context_fn = remat_context_fn(self.cfg.remat_policy)
            kw = {} if context_fn is None else {"context_fn": context_fn}
        for layer in self.layers:
            if remat:
                x = checkpoint(layer, x, positions, segment_ids, use_reentrant=False, **kw)
            else:
                x = layer(x, positions, segment_ids)
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


class _CausalLMLoss(torch.autograd.Function):
    """Token-mean cross entropy with the hand-written gradient of the JAX
    ``causal_lm_loss`` (``llama.py:514-557``)."""

    @staticmethod
    def forward(ctx, logits, labels, loss_mask, denom):
        lse = torch.logsumexp(logits.float(), dim=-1)                                   # [B, S]
        tgt = torch.gather(logits, -1, labels[..., None].long())[..., 0].float()
        nll = lse - tgt
        mask = None if loss_mask is None else loss_mask.float()
        if denom is not None:
            loss = (nll if mask is None else nll * mask).sum() / denom
        elif mask is not None:
            denom = mask.sum().clamp_min(1.0)
            loss = (nll * mask).sum() / denom
        else:
            denom = torch.tensor(float(nll.numel()), device=nll.device)
            loss = nll.mean()
        ctx.save_for_backward(logits, labels, lse, denom, *([] if mask is None else [mask]))
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse, denom, *mask = ctx.saved_tensors
        w = (g / denom) * mask[0] if mask else (g / denom).expand(lse.shape)
        d = torch.exp(logits.float() - lse[..., None])                                  # softmax
        d.scatter_add_(-1, labels[..., None].long(), torch.full_like(lse[..., None], -1.0))  # − onehot
        d.mul_(w[..., None])
        return d.to(logits.dtype), None, None, None


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor, loss_mask: Optional[torch.Tensor] = None,
                   denom: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean cross entropy in float32 from an f32 logsumexp minus the
    target logit; with ``loss_mask`` the mean is over the masked-in tokens
    (denominator ``max(sum, 1)``).  ``denom`` replaces the denominator: a
    data-parallel rank divides its token sum by the count over all ranks, so
    that the ranks' sum is one mean over the global batch.  The gradient is
    ``(softmax − onehot)·w`` in the logits' dtype, computed from the saved
    logits: no [B, S, V] float32 log-prob tensor is kept."""
    return _CausalLMLoss.apply(logits, labels, loss_mask, denom)
