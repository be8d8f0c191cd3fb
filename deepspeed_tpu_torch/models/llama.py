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
``flash_only``; see ``remat_context_fn``), through ``block_runner``, which
every cache-free model of the port shares.  A ``sliding_window`` reaches the
attention impl as JAX's does (``llama.py:395-399``): the flash op sends it to
the chunked path, as JAX's does, so no kernel runs for a window.

Numerics follow the JAX modules: weights live in ``param_dtype`` and are
cast to ``dtype`` at use (flax ``DenseGeneral``/``Embed`` promote the same
way); RMSNorm and RoPE compute in float32 and cast back; attention
accumulates in float32.

Tensor parallelism (``tensor_parallel`` N > 1; JAX's Megatron layout from
``module_inject/tp_rules.py``, the collectives GSPMD inserts placed by hand
in ``module_inject/layers.py``): q/k/v (with their biases), gate and up
are column-parallel, o and down row-parallel (one all-reduce each, in the forward), the embedding
vocab-parallel (ids outside the rank's rows look up zeros, then an
all-reduce) and the LM head vocab-parallel, tied or not, so the cache-free
model's logits are ``[B, S, V/N]`` on a rank; ``causal_lm_loss`` with the
rank's ``tp`` is the vocab-parallel cross entropy.  Rank t attends over
query heads ``[t·H/N, (t+1)·H/N)`` and kv heads ``[t·HK/N, (t+1)·HK/N)``,
so each query head keeps its kv head.  The norms are replicated: their
gradients are equal on every rank of a tensor group without a reduce.
``init_weights_`` draws each cut tensor whole from the generator and keeps
the rank's slice, one tensor at a time, so a rank holds exactly the slices
of the one-rank model of the same seed.

Parameter names mirror the JAX tree (``embed_tokens``, ``layers.{i}.
self_attn.{q,k,v,o}_proj``, ``input_layernorm``, ``post_attention_layernorm``,
``mlp.{gate,up,down}_proj``, ``norm``, ``lm_head``) so that
``models/convert.py`` maps one onto the other leaf by leaf, and the cache
twin (``llama_cache.py``) loads the same state dict.
"""

import dataclasses
import functools
import math
from typing import Callable, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..accelerator import DeviceLike, resolve_device
from ..module_inject.layers import (NO_TENSOR_PARALLEL, ColumnParallelLinear, RowParallelLinear, TensorParallel,
                                    VocabParallelEmbedding, all_reduce_f32, copy_to_tensor_region,
                                    narrow_to_rank, row_parallel_dense, set_tensor_parallel_, tensor_parallel_of,
                                    vocab_parallel_embed)
from ..ops.attention import chunked_attention, reference_attention
from ..ops.flash_attention import flash_attention


_REQUIRED = object()


def hf_value(hf_cfg, name: str, default=_REQUIRED):
    """Field ``name`` of an HF config: a mapping read from ``config.json``
    or any object with attributes (a ``SimpleNamespace``, a transformers
    config).  A missing or null field gives ``default``; a missing required
    one raises ``KeyError``."""
    value = hf_cfg.get(name) if isinstance(hf_cfg, Mapping) else getattr(hf_cfg, name, None)
    if value is None:
        if default is _REQUIRED:
            raise KeyError(f"the HF config has no {name!r}")
        return default
    return value


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
    attention_out_bias: bool = False  # o_proj bias (InternLM-1, Llama with attention_bias)
    sliding_window: int = 0  # 0 = full attention; > 0 = Mistral's window
    # per-block activation checkpointing of the cache-free model (training)
    remat: bool = True
    remat_policy: str = "nothing_saveable"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def from_hf(hf_cfg, **overrides) -> "LlamaConfig":
        """From an HF config (``config.json`` as a mapping, or a namespace),
        with JAX's rules (``llama.py:57-87``): ``use_sliding_window=False``
        turns the window off (Qwen2 ships ``sliding_window`` 32768 unused);
        ``max_window_layers`` >= the layer count means no layer is windowed,
        and a smaller positive one (mixed full and windowed layers) raises."""
        layers = hf_value(hf_cfg, "num_hidden_layers")
        heads = hf_value(hf_cfg, "num_attention_heads")
        window = hf_value(hf_cfg, "sliding_window", 0) if hf_value(hf_cfg, "use_sliding_window", True) else 0
        fields = dict(
            vocab_size=hf_value(hf_cfg, "vocab_size"),
            hidden_size=hf_value(hf_cfg, "hidden_size"),
            intermediate_size=hf_value(hf_cfg, "intermediate_size"),
            num_hidden_layers=layers,
            num_attention_heads=heads,
            num_key_value_heads=hf_value(hf_cfg, "num_key_value_heads", heads),
            max_position_embeddings=hf_value(hf_cfg, "max_position_embeddings"),
            rope_theta=hf_value(hf_cfg, "rope_theta", 10000.0),
            rms_norm_eps=hf_value(hf_cfg, "rms_norm_eps", 1e-5),
            tie_word_embeddings=hf_value(hf_cfg, "tie_word_embeddings", False),
            attention_bias=hf_value(hf_cfg, "attention_bias", False),
            sliding_window=window,
        )
        mwl = hf_value(hf_cfg, "max_window_layers", None)
        if window and mwl is not None:
            if mwl >= layers:
                fields["sliding_window"] = 0
            elif mwl > 0:
                raise NotImplementedError(f"mixed full/window attention (max_window_layers={mwl} of {layers}) is "
                                          "not supported, as in the JAX package's scanned layers")
        fields.update(overrides)
        return LlamaConfig(**fields)


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


def _parallel(cls, cfg: LlamaConfig, fan_in: int, fan_out: int, bias: bool, device, tp_size: int) -> nn.Linear:
    """An uninitialised column- or row-parallel ``nn.Linear`` (``cls``) of
    whole size ``fan_in`` → ``fan_out`` over ``tp_size`` ranks."""
    return nn.utils.skip_init(cls, fan_in, fan_out, bias=bias, device=device, dtype=cfg.param_dtype, tp_size=tp_size)


def check_divides(tp_size: int, **dims: int) -> None:
    """Raise JAX's ``ValueError`` ("must divide") unless ``tp_size``
    divides every dim of ``dims`` (name → size)."""
    bad = {k: v for k, v in dims.items() if v % tp_size}
    if bad:
        raise ValueError(f"tensor_parallel={tp_size} must divide " + ", ".join(f"{k}={v}" for k, v in bad.items()))


def check_tensor_parallel(cfg: LlamaConfig, tp_size: int) -> None:
    """Raise unless ``tp_size`` divides the heads, the kv heads, the MLP
    width and the vocab (JAX's serving engine raises for the heads,
    ``engine_v2.py:355-358``; its layouts refuse the others)."""
    check_divides(tp_size, num_attention_heads=cfg.num_attention_heads,
                  num_key_value_heads=cfg.num_key_value_heads, intermediate_size=cfg.intermediate_size,
                  vocab_size=cfg.vocab_size)


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
                                  "not ported yet (ROADMAP Queue 1 item 6, multi-device training)")
    raise ValueError(f"Unknown attention impl {name!r} (reference | chunked | flash)")


class LlamaAttention(nn.Module):
    """Projections + RoPE shared by the cache-free and the paged forward;
    over ``tp_size`` ranks a rank's heads (q/k/v column-parallel, o
    row-parallel)."""

    def __init__(self, cfg: LlamaConfig, device=None, tp_size: int = 1):
        super().__init__()
        check_tensor_parallel(cfg, tp_size)
        self.cfg = cfg
        hd, e = cfg.head_dim, cfg.hidden_size
        col, row = ColumnParallelLinear, RowParallelLinear
        self.q_proj = _parallel(col, cfg, e, cfg.num_attention_heads * hd, cfg.attention_bias, device, tp_size)
        self.k_proj = _parallel(col, cfg, e, cfg.num_key_value_heads * hd, cfg.attention_bias, device, tp_size)
        self.v_proj = _parallel(col, cfg, e, cfg.num_key_value_heads * hd, cfg.attention_bias, device, tp_size)
        self.o_proj = _parallel(row, cfg, cfg.num_attention_heads * hd, e, cfg.attention_out_bias, device, tp_size)

    @property
    def n_heads(self) -> int:
        """This rank's query heads."""
        return self.q_proj.out_features // self.cfg.head_dim

    @property
    def n_kv(self) -> int:
        """This rank's kv heads."""
        return self.k_proj.out_features // self.cfg.head_dim

    def qkv(self, x: torch.Tensor, positions: torch.Tensor):
        """x [B, S, E] → post-RoPE q [B, S, H, D], k/v [B, S, KV, D] (this rank's heads)."""
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.head_dim
        x = copy_to_tensor_region(x, self.q_proj.tp, "qkv")
        q = dense(x, self.q_proj, cfg.dtype).view(b, s, self.n_heads, hd)
        k = dense(x, self.k_proj, cfg.dtype).view(b, s, self.n_kv, hd)
        v = dense(x, self.v_proj, cfg.dtype).view(b, s, self.n_kv, hd)
        cos, sin = rotary_embedding(positions, hd, cfg.rope_theta)
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v

    def out(self, attn: torch.Tensor) -> torch.Tensor:
        b, s = attn.shape[:2]
        return row_parallel_dense(attn.reshape(b, s, -1), self.o_proj, self.cfg.dtype, "o_proj")

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        q, k, v = self.qkv(x, positions)
        attn = get_attention_impl(self.cfg.attention_impl)
        kw = {"sliding_window": self.cfg.sliding_window} if self.cfg.sliding_window else {}
        return self.out(attn(q, k, v, causal=True, segment_ids=segment_ids, **kw))


class LlamaMLP(nn.Module):
    """SwiGLU; over ``tp_size`` ranks gate and up are column-parallel, down
    row-parallel."""

    def __init__(self, cfg: LlamaConfig, device=None, tp_size: int = 1):
        super().__init__()
        self.cfg = cfg
        col, row = ColumnParallelLinear, RowParallelLinear
        self.gate_proj = _parallel(col, cfg, cfg.hidden_size, cfg.intermediate_size, False, device, tp_size)
        self.up_proj = _parallel(col, cfg, cfg.hidden_size, cfg.intermediate_size, False, device, tp_size)
        self.down_proj = _parallel(row, cfg, cfg.intermediate_size, cfg.hidden_size, False, device, tp_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        x = copy_to_tensor_region(x, self.gate_proj.tp, "mlp")
        return row_parallel_dense(F.silu(dense(x, self.gate_proj, dt)) * dense(x, self.up_proj, dt), self.down_proj,
                                  dt, "down_proj")


class LlamaBlock(nn.Module):

    def __init__(self, cfg: LlamaConfig, device=None, self_attn: Optional[nn.Module] = None, tp_size: int = 1):
        super().__init__()
        self.cfg = cfg
        self.self_attn = self_attn if self_attn is not None else LlamaAttention(cfg, device=device, tp_size=tp_size)
        self.mlp = LlamaMLP(cfg, device=device, tp_size=tp_size)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype, cfg.param_dtype, device)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype, cfg.param_dtype,
                                                device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, segment_ids: Optional[torch.Tensor] = None,
                pld_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``pld_scale`` (a 0-d tensor) gates both residual deltas of the
        block in the compute dtype, as JAX's ``s * ...`` with ``s =
        pld_scale.astype(cfg.dtype)`` (progressive layer drop)."""
        attn = self.self_attn(self.input_layernorm(x), positions, segment_ids)
        s = None if pld_scale is None else pld_scale.to(self.cfg.dtype)
        h = x + (attn if s is None else s * attn)
        mlp = self.mlp(self.post_attention_layernorm(h))
        return h + (mlp if s is None else s * mlp)


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


def block_runner(cfg) -> Callable:
    """How a cache-free model runs one of its blocks, ``run(block, *args)``:
    under ``torch.utils.checkpoint`` with ``cfg.remat_policy`` when
    ``cfg.remat`` and gradients are on (JAX's ``nn.remat`` around each
    block), else a plain call."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return lambda block, *args: block(*args)
    from torch.utils.checkpoint import checkpoint
    context_fn = remat_context_fn(cfg.remat_policy)
    kw = {} if context_fn is None else {"context_fn": context_fn}
    return lambda block, *args: checkpoint(block, *args, use_reentrant=False, **kw)


class LlamaForCausalLM(nn.Module):
    """Cache-free forward: ``input_ids`` [B, S] → logits [B, S, V] in the
    compute dtype (``[B, S, V/N]``, this rank's vocab slice, over
    ``tensor_parallel`` N ranks).  Attention follows ``cfg.attention_impl``
    through ``get_attention_impl``.  A tensor-parallel model holds the
    slices of the process group's rank modulo N (its tensor coordinate in
    JAX's data × tensor layout) and runs its collectives on ``tp.group``;
    the engine that holds it sets both
    (``module_inject.layers.set_tensor_parallel_``)."""

    def __init__(self, cfg: LlamaConfig, device: DeviceLike = "cuda", tensor_parallel: int = 1):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        check_tensor_parallel(cfg, tensor_parallel)
        #: this rank's place on the tensor axis (its group set by the engine)
        self.tp = TensorParallel(tensor_parallel)
        self.embed_tokens = nn.utils.skip_init(VocabParallelEmbedding, cfg.vocab_size, cfg.hidden_size, device=dev,
                                               dtype=cfg.param_dtype, tp_size=tensor_parallel)
        self.layers = nn.ModuleList([self._make_block(cfg, dev, i) for i in range(cfg.num_hidden_layers)])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype, cfg.param_dtype, dev)
        self.lm_head = None if cfg.tie_word_embeddings else \
            _parallel(ColumnParallelLinear, cfg, cfg.hidden_size, cfg.vocab_size, False, dev, tensor_parallel)
        if tensor_parallel > 1:
            from ..comm import comm
            set_tensor_parallel_(self, TensorParallel(tensor_parallel, comm.get_rank() % tensor_parallel))

    def _make_block(self, cfg: LlamaConfig, device, layer: int) -> nn.Module:
        """Block ``layer`` of the stack (a family whose layers differ, as
        Qwen2-MoE's dense and sparse ones, reads the index)."""
        return LlamaBlock(cfg, device=device, tp_size=self.tp.size)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return vocab_parallel_embed(input_ids.long(), self.embed_tokens.weight, self.tp).to(self.cfg.dtype)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm + LM head (tied: ``embed.attend``) over hidden rows:
        this rank's vocab slice of the logits over ``tensor_parallel`` ranks."""
        x = copy_to_tensor_region(self.norm(x), self.tp, "lm_head")
        if self.lm_head is None:
            return x.to(self.cfg.dtype) @ self.embed_tokens.weight.to(self.cfg.dtype).T
        return dense(x, self.lm_head, self.cfg.dtype)

    #: the engine passes ``pld_scale`` when progressive layer drop is configured
    supports_pld = True

    def forward(self, input_ids: torch.Tensor, positions: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None, pld_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``pld_scale`` (``[L]``, progressive layer drop's ``mask/keep_p``)
        gates layer ``l``'s residual deltas by ``pld_scale[l]``; it reaches
        each block through the remat ``checkpoint`` call."""
        if pld_scale is not None and pld_scale.shape != (self.cfg.num_hidden_layers, ):
            raise ValueError(f"pld_scale has shape {tuple(pld_scale.shape)}, expected "
                             f"({self.cfg.num_hidden_layers},)")
        if positions is None:
            positions = torch.arange(input_ids.shape[1], device=input_ids.device).expand(input_ids.shape)
        x = self.embed(input_ids)
        run = block_runner(self.cfg)
        for i, layer in enumerate(self.layers):
            x = run(layer, x, positions, segment_ids, None if pld_scale is None else pld_scale[i])
        return self.logits(x)


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights from ``generator`` (on the model's device), after
    flax's initialisers: embeddings N(0, 0.02), projections N(0, 1/fan_in)
    (lecun normal, untruncated), norm scales 1, biases 0; a module with
    weights of its own kind (the MoE routers and expert banks) initialises
    them by its ``init_weights_(generator)``."""
    for mod in model.modules():
        tp = tensor_parallel_of(mod)
        dim = getattr(mod, "tp_dim", None) if tp.size > 1 else None
        if isinstance(mod, nn.Embedding):
            _draw_whole(mod.weight, dim, tp, lambda w: w.normal_(0.0, 0.02, generator=generator))
        elif isinstance(mod, nn.Linear):
            fan_in = mod.in_features * (tp.size if dim == 1 else 1)
            _draw_whole(mod.weight, dim, tp, lambda w: w.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, RMSNorm):
            mod.weight.fill_(1.0)
        elif hasattr(mod, "init_weights_"):
            mod.init_weights_(generator)
    return model


def _draw_whole(param: torch.Tensor, dim: Optional[int], tp: TensorParallel, draw) -> None:
    """``draw`` the whole tensor of which ``param`` is this rank's slice on
    ``dim`` (``param`` itself when it is whole) and keep the slice: the
    generator advances as for the whole tensor."""
    if dim is None:
        draw(param)
        return
    shape = list(param.shape)
    shape[dim] *= tp.size
    whole = draw(torch.empty(shape, dtype=param.dtype, device=param.device))
    param.copy_(narrow_to_rank(whole, dim, tp))


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


class _VocabParallelCausalLMLoss(torch.autograd.Function):
    """``_CausalLMLoss`` over vocab-parallel logits ``[B, S, V/N]`` (rank t
    holds columns ``[t·V/N, (t+1)·V/N)``): the row max is all-reduced
    (MAX), then the sum of ``exp(x − max)`` and the target logit, which only
    its owner adds (one SUM of both); every rank gets the loss.  The
    backward is the rank's slice of ``(softmax − onehot)·w``, no collective."""

    @staticmethod
    def forward(ctx, logits, labels, loss_mask, denom, tp):
        lf = logits.float()
        m = all_reduce_f32(lf.max(dim=-1).values, tp, "loss_max", op="max")                   # [B, S]
        n = logits.shape[-1]
        local = labels.long() - tp.rank * n
        inside = (local >= 0) & (local < n)
        tgt = torch.gather(logits, -1, torch.where(inside, local, 0)[..., None])[..., 0].float()
        sums = all_reduce_f32(torch.stack([torch.exp(lf - m[..., None]).sum(-1), torch.where(inside, tgt, 0.0)]),
                              tp, "loss_sum")
        lse = m + torch.log(sums[0])
        nll = lse - sums[1]
        mask = None if loss_mask is None else loss_mask.float()
        if denom is not None:
            loss = (nll if mask is None else nll * mask).sum() / denom
        elif mask is not None:
            denom = mask.sum().clamp_min(1.0)
            loss = (nll * mask).sum() / denom
        else:
            denom = torch.tensor(float(nll.numel()), device=nll.device)
            loss = nll.mean()
        ctx.save_for_backward(logits, local, inside, lse, denom, *([] if mask is None else [mask]))
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, local, inside, lse, denom, *mask = ctx.saved_tensors
        w = (g / denom) * mask[0] if mask else (g / denom).expand(lse.shape)
        d = torch.exp(logits.float() - lse[..., None])                                  # softmax
        d.scatter_add_(-1, torch.where(inside, local, 0)[..., None],
                       torch.where(inside, -1.0, 0.0)[..., None].to(d.dtype))           # − onehot, owner only
        d.mul_(w[..., None])
        return d.to(logits.dtype), None, None, None, None


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor, loss_mask: Optional[torch.Tensor] = None,
                   denom: Optional[torch.Tensor] = None, tp: TensorParallel = NO_TENSOR_PARALLEL) -> torch.Tensor:
    """Token-mean cross entropy in float32 from an f32 logsumexp minus the
    target logit; with ``loss_mask`` the mean is over the masked-in tokens
    (denominator ``max(sum, 1)``).  ``denom`` replaces the denominator: a
    data-parallel rank divides its token sum by the count over all ranks, so
    that the ranks' sum is one mean over the global batch.  The gradient is
    ``(softmax − onehot)·w`` in the logits' dtype, computed from the saved
    logits: no [B, S, V] float32 log-prob tensor is kept.  With a ``tp`` of
    more than one rank, ``logits`` are this rank's vocab slice
    (``_VocabParallelCausalLMLoss``)."""
    if tp.size > 1:
        return _VocabParallelCausalLMLoss.apply(logits, labels, loss_mask, denom, tp)
    return _CausalLMLoss.apply(logits, labels, loss_mask, denom)
