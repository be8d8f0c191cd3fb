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

Tensor parallelism (``tensor_parallel`` N > 1; JAX's logical axes through
``module_inject/tp_rules.py``, the collectives placed by hand in
``module_inject/layers.py`` as in ``models/llama.py``): q/k/v (and their
biases) and ``dense_h_to_4h`` (and its bias) are column-parallel, ``dense``
and ``dense_4h_to_h`` row-parallel (their biases whole, added after the
reduce), the embedding and the head vocab-parallel.  A rank attends over
its query and kv heads, and Falcon-RW's alibi adds the slopes of the
rank's heads (``rank_alibi_slopes``), not the model's first H/N.  The
parallel block (Falcon-7B, the new architecture) reduces its two
row-parallel partial sums apart: two all-reduces a block (kinds ``o_proj``
and ``down_proj``, as Llama's), each followed by its bias, so a block
computes what one rank computes.  A degree that does not divide the heads,
the kv heads (Falcon-7B's one), the MLP width or the vocab raises JAX's
``ValueError`` ("must divide").
"""

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..accelerator import DeviceLike, resolve_device
from ..module_inject.layers import (ColumnParallelLinear, RowParallelLinear, TensorParallel, VocabParallelEmbedding,
                                    copy_to_tensor_region, row_parallel_dense, set_tensor_parallel_,
                                    vocab_parallel_embed)
from ..ops.attention import reference_attention
from .llama import (LayerNorm, _parallel, apply_rope, block_runner, check_divides, dense, get_attention_impl, hf_value,
                    rotary_embedding)


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


def check_tensor_parallel(cfg: FalconConfig, tp_size: int) -> None:
    """Raise JAX's ``ValueError`` unless ``tp_size`` divides the heads, the
    kv heads, the MLP width and the vocab."""
    check_divides(tp_size, num_attention_heads=cfg.num_attention_heads, num_key_value_heads=cfg.num_kv_heads,
                  ffn_hidden_size=cfg.ffn_hidden_size or 4 * cfg.hidden_size, vocab_size=cfg.vocab_size)


def rank_alibi_slopes(cfg: FalconConfig, tp: TensorParallel, device) -> torch.Tensor:
    """The float32 alibi slopes of this rank's heads: heads ``[t·H/N,
    (t+1)·H/N)`` of the model's ``alibi_slopes(H)``."""
    return torch.from_numpy(alibi_slopes(cfg.num_attention_heads)[tp.slice(cfg.num_attention_heads)]).to(device)


class FalconAttention(nn.Module):
    """The q/k/v and ``dense`` projections and the rotary, and the
    cache-free attention (the paged twin, ``cache_zoo.FalconAttentionCache``,
    shares the projections); over ``tp_size`` ranks a rank's heads."""

    def __init__(self, cfg: FalconConfig, device=None, tp_size: int = 1):
        super().__init__()
        self.cfg = cfg
        h, kv, d, e = cfg.num_attention_heads, cfg.num_kv_heads, cfg.head_dim, cfg.hidden_size
        col, row = ColumnParallelLinear, RowParallelLinear
        self.q_proj = _parallel(col, cfg, e, h * d, cfg.bias, device, tp_size)
        self.k_proj = _parallel(col, cfg, e, kv * d, cfg.bias, device, tp_size)
        self.v_proj = _parallel(col, cfg, e, kv * d, cfg.bias, device, tp_size)
        self.dense = _parallel(row, cfg, h * d, e, cfg.bias, device, tp_size)

    @property
    def n_heads(self) -> int:
        """This rank's query heads."""
        return self.q_proj.out_features // self.cfg.head_dim

    @property
    def n_kv(self) -> int:
        """This rank's kv heads."""
        return self.k_proj.out_features // self.cfg.head_dim

    def qkv(self, x: torch.Tensor, positions: torch.Tensor):
        """x [B, S, E] → q [B, S, H, D], k/v [B, S, KV, D] (this rank's heads), rotated unless alibi."""
        cfg = self.cfg
        b, s, _ = x.shape
        d = cfg.head_dim
        x = copy_to_tensor_region(x, self.q_proj.tp, "qkv")
        q = dense(x, self.q_proj, cfg.dtype).view(b, s, self.n_heads, d)
        k = dense(x, self.k_proj, cfg.dtype).view(b, s, self.n_kv, d)
        v = dense(x, self.v_proj, cfg.dtype).view(b, s, self.n_kv, d)
        if not cfg.alibi:   # Falcon-RW: alibi in the attention instead of rotary
            cos, sin = rotary_embedding(positions, d, cfg.rope_theta)
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        return q, k, v

    def out(self, attn: torch.Tensor) -> torch.Tensor:
        b, s = attn.shape[:2]
        return row_parallel_dense(attn.reshape(b, s, -1), self.dense, self.cfg.dtype, "o_proj")

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

    def __init__(self, cfg: FalconConfig, device=None, self_attention: Optional[nn.Module] = None,
                 tp_size: int = 1):
        super().__init__()
        self.cfg = cfg
        ln = lambda: LayerNorm(cfg.hidden_size, cfg.layer_norm_epsilon, cfg.dtype, cfg.param_dtype, device)
        if not cfg.parallel_attn:
            self.input_layernorm, self.post_attention_layernorm = ln(), ln()
        elif cfg.num_ln_in_parallel_attn == 2:
            self.ln_attn, self.ln_mlp = ln(), ln()
        else:
            self.input_layernorm = ln()
        self.self_attention = self_attention if self_attention is not None else \
            FalconAttention(cfg, device, tp_size=tp_size)
        ffn = cfg.ffn_hidden_size or 4 * cfg.hidden_size
        self.dense_h_to_4h = _parallel(ColumnParallelLinear, cfg, cfg.hidden_size, ffn, cfg.bias, device, tp_size)
        self.dense_4h_to_h = _parallel(RowParallelLinear, cfg, ffn, cfg.hidden_size, cfg.bias, device, tp_size)

    def mlp(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        x = copy_to_tensor_region(x, self.dense_h_to_4h.tp, "mlp")
        return row_parallel_dense(F.gelu(dense(x, self.dense_h_to_4h, dt)), self.dense_4h_to_h, dt, "down_proj")

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
    compute dtype (``[B, S, V/N]``, this rank's vocab slice, over
    ``tensor_parallel`` N ranks); each block under ``cfg.remat``'s
    checkpoint.  The paged twin (``cache_zoo``) subclasses it with its own
    blocks (``_make_block``) and shares ``embed`` and ``logits``."""

    def __init__(self, cfg: FalconConfig, device: DeviceLike = "cuda", tensor_parallel: int = 1):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        check_tensor_parallel(cfg, tensor_parallel)
        #: this rank's place on the tensor axis (its group set by the engine)
        self.tp = TensorParallel(tensor_parallel)
        self.word_embeddings = nn.utils.skip_init(VocabParallelEmbedding, cfg.vocab_size, cfg.hidden_size,
                                                  device=dev, dtype=cfg.param_dtype, tp_size=tensor_parallel)
        self.h = nn.ModuleList([self._make_block(cfg, dev) for _ in range(cfg.num_hidden_layers)])
        self.ln_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_epsilon, cfg.dtype, cfg.param_dtype, dev)
        self.lm_head = None if cfg.tie_word_embeddings else \
            _parallel(ColumnParallelLinear, cfg, cfg.hidden_size, cfg.vocab_size, False, dev, tensor_parallel)
        if tensor_parallel > 1:
            from ..comm import comm
            set_tensor_parallel_(self, TensorParallel(tensor_parallel, comm.get_rank() % tensor_parallel))

    def _make_block(self, cfg: FalconConfig, device) -> nn.Module:
        return FalconBlock(cfg, device, tp_size=self.tp.size)

    @property
    def attention_bias_kind(self) -> Optional[str]:
        """The attention bias K1 does not take (the v1 engine's kernel
        injection refuses it): ``"alibi"`` for Falcon-RW."""
        return "alibi" if self.cfg.alibi else None

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return vocab_parallel_embed(input_ids.long(), self.word_embeddings.weight, self.tp).to(self.cfg.dtype)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """``ln_f`` and the head (tied: ``embed.attend``) over hidden rows:
        this rank's vocab slice over ``tensor_parallel`` ranks."""
        x = copy_to_tensor_region(self.ln_f(x), self.tp, "lm_head")
        if self.lm_head is None:
            return x @ self.word_embeddings.weight.to(self.cfg.dtype).T
        return dense(x, self.lm_head, self.cfg.dtype)

    def forward(self, input_ids: torch.Tensor, positions: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        if positions is None:
            positions = torch.arange(input_ids.shape[1], device=input_ids.device).expand(input_ids.shape)
        slopes = rank_alibi_slopes(cfg, self.tp, input_ids.device) if cfg.alibi else None
        x = self.embed(input_ids)
        run = block_runner(cfg)
        for block in self.h:
            x = run(block, x, positions, segment_ids, slopes)
        return self.logits(x)
