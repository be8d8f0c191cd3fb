"""The Phi-1/Phi-2 family (port of ``deepspeed_tpu/models/phi.py``): its
config, the partial rotary, the attention and block, and the cache-free
training model ``PhiForCausalLM`` (JAX ``:73-155``).

A LayerNorm (with bias) feeds parallel attention and MLP branches that share
one residual; biases on every projection and the LM head; rotary on the first
``partial_rotary_factor`` of each head; a tanh-GELU MLP; optional per-head
``qk_layernorm`` (Phi-1/1.5).  Attention follows ``cfg.attention_impl``
(``"flash"``: K1/K2a/K2b on the card, at Phi-2's head dim 80).  Served by
``cache_zoo.PhiForCausalLMWithCache``, which shares ``PhiBlock`` and the
projections of ``PhiAttention``.  Phi-3 is a Llama layout
(``inference/v2/model_implementations/policies.py``).

Tensor parallelism (``tensor_parallel`` N > 1, as ``models/falcon.py``):
q/k/v and ``fc1`` (with their biases) column-parallel, ``dense`` and
``fc2`` row-parallel (kinds ``o_proj`` and ``down_proj``, each reduced
apart, two all-reduces a parallel block; their biases whole), the
embedding vocab-parallel and the biased head column-parallel over the
vocab with the rank's slice of its bias (whole in JAX).  The partial rotary
acts on each of the rank's heads, and so does ``qk_layernorm`` (its
whole scale and bias get their gradients summed over the tensor group);
``causal_lm_loss`` with the rank's ``tp``
is the vocab-parallel cross entropy.
"""

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..accelerator import DeviceLike, resolve_device
from ..module_inject.layers import (ColumnParallelLinear, RowParallelLinear, TensorParallel, VocabParallelEmbedding,
                                    copy_to_tensor_region, row_parallel_dense, set_tensor_parallel_,
                                    vocab_parallel_embed)
from .llama import (LayerNorm, _parallel, block_runner, check_divides, dense, get_attention_impl, hf_value,
                    rotary_embedding)


@dataclasses.dataclass(frozen=True)
class PhiConfig:
    vocab_size: int = 51200
    hidden_size: int = 2560
    intermediate_size: int = 10240
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    partial_rotary_factor: float = 0.4
    rope_theta: float = 10000.0
    layer_norm_eps: float = 1e-5
    max_position_embeddings: int = 2048
    tie_word_embeddings: bool = False
    qk_layernorm: bool = False
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

    @property
    def rotary_dim(self) -> int:
        return int(self.head_dim * self.partial_rotary_factor)

    @staticmethod
    def from_hf(hf_cfg, **overrides) -> "PhiConfig":
        """From an HF Phi config (a ``config.json`` mapping or a namespace)."""
        heads = hf_value(hf_cfg, "num_attention_heads")
        fields = dict(vocab_size=hf_value(hf_cfg, "vocab_size"),
                      hidden_size=hf_value(hf_cfg, "hidden_size"),
                      intermediate_size=hf_value(hf_cfg, "intermediate_size"),
                      num_hidden_layers=hf_value(hf_cfg, "num_hidden_layers"),
                      num_attention_heads=heads,
                      num_key_value_heads=hf_value(hf_cfg, "num_key_value_heads", heads),
                      partial_rotary_factor=hf_value(hf_cfg, "partial_rotary_factor", 0.5),
                      rope_theta=hf_value(hf_cfg, "rope_theta", 10000.0),
                      layer_norm_eps=hf_value(hf_cfg, "layer_norm_eps", 1e-5),
                      max_position_embeddings=hf_value(hf_cfg, "max_position_embeddings"),
                      tie_word_embeddings=hf_value(hf_cfg, "tie_word_embeddings", False),
                      qk_layernorm=hf_value(hf_cfg, "qk_layernorm", False))
        fields.update(overrides)
        return PhiConfig(**fields)


def apply_partial_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, rotary_dim: int) -> torch.Tensor:
    """Rotate the first ``rotary_dim`` of each head (HF's ``rotate_half`` on
    its two halves, in float32) and pass the rest through; x [B, S, N, D],
    cos/sin [B, S, rotary_dim/2] (JAX ``phi.py:61``)."""
    rot, keep = x[..., :rotary_dim].float(), x[..., rotary_dim:]
    r1, r2 = rot.chunk(2, dim=-1)
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    rotated = torch.cat([r1 * c - r2 * s, r2 * c + r1 * s], dim=-1)
    return torch.cat([rotated.to(x.dtype), keep], dim=-1)


def check_tensor_parallel(cfg: PhiConfig, tp_size: int) -> None:
    """Raise JAX's ``ValueError`` unless ``tp_size`` divides the heads, the
    kv heads, the MLP width and the vocab."""
    check_divides(tp_size, num_attention_heads=cfg.num_attention_heads,
                  num_key_value_heads=cfg.num_key_value_heads, intermediate_size=cfg.intermediate_size,
                  vocab_size=cfg.vocab_size)


class PhiAttention(nn.Module):
    """The biased q/k/v and ``dense`` projections, ``qk_layernorm`` and the
    partial rotary, and the cache-free attention (the paged twin,
    ``cache_zoo.PhiAttentionCache``, shares the rest); over ``tp_size``
    ranks a rank's heads."""

    def __init__(self, cfg: PhiConfig, device=None, tp_size: int = 1):
        super().__init__()
        self.cfg = cfg
        h, kv, d, e = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim, cfg.hidden_size
        col, row = ColumnParallelLinear, RowParallelLinear
        self.q_proj = _parallel(col, cfg, e, h * d, True, device, tp_size)
        self.k_proj = _parallel(col, cfg, e, kv * d, True, device, tp_size)
        self.v_proj = _parallel(col, cfg, e, kv * d, True, device, tp_size)
        self.dense = _parallel(row, cfg, h * d, e, True, device, tp_size)
        if cfg.qk_layernorm:   # per head, over D, before the rotary (Phi-1/1.5)
            self.q_layernorm = LayerNorm(d, cfg.layer_norm_eps, cfg.dtype, cfg.param_dtype, device)
            self.k_layernorm = LayerNorm(d, cfg.layer_norm_eps, cfg.dtype, cfg.param_dtype, device)

    @property
    def n_heads(self) -> int:
        """This rank's query heads."""
        return self.q_proj.out_features // self.cfg.head_dim

    @property
    def n_kv(self) -> int:
        """This rank's kv heads."""
        return self.k_proj.out_features // self.cfg.head_dim

    def qkv(self, x: torch.Tensor, positions: torch.Tensor):
        """x [B, S, E] → q [B, S, H, D], k/v [B, S, KV, D] (this rank's heads) after the partial rotary."""
        cfg = self.cfg
        b, s, _ = x.shape
        d = cfg.head_dim
        x = copy_to_tensor_region(x, self.q_proj.tp, "qkv")
        q = dense(x, self.q_proj, cfg.dtype).view(b, s, self.n_heads, d)
        k = dense(x, self.k_proj, cfg.dtype).view(b, s, self.n_kv, d)
        v = dense(x, self.v_proj, cfg.dtype).view(b, s, self.n_kv, d)
        if cfg.qk_layernorm:
            q, k = self._head_norm(self.q_layernorm, q), self._head_norm(self.k_layernorm, k)
        cos, sin = rotary_embedding(positions, cfg.rotary_dim, cfg.rope_theta)
        return apply_partial_rope(q, cos, sin, cfg.rotary_dim), apply_partial_rope(k, cos, sin, cfg.rotary_dim), v

    def _head_norm(self, norm: LayerNorm, x: torch.Tensor) -> torch.Tensor:
        """``norm`` over D of each of the rank's heads.  Its scale and bias
        are whole on every rank but see only the rank's heads, so their
        gradients are summed over the tensor group (kind ``qk_layernorm``)."""
        tp = self.q_proj.tp
        if tp.size == 1:
            return norm(x)
        w, b = (copy_to_tensor_region(p, tp, "qk_layernorm") for p in (norm.weight, norm.bias))
        return F.layer_norm(x.float(), (x.shape[-1], ), w.float(), b.float(), norm.eps).to(norm.dtype)

    def out(self, attn: torch.Tensor) -> torch.Tensor:
        b, s = attn.shape[:2]
        return row_parallel_dense(attn.reshape(b, s, -1), self.dense, self.cfg.dtype, "o_proj")

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        q, k, v = self.qkv(x, positions)
        return self.out(get_attention_impl(self.cfg.attention_impl)(q, k, v, causal=True, segment_ids=segment_ids))


class PhiBlock(nn.Module):
    """``x + attn(ln(x)) + mlp(ln(x))`` with a tanh-GELU MLP;
    ``forward(x, *attn_args)`` hands ``attn_args`` to ``self_attn`` (the
    cache-free attention, or the paged twin's when given)."""

    def __init__(self, cfg: PhiConfig, device=None, self_attn: Optional[nn.Module] = None, tp_size: int = 1):
        super().__init__()
        self.cfg = cfg
        self.input_layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype, cfg.param_dtype, device)
        self.self_attn = self_attn if self_attn is not None else PhiAttention(cfg, device, tp_size=tp_size)
        self.fc1 = _parallel(ColumnParallelLinear, cfg, cfg.hidden_size, cfg.intermediate_size, True, device, tp_size)
        self.fc2 = _parallel(RowParallelLinear, cfg, cfg.intermediate_size, cfg.hidden_size, True, device, tp_size)

    def forward(self, x: torch.Tensor, *attn_args) -> torch.Tensor:
        dt = self.cfg.dtype
        h = self.input_layernorm(x)
        attn = self.self_attn(h, *attn_args)
        m_in = copy_to_tensor_region(h, self.fc1.tp, "mlp")
        mlp = row_parallel_dense(F.gelu(dense(m_in, self.fc1, dt), approximate="tanh"), self.fc2, dt, "down_proj")
        return x + attn + mlp


class PhiForCausalLM(nn.Module):
    """Cache-free forward: ``input_ids`` [B, S] → logits [B, S, V] in the
    compute dtype (``[B, S, V/N]``, this rank's vocab slice, over
    ``tensor_parallel`` N ranks); each block under ``cfg.remat``'s
    checkpoint.  The paged twin (``cache_zoo``) subclasses it with its own
    blocks (``_make_block``) and shares ``embed`` and ``logits``."""

    def __init__(self, cfg: PhiConfig, device: DeviceLike = "cuda", tensor_parallel: int = 1):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        check_tensor_parallel(cfg, tensor_parallel)
        #: this rank's place on the tensor axis (its group set by the engine)
        self.tp = TensorParallel(tensor_parallel)
        self.embed_tokens = nn.utils.skip_init(VocabParallelEmbedding, cfg.vocab_size, cfg.hidden_size, device=dev,
                                               dtype=cfg.param_dtype, tp_size=tensor_parallel)
        self.layers = nn.ModuleList([self._make_block(cfg, dev) for _ in range(cfg.num_hidden_layers)])
        self.final_layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype, cfg.param_dtype, dev)
        self.lm_head = _parallel(ColumnParallelLinear, cfg, cfg.hidden_size, cfg.vocab_size, True, dev,
                                 tensor_parallel)
        if tensor_parallel > 1:
            from ..comm import comm
            set_tensor_parallel_(self, TensorParallel(tensor_parallel, comm.get_rank() % tensor_parallel))

    def _make_block(self, cfg: PhiConfig, device) -> nn.Module:
        return PhiBlock(cfg, device, tp_size=self.tp.size)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return vocab_parallel_embed(input_ids.long(), self.embed_tokens.weight, self.tp).to(self.cfg.dtype)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """The final LayerNorm and the biased head: this rank's vocab slice
        (and its slice of the bias) over ``tensor_parallel`` ranks."""
        return dense(copy_to_tensor_region(self.final_layernorm(x), self.tp, "lm_head"), self.lm_head, self.cfg.dtype)

    def forward(self, input_ids: torch.Tensor, positions: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        if positions is None:
            positions = torch.arange(input_ids.shape[1], device=input_ids.device).expand(input_ids.shape)
        x = self.embed(input_ids)
        run = block_runner(self.cfg)
        for layer in self.layers:
            x = run(layer, x, positions, segment_ids)
        return self.logits(x)
