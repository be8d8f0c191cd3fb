"""Qwen2-MoE: Llama attention with q/k/v biases and a sparse MLP with a
shared expert (port of ``deepspeed_tpu/models/qwen2_moe.py``; ref:
``inference/v2/model_implementations/qwen_v2_moe``).

The sparse MLP is JAX's exact dense mixture: a float32 softmax over all
experts, top-k (renormalised when ``norm_topk_prob``), every expert
evaluated on every token and weighed by a ``[T, E]`` matrix that is zero off
the top-k, summed in float32; plus the shared SwiGLU expert scaled by
``sigmoid(shared_expert_gate(x))`` in float32, then cast back
(``qwen2_moe.py:130-187``).  The gate and the shared-expert gate compute in
float32 on weights kept in ``param_dtype``.  Layers listed in
``mlp_only_layers``, or off ``decoder_sparse_step``, have the dense SwiGLU
MLP at ``intermediate_size`` (a mixed stack).

Over ``tensor_parallel`` N ranks (JAX's layout from ``tp_rules``, the
collectives GSPMD inserts placed by hand): the attention is the Llama
model's tensor-parallel path (the q/k/v biases cut with their heads); the
expert banks are cut on ``expert_mlp`` (``w_gate``/``w_up`` column-,
``w_down`` row-parallel), the shared expert is column- then row-parallel,
the router and the sigmoid shared-expert gate are whole.  The routed float32
mixture of the rank's partial expert outputs and the gated partial shared
expert are summed on each rank and all-reduced once, in float32, before the
cast.  The rows enter the banks and the shared expert through one
``copy_to_tensor_region``, and the routing weights and the shared gate
through one each, so their partial gradients are summed in the backward;
the gates' own input is not copied.

Parameter names mirror the JAX tree with the layers unrolled
(``layers.{i}.mlp.{gate.weight, w_gate, w_up, w_down, shared_gate_proj,
shared_up_proj, shared_down_proj, shared_expert_gate.weight}``; a dense
layer's ``mlp.{gate,up,down}_proj``).  The paged twin is in
``cache_zoo.py``.
"""

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..accelerator import DeviceLike
from ..module_inject.layers import (ColumnParallelLinear, RowParallelLinear, TensorParallel, copy_to_tensor_region,
                                    reduce_from_tensor_region)
from ..moe.experts import ExpertsFFN, swiglu_experts
from ..moe.layer import Router
from ..moe.sharded_moe import top_k
from .llama import (LlamaAttention, LlamaConfig, LlamaForCausalLM, LlamaMLP, RMSNorm, _draw_whole, _parallel, dense,
                    hf_value)


@dataclasses.dataclass(frozen=True)
class Qwen2MoeConfig:
    vocab_size: int = 151936
    hidden_size: int = 2048
    intermediate_size: int = 5632          # the dense layers' (unused when every layer is sparse)
    moe_intermediate_size: int = 1408
    shared_expert_intermediate_size: int = 5632
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    num_experts: int = 60
    num_experts_per_tok: int = 4
    norm_topk_prob: bool = False
    mlp_only_layers: tuple = ()            # HF: dense-MLP layer indices
    decoder_sparse_step: int = 1           # HF: layer i is sparse iff (i + 1) % step == 0
    qkv_bias: bool = True
    max_position_embeddings: int = 8192
    rope_theta: float = 1e6
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    attention_impl: str = "flash"
    remat: bool = True
    remat_policy: str = "nothing_saveable"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    def as_llama(self) -> LlamaConfig:
        return LlamaConfig(vocab_size=self.vocab_size, hidden_size=self.hidden_size,
                           intermediate_size=self.moe_intermediate_size, num_hidden_layers=self.num_hidden_layers,
                           num_attention_heads=self.num_attention_heads,
                           num_key_value_heads=self.num_key_value_heads,
                           max_position_embeddings=self.max_position_embeddings, rope_theta=self.rope_theta,
                           rms_norm_eps=self.rms_norm_eps, dtype=self.dtype, param_dtype=self.param_dtype,
                           attention_impl=self.attention_impl, attention_bias=self.qkv_bias, remat=self.remat,
                           remat_policy=self.remat_policy)

    def layer_is_sparse(self, i: int) -> bool:
        """HF ``Qwen2MoeDecoderLayer``: dense for ``mlp_only_layers`` and
        off-step layers, sparse otherwise."""
        return (i not in tuple(self.mlp_only_layers) and self.num_experts > 0
                and (i + 1) % max(1, self.decoder_sparse_step) == 0)

    @property
    def mixed_stack(self) -> bool:
        return any(not self.layer_is_sparse(i) for i in range(self.num_hidden_layers))

    @staticmethod
    def from_hf(hf_cfg, **overrides) -> "Qwen2MoeConfig":
        """From an HF config (a ``config.json`` mapping or a namespace), with
        JAX's fields and defaults (``:76-101``)."""
        heads = hf_value(hf_cfg, "num_attention_heads")
        fields = dict(vocab_size=hf_value(hf_cfg, "vocab_size"),
                      hidden_size=hf_value(hf_cfg, "hidden_size"),
                      intermediate_size=hf_value(hf_cfg, "intermediate_size"),
                      moe_intermediate_size=hf_value(hf_cfg, "moe_intermediate_size"),
                      shared_expert_intermediate_size=hf_value(hf_cfg, "shared_expert_intermediate_size"),
                      num_hidden_layers=hf_value(hf_cfg, "num_hidden_layers"),
                      num_attention_heads=heads,
                      num_key_value_heads=hf_value(hf_cfg, "num_key_value_heads", heads),
                      num_experts=hf_value(hf_cfg, "num_experts"),
                      num_experts_per_tok=hf_value(hf_cfg, "num_experts_per_tok"),
                      norm_topk_prob=hf_value(hf_cfg, "norm_topk_prob", False),
                      qkv_bias=hf_value(hf_cfg, "qkv_bias", True),
                      max_position_embeddings=hf_value(hf_cfg, "max_position_embeddings"),
                      rope_theta=hf_value(hf_cfg, "rope_theta", 1e6),
                      rms_norm_eps=hf_value(hf_cfg, "rms_norm_eps", 1e-6),
                      tie_word_embeddings=hf_value(hf_cfg, "tie_word_embeddings", False),
                      mlp_only_layers=tuple(hf_value(hf_cfg, "mlp_only_layers", ())),
                      decoder_sparse_step=hf_value(hf_cfg, "decoder_sparse_step", 1))
        fields.update(overrides)
        return Qwen2MoeConfig(**fields)


def mix_experts(y: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Σ_e weights[t, e]·y[e, t] in float32: y ``[E, T, d]`` (every expert's
    output for every token), weights ``[T, E]``."""
    return (y.float() * weights.T[..., None]).sum(0)


class Qwen2MoeSparseMLP(nn.Module):
    """Top-k of all experts as a dense mixture, plus the gated shared
    expert; over ``tp_size`` ranks the banks and the shared expert are this
    rank's slices."""

    #: the dim of each bank cut over the tensor axis (``expert_mlp``)
    TP_DIMS = ExpertsFFN.TP_DIMS

    def __init__(self, cfg: Qwen2MoeConfig, device=None, tp_size: int = 1):
        super().__init__()
        self.cfg = cfg
        e, n, m, si = cfg.hidden_size, cfg.num_experts, cfg.moe_intermediate_size, cfg.shared_expert_intermediate_size
        if m % tp_size:
            raise ValueError(f"tensor parallelism over {tp_size} ranks does not divide moe_intermediate_size={m}")
        #: this rank's place on the tensor axis
        self.tp = TensorParallel(tp_size)
        self.gate = Router(e, n, cfg.param_dtype, device)
        self.w_gate = nn.Parameter(torch.empty((n, e, m // tp_size), dtype=cfg.param_dtype, device=device))
        self.w_up = nn.Parameter(torch.empty((n, e, m // tp_size), dtype=cfg.param_dtype, device=device))
        self.w_down = nn.Parameter(torch.empty((n, m // tp_size, e), dtype=cfg.param_dtype, device=device))
        col, row = ColumnParallelLinear, RowParallelLinear
        self.shared_gate_proj = _parallel(col, cfg, e, si, False, device, tp_size)
        self.shared_up_proj = _parallel(col, cfg, e, si, False, device, tp_size)
        self.shared_down_proj = _parallel(row, cfg, si, e, False, device, tp_size)
        self.shared_expert_gate = Router(e, 1, cfg.param_dtype, device)

    def routing_weights(self, x: torch.Tensor) -> torch.Tensor:
        """x [T, E] → float32 [T, num_experts], zero off each token's top-k."""
        probs = torch.softmax(self.gate(x), dim=-1)
        vals, idx = top_k(probs, self.cfg.num_experts_per_tok)
        if self.cfg.norm_topk_prob:
            vals = vals / (vals.sum(-1, keepdim=True) + 1e-20)
        return torch.zeros_like(probs).scatter(1, idx, vals)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, tp = self.cfg.dtype, self.tp
        shape = x.shape
        t = x.reshape(-1, shape[-1])
        rows = copy_to_tensor_region(t, tp, "moe_in")
        y = swiglu_experts(rows[None], self.w_gate, self.w_up, self.w_down, dt)      # [E, T, hidden]
        out = mix_experts(y, copy_to_tensor_region(self.routing_weights(t), tp, "moe_weights"))   # float32
        # the shared expert's down projection without its reduce: the sum below takes it
        shared = dense(F.silu(dense(rows, self.shared_gate_proj, dt)) * dense(rows, self.shared_up_proj, dt),
                       self.shared_down_proj, dt)
        gate = copy_to_tensor_region(torch.sigmoid(self.shared_expert_gate(t)), tp, "shared_gate")
        out = reduce_from_tensor_region(out + gate * shared.float(), tp, "moe")
        return out.to(x.dtype).reshape(shape)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        """The expert banks N(0, 1/fan_in), each drawn whole and cut to the
        rank's slice (the routers and the shared expert are initialised as
        modules of their own)."""
        for name, dim in self.TP_DIMS.items():
            w = getattr(self, name)
            std = 1.0 / math.sqrt(w.shape[1] * (self.tp.size if dim == 1 else 1))
            _draw_whole(w, dim if self.tp.size > 1 else None, self.tp,
                        lambda t: t.normal_(0.0, std, generator=generator))


#: the dense MLP of ``mlp_only_layers`` and off-step layers (HF ``Qwen2MoeMLP``
#: at ``intermediate_size``): the Llama MLP
Qwen2MoeDenseMLP = LlamaMLP


class Qwen2MoeBlock(nn.Module):

    def __init__(self, cfg: Qwen2MoeConfig, sparse: bool = True, device=None, self_attn: Optional[nn.Module] = None,
                 tp_size: int = 1):
        super().__init__()
        self.cfg = cfg
        self.self_attn = self_attn if self_attn is not None else \
            LlamaAttention(cfg.as_llama(), device=device, tp_size=tp_size)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype, cfg.param_dtype, device)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype, cfg.param_dtype,
                                                device)
        self.mlp = Qwen2MoeSparseMLP(cfg, device, tp_size) if sparse else Qwen2MoeDenseMLP(cfg, device, tp_size)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, segment_ids: Optional[torch.Tensor] = None,
                pld_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
        if pld_scale is not None:
            raise NotImplementedError("progressive layer drop is not wired into the Qwen2-MoE block (nor in JAX)")
        h = x + self.self_attn(self.input_layernorm(x), positions, segment_ids)
        return h + self.mlp(self.post_attention_layernorm(h))


class Qwen2MoeForCausalLM(LlamaForCausalLM):
    """The training forward: ``input_ids`` [B, S] → logits [B, S, V] (this
    rank's ``[B, S, V/N]`` over ``tensor_parallel`` N, through the Llama
    base's vocab-parallel embedding and head)."""

    supports_pld = False

    def __init__(self, cfg: Qwen2MoeConfig, device: DeviceLike = "cuda", tensor_parallel: int = 1):
        super().__init__(cfg, device=device, tensor_parallel=tensor_parallel)

    def _make_block(self, cfg, device, layer: int) -> nn.Module:
        return Qwen2MoeBlock(cfg, sparse=cfg.layer_is_sparse(layer), device=device, tp_size=self.tp.size)
