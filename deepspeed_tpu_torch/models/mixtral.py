"""Mixtral: Llama attention and a sparse-MoE FFN (port of
``deepspeed_tpu/models/mixtral.py``; ref: the MoE training path of
``deepspeed/moe/layer.py`` and ``inference/v2/model_implementations/mixtral``).

The block swaps the dense SwiGLU MLP for ``moe.MoE`` (top-k gating with
capacity → the expert bank → combine) and the model sums the layers' router
losses: ``MixtralForCausalLM`` returns ``(logits, l_aux_total)`` and
``mixtral_lm_loss`` adds ``router_aux_loss_coef · l_aux`` to the causal-LM
token mean.  The block calls the layer with its default ``train=True``, so
the capacity factor is ``capacity_factor`` under ``eval_batch`` too, as in
JAX (``mixtral.py:101-112``).

Over several ranks each rank's layers gate its own rows as one group and
return that group's ``l_aux``; JAX averages ``l_aux`` over the groups.  The
loss function's ``rank_share`` is what one rank adds to the sum over the
ranks that the engine takes (``runtime/engine.py``): its share of the token
mean over the global micro-batch plus ``coef · l_aux_r / W``, so the sum is
JAX's ``CE + coef · mean(l_aux)`` and each group's gradient weighs 1/W, as
``jnp.mean``'s.  ``expert_parallel_size`` > 1 builds each MoE layer with
this rank's experts only (``moe.MoE``'s ``ep_size``).

Over ``tensor_parallel`` N ranks (JAX's layout from ``tp_rules``:
``heads``, ``kv_heads``, ``vocab`` and ``expert_mlp`` over ``tensor``) the
attention is the Llama model's tensor-parallel path and each expert's FFN
is cut over the tensor axis (``moe.ExpertsFFN``); the router and the norms
are whole.  W above counts the data-parallel ranks only: the ranks of a
tensor group gate the same rows and compute the same ``l_aux``, so it
enters the loss once a data group.  The loss is vocab-parallel then: the
engine hands its ``tp`` to ``rank_share``.

Parameter names mirror the JAX tree with the layers unrolled
(``layers.{i}.block_sparse_moe.{gate.weight, experts.w_gate, ...}``), so
``models/convert.py`` carries it across and the serving twin
(``mixtral_cache.py``) loads the same state dict.
"""

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..accelerator import DeviceLike
from ..moe.layer import MoE
from .llama import LlamaAttention, LlamaConfig, LlamaForCausalLM, RMSNorm, block_runner, causal_lm_loss, hf_value


@dataclasses.dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    max_position_embeddings: int = 32768
    rope_theta: float = 1e6
    rms_norm_eps: float = 1e-5
    num_local_experts: int = 8
    num_experts_per_tok: int = 2
    router_aux_loss_coef: float = 0.02
    capacity_factor: float = 1.25
    eval_capacity_factor: float = 2.0
    min_capacity: int = 4
    drop_tokens: bool = True
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    attention_impl: str = "flash"
    remat: bool = True
    remat_policy: str = "nothing_saveable"

    #: Mixtral's LM head is its own weight (not a field: no checkpoint ties it)
    tie_word_embeddings = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    def as_llama(self) -> LlamaConfig:
        """The attention's config (JAX ``:48-60``)."""
        return LlamaConfig(vocab_size=self.vocab_size, hidden_size=self.hidden_size,
                           intermediate_size=self.intermediate_size, num_hidden_layers=self.num_hidden_layers,
                           num_attention_heads=self.num_attention_heads,
                           num_key_value_heads=self.num_key_value_heads,
                           max_position_embeddings=self.max_position_embeddings, rope_theta=self.rope_theta,
                           rms_norm_eps=self.rms_norm_eps, dtype=self.dtype, param_dtype=self.param_dtype,
                           attention_impl=self.attention_impl, remat=self.remat, remat_policy=self.remat_policy)

    @staticmethod
    def from_hf(hf_cfg, **overrides) -> "MixtralConfig":
        """From an HF config (a ``config.json`` mapping or a namespace), with
        JAX's fields and defaults (``:62-80``) and ``rms_norm_eps``."""
        fields = dict(
            vocab_size=hf_value(hf_cfg, "vocab_size"),
            hidden_size=hf_value(hf_cfg, "hidden_size"),
            intermediate_size=hf_value(hf_cfg, "intermediate_size"),
            num_hidden_layers=hf_value(hf_cfg, "num_hidden_layers"),
            num_attention_heads=hf_value(hf_cfg, "num_attention_heads"),
            num_key_value_heads=hf_value(hf_cfg, "num_key_value_heads", 8),
            max_position_embeddings=hf_value(hf_cfg, "max_position_embeddings"),
            rope_theta=hf_value(hf_cfg, "rope_theta", 1e6),
            rms_norm_eps=hf_value(hf_cfg, "rms_norm_eps", 1e-5),
            num_local_experts=hf_value(hf_cfg, "num_local_experts", 8),
            num_experts_per_tok=hf_value(hf_cfg, "num_experts_per_tok", 2),
            router_aux_loss_coef=hf_value(hf_cfg, "router_aux_loss_coef", 0.02),
        )
        fields.update(overrides)
        return MixtralConfig(**fields)


PRESETS = {
    "mixtral-8x7b": MixtralConfig(),
    "tiny": MixtralConfig(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                          num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64, rope_theta=1e4,
                          num_local_experts=4, num_experts_per_tok=2),
}


def moe_layer(cfg: MixtralConfig, device=None, ep_size: int = 1, tp_size: int = 1) -> MoE:
    return MoE(hidden_size=cfg.hidden_size, num_experts=cfg.num_local_experts,
               intermediate_size=cfg.intermediate_size, k=cfg.num_experts_per_tok,
               capacity_factor=cfg.capacity_factor, eval_capacity_factor=cfg.eval_capacity_factor,
               min_capacity=cfg.min_capacity, drop_tokens=cfg.drop_tokens, dtype=cfg.dtype,
               param_dtype=cfg.param_dtype, device=device, ep_size=ep_size, tp_size=tp_size)


class MixtralBlock(nn.Module):
    """``h = x + attn(ln(x))``; ``h + moe(ln(h))``, and the layer's ``l_aux``."""

    def __init__(self, cfg: MixtralConfig, device=None, self_attn: Optional[nn.Module] = None, ep_size: int = 1,
                 tp_size: int = 1):
        super().__init__()
        self.cfg = cfg
        self.self_attn = self_attn if self_attn is not None else \
            LlamaAttention(cfg.as_llama(), device=device, tp_size=tp_size)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype, cfg.param_dtype, device)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype, cfg.param_dtype,
                                                device)
        self.block_sparse_moe = moe_layer(cfg, device, ep_size, tp_size)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, segment_ids: Optional[torch.Tensor] = None):
        h = x + self.self_attn(self.input_layernorm(x), positions, segment_ids)
        out, l_aux, _ = self.block_sparse_moe(self.post_attention_layernorm(h))
        return h + out, l_aux.float()


class MixtralForCausalLM(LlamaForCausalLM):
    """``input_ids`` [B, S] → ``(logits [B, S, V], l_aux_total)`` (this
    rank's ``[B, S, V/N]`` over ``tensor_parallel`` N): pair the engine
    with ``make_mixtral_loss_fn``.  Remat as the Llama model's."""

    supports_pld = False
    expert_parallel_size = 1

    def __init__(self, cfg: MixtralConfig, device: DeviceLike = "cuda", expert_parallel_size: int = 1,
                 tensor_parallel: int = 1):
        self.expert_parallel_size = expert_parallel_size   # read by _make_block during the base's __init__
        super().__init__(cfg, device=device, tensor_parallel=tensor_parallel)

    def _make_block(self, cfg, device, layer: int) -> nn.Module:
        return MixtralBlock(cfg, device=device, ep_size=self.expert_parallel_size, tp_size=self.tp.size)

    def forward(self, input_ids: torch.Tensor, positions: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None):
        if positions is None:
            positions = torch.arange(input_ids.shape[1], device=input_ids.device).expand(input_ids.shape)
        x = self.embed(input_ids)
        l_aux = torch.zeros((), dtype=torch.float32, device=x.device)
        run = block_runner(self.cfg)
        for layer in self.layers:
            x, l_aux_i = run(layer, x, positions, segment_ids)
            l_aux = l_aux + l_aux_i
        return self.logits(x), l_aux


def mixtral_lm_loss(outputs, labels: torch.Tensor, loss_mask: Optional[torch.Tensor] = None,
                    aux_loss_coef: float = 0.02) -> torch.Tensor:
    """Causal-LM token mean + ``aux_loss_coef · l_aux`` (the reference's
    user-side ``loss += l_aux * coef``)."""
    logits, l_aux = outputs
    return causal_lm_loss(logits, labels, loss_mask) + aux_loss_coef * l_aux


def make_mixtral_loss_fn(cfg: MixtralConfig):
    """The engine's ``loss_fn(outputs, batch)`` for ``MixtralForCausalLM``,
    with its ``rank_share(outputs, batch, denom, world, tp)``: one rank's
    share of the loss over ``world`` data-parallel ranks, its token sum over
    ``denom`` (the global token count) plus ``coef · l_aux / world``, over
    vocab-parallel logits when the engine's ``tp`` has more than one rank."""

    def loss_fn(outputs, batch):
        return mixtral_lm_loss(outputs, batch["labels"], batch.get("loss_mask"), cfg.router_aux_loss_coef)

    def rank_share(outputs, batch, denom, world: int, tp):
        logits, l_aux = outputs
        return causal_lm_loss(logits, batch["labels"], batch.get("loss_mask"), denom, tp=tp) + \
            cfg.router_aux_loss_coef * l_aux / world

    loss_fn.rank_share = rank_share
    return loss_fn
