"""The Phi-1/Phi-2 family's config and partial rotary (port of
``deepspeed_tpu/models/phi.py:23-70``).

A LayerNorm (with bias) feeds parallel attention and MLP branches that share
one residual; biases on every projection and the LM head; rotary on the first
``partial_rotary_factor`` of each head; a tanh-GELU MLP; optional per-head
``qk_layernorm`` (Phi-1/1.5).  Served by ``cache_zoo.PhiForCausalLMWithCache``;
the training model is not ported (ROADMAP Queue 1 item 5).  Phi-3 is a
Llama layout (``inference/v2/model_implementations/policies.py``).
"""

import dataclasses

import torch

from .llama import hf_value


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
    # serving twin: "flash" runs K3 on a GPU tensor (its plain version on a CPU one)
    attention_impl: str = "flash"

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
