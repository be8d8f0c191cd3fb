"""The Falcon family's config (port of ``deepspeed_tpu/models/falcon.py:28-92``).

Three layouts, all served by ``cache_zoo.FalconForCausalLMWithCache``:
  * Falcon-7B: multi-query (one KV head), parallel attention and MLP off
    ONE ``input_layernorm``, rotary positions;
  * the new decoder architecture (Falcon-40B/180B): grouped KV heads, the
    parallel branches off ``ln_attn`` and ``ln_mlp`` (or one shared
    LayerNorm when ``num_ln_in_parallel_attn`` is 1);
  * Falcon-RW: sequential blocks (``parallel_attn=False``), per-head MHA,
    alibi position bias in place of rotary (``alibi_slopes``).

The training model of the family is not ported (ROADMAP Queue 1 item 5).
"""

import dataclasses
import math

import numpy as np
import torch

from .llama import hf_value


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
    # serving twin: "flash" runs K3 on a GPU tensor (its plain version on a CPU one)
    attention_impl: str = "flash"

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
