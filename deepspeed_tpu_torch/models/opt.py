"""The OPT family's config (port of ``deepspeed_tpu/models/opt.py:27-58``).

Token embeddings and learned positions (offset 2), MHA with biases, a ReLU
MLP, LayerNorms with bias: pre-LN (``do_layer_norm_before``, every size but
350M) or post-LN, and OPT-350M's ``word_embed_proj_dim`` (embeddings of 512
projected to the 1024 of the decoder and back).  Served by
``cache_zoo.OPTForCausalLMWithCache``; the training model is not ported
(ROADMAP Queue 1 item 5).
"""

import dataclasses

import torch

from .llama import hf_value


@dataclasses.dataclass(frozen=True)
class OPTConfig:
    vocab_size: int = 50272
    hidden_size: int = 768
    ffn_dim: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 2048
    do_layer_norm_before: bool = True
    word_embed_proj_dim: int = 0  # 0 → hidden_size; OPT-350M projects 512 → 1024
    tie_word_embeddings: bool = True
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    # serving twin: "flash" runs K3 on a GPU tensor (its plain version on a CPU one)
    attention_impl: str = "flash"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def from_hf(hf_cfg, **overrides) -> "OPTConfig":
        """From an HF OPT config (a ``config.json`` mapping or a namespace);
        a ``word_embed_proj_dim`` equal to the hidden size is no projection."""
        hidden = hf_value(hf_cfg, "hidden_size")
        proj = hf_value(hf_cfg, "word_embed_proj_dim", hidden)
        fields = dict(vocab_size=hf_value(hf_cfg, "vocab_size"),
                      hidden_size=hidden,
                      ffn_dim=hf_value(hf_cfg, "ffn_dim"),
                      num_hidden_layers=hf_value(hf_cfg, "num_hidden_layers"),
                      num_attention_heads=hf_value(hf_cfg, "num_attention_heads"),
                      max_position_embeddings=hf_value(hf_cfg, "max_position_embeddings"),
                      do_layer_norm_before=hf_value(hf_cfg, "do_layer_norm_before", True),
                      word_embed_proj_dim=0 if proj == hidden else proj,
                      tie_word_embeddings=hf_value(hf_cfg, "tie_word_embeddings", True))
        fields.update(overrides)
        return OPTConfig(**fields)
