"""GPT-2 causal LM (port of ``deepspeed_tpu/models/gpt2.py``).

Learned absolute positions, pre-LN blocks with biases, a tanh-GELU MLP (4×)
and a tied LM head.  Attention follows ``cfg.attention_impl`` through
``get_attention_impl`` (``"flash"``: K1/K2a/K2b on a GPU at head dim 64).
``cfg.remat`` wraps each block in ``torch.utils.checkpoint`` under
``cfg.remat_policy``, as the Llama model does (``llama.block_runner``).
Parameter names mirror the JAX tree with the layers unrolled (``h.{i}.attn.
c_attn``, ``h.{i}.mlp.c_fc``, ...) and torch's ``[out, in]`` weights.

The projections are ``module_inject/layers.py``'s tensor-parallel layers
(``nn.Linear`` at degree 1), so the v1 engine cuts a whole model over
``tensor_parallel`` ranks (``cut_tensor_parallel_``): ``c_attn``'s outputs
are q, k and v laid out ``(3, H, D)`` (JAX's kernel axes ``(EMBED, None,
HEADS, HEAD_DIM)``), so a rank keeps its heads of each of the three
(``parts=3``), not a contiguous third of the rows; ``c_fc`` is
column-parallel, both ``c_proj`` row-parallel (kinds ``o_proj`` and
``down_proj``), the token table vocab-parallel (the tied head gives the
rank's vocab slice) and the learned positions whole.
"""

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..accelerator import DeviceLike, resolve_device
from ..module_inject.layers import (NO_TENSOR_PARALLEL, ColumnParallelLinear, RowParallelLinear,
                                    VocabParallelEmbedding, copy_to_tensor_region, row_parallel_dense,
                                    vocab_parallel_embed)
from .llama import LayerNorm, _parallel, block_runner, causal_lm_loss, dense, get_attention_impl, hf_value


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    layer_norm_epsilon: float = 1e-5
    tie_word_embeddings: bool = True
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True
    remat_policy: str = "nothing_saveable"
    attention_impl: str = "reference"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def from_hf(hf_cfg, **overrides) -> "GPT2Config":
        fields = dict(vocab_size=hf_value(hf_cfg, "vocab_size"), n_positions=hf_value(hf_cfg, "n_positions", 1024),
                      hidden_size=hf_value(hf_cfg, "n_embd", None) or hf_value(hf_cfg, "hidden_size", 768),
                      num_hidden_layers=hf_value(hf_cfg, "n_layer", None) or hf_value(hf_cfg, "num_hidden_layers", 12),
                      num_attention_heads=hf_value(hf_cfg, "n_head", None) or hf_value(hf_cfg, "num_attention_heads",
                                                                                          12),
                      layer_norm_epsilon=hf_value(hf_cfg, "layer_norm_epsilon", 1e-5))
        fields.update(overrides)
        return GPT2Config(**fields)


PRESETS = {
    "gpt2-125m": GPT2Config(),
    "gpt2-medium": GPT2Config(hidden_size=1024, num_hidden_layers=24, num_attention_heads=16),
    "gpt2-large": GPT2Config(hidden_size=1280, num_hidden_layers=36, num_attention_heads=20),
    "gpt2-xl": GPT2Config(hidden_size=1600, num_hidden_layers=48, num_attention_heads=25),
    "tiny": GPT2Config(vocab_size=128, n_positions=64, hidden_size=64, num_hidden_layers=2, num_attention_heads=4),
}


class GPT2Attention(nn.Module):

    def __init__(self, cfg: GPT2Config, device=None):
        super().__init__()
        self.cfg = cfg
        e = cfg.hidden_size
        self.c_attn = nn.utils.skip_init(ColumnParallelLinear, e, 3 * e, bias=True, device=device,
                                         dtype=cfg.param_dtype, parts=3)
        self.c_proj = _parallel(RowParallelLinear, cfg, e, e, True, device, 1)

    def forward(self, x, segment_ids=None):
        cfg = self.cfg
        b, s, _ = x.shape
        x = copy_to_tensor_region(x, self.c_attn.tp, "qkv")
        q, k, v = dense(x, self.c_attn, cfg.dtype).view(b, s, 3, -1, cfg.head_dim).unbind(dim=2)
        out = get_attention_impl(cfg.attention_impl)(q, k, v, causal=True, segment_ids=segment_ids)
        return row_parallel_dense(out.reshape(b, s, -1), self.c_proj, cfg.dtype, "o_proj")


class GPT2MLP(nn.Module):

    def __init__(self, cfg: GPT2Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.c_fc = _parallel(ColumnParallelLinear, cfg, cfg.hidden_size, 4 * cfg.hidden_size, True, device, 1)
        self.c_proj = _parallel(RowParallelLinear, cfg, 4 * cfg.hidden_size, cfg.hidden_size, True, device, 1)

    def forward(self, x):
        dt = self.cfg.dtype
        x = copy_to_tensor_region(x, self.c_fc.tp, "mlp")
        return row_parallel_dense(F.gelu(dense(x, self.c_fc, dt), approximate="tanh"), self.c_proj, dt, "down_proj")


class GPT2Block(nn.Module):

    def __init__(self, cfg: GPT2Config, device=None):
        super().__init__()
        ln = lambda: LayerNorm(cfg.hidden_size, cfg.layer_norm_epsilon, cfg.dtype, cfg.param_dtype, device)
        self.ln_1, self.attn, self.ln_2, self.mlp = ln(), GPT2Attention(cfg, device), ln(), GPT2MLP(cfg, device)

    def forward(self, x, segment_ids=None):
        h = x + self.attn(self.ln_1(x), segment_ids)
        return h + self.mlp(self.ln_2(h))


class GPT2LMHeadModel(nn.Module):
    """GPT-2 (``transformers.GPT2LMHeadModel``'s surface): ``input_ids``
    [B, S] → logits [B, S, V] in the compute dtype."""

    def __init__(self, cfg: GPT2Config, device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        #: this rank's place on the tensor axis (set by the v1 engine's cut)
        self.tp = NO_TENSOR_PARALLEL
        emb = lambda cls, n: nn.utils.skip_init(cls, n, cfg.hidden_size, device=dev, dtype=cfg.param_dtype)
        self.wte, self.wpe = emb(VocabParallelEmbedding, cfg.vocab_size), emb(nn.Embedding, cfg.n_positions)
        self.h = nn.ModuleList([GPT2Block(cfg, dev) for _ in range(cfg.num_hidden_layers)])
        self.ln_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_epsilon, cfg.dtype, cfg.param_dtype, dev)
        self.lm_head = None if cfg.tie_word_embeddings else \
            _parallel(ColumnParallelLinear, cfg, cfg.hidden_size, cfg.vocab_size, False, dev, 1)

    def forward(self, input_ids: torch.Tensor, positions=None, segment_ids=None) -> torch.Tensor:
        cfg = self.cfg
        if positions is None:
            positions = torch.arange(input_ids.shape[1], device=input_ids.device).expand(input_ids.shape)
        x = vocab_parallel_embed(input_ids.long(), self.wte.weight, self.tp).to(cfg.dtype) + \
            F.embedding(positions.long(), self.wpe.weight).to(cfg.dtype)
        run = block_runner(cfg)
        for block in self.h:
            x = run(block, x, segment_ids)
        x = copy_to_tensor_region(self.ln_f(x), self.tp, "lm_head")
        if self.lm_head is None:
            return x.to(cfg.dtype) @ self.wte.weight.to(cfg.dtype).T
        return dense(x, self.lm_head, cfg.dtype)


gpt2_lm_loss = causal_lm_loss
