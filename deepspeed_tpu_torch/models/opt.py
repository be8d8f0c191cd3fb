"""The OPT family (port of ``deepspeed_tpu/models/opt.py``): its config, the
attention and block, and the cache-free training model ``OPTForCausalLM``
(JAX ``:59-157``).

Token embeddings and learned positions (offset 2), MHA with biases, a ReLU
MLP, LayerNorms with bias: pre-LN (``do_layer_norm_before``, every size but
350M) or post-LN, and OPT-350M's ``word_embed_proj_dim`` (embeddings of 512
projected to the 1024 of the decoder and back).  Attention follows
``cfg.attention_impl`` (``"flash"``: K1/K2a/K2b on the card).  Served by
``cache_zoo.OPTForCausalLMWithCache``, which shares ``OPTBlock`` and the
projections of ``OPTAttention``.

Tensor parallelism (``tensor_parallel`` N > 1, as ``models/falcon.py``):
q/k/v and ``fc1`` (with their biases) column-parallel, ``out_proj`` and
``fc2`` row-parallel (kinds ``o_proj`` and ``down_proj``; their biases
whole), the token embedding and the head vocab-parallel.  The learned
positions and OPT-350M's ``project_in``/``project_out`` carry no logical
axes in JAX and stay whole on every rank.
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
from .llama import LayerNorm, _linear, _parallel, block_runner, check_divides, dense, get_attention_impl, hf_value


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


def check_tensor_parallel(cfg: OPTConfig, tp_size: int) -> None:
    """Raise JAX's ``ValueError`` unless ``tp_size`` divides the heads, the
    MLP width and the vocab."""
    check_divides(tp_size, num_attention_heads=cfg.num_attention_heads, ffn_dim=cfg.ffn_dim,
                  vocab_size=cfg.vocab_size)


class OPTAttention(nn.Module):
    """The biased q/k/v and ``out_proj`` projections, and the cache-free
    attention (the paged twin, ``cache_zoo.OPTAttentionCache``, shares the
    projections); over ``tp_size`` ranks a rank's heads."""

    def __init__(self, cfg: OPTConfig, device=None, tp_size: int = 1):
        super().__init__()
        self.cfg = cfg
        e = cfg.hidden_size
        self.q_proj, self.k_proj, self.v_proj = (_parallel(ColumnParallelLinear, cfg, e, e, True, device, tp_size)
                                                 for _ in range(3))
        self.out_proj = _parallel(RowParallelLinear, cfg, e, e, True, device, tp_size)

    @property
    def n_heads(self) -> int:
        """This rank's heads (query and kv)."""
        return self.q_proj.out_features // self.cfg.head_dim

    n_kv = n_heads

    def qkv(self, x: torch.Tensor):
        cfg = self.cfg
        shape = (*x.shape[:2], self.n_heads, cfg.head_dim)
        x = copy_to_tensor_region(x, self.q_proj.tp, "qkv")
        return tuple(dense(x, p, cfg.dtype).view(shape) for p in (self.q_proj, self.k_proj, self.v_proj))

    def out(self, attn: torch.Tensor) -> torch.Tensor:
        b, s = attn.shape[:2]
        return row_parallel_dense(attn.reshape(b, s, -1), self.out_proj, self.cfg.dtype, "o_proj")

    def forward(self, x: torch.Tensor, segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        q, k, v = self.qkv(x)
        return self.out(get_attention_impl(self.cfg.attention_impl)(q, k, v, causal=True, segment_ids=segment_ids))


class OPTBlock(nn.Module):
    """Pre-LN (``do_layer_norm_before``) or post-LN (OPT-350M) with a ReLU
    MLP; ``forward(x, *attn_args)`` hands ``attn_args`` to ``self_attn``
    (the cache-free attention, or the paged twin's when given)."""

    def __init__(self, cfg: OPTConfig, device=None, self_attn: Optional[nn.Module] = None, tp_size: int = 1):
        super().__init__()
        self.cfg = cfg
        self.self_attn_layer_norm = LayerNorm(cfg.hidden_size, 1e-5, cfg.dtype, cfg.param_dtype, device)
        self.self_attn = self_attn if self_attn is not None else OPTAttention(cfg, device, tp_size=tp_size)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, 1e-5, cfg.dtype, cfg.param_dtype, device)
        self.fc1 = _parallel(ColumnParallelLinear, cfg, cfg.hidden_size, cfg.ffn_dim, True, device, tp_size)
        self.fc2 = _parallel(RowParallelLinear, cfg, cfg.ffn_dim, cfg.hidden_size, True, device, tp_size)

    def forward(self, x: torch.Tensor, *attn_args) -> torch.Tensor:
        cfg = self.cfg
        pre = cfg.do_layer_norm_before
        h = x + self.self_attn(self.self_attn_layer_norm(x) if pre else x, *attn_args)
        if not pre:
            h = self.self_attn_layer_norm(h)
        m_in = copy_to_tensor_region(self.final_layer_norm(h) if pre else h, self.fc1.tp, "mlp")
        m = row_parallel_dense(F.relu(dense(m_in, self.fc1, cfg.dtype)), self.fc2, cfg.dtype, "down_proj")
        out = h + m
        return out if pre else self.final_layer_norm(out)


class OPTForCausalLM(nn.Module):
    """Cache-free forward: ``input_ids`` [B, S] → logits [B, S, V] in the
    compute dtype (``[B, S, V/N]``, this rank's vocab slice, over
    ``tensor_parallel`` N ranks); each block under ``cfg.remat``'s
    checkpoint.  The paged twin (``cache_zoo``) subclasses it with its own
    blocks (``_make_block``) and shares ``embed`` and ``logits``."""

    def __init__(self, cfg: OPTConfig, device: DeviceLike = "cuda", tensor_parallel: int = 1):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        check_tensor_parallel(cfg, tensor_parallel)
        #: this rank's place on the tensor axis (its group set by the engine)
        self.tp = TensorParallel(tensor_parallel)
        proj = cfg.word_embed_proj_dim or cfg.hidden_size
        self.embed_tokens = nn.utils.skip_init(VocabParallelEmbedding, cfg.vocab_size, proj, device=dev,
                                               dtype=cfg.param_dtype, tp_size=tensor_parallel)
        self.embed_positions = nn.utils.skip_init(nn.Embedding, cfg.max_position_embeddings + 2, cfg.hidden_size,
                                                  device=dev, dtype=cfg.param_dtype)
        self.project_in = self.project_out = None
        if cfg.word_embed_proj_dim:   # OPT-350M: project_in/out around the stack
            self.project_in = _linear(cfg, proj, cfg.hidden_size, False, dev)
            self.project_out = _linear(cfg, cfg.hidden_size, proj, False, dev)
        self.layers = nn.ModuleList([self._make_block(cfg, dev) for _ in range(cfg.num_hidden_layers)])
        # HF: the final LayerNorm exists only for pre-LN OPT
        self.final_layer_norm = LayerNorm(cfg.hidden_size, 1e-5, cfg.dtype, cfg.param_dtype, dev) \
            if cfg.do_layer_norm_before else None
        self.lm_head = None if cfg.tie_word_embeddings else \
            _parallel(ColumnParallelLinear, cfg, proj, cfg.vocab_size, False, dev, tensor_parallel)
        if tensor_parallel > 1:
            from ..comm import comm
            set_tensor_parallel_(self, TensorParallel(tensor_parallel, comm.get_rank() % tensor_parallel))

    def _make_block(self, cfg: OPTConfig, device) -> nn.Module:
        return OPTBlock(cfg, device, tp_size=self.tp.size)

    def embed(self, input_ids: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """Token embeddings (through ``project_in``) plus the learned
        positions, offset by 2 (HF's padding convention)."""
        cfg = self.cfg
        x = vocab_parallel_embed(input_ids.long(), self.embed_tokens.weight, self.tp).to(cfg.dtype)
        if self.project_in is not None:
            x = dense(x, self.project_in, cfg.dtype)
        return x + F.embedding(positions.long() + 2, self.embed_positions.weight).to(cfg.dtype)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """The final LayerNorm, ``project_out`` and the head over hidden
        rows: this rank's vocab slice over ``tensor_parallel`` ranks."""
        cfg = self.cfg
        if self.final_layer_norm is not None:
            x = self.final_layer_norm(x)
        if self.project_out is not None:
            x = dense(x, self.project_out, cfg.dtype)
        x = copy_to_tensor_region(x, self.tp, "lm_head")
        if self.lm_head is None:
            return x @ self.embed_tokens.weight.to(cfg.dtype).T
        return dense(x, self.lm_head, cfg.dtype)

    def forward(self, input_ids: torch.Tensor, positions: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        if positions is None:
            positions = torch.arange(input_ids.shape[1], device=input_ids.device).expand(input_ids.shape)
        x = self.embed(input_ids, positions)
        run = block_runner(self.cfg)
        for layer in self.layers:
            x = run(layer, x, segment_ids)
        return self.logits(x)
