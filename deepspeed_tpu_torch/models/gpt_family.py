"""The v1-era GPT-family causal LMs: BLOOM, GPT-NeoX, GPT-J and GPT-Neo
(port of ``deepspeed_tpu/models/gpt_family.py``).

Each family's quirks as the JAX models compute them:

  * BLOOM: alibi added unscaled to the scaled scores (HF ``baddbmm``), the
    fused ``query_key_value`` in an ``(H, 3, D)`` layout, a LayerNorm after
    the word embedding, a sequential residual and a tied head;
  * GPT-NeoX: NeoX-style (half-split) rotary over the first
    ``rotary_pct·D`` dims of each head, the fused ``query_key_value`` in an
    ``(H, 3, D)`` layout, the parallel residual (``use_parallel_residual``)
    or the sequential one, an untied ``embed_out``;
  * GPT-J: interleaved (rotate-every-two) rotary over ``rotary_dim`` dims,
    one LayerNorm feeding both parallel branches, a biased ``lm_head``;
  * GPT-Neo: learned positions, one attention window per layer
    (``attention_layers``: "global" or "local" of ``window_size`` keys),
    scores without the 1/√D scale, a tied head.

GPT-NeoX and GPT-J attend through ``get_attention_impl(cfg.attention_impl)``
(``"flash"``: K1 on a GPU, the chunked path on lengths that are not a
multiple of 128); BLOOM and GPT-Neo through their own plain attention, as in
JAX.  Numerics follow the JAX modules: weights in ``param_dtype`` cast to
``dtype`` at use, LayerNorm statistics in float32, attention scores in
float32.  Parameter names mirror the JAX tree with the layers unrolled
(``h.{i}`` or ``layers.{i}``) and torch's ``[out, in]`` weights, so
``models/convert.py`` carries a JAX tree across leaf by leaf.

The projections are ``module_inject/layers.py``'s tensor-parallel layers
(``nn.Linear`` at degree 1), so the v1 engine cuts a whole model over
``tensor_parallel`` ranks (``cut_tensor_parallel_``): q/k/v (BLOOM's and
GPT-NeoX's fused ``query_key_value``, laid out per head ``(H, 3, D)``, cut
by heads as one contiguous block) and the MLP's up projection
column-parallel, the attention output and the MLP's down projection
row-parallel (kinds ``o_proj`` and ``down_proj``; GPT-NeoX's and GPT-J's
parallel branches reduce apart, two all-reduces a block), the token table
and the head vocab-parallel (GPT-J's head bias cut with the vocab),
GPT-Neo's learned positions whole.  A rank attends over its heads:
BLOOM's alibi adds the slopes of those heads, the partial and interleaved
rotaries act per head.
"""

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..accelerator import DeviceLike, resolve_device
from ..module_inject.layers import (NO_TENSOR_PARALLEL, ColumnParallelLinear, RowParallelLinear,
                                    VocabParallelEmbedding, copy_to_tensor_region, row_parallel_dense,
                                    vocab_parallel_embed)
from ..ops.attention import reference_attention
from .falcon import rank_alibi_slopes
from .llama import LayerNorm, _parallel, dense, get_attention_impl, hf_value, rotary_embedding
from .phi import apply_partial_rope


def apply_rope_interleaved(x: torch.Tensor, positions: torch.Tensor, rotary_dim: int,
                           theta: float = 10000.0) -> torch.Tensor:
    """GPT-J rotary: rotate-every-two pairs over the first ``rotary_dim``
    dims (HF ``duplicate_interleave``), the rest passed through; x [B, S, N,
    D], float32 rotation cast back (JAX ``gpt_family.py:40``)."""
    rot, keep = x[..., :rotary_dim].float(), x[..., rotary_dim:]
    exponent = torch.arange(0, rotary_dim, 2, dtype=torch.float32, device=x.device) / rotary_dim
    ang = positions.float()[..., None] * (1.0 / (theta**exponent))                 # [B, S, rd/2]
    sin = torch.repeat_interleave(torch.sin(ang), 2, dim=-1)[:, :, None, :]
    cos = torch.repeat_interleave(torch.cos(ang), 2, dim=-1)[:, :, None, :]
    rot_ev = torch.stack([-rot[..., 1::2], rot[..., ::2]], dim=-1).reshape(rot.shape)
    return torch.cat([(rot * cos + rot_ev * sin).to(x.dtype), keep], dim=-1)


def _ln(cfg, device) -> LayerNorm:
    return LayerNorm(cfg.hidden_size, cfg.layer_norm_epsilon, cfg.dtype, cfg.param_dtype, device)


def _embedding(cfg, num: int, device, vocab: bool = True) -> nn.Embedding:
    """A token table (vocab-parallel) or, with ``vocab=False``, a whole one."""
    cls = VocabParallelEmbedding if vocab else nn.Embedding
    return nn.utils.skip_init(cls, num, cfg.hidden_size, device=device, dtype=cfg.param_dtype)


def _col(cfg, fan_in: int, fan_out: int, bias: bool, device) -> nn.Linear:
    return _parallel(ColumnParallelLinear, cfg, fan_in, fan_out, bias, device, 1)


def _row(cfg, fan_in: int, fan_out: int, bias: bool, device) -> nn.Linear:
    return _parallel(RowParallelLinear, cfg, fan_in, fan_out, bias, device, 1)


def _gelu_mlp(cfg, x, fc_in: nn.Linear, fc_out: nn.Linear) -> torch.Tensor:
    x = copy_to_tensor_region(x, fc_in.tp, "mlp")
    return row_parallel_dense(F.gelu(dense(x, fc_in, cfg.dtype), approximate="tanh"), fc_out, cfg.dtype, "down_proj")


def _out(cfg, attn: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """The attention's output projection over ``attn`` [B, S, H, D]."""
    return row_parallel_dense(attn.reshape(*attn.shape[:2], -1), layer, cfg.dtype, "o_proj")


def _positions(input_ids: torch.Tensor, positions: Optional[torch.Tensor]) -> torch.Tensor:
    if positions is None:
        positions = torch.arange(input_ids.shape[1], device=input_ids.device).expand(input_ids.shape)
    return positions


class _CausalLM(nn.Module):
    """The shared trunk: embed, the stack, the final LayerNorm, the head."""

    def __init__(self):
        super().__init__()
        #: this rank's place on the tensor axis (set by the v1 engine's cut)
        self.tp = NO_TENSOR_PARALLEL

    def _embed_tokens(self, input_ids, table: nn.Embedding) -> torch.Tensor:
        return vocab_parallel_embed(input_ids.long(), table.weight, self.tp).to(self.cfg.dtype)

    def _to_head(self, x: torch.Tensor) -> torch.Tensor:
        """The final hidden rows into the (vocab-parallel) head."""
        return copy_to_tensor_region(x, self.tp, "lm_head")

    def _embed(self, input_ids, positions) -> torch.Tensor:
        raise NotImplementedError

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _blocks(self):
        raise NotImplementedError

    def forward(self, input_ids: torch.Tensor, positions: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        positions = _positions(input_ids, positions)
        x = self._embed(input_ids, positions)
        for block in self._blocks():
            x = block(x, positions, segment_ids)
        return self._head(x)

    def attend(self, x: torch.Tensor, embedding: nn.Embedding) -> torch.Tensor:
        """flax ``Embed.attend``: x against the table (the rank's vocab
        rows), both in the compute dtype."""
        return self._to_head(x).to(self.cfg.dtype) @ embedding.weight.to(self.cfg.dtype).T


# ------------------------------------------------------------------- BLOOM


@dataclasses.dataclass(frozen=True)
class BloomConfig:
    vocab_size: int = 250880
    hidden_size: int = 64
    num_hidden_layers: int = 2
    num_attention_heads: int = 8
    layer_norm_epsilon: float = 1e-5
    tie_word_embeddings: bool = True
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    attention_impl: str = "reference"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def from_hf(hf_cfg, **overrides) -> "BloomConfig":
        fields = dict(vocab_size=hf_value(hf_cfg, "vocab_size"), hidden_size=hf_value(hf_cfg, "hidden_size"),
                      num_hidden_layers=hf_value(hf_cfg, "n_layer"), num_attention_heads=hf_value(hf_cfg, "n_head"),
                      layer_norm_epsilon=hf_value(hf_cfg, "layer_norm_epsilon", 1e-5),
                      tie_word_embeddings=hf_value(hf_cfg, "tie_word_embeddings", True))
        fields.update(overrides)
        return BloomConfig(**fields)


class BloomAttention(nn.Module):

    def __init__(self, cfg: BloomConfig, device=None):
        super().__init__()
        self.cfg = cfg
        e = cfg.hidden_size
        self.query_key_value = _col(cfg, e, 3 * e, True, device)
        self.dense = _row(cfg, e, e, True, device)

    def forward(self, x, positions, segment_ids=None, slopes=None):
        cfg = self.cfg
        b, s, _ = x.shape
        x = copy_to_tensor_region(x, self.query_key_value.tp, "qkv")
        qkv = dense(x, self.query_key_value, cfg.dtype).view(b, s, -1, 3, cfg.head_dim)
        q, k, v = qkv.unbind(dim=3)
        bias = slopes[None, :, None, None] * positions.float()[:, None, None, :]
        return _out(cfg, reference_attention(q, k, v, True, segment_ids=segment_ids, attn_bias=bias), self.dense)


class BloomBlock(nn.Module):

    def __init__(self, cfg: BloomConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.input_layernorm = _ln(cfg, device)
        self.self_attention = BloomAttention(cfg, device)
        self.post_attention_layernorm = _ln(cfg, device)
        self.dense_h_to_4h = _col(cfg, cfg.hidden_size, 4 * cfg.hidden_size, True, device)
        self.dense_4h_to_h = _row(cfg, 4 * cfg.hidden_size, cfg.hidden_size, True, device)

    def forward(self, x, positions, segment_ids=None, slopes=None):
        h = x + self.self_attention(self.input_layernorm(x), positions, segment_ids, slopes)
        return h + _gelu_mlp(self.cfg, self.post_attention_layernorm(h), self.dense_h_to_4h, self.dense_4h_to_h)


class BloomForCausalLM(_CausalLM):
    """BLOOM (ref: ``module_inject/containers/bloom.py``).  Its attention is
    the plain one with alibi, whatever ``attention_impl`` says, as in JAX."""
    #: the attention bias that K1 does not take
    attention_bias_kind = "alibi"

    def __init__(self, cfg: BloomConfig, device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.word_embeddings = _embedding(cfg, cfg.vocab_size, dev)
        self.word_embeddings_layernorm = _ln(cfg, dev)
        self.h = nn.ModuleList([BloomBlock(cfg, dev) for _ in range(cfg.num_hidden_layers)])
        self.ln_f = _ln(cfg, dev)

    def forward(self, input_ids, positions=None, segment_ids=None):
        positions = _positions(input_ids, positions)
        slopes = rank_alibi_slopes(self.cfg, self.tp, input_ids.device)
        x = self.word_embeddings_layernorm(self._embed_tokens(input_ids, self.word_embeddings))
        for block in self.h:
            x = block(x, positions, segment_ids, slopes)
        return self.attend(self.ln_f(x), self.word_embeddings)


# ---------------------------------------------------------------- GPT-NeoX


@dataclasses.dataclass(frozen=True)
class GPTNeoXConfig:
    vocab_size: int = 50432
    hidden_size: int = 64
    intermediate_size: int = 256
    num_hidden_layers: int = 2
    num_attention_heads: int = 8
    rotary_pct: float = 0.25
    rope_theta: float = 10000.0
    use_parallel_residual: bool = True
    layer_norm_epsilon: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    attention_impl: str = "reference"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def from_hf(hf_cfg, **overrides) -> "GPTNeoXConfig":
        fields = dict(vocab_size=hf_value(hf_cfg, "vocab_size"), hidden_size=hf_value(hf_cfg, "hidden_size"),
                      intermediate_size=hf_value(hf_cfg, "intermediate_size"),
                      num_hidden_layers=hf_value(hf_cfg, "num_hidden_layers"),
                      num_attention_heads=hf_value(hf_cfg, "num_attention_heads"),
                      rotary_pct=hf_value(hf_cfg, "rotary_pct", 0.25),
                      rope_theta=hf_value(hf_cfg, "rotary_emb_base", 10000.0),
                      use_parallel_residual=hf_value(hf_cfg, "use_parallel_residual", True),
                      layer_norm_epsilon=hf_value(hf_cfg, "layer_norm_eps", 1e-5))
        fields.update(overrides)
        return GPTNeoXConfig(**fields)


class GPTNeoXBlock(nn.Module):

    def __init__(self, cfg: GPTNeoXConfig, device=None):
        super().__init__()
        self.cfg = cfg
        e = cfg.hidden_size
        self.input_layernorm = _ln(cfg, device)
        self.post_attention_layernorm = _ln(cfg, device)
        self.query_key_value = _col(cfg, e, 3 * e, True, device)
        self.dense = _row(cfg, e, e, True, device)
        self.dense_h_to_4h = _col(cfg, e, cfg.intermediate_size, True, device)
        self.dense_4h_to_h = _row(cfg, cfg.intermediate_size, e, True, device)

    def attention(self, x, positions, segment_ids=None):
        cfg = self.cfg
        b, s, _ = x.shape
        d = cfg.head_dim
        rot = int(d * cfg.rotary_pct)
        x = copy_to_tensor_region(x, self.query_key_value.tp, "qkv")
        q, k, v = dense(x, self.query_key_value, cfg.dtype).view(b, s, -1, 3, d).unbind(dim=3)
        cos, sin = rotary_embedding(positions, rot, cfg.rope_theta)
        q, k = apply_partial_rope(q, cos, sin, rot), apply_partial_rope(k, cos, sin, rot)
        return _out(cfg, get_attention_impl(cfg.attention_impl)(q, k, v, causal=True, segment_ids=segment_ids),
                    self.dense)

    def forward(self, x, positions, segment_ids=None):
        attn = self.attention(self.input_layernorm(x), positions, segment_ids)
        if self.cfg.use_parallel_residual:
            return x + attn + _gelu_mlp(self.cfg, self.post_attention_layernorm(x), self.dense_h_to_4h,
                                        self.dense_4h_to_h)
        h = x + attn
        return h + _gelu_mlp(self.cfg, self.post_attention_layernorm(h), self.dense_h_to_4h, self.dense_4h_to_h)


class GPTNeoXForCausalLM(_CausalLM):
    """GPT-NeoX (ref: ``module_inject/containers/gptneox.py``)."""

    def __init__(self, cfg: GPTNeoXConfig, device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed_in = _embedding(cfg, cfg.vocab_size, dev)
        self.layers = nn.ModuleList([GPTNeoXBlock(cfg, dev) for _ in range(cfg.num_hidden_layers)])
        self.final_layer_norm = _ln(cfg, dev)
        self.embed_out = _col(cfg, cfg.hidden_size, cfg.vocab_size, False, dev)

    def _embed(self, input_ids, positions):
        return self._embed_tokens(input_ids, self.embed_in)

    def _blocks(self):
        return self.layers

    def _head(self, x):
        return dense(self._to_head(self.final_layer_norm(x)), self.embed_out, self.cfg.dtype)


# ------------------------------------------------------------------- GPT-J


@dataclasses.dataclass(frozen=True)
class GPTJConfig:
    vocab_size: int = 50400
    hidden_size: int = 64
    intermediate_size: int = 256
    num_hidden_layers: int = 2
    num_attention_heads: int = 8
    rotary_dim: int = 8
    layer_norm_epsilon: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    attention_impl: str = "reference"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def from_hf(hf_cfg, **overrides) -> "GPTJConfig":
        e, heads = hf_value(hf_cfg, "n_embd"), hf_value(hf_cfg, "n_head")
        fields = dict(vocab_size=hf_value(hf_cfg, "vocab_size"), hidden_size=e,
                      intermediate_size=hf_value(hf_cfg, "n_inner", None) or 4 * e,
                      num_hidden_layers=hf_value(hf_cfg, "n_layer"), num_attention_heads=heads,
                      rotary_dim=hf_value(hf_cfg, "rotary_dim", None) or e // heads,
                      layer_norm_epsilon=hf_value(hf_cfg, "layer_norm_epsilon", 1e-5))
        fields.update(overrides)
        return GPTJConfig(**fields)


class GPTJBlock(nn.Module):

    def __init__(self, cfg: GPTJConfig, device=None):
        super().__init__()
        self.cfg = cfg
        e = cfg.hidden_size
        self.ln_1 = _ln(cfg, device)
        self.q_proj = _col(cfg, e, e, False, device)
        self.k_proj = _col(cfg, e, e, False, device)
        self.v_proj = _col(cfg, e, e, False, device)
        self.out_proj = _row(cfg, e, e, False, device)
        self.fc_in = _col(cfg, e, cfg.intermediate_size, True, device)
        self.fc_out = _row(cfg, cfg.intermediate_size, e, True, device)

    def forward(self, x, positions, segment_ids=None):
        cfg = self.cfg
        b, s, _ = x.shape
        a_in = self.ln_1(x)    # one LayerNorm feeds both parallel branches
        q_in = copy_to_tensor_region(a_in, self.q_proj.tp, "qkv")
        heads = lambda proj: dense(q_in, proj, cfg.dtype).view(b, s, -1, cfg.head_dim)
        q = apply_rope_interleaved(heads(self.q_proj), positions, cfg.rotary_dim)
        k = apply_rope_interleaved(heads(self.k_proj), positions, cfg.rotary_dim)
        out = get_attention_impl(cfg.attention_impl)(q, k, heads(self.v_proj), causal=True, segment_ids=segment_ids)
        return x + _out(cfg, out, self.out_proj) + _gelu_mlp(cfg, a_in, self.fc_in, self.fc_out)


class GPTJForCausalLM(_CausalLM):
    """GPT-J (ref: ``module_inject/containers/gptj.py``): the LM head has a bias."""

    def __init__(self, cfg: GPTJConfig, device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.wte = _embedding(cfg, cfg.vocab_size, dev)
        self.h = nn.ModuleList([GPTJBlock(cfg, dev) for _ in range(cfg.num_hidden_layers)])
        self.ln_f = _ln(cfg, dev)
        self.lm_head = _col(cfg, cfg.hidden_size, cfg.vocab_size, True, dev)

    def _embed(self, input_ids, positions):
        return self._embed_tokens(input_ids, self.wte)

    def _blocks(self):
        return self.h

    def _head(self, x):
        return dense(self._to_head(self.ln_f(x)), self.lm_head, self.cfg.dtype)


# ------------------------------------------------------------------ GPT-Neo


@dataclasses.dataclass(frozen=True)
class GPTNeoConfig:
    vocab_size: int = 50257
    hidden_size: int = 64
    intermediate_size: int = 256
    num_hidden_layers: int = 2
    num_attention_heads: int = 8
    max_position_embeddings: int = 2048
    attention_layers: Tuple[str, ...] = ("global", "local")
    window_size: int = 256
    layer_norm_epsilon: float = 1e-5
    tie_word_embeddings: bool = True
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    def layer_window(self, layer: int) -> int:
        """Layer ``layer``'s window: ``window_size`` keys for a "local"
        layer, 0 (the whole causal prefix) for a "global" one."""
        kind = self.attention_layers[layer % len(self.attention_layers)]
        return self.window_size if kind == "local" else 0

    @staticmethod
    def from_hf(hf_cfg, **overrides) -> "GPTNeoConfig":
        e = hf_value(hf_cfg, "hidden_size")
        fields = dict(vocab_size=hf_value(hf_cfg, "vocab_size"), hidden_size=e,
                      intermediate_size=hf_value(hf_cfg, "intermediate_size", None) or 4 * e,
                      num_hidden_layers=hf_value(hf_cfg, "num_layers"),
                      num_attention_heads=hf_value(hf_cfg, "num_heads"),
                      max_position_embeddings=hf_value(hf_cfg, "max_position_embeddings"),
                      attention_layers=tuple(hf_value(hf_cfg, "attention_layers")),
                      window_size=hf_value(hf_cfg, "window_size", 256),
                      layer_norm_epsilon=hf_value(hf_cfg, "layer_norm_epsilon", 1e-5))
        fields.update(overrides)
        return GPTNeoConfig(**fields)


def windowed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
                       segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal attention over the last ``window`` keys (``window <= 0``: the
    whole prefix), with NO 1/√D scale: GPT-Neo was trained without it (JAX
    ``_windowed_attention``, ``gpt_family.py:383``)."""
    sq = q.shape[1]
    logits = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sq, device=q.device)[None, :]
    eff = window if window > 0 else sq + 1
    logits = torch.where((qpos >= kpos) & (kpos > qpos - eff), logits, -1e30)
    if segment_ids is not None:
        logits = torch.where((segment_ids[:, :, None] == segment_ids[:, None, :])[:, None], logits, -1e30)
    return torch.einsum("bnqk,bknd->bqnd", torch.softmax(logits, dim=-1).to(v.dtype), v)


class GPTNeoBlock(nn.Module):

    def __init__(self, cfg: GPTNeoConfig, window: int, device=None):
        super().__init__()
        self.cfg, self.window = cfg, window
        e = cfg.hidden_size
        self.ln_1 = _ln(cfg, device)
        self.q_proj = _col(cfg, e, e, False, device)
        self.k_proj = _col(cfg, e, e, False, device)
        self.v_proj = _col(cfg, e, e, False, device)
        self.out_proj = _row(cfg, e, e, True, device)
        self.ln_2 = _ln(cfg, device)
        self.c_fc = _col(cfg, e, cfg.intermediate_size, True, device)
        self.c_proj = _row(cfg, cfg.intermediate_size, e, True, device)

    def forward(self, x, positions, segment_ids=None):
        cfg = self.cfg
        b, s, _ = x.shape
        a_in = copy_to_tensor_region(self.ln_1(x), self.q_proj.tp, "qkv")
        heads = lambda proj: dense(a_in, proj, cfg.dtype).view(b, s, -1, cfg.head_dim)
        out = windowed_attention(heads(self.q_proj), heads(self.k_proj), heads(self.v_proj), self.window, segment_ids)
        h = x + _out(cfg, out, self.out_proj)
        return h + _gelu_mlp(cfg, self.ln_2(h), self.c_fc, self.c_proj)


class GPTNeoForCausalLM(_CausalLM):
    """GPT-Neo (ref: ``module_inject/containers/gptneo.py``)."""

    def __init__(self, cfg: GPTNeoConfig, device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.wte = _embedding(cfg, cfg.vocab_size, dev)
        self.wpe = _embedding(cfg, cfg.max_position_embeddings, dev, vocab=False)
        self.h = nn.ModuleList([GPTNeoBlock(cfg, cfg.layer_window(i), dev) for i in range(cfg.num_hidden_layers)])
        self.ln_f = _ln(cfg, dev)

    def _embed(self, input_ids, positions):
        return self._embed_tokens(input_ids, self.wte) + F.embedding(positions.long(),
                                                                     self.wpe.weight).to(self.cfg.dtype)

    def _blocks(self):
        return self.h

    def _head(self, x):
        return self.attend(self.ln_f(x), self.wte)
