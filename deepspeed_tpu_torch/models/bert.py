"""The BERT family: the encoder and its MLM and classification heads (port of
``deepspeed_tpu/models/bert.py``).

A post-LN encoder (original BERT; ``pre_layer_norm`` for the pre-LN variant
of ``ops/transformer``), learned positions, token-type embeddings, an erf
GELU FFN, and bidirectional plain attention with an optional ``[B, S]`` key
mask (1 keeps, 0 pads).  Parameter names mirror the JAX tree with the layers
unrolled (``bert.encoder.{i}.attention.query``, ...) and torch's ``[out,
in]`` weights.  ``cfg.remat`` wraps each layer in ``torch.utils.checkpoint``
when gradients are on (JAX ``nothing_saveable``).
"""

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..accelerator import DeviceLike, resolve_device
from .llama import LayerNorm, _linear, dense, hf_value


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pre_layer_norm: bool = False
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def from_hf(hf_cfg, **overrides) -> "BertConfig":
        fields = dict(vocab_size=hf_value(hf_cfg, "vocab_size"), hidden_size=hf_value(hf_cfg, "hidden_size"),
                      num_hidden_layers=hf_value(hf_cfg, "num_hidden_layers"),
                      num_attention_heads=hf_value(hf_cfg, "num_attention_heads"),
                      intermediate_size=hf_value(hf_cfg, "intermediate_size"),
                      max_position_embeddings=hf_value(hf_cfg, "max_position_embeddings"),
                      type_vocab_size=hf_value(hf_cfg, "type_vocab_size", 2),
                      layer_norm_eps=hf_value(hf_cfg, "layer_norm_eps", 1e-12))
        fields.update(overrides)
        return BertConfig(**fields)


PRESETS = {
    "bert-base": BertConfig(),
    "bert-large": BertConfig(hidden_size=1024, num_hidden_layers=24, num_attention_heads=16, intermediate_size=4096),
    "bert-tiny": BertConfig(hidden_size=128, num_hidden_layers=2, num_attention_heads=2, intermediate_size=512),
}


def _ln(cfg: BertConfig, device) -> LayerNorm:
    return LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype, cfg.param_dtype, device)


def bidirectional_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            attention_mask: Optional[torch.Tensor] = None, causal: bool = False) -> torch.Tensor:
    """Plain softmax attention without a causal mask unless asked: float32
    scores scaled by 1/√D, padded keys (``attention_mask`` == 0) at -1e30,
    probabilities cast to v's dtype before the PV product."""
    s = q.shape[1]
    logits = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * (1.0 / math.sqrt(q.shape[-1]))
    if causal:
        logits = torch.where(torch.ones(s, s, dtype=torch.bool, device=q.device).tril(), logits, -1e30)
    if attention_mask is not None:
        logits = torch.where(attention_mask[:, None, None, :] > 0, logits, -1e30)
    return torch.einsum("bnqk,bknd->bqnd", torch.softmax(logits, dim=-1).to(v.dtype), v)


class BertSelfAttention(nn.Module):

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        e = cfg.hidden_size
        self.query, self.key, self.value = (_linear(cfg, e, e, True, device) for _ in range(3))
        self.output = _linear(cfg, e, e, True, device)

    def forward(self, x, attention_mask=None):
        cfg = self.cfg
        b, s, _ = x.shape
        heads = lambda proj: dense(x, proj, cfg.dtype).view(b, s, cfg.num_attention_heads, cfg.head_dim)
        out = bidirectional_attention(heads(self.query), heads(self.key), heads(self.value), attention_mask)
        return dense(out.reshape(b, s, -1), self.output, cfg.dtype)


class BertLayer(nn.Module):

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.attention = BertSelfAttention(cfg, device)
        self.attention_output_ln = _ln(cfg, device)
        self.intermediate = _linear(cfg, cfg.hidden_size, cfg.intermediate_size, True, device)
        self.output = _linear(cfg, cfg.intermediate_size, cfg.hidden_size, True, device)
        self.output_ln = _ln(cfg, device)

    def forward(self, x, attention_mask=None):
        cfg = self.cfg
        if cfg.pre_layer_norm:
            x = x + self.attention(self.attention_output_ln(x), attention_mask)
            mlp_in = self.output_ln(x)
        else:
            x = self.attention_output_ln(x + self.attention(x, attention_mask))
            mlp_in = x
        h = dense(F.gelu(dense(mlp_in, self.intermediate, cfg.dtype)), self.output, cfg.dtype)
        return x + h if cfg.pre_layer_norm else self.output_ln(x + h)


class BertModel(nn.Module):
    """The encoder trunk: ``input_ids`` [B, S] → final hidden states [B, S, E]."""

    def __init__(self, cfg: BertConfig, device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        emb = lambda n: nn.utils.skip_init(nn.Embedding, n, cfg.hidden_size, device=dev, dtype=cfg.param_dtype)
        self.word_embeddings = emb(cfg.vocab_size)
        self.position_embeddings = emb(cfg.max_position_embeddings)
        self.token_type_embeddings = emb(cfg.type_vocab_size)
        self.embeddings_ln = _ln(cfg, dev)
        self.encoder = nn.ModuleList([BertLayer(cfg, dev) for _ in range(cfg.num_hidden_layers)])

    def forward(self, input_ids, attention_mask=None, token_type_ids=None, positions=None):
        cfg = self.cfg
        if positions is None:
            positions = torch.arange(input_ids.shape[1], device=input_ids.device).expand(input_ids.shape)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = lambda ids, table: F.embedding(ids.long(), table.weight).to(cfg.dtype)
        x = emb(input_ids, self.word_embeddings) + emb(positions, self.position_embeddings)
        x = self.embeddings_ln(x + emb(token_type_ids, self.token_type_embeddings))
        remat = cfg.remat and torch.is_grad_enabled()
        for layer in self.encoder:
            if remat:
                from torch.utils.checkpoint import checkpoint
                x = checkpoint(layer, x, attention_mask, use_reentrant=False)
            else:
                x = layer(x, attention_mask)
        return x


class BertForMaskedLM(nn.Module):
    """The MLM head over the trunk: a dense + GELU + LayerNorm transform,
    then the ``decoder`` to the vocabulary."""

    def __init__(self, cfg: BertConfig, device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.bert = BertModel(cfg, dev)
        self.transform = _linear(cfg, cfg.hidden_size, cfg.hidden_size, True, dev)
        self.transform_ln = _ln(cfg, dev)
        self.decoder = _linear(cfg, cfg.hidden_size, cfg.vocab_size, True, dev)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None, positions=None):
        cfg = self.cfg
        x = self.bert(input_ids, attention_mask, token_type_ids, positions)
        x = self.transform_ln(F.gelu(dense(x, self.transform, cfg.dtype)))
        return dense(x, self.decoder, cfg.dtype)


class BertForSequenceClassification(nn.Module):
    """A tanh pooler over the first token, then a float32 classifier."""

    def __init__(self, cfg: BertConfig, num_labels: int = 2, device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.bert = BertModel(cfg, dev)
        self.pooler = _linear(cfg, cfg.hidden_size, cfg.hidden_size, True, dev)
        self.classifier = _linear(cfg, cfg.hidden_size, num_labels, True, dev)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None, positions=None):
        x = self.bert(input_ids, attention_mask, token_type_ids, positions)
        pooled = torch.tanh(dense(x[:, 0], self.pooler, self.cfg.dtype))
        return dense(pooled, self.classifier, torch.float32)


def masked_lm_loss(logits: torch.Tensor, labels: torch.Tensor, loss_mask: Optional[torch.Tensor] = None,
                   ignore_index: int = -100) -> torch.Tensor:
    """MLM cross entropy in float32; positions labelled ``ignore_index`` are
    skipped, the mean is over the rest (times ``loss_mask``), at least 1."""
    valid = labels != ignore_index
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, torch.where(valid, labels, 0)[..., None].long())[..., 0]
    mask = valid.float() if loss_mask is None else valid.float() * loss_mask
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
