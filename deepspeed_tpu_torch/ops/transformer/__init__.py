"""The legacy fused transformer layer's API (port of
``deepspeed_tpu/ops/transformer/__init__.py``; ref:
``deepspeed/ops/transformer/transformer.py``): ``DeepSpeedTransformerConfig``
and ``DeepSpeedTransformerLayer``, a shim over ``models/bert.BertLayer``.
The dropout ratios and the initialisation knobs are accepted for the
reference's signature and not read: the layer is deterministic, and its
weights come from a state dict or ``init_weights_``."""

import dataclasses

import torch

from ...accelerator import DeviceLike, resolve_device
from ...models.bert import BertConfig, BertLayer


@dataclasses.dataclass
class DeepSpeedTransformerConfig:
    """ref: ``ops/transformer/transformer.py DeepSpeedTransformerConfig`` (JAX ``:22``)."""
    batch_size: int = -1
    hidden_size: int = 768
    intermediate_size: int = 3072
    heads: int = 12
    attn_dropout_ratio: float = 0.1
    hidden_dropout_ratio: float = 0.1
    num_hidden_layers: int = 12
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    local_rank: int = -1
    seed: int = -1
    fp16: bool = False
    pre_layer_norm: bool = True
    normalize_invertible: bool = False
    gelu_checkpoint: bool = False
    adjust_init_range: bool = True
    attn_dropout_checkpoint: bool = False
    stochastic_mode: bool = False
    return_tuple: bool = False
    training: bool = True

    def to_bert_config(self) -> BertConfig:
        return BertConfig(hidden_size=self.hidden_size, intermediate_size=self.intermediate_size,
                          num_attention_heads=self.heads, num_hidden_layers=self.num_hidden_layers,
                          layer_norm_eps=self.layer_norm_eps, pre_layer_norm=self.pre_layer_norm,
                          dtype=torch.float16 if self.fp16 else torch.float32)


def DeepSpeedTransformerLayer(config: DeepSpeedTransformerConfig, initial_weights=None, initial_biases=None,
                              device: DeviceLike = "cuda") -> BertLayer:
    """ref: ``transformer.py DeepSpeedTransformerLayer(config)`` (JAX ``:60``):
    the ``BertLayer`` of the config (``initial_weights``/``initial_biases``
    are accepted for the signature; load a state dict instead)."""
    return BertLayer(config.to_bert_config(), device=resolve_device(device))
