"""Module injection (port of ``deepspeed_tpu/module_inject``): an HF model
or checkpoint directory → the port's model and weights; ``tp_rules`` holds
ZeRO-3's sharding rule (its tensor-parallel rules come with tensor
parallelism, ROADMAP Queue 1 item 6)."""

from .replace_module import replace_module, replace_transformer_layer

__all__ = ["replace_module", "replace_transformer_layer"]
