"""Module injection (port of ``deepspeed_tpu/module_inject``): an HF model
or checkpoint directory → the port's model and weights; ``tp_rules`` holds
the sharding rules of the tensor, expert and ZeRO-3 axes, ``layers`` the
tensor-parallel layers and their collectives."""

from .replace_module import replace_module, replace_transformer_layer

__all__ = ["replace_module", "replace_transformer_layer"]
