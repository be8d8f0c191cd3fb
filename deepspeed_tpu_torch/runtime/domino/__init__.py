"""Domino: the tensor-parallel transformer with compute/communication
overlap (port of ``deepspeed_tpu/runtime/domino``; ref:
``deepspeed/runtime/domino/``)."""

from .transformer import DominoTransformer, DominoTransformerLayer

__all__ = ["DominoTransformer", "DominoTransformerLayer"]
