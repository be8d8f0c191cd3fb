"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu``.

The JAX package (``deepspeed_tpu``) stays the reference; this package mirrors
its module paths (``deepspeed_tpu/models/llama_cache.py`` ↔
``deepspeed_tpu_torch/models/llama_cache.py``) and never imports it, JAX or
flax.  Every Pallas TPU kernel on a ported path becomes a hand-written
Hopper kernel under ``csrc/``, built on first use (``ops/op_builder``).

Importing this package loads nothing heavy: import the submodules you need,
e.g. ``from deepspeed_tpu_torch.inference.v2 import build_engine``.
"""

__version__ = "0.1.0"
