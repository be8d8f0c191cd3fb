"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu``.

The JAX package (``deepspeed_tpu``) stays the reference; this package mirrors
its module paths (``deepspeed_tpu/models/llama_cache.py`` ↔
``deepspeed_tpu_torch/models/llama_cache.py``) and never imports it, JAX or
flax.  Every Pallas TPU kernel on a ported path becomes a hand-written
Hopper kernel under ``csrc/``, built on first use (``ops/op_builder``).

Importing this package loads nothing heavy: ``initialize`` imports the
training runtime when called, and the serving path is imported from its
module, e.g. ``from deepspeed_tpu_torch.inference.v2 import build_engine``.
"""

__version__ = "0.1.0"


def initialize(model=None, config=None, optimizer=None, lr_scheduler=None, params=None, device=None,
               training_data=None):
    """Create a training engine (port of ``deepspeed_tpu.initialize``; ref:
    ``deepspeed/__init__.py:69``).

    ``model`` is an ``nn.Module`` (``models.llama.LlamaForCausalLM``);
    ``config`` the DeepSpeed JSON dict or path; ``params`` an optional state
    dict loaded into the model; ``optimizer`` an optional factory
    ``params -> torch.optim.Optimizer``.  The engine runs on ``device``,
    CUDA unless the caller passes ``device="cpu"`` (no GPU raises).  Returns
    ``(engine, optimizer, None, lr_scheduler)``.
    """
    if model is None:
        raise ValueError("deepspeed_tpu_torch.initialize: model is required")
    if config is None:
        raise ValueError("deepspeed_tpu_torch.initialize: config is required")
    if training_data is not None:
        raise NotImplementedError("training_data / the DeepSpeed dataloader is not ported (ROADMAP Queue 1, dataloader): "
                                  "pass batches to engine.train_batch(batch=...) or data_iter=")
    from .runtime.config import DeepSpeedConfig
    from .runtime.engine import DeepSpeedEngine
    ds_config = config if isinstance(config, DeepSpeedConfig) else DeepSpeedConfig(config)
    engine = DeepSpeedEngine(model=model, config=ds_config, optimizer=optimizer, lr_scheduler=lr_scheduler,
                             params=params, device=device)
    return engine, engine.optimizer, None, engine.lr_scheduler
