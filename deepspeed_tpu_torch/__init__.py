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

import os

__version__ = "0.1.0"


def initialize(model=None, config=None, optimizer=None, lr_scheduler=None, params=None, device=None,
               training_data=None, dist_init_required=None):
    """Create a training engine (port of ``deepspeed_tpu.initialize``; ref:
    ``deepspeed/__init__.py:69``).

    ``model`` is an ``nn.Module`` (``models.llama.LlamaForCausalLM``);
    ``config`` the DeepSpeed JSON dict or path; ``params`` an optional state
    dict loaded into the model; ``optimizer`` an optional factory
    ``params -> torch.optim.Optimizer``.  The engine runs on ``device``,
    CUDA unless the caller passes ``device="cpu"`` (no GPU raises).  Returns
    ``(engine, optimizer, None, lr_scheduler)``.

    Data parallelism runs over the default ``torch.distributed`` process
    group.  Without one, ``comm.init_distributed`` creates it (from the
    launcher's ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT``) when
    ``dist_init_required`` is True, or when it is None and the environment
    names a world larger than 1; otherwise the engine trains one rank.
    """
    if model is None:
        raise ValueError("deepspeed_tpu_torch.initialize: model is required")
    if config is None:
        raise ValueError("deepspeed_tpu_torch.initialize: config is required")
    if training_data is not None:
        raise NotImplementedError("training_data / the DeepSpeed dataloader is not ported (ROADMAP Queue 1, dataloader): "
                                  "pass batches to engine.train_batch(batch=...) or data_iter=")
    from .comm import comm
    from .runtime.config import DeepSpeedConfig
    from .runtime.engine import DeepSpeedEngine
    if dist_init_required or (dist_init_required is None and int(os.environ.get("WORLD_SIZE", 1)) > 1):
        comm.init_distributed()
    ds_config = config if isinstance(config, DeepSpeedConfig) else DeepSpeedConfig(config)
    engine = DeepSpeedEngine(model=model, config=ds_config, optimizer=optimizer, lr_scheduler=lr_scheduler,
                             params=params, device=device)
    return engine, engine.optimizer, None, engine.lr_scheduler
