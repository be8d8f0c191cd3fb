"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu``.

The JAX package (``deepspeed_tpu``) stays the reference; this package mirrors
its module paths (``deepspeed_tpu/models/llama_cache.py`` ↔
``deepspeed_tpu_torch/models/llama_cache.py``) and never imports it, JAX or
flax.  Every Pallas TPU kernel on a ported path becomes a hand-written
Hopper kernel under ``csrc/``, built on first use (``ops/op_builder``).

Importing this package loads nothing heavy: ``initialize`` imports the
training runtime when called, ``init_inference`` the v1 inference engine,
and the serving path is imported from its module, e.g.
``from deepspeed_tpu_torch.inference.v2 import build_engine``.
"""

import dataclasses
import importlib
import os

__version__ = "0.1.0"


def __getattr__(name):
    """``deepspeed_tpu_torch.zero`` is ``runtime.zero`` (JAX exports ``ds.zero``),
    imported on first use."""
    if name == "zero":
        return importlib.import_module(".runtime.zero", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def initialize(args=None, model=None, optimizer=None, model_parameters=None, training_data=None, lr_scheduler=None,
               distributed_port=29500, mpu=None, dist_init_required=None, collate_fn=None, config=None,
               config_params=None, loss_fn=None, model_inputs_fn=None, params=None, device=None):
    """Create a training engine (port of ``deepspeed_tpu.initialize``; ref:
    ``deepspeed/__init__.py:69``).

    ``model`` is an ``nn.Module`` (``models.llama.LlamaForCausalLM``);
    ``config`` the DeepSpeed JSON dict or path (else ``config_params``, else
    ``args.deepspeed_config``); ``params`` an optional state dict loaded into
    the model; ``optimizer`` an optional factory ``params ->
    torch.optim.Optimizer``; ``loss_fn(outputs, batch)`` and
    ``model_inputs_fn(batch) -> (args, kwargs)`` replace the causal-LM loss
    and the model's inputs.  The engine runs on ``device``, CUDA unless the
    caller passes ``device="cpu"`` (no GPU raises).  Returns ``(engine,
    optimizer, training_dataloader, lr_scheduler)``: with ``training_data``
    the loader is a ``DeepSpeedDataLoader`` of global micro-batches
    (``train_batch_size // gradient_accumulation_steps`` rows, through
    ``collate_fn``), which ``engine.train_batch(data_iter=...)`` takes
    ``gradient_accumulation_steps`` at a time.

    Data parallelism runs over the default ``torch.distributed`` process
    group.  Without one, ``comm.init_distributed`` creates it (from the
    launcher's ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT``) when
    ``dist_init_required`` is True, or when it is None and the environment
    names a world larger than 1; otherwise the engine trains one rank.
    ``model_parameters`` and ``distributed_port`` are the reference's: the
    engine trains every floating parameter of ``model``.  A Megatron-style
    ``mpu`` maps its grid onto the mesh (JAX ``__init__.py:62-70``,
    ``comm/mesh.mesh_from_mpu``): its tensor degree on ``tensor``, its data
    degree on ``data``, so the engine's groups follow the grid; one the
    process group cannot hold raises JAX's ``ValueError``, pipeline stages
    raise naming ROADMAP item 6.4.
    """
    if model is None:
        raise ValueError("deepspeed_tpu_torch.initialize: model is required")
    if config is None and config_params is not None:
        config = config_params
    if config is None and args is not None and hasattr(args, "deepspeed_config"):
        config = args.deepspeed_config
    if config is None:
        raise ValueError("deepspeed_tpu_torch.initialize: config is required")
    from .comm import comm
    from .runtime.config import DeepSpeedConfig
    from .runtime.dataloader import DeepSpeedDataLoader
    from .runtime.engine import DeepSpeedEngine
    if dist_init_required or (dist_init_required is None and int(os.environ.get("WORLD_SIZE", 1)) > 1):
        comm.init_distributed()
    ds_config = config if isinstance(config, DeepSpeedConfig) else DeepSpeedConfig(config, mpu=mpu)
    engine = DeepSpeedEngine(model=model, config=ds_config, optimizer=optimizer, lr_scheduler=lr_scheduler,
                             params=params, device=device, loss_fn=loss_fn, model_inputs_fn=model_inputs_fn)
    dataloader = None
    if training_data is not None:
        micro_global = ds_config.train_batch_size // ds_config.gradient_accumulation_steps
        dataloader = DeepSpeedDataLoader(training_data, batch_size=micro_global, collate_fn=collate_fn)
    return engine, engine.optimizer, dataloader, engine.lr_scheduler



def tp_model_init(model=None, tp_size: int = 1, dtype=None, config=None):
    """Prepare a model for tensor-parallel training (port of
    ``deepspeed_tpu.tp_model_init``; ref: ``deepspeed/__init__.py:369``):
    returns ``(model, TpTrainingManager)``.  The engine cuts a whole
    Llama-family model to its rank's slices itself (``tensor_parallel.
    autotp_size`` in its config); the manager's ``plan``/``shardings`` cover
    trees without logical axes, as JAX's."""
    from .runtime.tensor_parallel import TpTrainingManager, TPTrainingConfig
    if isinstance(config, TPTrainingConfig):
        cfg = config
    elif isinstance(config, dict):
        cfg = TPTrainingConfig(**{**config, "autotp_size": config.get("autotp_size", tp_size)})
    elif config is None:
        cfg = TPTrainingConfig(autotp_size=tp_size)
    else:
        raise TypeError(f"config must be TPTrainingConfig or dict, got {type(config)}")
    return model, TpTrainingManager(model=model, tp_size=tp_size, dtype=dtype, config=cfg)


def init_inference(model=None, config=None, **kwargs):
    """Build the v1 inference engine (port of ``deepspeed_tpu.init_inference``;
    ref: ``deepspeed/__init__.py:291``): ``InferenceEngine(model, config,
    params=None, device="cuda", generator=None)``.  Other keyword arguments
    are config keys (``tensor_parallel=2``, ``replace_with_kernel_inject=True``,
    ``dtype``...) merged over ``config``'s, as the reference merges them."""
    from .inference.engine import DeepSpeedInferenceConfig, InferenceEngine
    engine_keys = ("params", "device", "generator")
    over = {k: v for k, v in kwargs.items() if k not in engine_keys}
    if over:
        if isinstance(config, DeepSpeedInferenceConfig):
            config = dataclasses.asdict(config)
        config = {**(config or {}), **over}
    return InferenceEngine(model=model, config=config or {}, **{k: v for k, v in kwargs.items() if k in engine_keys})
