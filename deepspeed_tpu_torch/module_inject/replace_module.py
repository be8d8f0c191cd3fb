"""Module replacement: an HF checkpoint → the port's model (port of
``deepspeed_tpu/module_inject/replace_module.py``; ref:
``deepspeed/module_inject/replace_module.py``).

The reference swaps each transformer layer of a live torch model for a
fused container; here, as in JAX, the whole model is translated: the model
type's policy (``inference/v2/model_implementations/policies.py``) builds
the family's config, converts the checkpoint's state dict and makes the
model, which holds the converted weights.
"""

import dataclasses
from typing import Tuple

import torch
from torch import nn

from ..accelerator import DeviceLike
from ..utils.logging import logger


def replace_transformer_layer(orig_layer_impl=None, model=None, checkpoint_dict=None, config=None,
                              model_config=None):
    """ref: ``replace_module.py:183``: surgery on a live model's layers has
    no counterpart here (JAX ``:20``)."""
    raise NotImplementedError("kernel injection into the layers of a live model is not how the port serves: use "
                              "deepspeed_tpu_torch.module_inject.replace_module(model_or_path) or "
                              "inference.v2.engine_factory.build_hf_engine")


def replace_module(model_or_path, policy=None, dtype=None, device: DeviceLike = "cuda") -> Tuple[nn.Module, dict]:
    """``(model, state_dict)`` for a local HF checkpoint directory, or an
    object with ``config`` and ``state_dict()`` (a transformers model): the
    policy's model (paged twin or v1 model) holding the converted weights
    on ``device``, computing in ``dtype`` when given (JAX ``:31``)."""
    from ..inference.v2.checkpoint_io import load_state_dict, read_config
    from ..inference.v2.model_implementations.policies import policy_for
    from ..models.cache_zoo import build_cache_model
    from ..models.llama import hf_value

    if isinstance(model_or_path, str):
        hf_cfg, sd = read_config(model_or_path), load_state_dict(model_or_path)
    else:
        hf_cfg, sd = model_or_path.config, model_or_path.state_dict()
    pol = policy if policy is not None else policy_for(hf_value(hf_cfg, "model_type", "llama"))
    cfg = pol.build_config(hf_cfg)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    state = pol.convert(sd, cfg)
    model = pol.build_model(cfg, device="meta") if not pol.paged else build_cache_model(cfg, 16, device="meta")
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()}, strict=True, assign=True)
    logger.info(f"replace_module: {pol.model_type} → {type(model).__name__}")
    return model.to(device), state
