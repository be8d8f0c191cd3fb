"""Build an ``InferenceEngineV2`` from a HuggingFace checkpoint directory
(port of ``deepspeed_tpu/inference/v2/engine_factory.py``; ref:
``deepspeed/inference/v2/engine_factory.py:69 build_hf_engine``).

The directory holds ``config.json`` and the weights (``*.safetensors``
shards or ``pytorch_model*.bin``), read by ``checkpoint_io`` (no
``transformers``, no ``safetensors``).  The model type picks the policy
(``model_implementations/policies.py``), which builds the family's config
and maps the weights onto its paged twin.  Whatever dtype the checkpoint
was saved in, the model computes in bfloat16, as the JAX package's
``build_hf_engine`` does (its configs' default ``dtype``), and the engine
keeps the weights in bfloat16 too: the JAX model casts its float32 weights
to bfloat16 at every use, so the numbers served are the same, in half the
memory.
"""

import dataclasses
from typing import Optional

import torch

from ...accelerator import DeviceLike
from ...models.llama import hf_value
from ...utils.logging import logger
from .checkpoint_io import load_state_dict, read_config
from .engine_v2 import InferenceEngineV2, RaggedInferenceEngineConfig
from .model_implementations.policies import ROADMAP_V1, policy_for

#: the dtype a checkpoint's model computes in and keeps its weights in
SERVING_DTYPE = torch.bfloat16


def build_hf_engine(path: str, engine_config: Optional[RaggedInferenceEngineConfig] = None, debug_level: int = 0,
                    quantization_mode: Optional[str] = None, device: DeviceLike = "cuda") -> InferenceEngineV2:
    """The engine over the checkpoint in ``path`` (``debug_level`` is
    accepted for the reference's signature).  ``quantization_mode`` raises:
    the weight quantization of the JAX package is not ported, nor its v1
    engine for the families without a paged twin."""
    if quantization_mode is not None:
        raise NotImplementedError(f"quantization_mode={quantization_mode!r}: inference/quantization.py is not "
                                  f"ported ({ROADMAP_V1})")
    hf_cfg = read_config(path)
    policy = policy_for(hf_value(hf_cfg, "model_type", "llama"))
    cfg = policy.build_config(hf_cfg)
    cfg = dataclasses.replace(cfg, dtype=SERVING_DTYPE, param_dtype=SERVING_DTYPE)
    state = policy.convert(load_state_dict(path), cfg)
    logger.info(f"build_hf_engine: model_type={policy.model_type} "
                f"{sum(t.numel() for t in state.values()) / 1e6:.1f}M params in {SERVING_DTYPE}")
    return InferenceEngineV2(cfg, state, engine_config, device=device)
