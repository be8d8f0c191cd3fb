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

A family without a paged twin (``policy.paged`` False: BLOOM, GPT-NeoX,
GPT-J, GPT-Neo, BERT, DistilBERT, CLIP, Megatron GPT) is served by the v1
engine, ``init_inference``, in float32, as JAX's factory routes it
(``engine_factory.py:54-80``; JAX keeps its config's bf16 compute dtype
under float32 weights, the port computes in float32 too); ``engine_config``
is ignored with JAX's warning, and ``quantization_mode`` raises, as in
JAX.  For the paged families ``quantization_mode`` (any value, e.g.
``"wf6af16"``) serves int8 weights (``inference/quantization.py``).
"""

import dataclasses
from typing import Optional

import torch

from ...accelerator import DeviceLike
from ...models.llama import hf_value
from ...utils.logging import logger
from ..quantization import quantize_inference_params
from .checkpoint_io import load_state_dict, read_config
from .engine_v2 import InferenceEngineV2, RaggedInferenceEngineConfig
from .model_implementations.policies import policy_for

#: the dtype a checkpoint's model computes in and keeps its weights in
SERVING_DTYPE = torch.bfloat16
#: the dtype of the v1 route (JAX's ``init_inference(config={"dtype": "fp32"})``)
V1_DTYPE = torch.float32


def build_hf_engine(path: str, engine_config: Optional[RaggedInferenceEngineConfig] = None, debug_level: int = 0,
                    quantization_mode: Optional[str] = None, device: DeviceLike = "cuda"):
    """The engine over the checkpoint in ``path`` (``debug_level`` is
    accepted for the reference's signature): an ``InferenceEngineV2`` for a
    family with a paged twin, else the v1 ``InferenceEngine``."""
    hf_cfg = read_config(path)
    model_type = hf_value(hf_cfg, "model_type", "llama")
    policy = policy_for(model_type)
    if not policy.paged:
        if quantization_mode is not None:
            raise NotImplementedError(f"quantization_mode={quantization_mode!r} requires the paged v2 engine; "
                                      f"{model_type} has no paged cache twin and serves through the v1 engine")
        if engine_config is not None:
            logger.warning(f"build_hf_engine: engine_config is ignored for {model_type} (the v1 route: no ragged "
                           "scheduler or KV arena)")
        cfg = dataclasses.replace(policy.build_config(hf_cfg), dtype=V1_DTYPE)
        model = policy.build_model(cfg, device="meta")
        model.load_state_dict(policy.convert(load_state_dict(path), cfg), strict=True, assign=True)
        logger.info(f"build_hf_engine: {model_type} has no paged twin: serving through the v1 engine")
        from ... import init_inference
        return init_inference(model=model, config={"dtype": "fp32"}, device=device)
    cfg = policy.build_config(hf_cfg)
    cfg = dataclasses.replace(cfg, dtype=SERVING_DTYPE, param_dtype=SERVING_DTYPE)
    state = policy.convert(load_state_dict(path), cfg)
    logger.info(f"build_hf_engine: model_type={policy.model_type} "
                f"{sum(t.numel() for t in state.values()) / 1e6:.1f}M params in {SERVING_DTYPE}")
    if quantization_mode is not None:
        state = quantize_inference_params(state, dtype=SERVING_DTYPE, cfg=cfg)
    return InferenceEngineV2(cfg, state, engine_config, device=device)
