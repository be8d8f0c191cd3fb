"""FastGen v2 serving engine (port of ``deepspeed_tpu/inference/v2``)."""

from ...models.llama_cache import PagedKVConfig
from .engine_v2 import InferenceEngineV2, RaggedInferenceEngineConfig, build_engine
from .scheduler import SchedulerConfig

__all__ = ["InferenceEngineV2", "PagedKVConfig", "RaggedInferenceEngineConfig", "SchedulerConfig", "build_engine"]
