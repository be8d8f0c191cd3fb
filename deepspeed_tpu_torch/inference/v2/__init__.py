"""FastGen v2 serving engine (port of ``deepspeed_tpu/inference/v2``)."""

from ...models.cache_zoo import build_cache_model
from ...models.llama_cache import PagedKVConfig
from .engine_factory import build_hf_engine
from .engine_v2 import InferenceEngineV2, RaggedInferenceEngineConfig, ServingBudget, build_engine, compile_aot_serving
from .scheduler import SchedulerConfig
from .spec import DRAFTERS, DraftProvider, NGramDrafter, SpecConfig, SpecStats, make_drafter

__all__ = ["DRAFTERS", "DraftProvider", "InferenceEngineV2", "NGramDrafter", "PagedKVConfig",
           "RaggedInferenceEngineConfig", "SchedulerConfig", "SpecConfig", "SpecStats", "build_cache_model",
           "build_engine", "build_hf_engine", "make_drafter"]
