"""FastGen v2 serving engine (port of ``deepspeed_tpu/inference/v2``)."""

from ...models.llama_cache import PagedKVConfig
from .engine_v2 import InferenceEngineV2, RaggedInferenceEngineConfig, build_engine
from .scheduler import SchedulerConfig
from .spec import DRAFTERS, DraftProvider, NGramDrafter, SpecConfig, SpecStats, make_drafter

__all__ = ["DRAFTERS", "DraftProvider", "InferenceEngineV2", "NGramDrafter", "PagedKVConfig",
           "RaggedInferenceEngineConfig", "SchedulerConfig", "SpecConfig", "SpecStats", "build_engine",
           "make_drafter"]
