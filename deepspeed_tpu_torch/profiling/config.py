"""The flops profiler's config (port of ``deepspeed_tpu/profiling/config.py``):
the block lives with the other feature blocks in ``runtime/config.py``."""

from ..runtime.config import FlopsProfilerConfig as DeepSpeedFlopsProfilerConfig  # noqa: F401
