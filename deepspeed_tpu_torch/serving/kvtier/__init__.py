"""Tiered paged KV: host-offload tier with park/resume, demotion-first
preemption, and prefetch-hidden promotion (docs/SERVING.md "Tiered KV")."""

from .tier import HostKVHandle, HostKVTier, TierConfig, TieredKVManager

__all__ = ["TierConfig", "HostKVHandle", "HostKVTier", "TieredKVManager"]
