"""Offloaded optimizer state (port of ``deepspeed_tpu/runtime/swap_tensor``):
the aio swapper, the host-streamed and the NVMe-pipelined optimizer tiers,
and their overlap instrumentation."""

from .swapper import AioSwapConfig, PartitionedOptimizerSwapper, SwapInHandle, SwapOutHandle, TensorSwapper  # noqa: F401
