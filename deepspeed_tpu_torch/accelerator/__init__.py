"""Accelerator abstraction (port of ``deepspeed_tpu/accelerator/``).

``get_accelerator()`` returns the CUDA accelerator; ``resolve_device`` is
the one place that turns an entry point's ``device`` argument into a
``torch.device`` and enforces the port's rule: the default is CUDA, and
without a GPU an entry point raises unless the caller asked for the CPU.
"""

from .cuda_accelerator import CUDA_Accelerator, DeviceLike, get_accelerator, resolve_device

__all__ = ["CUDA_Accelerator", "DeviceLike", "get_accelerator", "resolve_device"]
