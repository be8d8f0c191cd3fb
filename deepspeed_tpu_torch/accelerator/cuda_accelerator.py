"""CUDA accelerator: the few methods of ``accelerator/abstract_accelerator.py``
(ref: ``deepspeed/accelerator/cuda_accelerator.py``) that the serving slice
needs — device name, synchronize, memory stats — plus device resolution."""

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means CUDA.  A CUDA device without a visible GPU raises:
    entry points never move to the CPU unless the caller passed
    ``device="cpu"``.  ``"meta"`` builds a module without allocating its
    weights (they come from ``load_state_dict(..., assign=True)``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA GPU is visible "
                           "(pass device='cpu' to run the plain PyTorch path)")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}: the port runs on 'cuda' or 'cpu'")
    return dev


class CUDA_Accelerator:
    """ref: accelerator/abstract_accelerator.py DeepSpeedAccelerator names."""

    def is_available(self) -> bool:
        return torch.cuda.is_available()

    def device_name(self, device_index: Optional[int] = None) -> str:
        return "cuda" if device_index is None else f"cuda:{device_index}"

    def device(self, device_index: Optional[int] = None) -> torch.device:
        return resolve_device(self.device_name(device_index))

    def device_count(self) -> int:
        return torch.cuda.device_count()

    def synchronize(self, device_index: Optional[int] = None) -> None:
        torch.cuda.synchronize(device_index)

    def memory_allocated(self, device_index: Optional[int] = None) -> int:
        return torch.cuda.memory_allocated(device_index)

    def max_memory_allocated(self, device_index: Optional[int] = None) -> int:
        return torch.cuda.max_memory_allocated(device_index)

    def reset_peak_memory_stats(self, device_index: Optional[int] = None) -> None:
        torch.cuda.reset_peak_memory_stats(device_index)


def get_accelerator() -> CUDA_Accelerator:
    return CUDA_Accelerator()
