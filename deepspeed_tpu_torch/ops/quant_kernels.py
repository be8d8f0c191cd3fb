"""Block quantize / dequantize: the wrappers of the hand-written CUDA kernels
``csrc/quant.cu`` and the dispatch between them and their plain versions.

Port of ``deepspeed_tpu/ops/quant_kernels.py``.  The kernels replace the
Pallas TPU kernels of that module:

  K4a ``quantize_int8_cuda``   ← ``_q8_kernel``  (:31)
  K4b ``dequantize_int8_cuda`` ← ``_dq8_kernel`` (:39)
  K5a ``quantize_int4_cuda``   ← ``_q4_kernel``  (:44)
  K5b ``dequantize_int4_cuda`` ← ``_dq4_kernel`` (:56)

The contract is ``ops/quantizer.py``'s: ``(q [n/block, block] int8 | packed
[n/block, block/2] uint8, scales [n/block] f32)``; dequantization returns
float32 of the requested shape.  Each kernel is bit-exact to its plain
version.

``quantize_int8`` and the other three dispatch on the device of their
input: a CPU tensor runs the plain version, a CUDA tensor launches the
kernel or raises (device, dtype, shape, an int4 block that is odd, a block
above 1024).  The Pallas wrappers fall back to jnp when ``nblocks`` is not a
multiple of their 256-row tile; the CUDA kernels take any ``nblocks``.
"""

import ctypes
import functools
import math
from typing import Sequence, Tuple

import torch

from . import quantizer
from .op_builder import load_kernel

#: the largest block the kernels take (32 values per lane of one warp)
MAX_BLOCK = 1024
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernels' library, built on first use, with its C signatures."""
    lib = load_kernel("quant")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.ds_quant_q8, lib.ds_quant_q4):
        fn.argtypes = [p, i, p, p, ll, i, p]
        fn.restype = i
    for fn in (lib.ds_quant_dq8, lib.ds_quant_dq4):
        fn.argtypes = [p, p, p, ll, i, p]
        fn.restype = i
    lib.ds_quant_error_string.argtypes = [i]
    lib.ds_quant_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name: str, fn, *args) -> None:
    status = fn(*args, torch.cuda.current_stream(torch.cuda.current_device()).cuda_stream)
    if status != 0:
        raise RuntimeError(f"{name}: launch failed: {_lib().ds_quant_error_string(status).decode()}")


def _check_input(name: str, x: torch.Tensor, block: int, int4: bool) -> int:
    """Raise on what the quantize kernels do not take; return nblocks."""
    if not 0 < block <= MAX_BLOCK or (int4 and block % 2):
        raise ValueError(f"{name}: block {block} must be in 1..{MAX_BLOCK}" + (" and even" if int4 else ""))
    if x.numel() == 0 or x.numel() % block:
        raise ValueError(f"{name}: size {x.numel()} is not a positive multiple of block {block}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name} takes float32 or bfloat16 input, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: the input must be contiguous")
    if not x.is_cuda:
        raise ValueError(f"{name} needs a CUDA tensor, got one on {x.device}")
    return x.numel() // block


def _check_codes(name: str, q: torch.Tensor, scale: torch.Tensor, shape: Sequence[int], code_dtype,
                 per_byte: int) -> Tuple[int, int]:
    """Raise on what the dequantize kernels do not take; return (nblocks, block)."""
    if q.dtype != code_dtype or scale.dtype != torch.float32:
        raise ValueError(f"{name} takes {code_dtype} codes and float32 scales, got {q.dtype} and {scale.dtype}")
    if q.dim() != 2 or scale.shape != (q.shape[0], ) or q.numel() == 0:
        raise ValueError(f"{name}: codes must be [nblocks, width] and scales [nblocks], got {tuple(q.shape)} and "
                         f"{tuple(scale.shape)}")
    if not (q.is_contiguous() and scale.is_contiguous()):
        raise ValueError(f"{name}: codes and scales must be contiguous")
    nblocks, block = q.shape[0], q.shape[1] * per_byte
    if math.prod(shape) != nblocks * block:
        raise ValueError(f"{name}: shape {tuple(shape)} does not hold {nblocks}×{block} values")
    if not (q.is_cuda and scale.is_cuda and q.device == scale.device):
        raise ValueError(f"{name} needs codes and scales on one CUDA device, got {q.device} and {scale.device}")
    return nblocks, block


def quantize_int8_cuda(x: torch.Tensor, block: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K4a: ``(q [n/block, block] int8, scales [n/block] f32)``."""
    nb = _check_input("quantize_int8_cuda", x, block, int4=False)
    q = torch.empty((nb, block), dtype=torch.int8, device=x.device)
    s = torch.empty((nb, ), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _launch("quantize_int8_cuda", _lib().ds_quant_q8, x.data_ptr(), _DTYPE_CODES[x.dtype], q.data_ptr(),
                s.data_ptr(), nb, block)
    quantize_int8_cuda.launches += 1
    return q, s


def dequantize_int8_cuda(q: torch.Tensor, scale: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Launch K4b: ``q · scale`` in float32, reshaped to ``shape``."""
    nb, block = _check_codes("dequantize_int8_cuda", q, scale, shape, torch.int8, 1)
    out = torch.empty((nb, block), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _launch("dequantize_int8_cuda", _lib().ds_quant_dq8, q.data_ptr(), scale.data_ptr(), out.data_ptr(), nb,
                block)
    dequantize_int8_cuda.launches += 1
    return out.reshape(shape)


def quantize_int4_cuda(x: torch.Tensor, block: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K5a: ``(packed [n/block, block/2] uint8, scales [n/block] f32)``."""
    nb = _check_input("quantize_int4_cuda", x, block, int4=True)
    q = torch.empty((nb, block // 2), dtype=torch.uint8, device=x.device)
    s = torch.empty((nb, ), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _launch("quantize_int4_cuda", _lib().ds_quant_q4, x.data_ptr(), _DTYPE_CODES[x.dtype], q.data_ptr(),
                s.data_ptr(), nb, block)
    quantize_int4_cuda.launches += 1
    return q, s


def dequantize_int4_cuda(packed: torch.Tensor, scale: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Launch K5b: unpack the halves layout, −8, × scale, reshaped to ``shape``."""
    nb, block = _check_codes("dequantize_int4_cuda", packed, scale, shape, torch.uint8, 2)
    out = torch.empty((nb, block), dtype=torch.float32, device=packed.device)
    with torch.cuda.device(packed.device):
        _launch("dequantize_int4_cuda", _lib().ds_quant_dq4, packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
                nb, block)
    dequantize_int4_cuda.launches += 1
    return out.reshape(shape)


#: launches of each kernel since its counter was last set to 0
quantize_int8_cuda.launches = 0
dequantize_int8_cuda.launches = 0
quantize_int4_cuda.launches = 0
dequantize_int4_cuda.launches = 0


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"quantization: unsupported device {t.device}")
    return t.device.type


def quantize_int8(x: torch.Tensor, block: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4a on a CUDA tensor, ``quantizer.quantize_int8`` on a CPU tensor."""
    if _device_kind(x) == "cuda":
        return quantize_int8_cuda(x, block)
    return quantizer.quantize_int8(x, block)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """K4b on CUDA tensors, ``quantizer.dequantize_int8`` on CPU tensors."""
    if _device_kind(q) == "cuda":
        return dequantize_int8_cuda(q, scale, shape)
    return quantizer.dequantize_int8(q, scale, shape)


def quantize_int4(x: torch.Tensor, block: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5a on a CUDA tensor, ``quantizer.quantize_int4`` on a CPU tensor."""
    if _device_kind(x) == "cuda":
        return quantize_int4_cuda(x, block)
    return quantizer.quantize_int4(x, block)


def dequantize_int4(packed: torch.Tensor, scale: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """K5b on CUDA tensors, ``quantizer.dequantize_int4`` on CPU tensors."""
    if _device_kind(packed) == "cuda":
        return dequantize_int4_cuda(packed, scale, shape)
    return quantizer.dequantize_int4(packed, scale, shape)
