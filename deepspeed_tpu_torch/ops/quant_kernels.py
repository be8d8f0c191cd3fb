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

K4a and K4b are grouped: given a ``SegmentTable``, one launch quantizes
every tensor of a training step, each padded apart to ``world·block`` so
that its blocks start at its own origin, into one rank-major code buffer
(chunk ``d`` is what rank ``d`` receives: the whole buffer is one
``all_to_all_single``), and one launch dequantizes such a buffer back into
the tensors' order, cut to each tensor's size.  Without a table a call is
one tensor in the identity layout.

``quantize_int8`` and the other three dispatch on the device of their
input: a CPU tensor runs the plain version, a CUDA tensor launches the
kernel or raises (device, dtype, shape, table, an int4 block that is odd, a
block above 1024).  The Pallas wrappers fall back to jnp when ``nblocks`` is
not a multiple of their 256-row tile; the CUDA kernels take any ``nblocks``.
"""

import ctypes
import functools
import math
from itertools import accumulate
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from . import quantizer
from .op_builder import load_kernel

#: the largest block the kernels take (32 values per lane of one warp)
MAX_BLOCK = 1024
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class SegmentTable:
    """The static layout of one step's tensors on the grouped int8 wire.

    Per tensor ``t`` (in the given order): its element count ``n_t``, its
    first element in the flat tensor-order buffer (the tensors back to back,
    unpadded), its code rows per rank chunk ``c_t = ⌈n_t / (world·block)⌉``
    (the count padded to ``world·block``, over ``world·block``) and its first
    row inside a chunk (the sum of the ``c_u`` before it).  ``chunk`` is the
    sum of the ``c_t`` and the code buffer has ``world·chunk`` rows,
    rank-major: block ``b`` of tensor ``t`` is row ``(b // c_t)·chunk +
    off_t + b % c_t``.  The kernels also read each chunk row's tensor index
    (``chunk`` int32).  The shapes and the world size of a training run are
    fixed, so a table is built once; its records and row index go to a
    device once (``device_tables``)."""

    def __init__(self, numels: Sequence[int], world: int, block: int = 256):
        numels = tuple(int(n) for n in numels)
        if not numels or min(numels) <= 0:
            raise ValueError(f"a segment table needs tensors of at least one element, got sizes {numels}")
        if world < 1 or not 0 < block <= MAX_BLOCK:
            raise ValueError(f"world {world} must be >= 1 and block {block} in 1..{MAX_BLOCK}")
        unit = world * block
        self.numels, self.world, self.block = numels, world, block
        self.offsets = tuple(accumulate(numels[:-1], initial=0))
        self.chunk_rows = tuple(-(-n // unit) for n in numels)
        self.chunk_offsets = tuple(accumulate(self.chunk_rows[:-1], initial=0))
        self.chunk = sum(self.chunk_rows)
        self.rows = world * self.chunk
        self.total = sum(numels)
        self._records = np.array([self.numels, self.offsets, self.chunk_rows, self.chunk_offsets],
                                 dtype=np.int64).T.copy()
        self._row_segments = np.repeat(np.arange(len(numels), dtype=np.int32), self.chunk_rows)
        self._on_device: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def __len__(self) -> int:
        return len(self.numels)

    def segments(self) -> Iterator[Tuple[int, int, int, int]]:
        """``(n_t, first element, rows per chunk, first row in a chunk)`` per tensor."""
        return zip(self.numels, self.offsets, self.chunk_rows, self.chunk_offsets)

    def device_tables(self, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The records ``[len, 4]`` int64 (n_t, first element, rows per chunk,
        first row in a chunk) and the tensor of each chunk row ``[chunk]``
        int32, on ``device``, copied there once."""
        device = torch.device(device)
        if device not in self._on_device:
            self._on_device[device] = (torch.from_numpy(self._records).to(device),
                                       torch.from_numpy(self._row_segments).to(device))
        return self._on_device[device]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernels' library, built on first use, with its C signatures."""
    lib = load_kernel("quant")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ds_quant_q8.argtypes = [p, i, p, p, p, p, ll, ll, ll, i, p]
    lib.ds_quant_dq8.argtypes = [p, p, p, p, p, ll, ll, ll, i, i, p]
    lib.ds_quant_q4.argtypes = [p, i, p, p, ll, i, p]
    lib.ds_quant_dq4.argtypes = [p, p, p, ll, i, p]
    for fn in (lib.ds_quant_q8, lib.ds_quant_dq8, lib.ds_quant_q4, lib.ds_quant_dq4):
        fn.restype = i
    lib.ds_quant_error_string.argtypes = [i]
    lib.ds_quant_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name: str, fn, *args) -> None:
    status = fn(*args, torch.cuda.current_stream(torch.cuda.current_device()).cuda_stream)
    if status != 0:
        raise RuntimeError(f"{name}: launch failed: {_lib().ds_quant_error_string(status).decode()}")


def _check_input(name: str, x: torch.Tensor, block: int, int4: bool, table: Optional[SegmentTable] = None) -> int:
    """Raise on what the quantize kernels do not take; return the code rows."""
    if not 0 < block <= MAX_BLOCK or (int4 and block % 2):
        raise ValueError(f"{name}: block {block} must be in 1..{MAX_BLOCK}" + (" and even" if int4 else ""))
    if table is not None:
        if table.block != block:
            raise ValueError(f"{name}: block {block} differs from the table's {table.block}")
        if x.dim() != 1 or x.numel() != table.total:
            raise ValueError(f"{name}: the input must be the flat [{table.total}] buffer of the table's tensors, "
                             f"got {tuple(x.shape)}")
    elif x.numel() == 0 or x.numel() % block:
        raise ValueError(f"{name}: size {x.numel()} is not a positive multiple of block {block}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name} takes float32 or bfloat16 input, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: the input must be contiguous")
    if not x.is_cuda:
        raise ValueError(f"{name} needs a CUDA tensor, got one on {x.device}")
    return table.rows if table is not None else x.numel() // block


def _check_codes(name: str, q: torch.Tensor, scale: torch.Tensor, shape: Sequence[int], code_dtype,
                 per_byte: int, table: Optional[SegmentTable] = None) -> Tuple[int, int]:
    """Raise on what the dequantize kernels do not take; return (rows, block)."""
    if q.dtype != code_dtype or scale.dtype != torch.float32:
        raise ValueError(f"{name} takes {code_dtype} codes and float32 scales, got {q.dtype} and {scale.dtype}")
    if q.dim() != 2 or scale.shape != (q.shape[0], ) or q.numel() == 0:
        raise ValueError(f"{name}: codes must be [nblocks, width] and scales [nblocks], got {tuple(q.shape)} and "
                         f"{tuple(scale.shape)}")
    if not (q.is_contiguous() and scale.is_contiguous()):
        raise ValueError(f"{name}: codes and scales must be contiguous")
    nblocks, block = q.shape[0], q.shape[1] * per_byte
    if table is not None and (nblocks, block) != (table.rows, table.block):
        raise ValueError(f"{name}: codes {tuple(q.shape)} are not the table's [{table.rows}, {table.block}]")
    values = table.total if table is not None else nblocks * block
    if math.prod(shape) != values:
        raise ValueError(f"{name}: shape {tuple(shape)} does not hold {values} values")
    if not (q.is_cuda and scale.is_cuda and q.device == scale.device):
        raise ValueError(f"{name} needs codes and scales on one CUDA device, got {q.device} and {scale.device}")
    return nblocks, block


def _round_bf16(through: Optional[torch.dtype]) -> int:
    if through not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"dequantize_int8: values go through float32 or bfloat16, not {through}")
    return int(through == torch.bfloat16)


def _layout(table: Optional[SegmentTable], device, rows: int, n0: int) -> tuple:
    """The C layout arguments: (records, row segments, n0, chunk, rows)."""
    if table is None:
        return None, None, n0, rows, rows
    records, row_segments = table.device_tables(device)
    return records.data_ptr(), row_segments.data_ptr(), 0, table.chunk, table.rows


def quantize_int8_cuda(x: torch.Tensor, block: int = 256,
                       table: Optional[SegmentTable] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K4a: ``(q [rows, block] int8, scales [rows] f32)``.  Without a
    table, ``x`` (a multiple of ``block``) in the identity layout
    (``rows = n/block``); with one, ``x`` is the flat ``[table.total]``
    buffer of the table's tensors and the rows are rank-major."""
    rows = _check_input("quantize_int8_cuda", x, block, int4=False, table=table)
    q = torch.empty((rows, block), dtype=torch.int8, device=x.device)
    s = torch.empty((rows, ), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _launch("quantize_int8_cuda", _lib().ds_quant_q8, x.data_ptr(), _DTYPE_CODES[x.dtype], q.data_ptr(),
                s.data_ptr(), *_layout(table, x.device, rows, x.numel()), block)
    quantize_int8_cuda.launches += 1
    return q, s


def dequantize_int8_cuda(q: torch.Tensor, scale: torch.Tensor, shape: Sequence[int],
                         table: Optional[SegmentTable] = None, through: Optional[torch.dtype] = None) -> torch.Tensor:
    """Launch K4b: ``q · scale`` in float32, reshaped to ``shape``.  With a
    table, the rank-major rows go back to the tensors' order, each cut to its
    size (``shape`` holds ``table.total`` values).  ``through=torch.bfloat16``
    writes each value as ``.to(torch.bfloat16).float()`` gives it."""
    nb, block = _check_codes("dequantize_int8_cuda", q, scale, shape, torch.int8, 1, table)
    round_bf16 = _round_bf16(through)
    out = torch.empty((table.total if table is not None else nb * block, ), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _launch("dequantize_int8_cuda", _lib().ds_quant_dq8, q.data_ptr(), scale.data_ptr(), out.data_ptr(),
                *_layout(table, q.device, nb, nb * block), block, round_bf16)
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


def quantize_int8(x: torch.Tensor, block: int = 256,
                  table: Optional[SegmentTable] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4a on a CUDA tensor; on a CPU tensor ``quantizer.quantize_int8``, or
    with a table ``quantizer.quantize_int8_grouped``."""
    if _device_kind(x) == "cuda":
        return quantize_int8_cuda(x, block, table)
    if table is None:
        return quantizer.quantize_int8(x, block)
    if table.block != block:
        raise ValueError(f"quantize_int8: block {block} differs from the table's {table.block}")
    return quantizer.quantize_int8_grouped(x, table)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape: Sequence[int],
                    table: Optional[SegmentTable] = None, through: Optional[torch.dtype] = None) -> torch.Tensor:
    """K4b on CUDA tensors; on CPU tensors ``quantizer.dequantize_int8``, or
    with a table ``quantizer.dequantize_int8_grouped``."""
    if _device_kind(q) == "cuda":
        return dequantize_int8_cuda(q, scale, shape, table, through)
    _round_bf16(through)
    if table is None:
        return quantizer.dequantize_int8(q, scale, shape, through)
    return quantizer.dequantize_int8_grouped(q, scale, table, through).reshape(shape)


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
