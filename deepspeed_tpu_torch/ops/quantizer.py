"""Block quantization: the plain PyTorch versions of the quant kernels.

Port of ``deepspeed_tpu/ops/quantizer.py:19-69`` (ref: DeepSpeed
``csrc/quantization/{quantize.cu, dequantize.cu, quantize_intX.cu}``):
symmetric per-block int8 and int4 for the ZeRO++ quantized gradient wire
(``runtime/comm/compressed.py``).  These are what the CUDA kernels K4a/K4b
(int8) and K5a/K5b (int4) of ``csrc/quant.cu`` compute, bit for bit, and
what ``ops/quant_kernels.py`` runs for a tensor on the CPU.

Contract, as in the JAX package: ``x`` of ``n`` elements (``n % block ==
0``) becomes ``(q [n/block, block] int8, scales [n/block] float32)``, or for
int4 ``(packed [n/block, block/2] uint8, scales)``.  The arithmetic is the
JAX source's, one IEEE float32 operation at a time, as the JAX package
computes it op by op: ``scale = absmax / qmax`` (1 for an all-zero block)
and ``x / scale`` are true divides (not products with a reciprocal), the
codes are rounded half to even (``torch.round``, as ``jnp.round``) and
clipped, and dequantization is one float32 product per element.  (Compiled
by XLA on the CPU, the JAX functions differ in the last bit: the divide by
the constant qmax becomes a product with ``fl(1/qmax)``, and products are
contracted into the sums and differences that consume them; PERF.md.)

``quantize_int8_grouped`` / ``dequantize_int8_grouped`` are the plain
versions of the grouped K4a/K4b: a step's tensors in one rank-major code
buffer laid out by a ``SegmentTable`` (``ops/quant_kernels.py``), computed
tensor by tensor with ``quantize_int8`` / ``dequantize_int8``.

int4 packs in the *halves* layout (``quantizer.py:48-53``): byte ``i`` of a
block holds element ``i`` in its low nibble and element ``i + block/2`` in
its high nibble, each stored as ``code + 8`` (1..15).

``pack_signs`` / ``unpack_signs`` (1-bit) wait for the 1-bit optimizers.
"""

import math
from typing import Optional, Sequence, Tuple

import torch


def _blocked(x: torch.Tensor, block: int) -> torch.Tensor:
    n = x.numel()
    if block <= 0 or n % block:
        raise ValueError(f"size {n} not divisible by quant block {block}")
    return x.reshape(n // block, block)


def _scales(xb: torch.Tensor, qmax: float) -> torch.Tensor:
    absmax = xb.abs().amax(dim=1)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar is a
    # product with its reciprocal, by a tensor a true divide
    return torch.where(absmax == 0, torch.ones_like(absmax), absmax / torch.full_like(absmax, qmax))


def quantize_int8(x: torch.Tensor, block: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """What K4a computes: ``(q [n/block, block] int8, scales [n/block] f32)``."""
    xb = _blocked(x.float(), block)
    scale = _scales(xb, 127.0)
    q = torch.clamp(torch.round(xb / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape: Sequence[int],
                    through: Optional[torch.dtype] = None) -> torch.Tensor:
    """What K4b computes: ``q · scale`` in float32, cut to ``shape``'s size
    (the last row's padding dropped) and reshaped to it; with ``through``,
    each value as that dtype holds it (widened back)."""
    out = (q.float() * scale[:, None]).reshape(-1)
    if -1 not in shape:
        out = out[:math.prod(shape)]
    out = out.reshape(shape)
    return out if through in (None, torch.float32) else out.to(through).float()


def quantize_int8_grouped(x: torch.Tensor, table) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the grouped K4a computes: each tensor of the flat ``x``
    (``[table.total]``, the tensors back to back) padded with zeros to
    ``world·block`` and quantized on its own, its blocks laid out rank-major:
    ``(q [world·chunk, block] int8, scales [world·chunk] f32)``."""
    w, c_all, block = table.world, table.chunk, table.block
    if x.numel() != table.total:
        raise ValueError(f"the grouped input holds {x.numel()} values, the table {table.total}")
    q = torch.empty((w, c_all, block), dtype=torch.int8, device=x.device)
    s = torch.empty((w, c_all), dtype=torch.float32, device=x.device)
    flat = x.reshape(-1)
    for n, first, c, off in table.segments():
        padded = torch.zeros(w * c * block, dtype=torch.float32, device=x.device)
        padded[:n] = flat[first:first + n].float()
        qt, st = quantize_int8(padded, block)
        q[:, off:off + c] = qt.view(w, c, block)
        s[:, off:off + c] = st.view(w, c)
    return q.view(w * c_all, block), s.view(w * c_all)


def dequantize_int8_grouped(q: torch.Tensor, scale: torch.Tensor, table,
                            through: Optional[torch.dtype] = None) -> torch.Tensor:
    """What the grouped K4b computes: the rank-major rows of ``q`` back in
    the tensors' order, each tensor dequantized on its own and cut to its
    size: float32 ``[table.total]`` (through ``through`` as in
    ``dequantize_int8``)."""
    w, c_all, block = table.world, table.chunk, table.block
    if tuple(q.shape) != (w * c_all, block) or tuple(scale.shape) != (w * c_all, ):
        raise ValueError(f"codes {tuple(q.shape)} and scales {tuple(scale.shape)} are not the table's "
                         f"[{w * c_all}, {block}] and [{w * c_all}]")
    out = torch.empty(table.total, dtype=torch.float32, device=q.device)
    qv, sv = q.view(w, c_all, block), scale.view(w, c_all)
    for n, first, c, off in table.segments():
        rows = qv[:, off:off + c].reshape(w * c, block)
        out[first:first + n] = dequantize_int8(rows, sv[:, off:off + c].reshape(w * c), (w * c * block, ),
                                               through)[:n]
    return out


def quantize_int4(x: torch.Tensor, block: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """What K5a computes: ``(packed [n/block, block/2] uint8, scales [n/block] f32)``."""
    if block % 2:
        raise ValueError(f"int4 packs two codes per byte: block {block} must be even")
    xb = _blocked(x.float(), block)
    scale = _scales(xb, 7.0)
    q = (torch.clamp(torch.round(xb / scale[:, None]), -7, 7) + 8).to(torch.uint8)   # 1..15
    half = block // 2
    return q[:, :half] | (q[:, half:] << 4), scale


def dequantize_int4(packed: torch.Tensor, scale: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """What K5b computes: unpack the halves layout, −8, × scale, in float32."""
    lo = (packed & 0xF).to(torch.int8) - 8
    hi = ((packed >> 4) & 0xF).to(torch.int8) - 8
    q = torch.cat([lo, hi], dim=-1)
    return (q.float() * scale[:, None]).reshape(shape)


def quantization_error(x: torch.Tensor, bits: int = 8, block: int = 256) -> torch.Tensor:
    """The round trip's residual ``x − dequant(quant(x))`` in ``x``'s dtype."""
    if bits == 8:
        q, s = quantize_int8(x, block)
        return x - dequantize_int8(q, s, x.shape).to(x.dtype)
    q, s = quantize_int4(x, block)
    return x - dequantize_int4(q, s, x.shape).to(x.dtype)
