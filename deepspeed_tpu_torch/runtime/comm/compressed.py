"""The ZeRO++ quantized gradient wire (qgZ) and its LoCo error feedback,
over a ``torch.distributed`` process group.

Port of ``deepspeed_tpu/runtime/comm/compressed.py:64-177`` (ref:
``deepspeed/runtime/comm/coalesced_collectives.py:31
all_to_all_quant_reduce`` and ``:81 all_to_all_loco_quant_reduce``, and
ZeRO++'s quantized all-gather).  The JAX functions run inside
``shard_map`` over a named axis; these run on every rank of ``group``
(the default process group when None) with that rank's tensor.  The wire
carries int8 codes (or packed int4) and one float32 scale per block, not
float32 values; the codes come from the kernels K4a/K5a and are read back
by K4b/K5b (``ops/quant_kernels.py``: the plain versions for CPU tensors).

Two translations of the JAX program, both the same function:
  * ``jax.lax.all_to_all(q, split_axis=0, concat_axis=0, tiled=False)`` on
    ``[W, ...]`` is ``all_to_all_single`` on the contiguous ``[W·nb, ...]``:
    rank r sends chunk d to rank d, and chunk s of what it receives came
    from rank s.  ``all_gather`` (not tiled) is ``all_gather_into_tensor``.
  * ``jax.vmap`` of the dequantization over the W received copies is one
    launch over ``[W·nb, block]``: blocks are independent.

The reduction over the W copies is a sum then a divide by W, as
``jnp.mean`` computes it.  Quantization blocks start at each tensor's own
origin: callers pass one tensor at a time (never a flattened bucket of
several), or every code and scale would differ from the reference.

``compressed_allreduce`` (the 1-bit wire) waits for the 1-bit optimizers.
"""

from typing import Optional, Tuple

import torch

from ...comm import comm
from ...ops.quant_kernels import dequantize_int4, dequantize_int8, quantize_int4, quantize_int8


def _codec(bits: int):
    if bits == 8:
        return quantize_int8, dequantize_int8
    if bits == 4:
        return quantize_int4, dequantize_int4
    raise ValueError(f"bits must be 8 or 4, got {bits}")


def all_to_all_quant_reduce(x: torch.Tensor, group=None, bits: int = 8, block: int = 256,
                            return_local_dequant: bool = False):
    """qgZ reduce-scatter: this rank's ``x`` ``[n]`` (``n`` a multiple of
    ``world·block``) is quantized and its chunk ``d`` sent to rank ``d``;
    each rank dequantizes the W copies of its own chunk and averages them in
    float32.  Returns the rank's shard ``[n/W]``, and with
    ``return_local_dequant`` also ``x`` as the wire carried it (the LoCo
    residual's source)."""
    quantize, dequantize = _codec(bits)
    world = comm.get_world_size(group)
    flat = x.reshape(-1).float()
    n = flat.numel()
    if n % world:
        raise ValueError(f"size {n} is not divisible by the world size {world}")
    shard = n // world
    q, s = quantize(flat, block)
    local_deq = dequantize(q, s, (n, )) if return_local_dequant else None
    q_recv, s_recv = torch.empty_like(q), torch.empty_like(s)
    comm.all_to_all_single(q_recv, q, group)
    comm.all_to_all_single(s_recv, s, group)
    total = dequantize(q_recv, s_recv, (world, shard)).sum(dim=0)
    reduced = total / torch.full_like(total, world)   # a true divide on every device (see ops/quantizer.py)
    if return_local_dequant:
        return reduced, local_deq
    return reduced


def quantized_all_gather(shard: torch.Tensor, group=None, bits: int = 8, block: int = 256) -> torch.Tensor:
    """qwZ all-gather: every rank's quantized ``shard`` ``[m]``, dequantized
    in rank order into the full float32 tensor ``[W·m]``."""
    quantize, dequantize = _codec(bits)
    world = comm.get_world_size(group)
    flat = shard.reshape(-1).float()
    q, s = quantize(flat, block)
    all_q = q.new_empty((world * q.shape[0], q.shape[1]))
    all_s = s.new_empty((world * s.shape[0], ))
    comm.all_gather_into_tensor(all_q, q, group)
    comm.all_gather_into_tensor(all_s, s, group)
    return dequantize(all_q, all_s, (world * flat.numel(), ))


def _padded(flat: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.cat([flat, flat.new_zeros(pad)]) if pad else flat


def padded_quant_allreduce(x: torch.Tensor, group=None, bits: int = 8, block: int = 256,
                           error: Optional[torch.Tensor] = None, err_beta: float = 0.8):
    """The whole-tensor mean over the group on the qgZ wire: pad to a
    multiple of ``world·block`` (zeros are exact under the mean), quantized
    reduce-scatter, quantized all-gather, cut back to ``x``'s shape and
    dtype.  With ``error`` (``x``'s shape): the LoCo variant, which also
    returns the new residual.  Returns ``reduced`` or ``(reduced, new_error)``."""
    flat = x.reshape(-1).float()
    unit = comm.get_world_size(group) * block
    pad = (-flat.numel()) % unit
    if error is None:
        shard = all_to_all_quant_reduce(_padded(flat, pad), group, bits=bits, block=block)
        full = quantized_all_gather(shard, group, bits=bits, block=block)
        return full[:x.numel()].reshape(x.shape).to(x.dtype)
    shard, new_err = loco_all_to_all_quant_reduce(_padded(flat, pad), _padded(error.reshape(-1).float(), pad), group,
                                                  bits=bits, block=block, err_beta=err_beta)
    full = quantized_all_gather(shard, group, bits=bits, block=block)
    return full[:x.numel()].reshape(x.shape).to(x.dtype), new_err[:x.numel()].reshape(x.shape)


def loco_all_to_all_quant_reduce(x: torch.Tensor, error: torch.Tensor, group=None, bits: int = 8, block: int = 256,
                                 err_beta: float = 0.8) -> Tuple[torch.Tensor, torch.Tensor]:
    """LoCo-qgZ: ``x + err_beta·error`` goes on the qgZ wire, and the new
    error is what the wire lost of it.  Returns ``(reduced shard [n/W],
    new_error)`` with ``new_error`` in ``error``'s shape and dtype."""
    fed = x.reshape(-1).float() + err_beta * error.reshape(-1).float()
    reduced, deq = all_to_all_quant_reduce(fed, group, bits=bits, block=block, return_local_dequant=True)
    return reduced, (fed - deq).reshape(x.shape).to(error.dtype)
