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

The reduction over the W copies is a sum then a product with fl(1/W), as
``jnp.mean`` computes it even op by op (a true divide by W differs from it
in the last bit at W = 3, 5, 6, ...).  Quantization blocks start at each
tensor's own origin: callers pass one tensor at a time (never a flattened
bucket of several), or every code and scale would differ from the
reference.

``GroupedQuantAllreduce`` is ``padded_quant_allreduce`` over a whole list
of tensors (the JAX engine's ``jax.tree.map`` of it over the gradients,
``deepspeed_tpu/runtime/engine.py:984-987``) in 2 launches of the grouped
K4a, 2 of the grouped K4b and 4 collectives, instead of 2 + 2 launches and
4 collectives per tensor: each tensor is still padded apart (a
``SegmentTable``), and the codes of all of them travel in one buffer per
direction.  Every code, scale and dequantized value equals the per-tensor
route's at any world size.  The mean over the W received copies is one
``sum(dim=0)`` over ``[W, Σ shards]`` where the per-tensor route sums each
``[W, shard_t]``: the reduced values are bit-identical too, held at W = 3
against JAX on the CPU and between the two routes on an H100
(``tests/test_torch_qgz.py``).

``compressed_allreduce`` (the 1-bit wire) waits for the 1-bit optimizers.
"""

import math
from typing import List, Optional, Sequence, Tuple

import torch

from ...comm import comm
from ...ops.quant_kernels import SegmentTable, dequantize_int4, dequantize_int8, quantize_int4, quantize_int8


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
    reduced = total * torch.full_like(total, 1.0 / world)   # jnp.mean's sum · fl(1/W), on every device
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


class GroupedQuantAllreduce:
    """The grouped qgZ exchange over a fixed list of tensor shapes: the
    ``SegmentTable`` of the shapes at the group's world size (blocks of 256),
    and a flat buffer of the wire's input ``dtype`` whose views take a step's
    tensors in one ``torch._foreach_copy_`` (the cast to ``dtype``
    included).  int8 only (``bits=8``), as the JAX engine's qgZ step.  Built
    once, called once per step."""

    def __init__(self, shapes: Sequence[Sequence[int]], dtype: torch.dtype = torch.float32, device=None, group=None,
                 bits: int = 8):
        if bits != 8:
            raise ValueError(f"the grouped qgZ exchange is int8 (bits=8), got bits={bits}: "
                             "use padded_quant_allreduce per tensor")
        self.group = group
        self.dtype = dtype
        self.shapes = [tuple(s) for s in shapes]
        self.world = comm.get_world_size(group)
        self.table = SegmentTable([math.prod(s) for s in self.shapes], self.world)
        self.inputs = torch.empty(self.table.total, dtype=dtype, device=device)
        self.input_views = self._views(self.inputs)

    def _views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        return [v.view(s) for v, s in zip(flat.split(self.table.numels), self.shapes)]

    def __call__(self, xs: Sequence[torch.Tensor], errors: Optional[Sequence[torch.Tensor]] = None,
                 err_beta: float = 0.8):
        """``padded_quant_allreduce`` of every ``x`` (taken as ``dtype``),
        widened to float32: the reduced tensors in the shapes of ``xs``, views
        of one buffer.  With ``errors`` (in the same shapes; the wire's dtype
        float32, as LoCo feeds it): LoCo, and also the new errors."""
        table, block, world = self.table, self.table.block, self.world
        if len(xs) != len(table) or (errors is not None and len(errors) != len(table)):
            raise ValueError(f"the exchange was built for {len(table)} tensors, got {len(xs)}"
                             + ("" if errors is None else f" and {len(errors)} errors"))
        if errors is not None and self.dtype != torch.float32:
            raise ValueError(f"LoCo feeds the grouped exchange float32 (x + err_beta·error), not {self.dtype}")
        src = self.inputs
        torch._foreach_copy_(self.input_views, list(xs))
        if errors is not None:   # in place: the inputs become x + err_beta·error
            torch._foreach_add_(self.input_views, torch._foreach_mul([e.float() for e in errors], err_beta))
        q, s = quantize_int8(src, block, table)
        local_deq = dequantize_int8(q, s, (table.total, ), table) if errors is not None else None
        q_recv, s_recv = torch.empty_like(q), torch.empty_like(s)
        comm.all_to_all_single(q_recv, q, self.group)
        comm.all_to_all_single(s_recv, s, self.group)
        total = dequantize_int8(q_recv, s_recv, (world, table.chunk * block)).sum(dim=0)
        reduced = total * torch.full_like(total, 1.0 / world)   # jnp.mean's sum · fl(1/W), on every device
        q, s = quantize_int8(reduced, block)
        all_q = q.new_empty((world * q.shape[0], block))
        all_s = s.new_empty((world * s.shape[0], ))
        comm.all_gather_into_tensor(all_q, q, self.group)
        comm.all_gather_into_tensor(all_s, s, self.group)
        full = dequantize_int8(all_q, all_s, (table.total, ), table, through=self.dtype)
        if errors is None:
            return self._views(full)
        return self._views(full), self._views(src - local_deq)
