"""Tensor-parallel layers: the collectives that GSPMD inserts around the
JAX package's Megatron layout, placed by hand (ref:
``deepspeed/module_inject/layers.py`` ``LinearLayer``/``LinearAllreduce``
and Megatron's ``mappings.py``).

The JAX package shards each weight over the ``tensor`` mesh axis by its
logical axes (``module_inject/tp_rules.py``) and lets GSPMD insert the
collectives.  The port keeps each rank's slice of such a weight in a layer
of its own and runs the same collectives on the tensor group
(``TensorParallel.group``), as ``torch.autograd.Function``s:

* ``copy_to_tensor_region``: identity forward, all-reduce of the gradient
  in the backward (the input of a column-parallel projection: each rank's
  slice of the output contributes to the input's gradient);
* ``reduce_from_tensor_region``: all-reduce forward, identity backward (the
  partial sums of a row-parallel projection, the vocab-parallel embedding's
  rows);
* ``gather_from_tensor_region``: all-gather along the last dim forward,
  this rank's slice of the gradient backward (the served logits).

The sums run in float32 and the result is cast back, as one matmul's float32
accumulation would; gathers move bit patterns.  Every collective is counted
by kind and direction in ``comm.tensor_parallel_kinds`` and kept out of the
CommsLogger (``comm.unrecorded``), as JAX logs its jitted step as one entry.

``ColumnParallelLinear`` holds ``[out/N, in]`` (its bias ``[out/N]``; a
fused projection of ``parts`` outputs laid out part-major, as GPT-2's
``c_attn`` ``(3, H, D)``, holds the rank's slice of each part),
``RowParallelLinear`` ``[out, in/N]`` (its bias whole, added after the
reduce), ``VocabParallelEmbedding`` ``[V/N, E]``: rank ``t`` holds rows
(or columns) ``[t·n, (t+1)·n)`` of the whole tensor, the JAX slice of the
tensor axis.  ``tp_dim`` is the sliced dim of the port tensor.  At
``tensor`` 1 they are ``nn.Linear`` and ``nn.Embedding`` and run no
collective.  A module that holds several sliced tensors of its own (an
expert bank, ``moe.ExpertsFFN``; Qwen2-MoE's sparse MLP) names them in
``TP_DIMS`` (parameter → sliced dim) and carries its ``tp``: the helpers
below cut, name and place them as they do the layers'.
"""

import dataclasses
from typing import Any, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..comm import comm
from ..comm.mesh import ROADMAP_TENSOR_PARALLEL


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """A rank's place on the tensor axis: the degree, its ``t`` and the
    process group of its tensor group (None at degree 1)."""
    size: int = 1
    rank: int = 0
    group: Any = None

    def slice(self, n: int) -> slice:
        """This rank's part of a dim of whole size ``n``."""
        if n % self.size:
            raise ValueError(f"tensor parallelism over {self.size} ranks does not divide a dim of {n}")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)


NO_TENSOR_PARALLEL = TensorParallel()


def _count(kind: str, direction: str) -> None:
    comm.tensor_parallel_kinds[(kind, direction)] += 1


def all_reduce_f32(x: torch.Tensor, tp: TensorParallel, kind: str, direction: str = "forward",
                   op: str = comm.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over the tensor group in float32 (a new tensor in ``x``'s dtype)."""
    y = x.to(torch.float32, copy=True).contiguous()
    with comm.unrecorded():
        comm.all_reduce(y, op, group=tp.group)
    _count(kind, direction)
    return y.to(x.dtype)


def gather_dim(x: torch.Tensor, tp: TensorParallel, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``, in rank order over the
    tensor group (bits moved as bytes; not counted)."""
    x = x.contiguous()
    stacked = x.new_empty((tp.size, ) + tuple(x.shape))
    with comm.unrecorded():
        comm.all_gather_into_tensor(stacked.view(-1).view(torch.uint8), x.view(-1).view(torch.uint8), group=tp.group)
    dim %= x.dim()
    shape = list(x.shape)
    shape[dim] *= tp.size
    return stacked.movedim(0, dim).reshape(shape)


def all_gather_last(x: torch.Tensor, tp: TensorParallel, kind: str, direction: str = "forward") -> torch.Tensor:
    """``gather_dim`` along the last dim, counted as ``kind``."""
    out = gather_dim(x, tp, -1)
    _count(kind, direction)
    return out


class _CopyToTensorRegion(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, tp, kind):
        ctx.tp, ctx.kind = tp, kind
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_f32(g, ctx.tp, ctx.kind, "backward"), None, None


class _ReduceFromTensorRegion(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, tp, kind):
        return all_reduce_f32(x, tp, kind)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFromTensorRegion(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, tp, kind):
        ctx.tp, ctx.n = tp, x.shape[-1]
        return all_gather_last(x, tp, kind)

    @staticmethod
    def backward(ctx, g):
        t = ctx.tp.rank
        return g[..., t * ctx.n:(t + 1) * ctx.n].contiguous(), None, None


def copy_to_tensor_region(x: torch.Tensor, tp: TensorParallel, kind: str = "copy_to") -> torch.Tensor:
    return _CopyToTensorRegion.apply(x, tp, kind) if tp.size > 1 else x


def reduce_from_tensor_region(x: torch.Tensor, tp: TensorParallel, kind: str = "reduce_from") -> torch.Tensor:
    return _ReduceFromTensorRegion.apply(x, tp, kind) if tp.size > 1 else x


def gather_from_tensor_region(x: torch.Tensor, tp: TensorParallel, kind: str = "gather_from") -> torch.Tensor:
    return _GatherFromTensorRegion.apply(x, tp, kind) if tp.size > 1 else x


class ColumnParallelLinear(nn.Linear):
    """``nn.Linear(in, out)`` of which this rank holds output rows
    ``[t·out/N, (t+1)·out/N)`` (ref: ``LinearLayer``); with ``parts`` > 1
    the outputs are ``parts`` blocks laid out part-major (a fused q/k/v) and
    the rank holds rows ``[t·n/N, (t+1)·n/N)`` of each block of ``n``."""
    tp_dim = 0

    def __init__(self, in_features: int, out_features: int, bias: bool = True, device=None, dtype=None,
                 tp_size: int = 1, parts: int = 1):
        if out_features % (tp_size * parts):
            raise ValueError(f"tensor parallelism over {tp_size} ranks does not divide {out_features} outputs "
                             f"in {parts} parts")
        super().__init__(in_features, out_features // tp_size, bias=bias, device=device, dtype=dtype)
        self.tp = TensorParallel(tp_size)
        self.parts = parts


class RowParallelLinear(nn.Linear):
    """``nn.Linear(in, out)`` of which this rank holds input columns
    ``[t·in/N, (t+1)·in/N)``; the partial products are all-reduced before
    the (whole) bias is added (ref: ``LinearAllreduce``)."""
    tp_dim = 1

    def __init__(self, in_features: int, out_features: int, bias: bool = True, device=None, dtype=None,
                 tp_size: int = 1):
        if in_features % tp_size:
            raise ValueError(f"tensor parallelism over {tp_size} ranks does not divide {in_features} inputs")
        super().__init__(in_features // tp_size, out_features, bias=bias, device=device, dtype=dtype)
        self.tp = TensorParallel(tp_size)


class VocabParallelEmbedding(nn.Embedding):
    """``nn.Embedding(V, E)`` of which this rank holds rows ``[t·V/N,
    (t+1)·V/N)``: an id outside them looks up zeros, and the ranks' rows
    are all-reduced (exactly one rank adds a nonzero row)."""
    tp_dim = 0

    def __init__(self, num_embeddings: int, embedding_dim: int, device=None, dtype=None, tp_size: int = 1):
        if num_embeddings % tp_size:
            raise ValueError(f"tensor parallelism over {tp_size} ranks does not divide a vocab of {num_embeddings}")
        super().__init__(num_embeddings // tp_size, embedding_dim, device=device, dtype=dtype)
        self.tp = TensorParallel(tp_size)


def row_parallel_dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype, kind: str) -> torch.Tensor:
    """flax ``DenseGeneral`` over a row-parallel layer: this rank's partial
    product, summed over the tensor group, then the bias; at degree 1 one
    ``F.linear`` with the bias, as ``models/llama.dense``."""
    tp = getattr(layer, "tp", NO_TENSOR_PARALLEL)
    bias = None if layer.bias is None else layer.bias.to(dtype)
    if tp.size == 1:
        return F.linear(x.to(dtype), layer.weight.to(dtype), bias)
    y = reduce_from_tensor_region(F.linear(x.to(dtype), layer.weight.to(dtype)), tp, kind)
    return y if bias is None else y + bias


def vocab_parallel_embed(ids: torch.Tensor, weight: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The rows of ``ids`` from a vocab-parallel table (the whole table's at degree 1)."""
    if tp.size == 1:
        return F.embedding(ids, weight)
    n = weight.shape[0]
    local = ids - tp.rank * n
    inside = (local >= 0) & (local < n)
    rows = F.embedding(torch.where(inside, local, 0), weight) * inside[..., None].to(weight.dtype)
    return reduce_from_tensor_region(rows, tp, "embed")


def set_tensor_parallel_(module: nn.Module, tp: TensorParallel) -> nn.Module:
    """Give every tensor-parallel layer of ``module`` (and ``module``
    itself, when it has a ``tp``) the rank's place ``tp``; the layers'
    degree must be ``tp.size``."""
    for m in module.modules():
        if hasattr(m, "tp") and isinstance(m.tp, TensorParallel):
            if (isinstance(m, _LAYERS) or _bank_dims(m)) and m.tp.size != tp.size:
                raise ValueError(f"{type(m).__name__} built for {m.tp.size} tensor-parallel ranks, set to {tp.size}")
            m.tp = tp
    return module


@torch.no_grad()
def cut_tensor_parallel_(module: nn.Module, tp: TensorParallel) -> nn.Module:
    """Cut a model built whole (its parallel layers at degree 1) to rank
    ``tp.rank``'s slices in place, and give it and its layers ``tp``."""
    for _, m in tp_layers(module):
        if m.tp.size != 1:
            raise ValueError(f"{type(m).__name__} is already cut over {m.tp.size} ranks")
        parts = getattr(m, "parts", 1)
        m.weight = nn.Parameter(narrow_to_rank(m.weight.data, m.tp_dim, tp, parts).clone(),
                                requires_grad=m.weight.requires_grad)
        if isinstance(m, ColumnParallelLinear) and m.bias is not None:
            m.bias = nn.Parameter(narrow_to_rank(m.bias.data, 0, tp, parts).clone(),
                                  requires_grad=m.bias.requires_grad)
        if isinstance(m, VocabParallelEmbedding):
            m.num_embeddings = m.weight.shape[0]
        else:
            m.out_features, m.in_features = m.weight.shape
        m.tp = tp
    for _, m in tp_banks(module):
        cut_bank_(m, tp)
    return set_tensor_parallel_(module, tp)


@torch.no_grad()
def cut_bank_(module: nn.Module, tp: TensorParallel) -> None:
    """Cut a module's own sliced tensors (``TP_DIMS``), built whole, to rank
    ``tp.rank``'s slices in place, and give it ``tp``."""
    if module.tp.size != 1:
        raise ValueError(f"{type(module).__name__} is already cut over {module.tp.size} ranks")
    for pname, dim in _bank_dims(module).items():
        w = getattr(module, pname)
        w.data = narrow_to_rank(w.data, dim, tp).clone()
    module.tp = tp


def tensor_parallel_of(module: nn.Module) -> TensorParallel:
    """The ``tp`` of ``module`` (degree 1 when it has none)."""
    return getattr(module, "tp", NO_TENSOR_PARALLEL)


_LAYERS = (ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)


def tp_layers(module: nn.Module):
    """(name, layer) of every tensor-parallel layer of ``module``."""
    return [(n, m) for n, m in module.named_modules() if isinstance(m, _LAYERS)]


def _bank_dims(module: nn.Module) -> dict:
    return getattr(module, "TP_DIMS", None) or {}


def tp_banks(module: nn.Module):
    """(name, module) of every module of ``module`` that holds sliced
    tensors of its own (``TP_DIMS``)."""
    return [(n, m) for n, m in module.named_modules() if _bank_dims(m)]


def tp_dims(module: nn.Module) -> dict:
    """Parameter name → the dim of the port tensor sliced over the tensor
    axis, for every parameter a rank holds a slice of (a column-parallel
    layer's weight and bias, a row-parallel layer's weight, a
    vocab-parallel table, an expert bank's weights).  A fused projection's
    slice is not one contiguous cut: one cut over several ranks raises (it
    is cut by ``cut_tensor_parallel_`` only)."""
    out = {}
    for name, m in tp_layers(module):
        if getattr(m, "parts", 1) > 1 and m.tp.size > 1:
            raise NotImplementedError(f"{name!r} fuses {m.parts} projections: its tensor slice is not one "
                                      f"contiguous cut of the whole tensor ({ROADMAP_TENSOR_PARALLEL})")
        pre = f"{name}." if name else ""
        out[pre + "weight"] = m.tp_dim
        if isinstance(m, ColumnParallelLinear) and m.bias is not None:
            out[pre + "bias"] = 0
    for name, m in tp_banks(module):
        pre = f"{name}." if name else ""
        out.update({pre + pname: dim for pname, dim in _bank_dims(m).items()})
    return out


def narrow_to_rank(t: torch.Tensor, dim: Optional[int], tp: TensorParallel, parts: int = 1) -> torch.Tensor:
    """This rank's slice of the whole tensor ``t`` on ``dim`` (``t`` itself
    for None); with ``parts`` > 1, ``dim`` is ``parts`` blocks and the
    rank's slice of each is kept (a copy)."""
    if dim is None or tp.size == 1:
        return t
    if parts > 1:
        shape = list(t.shape)
        blocks = t.reshape(shape[:dim] + [parts, shape[dim] // parts] + shape[dim + 1:])
        shape[dim] //= tp.size
        return narrow_to_rank(blocks, dim + 1, tp).reshape(shape)
    s = tp.slice(t.shape[dim])
    return t.narrow(dim, s.start, s.stop - s.start)


def slice_state(state: Mapping[str, torch.Tensor], dims: Mapping[str, int], tp: TensorParallel) -> dict:
    """``state`` with each tensor named in ``dims`` narrowed to this rank's
    slice on its dim (a view), the rest as they are."""
    return {k: narrow_to_rank(v, dims.get(k), tp) for k, v in state.items()}
