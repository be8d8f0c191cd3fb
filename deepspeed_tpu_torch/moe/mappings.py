"""MoE ↔ tensor-parallel token mappings (port of
``deepspeed_tpu/moe/mappings.py``; ref: ``deepspeed/moe/mappings.py``,
after Megatron's ``mpu/mappings.py``).

Under tensor parallelism every rank of a tensor group holds every token.
``drop_tokens`` keeps this rank's 1/N slice of a token dim and
``gather_tokens`` all-gathers the slices back, in rank order over the
tensor group (``module_inject.layers.TensorParallel``).  They are each
other's transpose, as ``torch.autograd.Function``s: drop's backward
all-gathers the gradient, gather's backward keeps this rank's slice of it.
On the global value each is the identity, and ``gather_tokens(drop_tokens(x))``
equals ``x`` on every rank.  At degree 1 both return ``x`` itself.

The JAX package writes them as sharding constraints (a layout, not a
value: its MoE layer calls them and gates the same rows either way).  The
port's ``moe.MoE`` does not call them: every rank of a tensor group gates
its replicated rows the same way and runs its slice of every expert
(``moe/layer.py``), so its numbers are JAX's.
"""

import torch

from ..module_inject.layers import NO_TENSOR_PARALLEL, TensorParallel, _count, gather_dim


class _DropTokens(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        s = tp.slice(x.shape[dim])
        return x.narrow(dim, s.start, s.stop - s.start).contiguous()

    @staticmethod
    def backward(ctx, g):
        _count("drop_tokens", "backward")
        return gather_dim(g, ctx.tp, ctx.dim), None, None


class _GatherTokens(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp, ctx.n = dim, tp, x.shape[dim]
        _count("gather_tokens", "forward")
        return gather_dim(x, tp, dim)

    @staticmethod
    def backward(ctx, g):
        t = ctx.tp.rank
        return g.narrow(ctx.dim, t * ctx.n, ctx.n).contiguous(), None, None


def drop_tokens(x: torch.Tensor, dim: int = 1, tp: TensorParallel = NO_TENSOR_PARALLEL) -> torch.Tensor:
    """This rank's slice of the token dim ``dim`` (ref ``mappings.py:113``);
    the degree must divide it."""
    if tp.size == 1:
        return x
    return _DropTokens.apply(x, dim % x.dim(), tp)


def gather_tokens(x: torch.Tensor, dim: int = 1, tp: TensorParallel = NO_TENSOR_PARALLEL) -> torch.Tensor:
    """The token dim ``dim`` gathered over the tensor group (ref ``mappings.py:105``)."""
    if tp.size == 1:
        return x
    return _GatherTokens.apply(x, dim % x.dim(), tp)
