"""Domino: a tensor-parallel transformer that overlaps each µ-batch's
all-reduce with the next µ-batch's compute (port of
``deepspeed_tpu/runtime/domino/transformer.py``; ref:
``runtime/domino/transformer.py:411`` ``DominoTransformer`` and
``domino/async_linear.py:47``).

The block is Megatron's: LayerNorm → column-parallel QKV (this rank's
heads) → attention → row-parallel projection [+ all-reduce] → residual →
LayerNorm → column-parallel MLP-in → gelu → row-parallel MLP-out [+
all-reduce] → residual, on the parallel layers' collectives
(``module_inject/layers.py``).  The batch is split into ``micro_batches``
chunks (when it divides); each chunk's row-parallel partial sum is
all-reduced with ``async_op=True`` and waited for just before its residual
add, so the reduce of chunk i runs while chunk i+1 computes its attention
or MLP: the reference's Domino schedule, which the JAX package leaves to
XLA's latency-hiding scheduler.  The sums run in float32 (cast back), as
the parallel layers'; ``comm.tensor_parallel_kinds`` counts them as
``("domino", "forward")``.

The parameters keep the JAX layout and names, each a rank's slice over the
heads (``qkv`` ``[E, H/N, 3D]``, ``dense`` ``[H/N, D, E]``) or the MLP
width (``mlp_h_to_4h`` ``[E, F/N]``, ``mlp_4h_to_h`` ``[F/N, E]``); the
norm scales are whole.  ``DominoTransformer``'s layers are ``layer_{i}``,
as JAX's, so a JAX parameter tree loads by name (``load_jax_params``).
"""

import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ...comm import comm
from ...module_inject.layers import NO_TENSOR_PARALLEL, TensorParallel, copy_to_tensor_region, narrow_to_rank

#: per parameter: the dim of the JAX leaf cut over the tensor axis (None: whole)
TP_DIMS = {"input_layernorm": None, "post_attention_layernorm": None, "qkv": 1, "dense": 0, "mlp_h_to_4h": 1,
           "mlp_4h_to_h": 0}


class _Reducing:
    """A partial sum under an asynchronous all-reduce, and its handle."""
    __slots__ = ("buf", "work")


class _StartReduce(torch.autograd.Function):
    """Issue the float32 all-reduce of ``x`` over the tensor group without
    waiting (its backward: the gradient passes, as a sum's does)."""

    @staticmethod
    def forward(ctx, x, tp, box):
        box.buf = x.to(torch.float32, copy=True).contiguous()
        box.work = dist.all_reduce(box.buf, group=tp.group, async_op=True)
        comm.call_counts["all_reduce"] += 1
        comm.tensor_parallel_kinds[("domino", "forward")] += 1
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _WaitReduce(torch.autograd.Function):
    """Wait for the reduce ``_StartReduce`` issued; the reduced sum in ``x``'s dtype."""

    @staticmethod
    def forward(ctx, x, box):
        box.work.wait()
        out = box.buf.to(x.dtype)
        box.buf = box.work = None
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class DominoTransformerLayer(nn.Module):
    """One tensor-parallel block over µ-batch chunks (ref:
    ``DominoTransformerLayer.forward``); ``tp`` is the rank's place on the
    tensor axis (degree 1: the whole block, no collective)."""

    def __init__(self, hidden_size: int, num_attention_heads: int, ffn_hidden_size: int, micro_batches: int = 2,
                 causal: bool = True, dtype: torch.dtype = torch.float32, device=None,
                 tp: TensorParallel = NO_TENSOR_PARALLEL):
        super().__init__()
        h, e, f = num_attention_heads, hidden_size, ffn_hidden_size
        if h % tp.size or f % tp.size:
            raise ValueError(f"tensor_parallel={tp.size} must divide num_attention_heads={h} and "
                             f"ffn_hidden_size={f}")
        d = e // h
        self.head_dim, self.micro_batches, self.causal, self.dtype, self.tp = d, micro_batches, causal, dtype, tp
        hl, fl = h // tp.size, f // tp.size
        make = lambda *shape: nn.Parameter(torch.empty(shape, dtype=torch.float32, device=device))
        self.input_layernorm = nn.Parameter(torch.ones(e, device=device))
        self.post_attention_layernorm = nn.Parameter(torch.ones(e, device=device))
        self.qkv = make(e, hl, 3 * d)
        self.dense = make(hl, d, e)
        self.mlp_h_to_4h = make(e, fl)
        self.mlp_4h_to_h = make(fl, e)

    def _ln(self, v: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        v32 = v.float()
        m = v32.mean(-1, keepdim=True)
        var = v32.var(-1, unbiased=False, keepdim=True)
        return ((v - m) * torch.rsqrt(var + 1e-5) * scale).to(self.dtype)

    def _reduce(self, y: torch.Tensor) -> "tuple":
        """Start the all-reduce of a row-parallel partial sum (nothing at degree 1)."""
        if self.tp.size == 1:
            return y, None
        box = _Reducing()
        return _StartReduce.apply(y, self.tp, box), box

    @staticmethod
    def _wait(y: torch.Tensor, box) -> torch.Tensor:
        return y if box is None else _WaitReduce.apply(y, box)

    def _attention(self, xc: torch.Tensor) -> torch.Tensor:
        """This rank's heads of the attention and its partial projection."""
        dt, d = self.dtype, self.head_dim
        h = copy_to_tensor_region(self._ln(xc, self.input_layernorm), self.tp, "domino_qkv")
        qkv = torch.einsum("bse,ehd->bshd", h, self.qkv.to(dt))
        q, k, v = torch.split(qkv, d, dim=-1)
        scores = torch.einsum("bshd,bthd->bhst", q, k) / np.sqrt(d)
        if self.causal:
            s = xc.shape[1]
            mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=xc.device))
            scores = torch.where(mask[None, None], scores, torch.finfo(scores.dtype).min)
        probs = torch.softmax(scores, -1)
        ctx = torch.einsum("bhst,bthd->bshd", probs, v)
        return torch.einsum("bshd,hde->bse", ctx, self.dense.to(dt))

    def _mlp(self, xc: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h2 = copy_to_tensor_region(self._ln(xc, self.post_attention_layernorm), self.tp, "domino_mlp")
        inter = F.gelu(torch.einsum("bse,ef->bsf", h2, self.mlp_h_to_4h.to(dt)), approximate="tanh")
        return torch.einsum("bsf,fe->bse", inter, self.mlp_4h_to_h.to(dt))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        n = min(self.micro_batches, b)
        chunks = list(torch.split(x, b // n)) if n > 1 and b % n == 0 else [x]
        # attention of every chunk, each one's reduce issued before the next computes
        pending = [self._reduce(self._attention(c)) for c in chunks]
        mids = []
        for c, (y, box) in zip(chunks, pending):
            mids.append(c + self._wait(y, box))
        pending = [self._reduce(self._mlp(m)) for m in mids]
        outs = [m + self._wait(y, box) for m, (y, box) in zip(mids, pending)]
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        """flax's lecun normal (untruncated) on each kernel, drawn whole and
        cut to this rank's slice; the norm scales 1."""
        for name, dim in TP_DIMS.items():
            p = getattr(self, name)
            if dim is None:
                p.fill_(1.0)
                continue
            shape = list(p.shape)
            shape[dim] *= self.tp.size
            # flax variance_scaling: fan_in = shape[-2] × the dims other than the last two
            fan_in = shape[-2] * math.prod(shape[:-2])
            whole = torch.empty(shape, dtype=p.dtype, device=p.device).normal_(0.0, 1.0 / math.sqrt(fan_in),
                                                                               generator=generator)
            p.copy_(narrow_to_rank(whole, dim, self.tp))


class DominoTransformer(nn.Module):
    """A stack of Domino layers (ref: ``transformer.py:411``), ``layer_{i}`` each."""

    def __init__(self, num_layers: int, hidden_size: int, num_attention_heads: int, ffn_hidden_size: int,
                 micro_batches: int = 2, causal: bool = True, dtype: torch.dtype = torch.float32, device=None,
                 tp: TensorParallel = NO_TENSOR_PARALLEL):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", DominoTransformerLayer(hidden_size, num_attention_heads, ffn_hidden_size,
                                                                 micro_batches, causal, dtype, device, tp))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x)
        return x

    @torch.no_grad()
    def load_jax_params(self, params, tp: Optional[TensorParallel] = None) -> "DominoTransformer":
        """Load JAX ``DominoTransformer`` parameters (``{"layer_0": {"qkv":
        ...}}``, numpy or tensors, whole) as this rank's slices."""
        params = params.get("params", params)
        for i in range(self.num_layers):
            layer = getattr(self, f"layer_{i}")
            for name, dim in TP_DIMS.items():
                whole = torch.from_numpy(np.array(params[f"layer_{i}"][name], dtype=np.float32))
                getattr(layer, name).copy_(narrow_to_rank(whole, dim, tp or layer.tp))
        return self
