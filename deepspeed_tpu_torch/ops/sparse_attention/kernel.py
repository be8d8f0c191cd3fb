"""Block-sparse attention: the op, its plain versions and the wrappers of the
hand-written CUDA kernels ``csrc/sparse_attention.cu``.

Port of ``deepspeed_tpu/ops/sparse_attention/pallas_kernel.py``.  The kernels
replace its Pallas TPU kernels:

  K6a ``sparse_attn_fwd_cuda`` ← ``_kernel``     (:35),  driven by ``_fwd_impl`` (:257)
  K6b ``sparse_attn_dq_cuda``  ← ``_dq_kernel``  (:125), driven by ``_bwd_impl`` (:307)
  K6c ``sparse_attn_dkv_cuda`` ← ``_dkv_kernel`` (:152), driven by ``_bwd_impl`` (:307)

q, k and v are ``[B, H, S, D]`` (the JAX layout); the layout is a static
``[H, nb, nb]`` 0/1 array, nb = S / block.  Query row i attends to the keys
of the blocks its row block admits; with ``causal``, only to those at
positions <= i (token causality inside admitted blocks); with a
``key_padding_mask`` ``[B, S]`` (True = keep), only to kept keys.  A row that
attends to no key emits zeros and lse = 3e38, so its backward is exactly 0.

The index tables (``BlockSparseTables``) are built once per layout and device
(``SparseLayout.tables``) with one vectorised ``np.nonzero`` each, where the
JAX op rebuilds its gather maps in Python, one ``np.nonzero`` per (head, row),
on every forward and backward.

The forward and the backward are ``torch.library`` custom ops
(``ds_torch::sparse_attn_fwd``, ``ds_torch::sparse_attn_bwd``), as the flash
ops are, so that a selective checkpoint policy can name them; a
``torch.autograd.Function`` ties them together in place of JAX's
``custom_vjp`` (``_pallas_vjp``).  Each op dispatches on the device of its
inputs: a CUDA tensor launches the kernels or raises (an unsupported block,
head dim or dtype included); a CPU tensor runs the plain versions.

The plain versions compute what the kernels compute, with the same rounding
points: p and ds are rounded to v's dtype before their products (JAX
``:76``, ``:122``), do is cast to q's dtype (``:317``), lse, delta and every
product accumulate in float32.  lse is ``[B, H, S]`` float32; JAX's
lane-broadcast ``[B·H, S, 128]`` is a TPU tiling artifact.
"""

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..op_builder import load_kernel

#: finite mask value of the JAX kernels (``DEFAULT_MASK_VALUE``)
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
#: lse of a row that attends to no key: exp(s − lse) underflows to 0
EMPTY_ROW_LSE = 3e38
SUPPORTED_BLOCKS = (16, 32, 64, 128)
SUPPORTED_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# ---------------------------------------------------------------- index tables


@dataclass(frozen=True)
class BlockSparseTables:
    """The index tables of one ``[H, nb, nb]`` layout on one device, int32.

    ``row_ptr`` ``[H·nb + 1]`` and ``row_idx``: CSR of the kv blocks each
    (head, q block) admits, ascending (K6a, K6b); ``col_ptr`` and
    ``col_idx``: the transposed CSR, the q blocks that admit each (head, kv
    block) (K6c); ``row_order`` and ``col_order`` ``[H·nb]``: the
    (head, block) ids by descending count, the kernels' launch order.
    """
    num_heads: int
    num_blocks: int
    row_ptr: torch.Tensor
    row_idx: torch.Tensor
    row_order: torch.Tensor
    col_ptr: torch.Tensor
    col_idx: torch.Tensor
    col_order: torch.Tensor

    def tensors(self) -> List[torch.Tensor]:
        return [self.row_ptr, self.row_idx, self.row_order, self.col_ptr, self.col_idx, self.col_order]

    @classmethod
    def of_tensors(cls, tensors: List[torch.Tensor], num_heads: int, num_blocks: int) -> "BlockSparseTables":
        return cls(num_heads, num_blocks, *tensors)


def _csr(layout: np.ndarray):
    """``[H, nb, nb]`` bool → (ptr, idx, order) over its ``H·nb`` rows."""
    h, nb, _ = layout.shape
    rows, cols = np.nonzero(layout.reshape(h * nb, nb))   # row-major: columns ascend within a row
    counts = np.bincount(rows, minlength=h * nb)
    ptr = np.zeros(h * nb + 1, np.int64)
    np.cumsum(counts, out=ptr[1:])
    order = np.argsort(-counts, kind="stable")
    return ptr.astype(np.int32), cols.astype(np.int32), order.astype(np.int32)


def build_tables(layout: np.ndarray, device: Union[str, torch.device] = "cpu") -> BlockSparseTables:
    """The row and column tables of ``layout`` ``[H, nb, nb]`` on ``device``."""
    lay = np.asarray(layout)
    if lay.ndim != 3 or lay.shape[1] != lay.shape[2]:
        raise ValueError(f"layout must be [H, nb, nb], got {lay.shape}")
    lay = lay != 0
    arrays = _csr(lay) + _csr(lay.transpose(0, 2, 1))
    return BlockSparseTables(lay.shape[0], lay.shape[1],
                             *(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays))


def _device_key(device: Union[str, torch.device]) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class SparseLayout:
    """A static layout ``[H, nb, nb]`` over blocks of ``block`` tokens, with
    its index tables built on first use on each device and kept."""

    def __init__(self, layout: np.ndarray, block: int):
        self.layout = np.asarray(layout)
        if self.layout.ndim != 3 or self.layout.shape[1] != self.layout.shape[2]:
            raise ValueError(f"layout must be [H, nb, nb], got {self.layout.shape}")
        self.block = int(block)
        self._tables = {}

    @property
    def num_heads(self) -> int:
        return self.layout.shape[0]

    @property
    def num_blocks(self) -> int:
        return self.layout.shape[1]

    def tables(self, device: Union[str, torch.device]) -> BlockSparseTables:
        key = _device_key(device)
        if key not in self._tables:
            self._tables[key] = build_tables(self.layout, key)
        return self._tables[key]


# ---------------------------------------------------------------- plain versions


def _check_layout_fits(q: torch.Tensor, tables: BlockSparseTables, block: int) -> None:
    b, h, s, d = q.shape
    if s % block or s // block != tables.num_blocks or h != tables.num_heads:
        raise ValueError(f"layout [{tables.num_heads}, {tables.num_blocks}, {tables.num_blocks}] with block {block} "
                         f"does not fit q {tuple(q.shape)}")


def _head_rows(tables: BlockSparseTables, h: int, device: torch.device):
    """Head ``h``'s admitted kv blocks per q block, padded to the head's
    widest row: ``cols [nb, L]`` (padding 0) and ``valid [nb, L]``."""
    nb = tables.num_blocks
    ptr = tables.row_ptr[h * nb:(h + 1) * nb + 1].to(device, torch.long)
    idx = tables.row_idx.to(device, torch.long)
    counts = ptr[1:] - ptr[:-1]
    width = max(int(counts.max()), 1)
    slot = torch.arange(width, device=device)
    valid = slot[None, :] < counts[:, None]
    if idx.numel() == 0:
        return torch.zeros((nb, width), dtype=torch.long, device=device), valid
    pos = (ptr[:-1, None] + slot[None, :]).clamp_max(idx.numel() - 1)
    return torch.where(valid, idx[pos], 0), valid


def _gather(x: torch.Tensor, h: int, cols: torch.Tensor, block: int) -> torch.Tensor:
    """Head h of ``x [B, H, S, D]`` gathered per q block: ``[B, nb, L·block, D]``."""
    b, _, s, d = x.shape
    nb, width = cols.shape
    return x[:, h].reshape(b, nb, block, d)[:, cols].reshape(b, nb, width * block, d)


def _head_scores(q, k, tables, h, block, causal, scale, key_padding_mask):
    """Head h's scaled float32 scores over its gathered keys
    ``[B, nb, block, L·block]`` (MASK where not kept), the keep mask, and
    the gather table."""
    b, _, s, d = q.shape
    nb = tables.num_blocks
    cols, valid = _head_rows(tables, h, q.device)
    width = cols.shape[1]
    qh = q[:, h].reshape(b, nb, block, d).float()
    s_ = torch.einsum("brqd,brkd->brqk", qh, _gather(k, h, cols, block).float()) * scale
    keep = valid.repeat_interleave(block, dim=-1)[None, :, None, :]
    if causal:
        ar = torch.arange(block, device=q.device)
        qpos = torch.arange(nb, device=q.device)[:, None] * block + ar[None, :]
        kpos = (cols[..., None] * block + ar).reshape(nb, width * block)
        keep = keep & (qpos[None, :, :, None] >= kpos[None, :, None, :])
    if key_padding_mask is not None:
        kp = key_padding_mask.to(q.device, torch.bool).reshape(b, nb, block)[:, cols]
        keep = keep & kp.reshape(b, nb, width * block)[:, :, None, :]
    return torch.where(keep, s_, MASK_VALUE), keep, cols


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[-1])


def sparse_attn_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, tables: BlockSparseTables, block: int,
                          causal: bool = False, scale: Optional[float] = None,
                          key_padding_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """What K6a computes: ``(o [B, H, S, D] in q's dtype, lse [B, H, S] f32)``."""
    _check_layout_fits(q, tables, block)
    b, nh, s, d = q.shape
    scale = _scale(q, scale)
    o = torch.empty_like(q)
    lse = torch.empty((b, nh, s), dtype=torch.float32, device=q.device)
    for h in range(nh):
        s_, keep, cols = _head_scores(q, k, tables, h, block, causal, scale, key_padding_mask)
        m = s_.amax(dim=-1, keepdim=True)
        p = torch.where(keep, torch.exp(s_ - m), 0.0)
        l = p.sum(dim=-1, keepdim=True)
        acc = torch.einsum("brqk,brkd->brqd", p.to(v.dtype).float(), _gather(v, h, cols, block).float())
        safe = l.clamp_min(1e-30)
        o[:, h] = torch.where(l > 0, acc / safe, 0.0).reshape(b, s, d).to(q.dtype)
        lse[:, h] = torch.where(l > 0, m + torch.log(safe), EMPTY_ROW_LSE).reshape(b, s)
    return o, lse


def sparse_attn_delta_plain(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(do·o)`` as K6b writes it: ``[B, H, S]`` float32."""
    return (do.float() * o.float()).sum(-1)


def sparse_attn_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
                          do: torch.Tensor, tables: BlockSparseTables, block: int, causal: bool = False,
                          scale: Optional[float] = None, key_padding_mask: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What K6b and K6c compute: ``(dq, dk, dv)`` in the inputs' dtype.  dk
    and dv of every admitted key are summed over the q blocks that admit it
    (K6c walks the transposed table; here an ``index_add_`` over the row
    table), so a kv block no row admits gets zeros."""
    _check_layout_fits(q, tables, block)
    b, nh, s, d = q.shape
    nb = tables.num_blocks
    scale = _scale(q, scale)
    do = do.to(q.dtype)
    delta = sparse_attn_delta_plain(o, do)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    for h in range(nh):
        s_, keep, cols = _head_scores(q, k, tables, h, block, causal, scale, key_padding_mask)
        p = torch.where(keep, torch.exp(s_ - lse[:, h].reshape(b, nb, block, 1)), 0.0)
        dog = do[:, h].reshape(b, nb, block, d).float()
        dp = torch.einsum("brqd,brkd->brqk", dog, _gather(v, h, cols, block).float())
        ds = (p * (dp - delta[:, h].reshape(b, nb, block, 1)) * scale).to(q.dtype).float()
        dq[:, h] = torch.einsum("brqk,brkd->brqd", ds, _gather(k, h, cols, block).float()).reshape(b, s, d)
        qh = q[:, h].reshape(b, nb, block, d).float()
        width = cols.shape[1]
        for grad, w, src in ((dk, ds, qh), (dv, p.to(v.dtype).float(), dog)):
            contrib = torch.einsum("brqk,brqd->brkd", w, src).reshape(b, nb * width, block * d)
            acc = torch.zeros((b, nb, block * d), dtype=torch.float32, device=q.device)
            acc.index_add_(1, cols.reshape(-1), contrib)
            grad[:, h] = acc.reshape(b, s, d)
    return dq, dk, dv


# ---------------------------------------------------------------- kernel wrappers


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernels' library, built on first use, with its C signatures."""
    lib = load_kernel("sparse_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dims = [i, i, i, i, i, i, f, i, p]   # B, H, S, D, block, causal, scale, dtype, stream
    lib.ds_sparse_attn_fwd.argtypes = [p] * 9 + dims
    lib.ds_sparse_attn_dq.argtypes = [p] * 12 + dims
    lib.ds_sparse_attn_dkv.argtypes = [p] * 12 + dims
    for fn in (lib.ds_sparse_attn_fwd, lib.ds_sparse_attn_dq, lib.ds_sparse_attn_dkv):
        fn.restype = i
    lib.ds_sparse_attn_error_string.argtypes = [i]
    lib.ds_sparse_attn_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, tables: BlockSparseTables, block: int,
           key_padding_mask: Optional[torch.Tensor], *rest: torch.Tensor) -> None:
    """Raise on anything the kernels do not take."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(f"{name} needs CUDA tensors, got q on {q.device}, k on {k.device}, v on {v.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name} takes bfloat16 or float32 q/k/v of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q, k and v must be [B, H, S, D] of one shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[-1] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {q.shape[-1]} not in {SUPPORTED_HEAD_DIMS}")
    if block not in SUPPORTED_BLOCKS:
        raise ValueError(f"{name}: block {block} not in {SUPPORTED_BLOCKS}")
    _check_layout_fits(q, tables, block)
    if key_padding_mask is not None and (key_padding_mask.dtype != torch.bool or key_padding_mask.shape != (
            q.shape[0], q.shape[2]) or key_padding_mask.device != q.device or not key_padding_mask.is_contiguous()):
        raise ValueError(f"{name}: key_padding_mask must be a contiguous bool [B, S] tensor on {q.device}")
    for t in (q, k, v) + rest:
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: every tensor must be contiguous, 16-byte aligned and on {q.device}")
    for t in tables.tensors():
        if t.device != q.device or t.dtype != torch.int32:
            raise ValueError(f"{name}: the layout's tables must be int32 on {q.device} (SparseLayout.tables)")


def _launch(name: str, fn, q: torch.Tensor, *args) -> None:
    with torch.cuda.device(q.device):   # the kernels launch on the current device
        status = fn(*args, torch.cuda.current_stream(q.device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"{name}: launch failed: {_lib().ds_sparse_attn_error_string(status).decode()}")


def _dims(q: torch.Tensor, block: int, causal: bool, scale: Optional[float]):
    b, h, s, d = q.shape
    return (b, h, s, d, int(block), int(bool(causal)), _scale(q, scale), _DTYPE_CODES[q.dtype])


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def sparse_attn_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, tables: BlockSparseTables, block: int,
                         causal: bool = False, scale: Optional[float] = None,
                         key_padding_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K6a: ``(o [B, H, S, D], lse [B, H, S] f32)``."""
    _check("sparse_attn_fwd_cuda", q, k, v, tables, block, key_padding_mask)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    if q.numel():
        _launch("sparse_attn_fwd_cuda", _lib().ds_sparse_attn_fwd, q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                _ptr(key_padding_mask), tables.row_ptr.data_ptr(), tables.row_idx.data_ptr(),
                tables.row_order.data_ptr(), o.data_ptr(), lse.data_ptr(), *_dims(q, block, causal, scale))
        sparse_attn_fwd_cuda.launches += 1
    return o, lse


def sparse_attn_dq_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, tables: BlockSparseTables, block: int, causal: bool = False,
                        scale: Optional[float] = None, key_padding_mask: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K6b: ``(dq [B, H, S, D], delta [B, H, S] f32)``; K6c reads delta."""
    _check("sparse_attn_dq_cuda", q, k, v, tables, block, key_padding_mask, o, lse, do)
    if o.shape != q.shape or do.shape != q.shape or lse.shape != q.shape[:3] or o.dtype != q.dtype \
            or do.dtype != q.dtype or lse.dtype != torch.float32:
        raise ValueError("sparse_attn_dq_cuda: o and do must match q, lse must be [B, H, S] float32")
    dq = torch.empty_like(q)
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    if q.numel():
        _launch("sparse_attn_dq_cuda", _lib().ds_sparse_attn_dq, q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                o.data_ptr(), do.data_ptr(), lse.data_ptr(), _ptr(key_padding_mask), tables.row_ptr.data_ptr(),
                tables.row_idx.data_ptr(), tables.row_order.data_ptr(), dq.data_ptr(), delta.data_ptr(),
                *_dims(q, block, causal, scale))
        sparse_attn_dq_cuda.launches += 1
    return dq, delta


def sparse_attn_dkv_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                         delta: torch.Tensor, tables: BlockSparseTables, block: int, causal: bool = False,
                         scale: Optional[float] = None, key_padding_mask: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K6c: ``(dk, dv) [B, H, S, D]`` over the transposed table."""
    _check("sparse_attn_dkv_cuda", q, k, v, tables, block, key_padding_mask, do, lse, delta)
    stat = q.shape[:3]
    if do.shape != q.shape or do.dtype != q.dtype or lse.shape != stat or delta.shape != stat \
            or lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise ValueError("sparse_attn_dkv_cuda: do must match q, lse and delta must be [B, H, S] float32")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel():
        _launch("sparse_attn_dkv_cuda", _lib().ds_sparse_attn_dkv, q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(), _ptr(key_padding_mask), tables.col_ptr.data_ptr(),
                tables.col_idx.data_ptr(), tables.col_order.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                *_dims(q, block, causal, scale))
        sparse_attn_dkv_cuda.launches += 1
    return dk, dv


#: launches of each kernel since its counter was last set to 0
sparse_attn_fwd_cuda.launches = 0
sparse_attn_dq_cuda.launches = 0
sparse_attn_dkv_cuda.launches = 0

# ---------------------------------------------------------------- custom ops


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"sparse attention: unsupported device {t.device}")
    return t.device.type


@torch.library.custom_op("ds_torch::sparse_attn_fwd", mutates_args=())
def sparse_attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, tables: List[torch.Tensor],
                    key_padding_mask: Optional[torch.Tensor], block: int, causal: bool,
                    scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6a on a CUDA tensor, ``sparse_attn_fwd_plain`` on a CPU tensor.
    ``tables`` is ``BlockSparseTables.tensors()``."""
    t = BlockSparseTables.of_tensors(tables, q.shape[1], q.shape[2] // block)
    if _device_kind(q) == "cuda":
        return sparse_attn_fwd_cuda(q, k, v, t, block, causal, scale, key_padding_mask)
    return sparse_attn_fwd_plain(q, k, v, t, block, causal, scale, key_padding_mask)


@sparse_attn_fwd.register_fake
def _sparse_attn_fwd_fake(q, k, v, tables, key_padding_mask, block, causal, scale):
    return torch.empty_like(q), q.new_empty(q.shape[:3], dtype=torch.float32)


@torch.library.custom_op("ds_torch::sparse_attn_bwd", mutates_args=())
def sparse_attn_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
                    do: torch.Tensor, tables: List[torch.Tensor], key_padding_mask: Optional[torch.Tensor],
                    block: int, causal: bool, scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6b then K6c on a CUDA tensor, ``sparse_attn_bwd_plain`` on a CPU tensor."""
    t = BlockSparseTables.of_tensors(tables, q.shape[1], q.shape[2] // block)
    if _device_kind(q) == "cuda":
        dq, delta = sparse_attn_dq_cuda(q, k, v, o, lse, do, t, block, causal, scale, key_padding_mask)
        dk, dv = sparse_attn_dkv_cuda(q, k, v, do, lse, delta, t, block, causal, scale, key_padding_mask)
        return dq, dk, dv
    return sparse_attn_bwd_plain(q, k, v, o, lse, do, t, block, causal, scale, key_padding_mask)


@sparse_attn_bwd.register_fake
def _sparse_attn_bwd_fake(q, k, v, o, lse, do, tables, key_padding_mask, block, causal, scale):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


class _SparseAttention(torch.autograd.Function):
    """The forward op saves ``(q, k, v, o, lse)``; the backward op turns
    them and ``do`` into ``(dq, dk, dv)`` (JAX ``_pallas_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, tables, key_padding_mask, block, causal, scale):
        o, lse = sparse_attn_fwd(q, k, v, tables, key_padding_mask, block, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.tables, ctx.key_padding_mask, ctx.args = tables, key_padding_mask, (block, causal, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = sparse_attn_bwd(q, k, v, o, lse, do.to(q.dtype).contiguous(), ctx.tables,
                                     ctx.key_padding_mask, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


# ---------------------------------------------------------------- public op


def sparse_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            layout: Union[SparseLayout, np.ndarray], block: int, causal: bool = False,
                            scale: Optional[float] = None,
                            key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Block-sparse attention over ``[B, H, S, D]`` with a static
    ``[H, nb, nb]`` layout (port of ``sparse_attention_pallas``): the same
    contract as the golden ``sparse_attention``, forward and backward through
    K6a–c on a GPU.  Pass a ``SparseLayout`` to keep its index tables across
    calls; a bare array builds them for this call.  ``key_padding_mask``
    ``[B, S]`` (True = keep) is read by the kernels themselves."""
    if not isinstance(layout, SparseLayout):
        layout = SparseLayout(layout, block)
    elif layout.block != block:
        raise ValueError(f"SparseLayout of block {layout.block} used with block {block}")
    kpm = None
    if key_padding_mask is not None:
        kpm = torch.as_tensor(key_padding_mask, device=q.device).to(torch.bool).contiguous()
    return _SparseAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), layout.tables(q.device).tensors(),
                                  kpm, int(block), bool(causal), _scale(q, scale))
