"""K3 paged attention: the wrapper of the hand-written CUDA kernel
``csrc/paged_attention.cu``, which replaces the Pallas TPU kernel
``deepspeed_tpu/ops/paged_attention.py:40 _paged_kernel``.

``paged_attention`` is the op the serving path calls: a CUDA tensor goes
to the kernel (``paged_attention_cuda``), which launches or raises; a CPU
tensor goes to the plain PyTorch version
(``models/llama_cache.paged_attention``).  There is no fallback from one to
the other.
"""

import ctypes
import functools
from typing import Optional

import torch

from ..models.llama_cache import paged_attention as paged_attention_plain
from .op_builder import load_kernel

SUPPORTED_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel's library, built on first use, with its C signatures."""
    lib = load_kernel("paged_attention")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ds_paged_attention.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, ll, ll, ll, i, p]
    lib.ds_paged_attention.restype = i
    lib.ds_cuda_error_string.argtypes = [i]
    lib.ds_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_index(name: str, t: torch.Tensor, shape, device: torch.device) -> None:
    if t.device != device or t.dtype != torch.int32 or not t.is_contiguous() or tuple(t.shape) != shape:
        raise ValueError(f"paged_attention_cuda: {name} must be a contiguous int32 tensor of shape {shape} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def paged_attention_cuda(q: torch.Tensor, pages: torch.Tensor, block_table: torch.Tensor, start_pos: torch.Tensor,
                         chunk_lens: Optional[torch.Tensor], page_size: int) -> torch.Tensor:
    """Launch K3 on ``torch.cuda.current_stream()``.

    q: [B, C, H, D] (unit last stride); pages: [P, page_size, 2, n_kv, D]
    contiguous, q's dtype (bfloat16 or float32); block_table: [B, max_pages],
    start_pos / chunk_lens: [B], int32.  ``chunk_lens=None`` means every row
    is real.  Returns out [B, C, H, D].  Raises on anything the kernel does
    not take and on a launch that fails.  The block table's entries must be
    page ids below P; they stay on the device, unchecked, as checking them
    would synchronise with it.
    """
    if not (q.is_cuda and pages.is_cuda):
        raise ValueError(f"paged_attention_cuda needs CUDA tensors, got q on {q.device}, pages on {pages.device}")
    dev = q.device
    if pages.device != dev:
        raise ValueError(f"paged_attention_cuda: q on {dev} but pages on {pages.device}")
    if q.dtype not in _DTYPE_CODES or pages.dtype != q.dtype:
        raise ValueError(f"paged_attention_cuda takes bfloat16 or float32 q and pages of one dtype, "
                         f"got {q.dtype} and {pages.dtype}")
    if q.dim() != 4 or pages.dim() != 5:
        raise ValueError(f"paged_attention_cuda: q must be [B, C, H, D] and pages [P, page, 2, n_kv, D], "
                         f"got {tuple(q.shape)} and {tuple(pages.shape)}")
    b, c, h, d = q.shape
    _, ps, two, n_kv, pd = pages.shape
    if ps != page_size or two != 2 or pd != d or h % n_kv:
        raise ValueError(f"paged_attention_cuda: pages {tuple(pages.shape)} do not fit q {tuple(q.shape)} "
                         f"with page_size {page_size}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"paged_attention_cuda: head dim {d} not in {SUPPORTED_HEAD_DIMS}")
    if q.stride(-1) != 1 or not pages.is_contiguous() or pages.data_ptr() % 16:
        raise ValueError("paged_attention_cuda: q needs a unit last stride and pages a contiguous, "
                         "16-byte-aligned buffer")
    max_pages = block_table.shape[1] if block_table.dim() == 2 else -1
    _check_index("block_table", block_table, (b, max_pages), dev)
    _check_index("start_pos", start_pos, (b, ), dev)
    if chunk_lens is None:
        chunk_lens = torch.full((b, ), c, dtype=torch.int32, device=dev)
    _check_index("chunk_lens", chunk_lens, (b, ), dev)

    out = torch.empty((b, c, h, d), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    lib = _lib()

    def launch() -> int:
        return lib.ds_paged_attention(q.data_ptr(), pages.data_ptr(), block_table.data_ptr(), start_pos.data_ptr(),
                                      chunk_lens.data_ptr(), out.data_ptr(), b, c, h, n_kv, d, page_size, max_pages,
                                      q.stride(0), q.stride(1), q.stride(2), _DTYPE_CODES[q.dtype],
                                      torch.cuda.current_stream(dev).cuda_stream)

    if dev.index == torch.cuda.current_device():
        status = launch()
    else:
        with torch.cuda.device(dev):   # the kernel launches on the current device
            status = launch()
    if status != 0:
        raise RuntimeError(f"paged_attention_cuda: launch failed: {lib.ds_cuda_error_string(status).decode()}")
    paged_attention_cuda.launches += 1
    return out


#: launches of the K3 kernel since the counter was last set to 0
paged_attention_cuda.launches = 0


def paged_attention(q: torch.Tensor, pages: torch.Tensor, block_table: torch.Tensor, start_pos: torch.Tensor,
                    chunk_lens: Optional[torch.Tensor], page_size: int) -> torch.Tensor:
    """K3 on a CUDA tensor, the plain PyTorch version on a CPU tensor."""
    if q.is_cuda:
        return paged_attention_cuda(q, pages, block_table, start_pos, chunk_lens, page_size)
    if q.device.type == "cpu":
        return paged_attention_plain(q, pages, block_table, start_pos, chunk_lens, page_size)
    raise ValueError(f"paged_attention: unsupported device {q.device}")
