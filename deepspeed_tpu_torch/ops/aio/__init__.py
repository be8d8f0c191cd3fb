"""Python handle API over the port's async-IO engine (port of
``deepspeed_tpu/ops/aio``; ref: ``deepspeed/ops/aio`` and
``csrc/aio/py_lib/deepspeed_py_aio_handle.cpp``): ``AsyncIOHandle`` with
``async_pread``/``async_pwrite``/``sync_pread``/``sync_pwrite``/``wait``, and
``file_size``.

The engine is the port's own copy of the C++ thread pool
(``deepspeed_tpu_torch/csrc/aio/ds_aio.cpp``), built with ``g++`` on first
use (``ops/op_builder.AsyncIOBuilder``).  A buffer is a C-contiguous CPU
tensor (pinned, when the device leg is a CUDA copy) or numpy array; the
handle keeps every submitted buffer alive until ``wait()``.  With
``use_o_direct`` the buffers' addresses, their sizes and the file offsets
must be multiples of 4096 (``O_DIRECT``'s rule); a request that breaks it
raises before it is submitted.
"""

import ctypes
from typing import Union

import numpy as np
import torch

from ..op_builder import AsyncIOBuilder

#: the alignment ``O_DIRECT`` requires of addresses, sizes and offsets
O_DIRECT_ALIGN = 4096

_LIB = None

Buffer = Union[torch.Tensor, np.ndarray]


def _lib():
    global _LIB
    if _LIB is None:
        lib = AsyncIOBuilder().load()
        lib.aio_handle_new.restype = ctypes.c_void_p
        lib.aio_handle_new.argtypes = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
        lib.aio_handle_free.argtypes = [ctypes.c_void_p]
        for fn in (lib.aio_pread, lib.aio_pwrite):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong, ctypes.c_longlong]
        lib.aio_wait.restype = ctypes.c_longlong
        lib.aio_wait.argtypes = [ctypes.c_void_p]
        lib.aio_pending.restype = ctypes.c_longlong
        lib.aio_pending.argtypes = [ctypes.c_void_p]
        lib.aio_file_size.restype = ctypes.c_longlong
        lib.aio_file_size.argtypes = [ctypes.c_char_p]
        _LIB = lib
    return _LIB


def _address_and_size(buf: Buffer, writable: bool):
    """A buffer's address and byte size; it must be host memory, C-contiguous."""
    if isinstance(buf, torch.Tensor):
        if buf.device.type != "cpu" or not buf.is_contiguous():
            raise ValueError(f"aio buffers must be C-contiguous CPU tensors, got one on {buf.device} "
                             f"(contiguous={buf.is_contiguous()})")
        return buf.data_ptr(), buf.numel() * buf.element_size()
    if not isinstance(buf, np.ndarray) or not buf.flags.c_contiguous:
        raise ValueError("aio buffers must be C-contiguous CPU tensors or numpy arrays")
    if writable and not buf.flags.writeable:
        raise ValueError("aio read buffer is not writeable")
    return buf.ctypes.data, buf.nbytes


class AsyncIOHandle:
    """ref: csrc/aio/py_lib aio_handle (block_size, queue_depth, thread_count;
    single_submit/overlap_events are implicit in the thread-pool design)."""

    def __init__(self, block_size: int = 1 << 20, queue_depth: int = 32, thread_count: int = 4,
                 use_o_direct: bool = False):
        self._lib = _lib()
        self.use_o_direct = use_o_direct
        self._h = self._lib.aio_handle_new(block_size, queue_depth, thread_count, 1 if use_o_direct else 0)
        self._refs = []   # the submitted buffers, alive until wait()

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.aio_wait(h)
            self._lib.aio_handle_free(h)
            self._h = None

    def _submit(self, fn, buffer: Buffer, path, offset: int, writable: bool) -> None:
        addr, nbytes = _address_and_size(buffer, writable)
        if self.use_o_direct and (addr % O_DIRECT_ALIGN or nbytes % O_DIRECT_ALIGN or offset % O_DIRECT_ALIGN):
            raise ValueError(f"use_o_direct needs the buffer address, its size and the offset aligned to "
                             f"{O_DIRECT_ALIGN} bytes (address {addr:#x}, {nbytes} B, offset {offset})")
        self._refs.append(buffer)
        rc = fn(self._h, ctypes.c_void_p(addr), str(path).encode(), offset, nbytes)
        if rc != 0:
            raise OSError(f"aio submit failed: {rc}")

    def async_pread(self, buffer: Buffer, path, offset: int = 0) -> None:
        self._submit(self._lib.aio_pread, buffer, path, offset, writable=True)

    def async_pwrite(self, buffer: Buffer, path, offset: int = 0) -> None:
        self._submit(self._lib.aio_pwrite, buffer, path, offset, writable=False)

    def wait(self) -> int:
        """Block until every submitted request completes; returns their
        count.  Raises on the first IO error (ref: aio_handle.wait)."""
        n = self._lib.aio_wait(self._h)
        self._refs.clear()
        if n < 0:
            raise OSError(-int(n), f"async IO failed: errno {-int(n)}")
        return int(n)

    def pending(self) -> int:
        return int(self._lib.aio_pending(self._h))

    # sync conveniences (ref: deepspeed_py_aio.cpp sync_pread/sync_pwrite)
    def sync_pread(self, buffer: Buffer, path, offset: int = 0) -> int:
        self.async_pread(buffer, path, offset)
        return self.wait()

    def sync_pwrite(self, buffer: Buffer, path, offset: int = 0) -> int:
        self.async_pwrite(buffer, path, offset)
        return self.wait()


def file_size(path) -> int:
    n = _lib().aio_file_size(str(path).encode())
    if n < 0:
        raise OSError(-int(n), f"stat failed for {path}")
    return int(n)
