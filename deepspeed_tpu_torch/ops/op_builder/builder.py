"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Port of ``deepspeed_tpu/ops/op_builder/builder.py`` (ref: DeepSpeed's
``op_builder/builder.py`` ``OpBuilder.load``).  Each ``csrc/*.cu`` source
exposes a plain C interface (pointers, shapes, strides, the stream) and is
compiled on first use into a shared library

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

under ``deepspeed_tpu_torch/build/`` (git-ignored), named by a hash of its
source, the shared headers ``csrc/*.cuh`` and the flags, so an edited source
or header never loads a stale library.  No
PyTorch headers are compiled, so a build takes seconds.  A missing ``nvcc``
or a failed build raises; nothing falls back.

The host async-IO engine of the NVMe swap (``csrc/aio/ds_aio.cpp``,
``HOST_SOURCES``) is built the same way with ``g++`` and ``CXX_FLAGS``, into
the same directory (``AsyncIOBuilder``).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Tuple

from ...utils.logging import logger

PACKAGE_ROOT = Path(__file__).resolve().parents[2]   # deepspeed_tpu_torch/
BUILD_DIR = PACKAGE_ROOT / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

#: kernel name -> source under deepspeed_tpu_torch/
KERNEL_SOURCES = {"paged_attention": "csrc/paged_attention.cu", "flash_attention": "csrc/flash_attention.cu",
                  "sparse_attention": "csrc/sparse_attention.cu", "quant": "csrc/quant.cu"}
#: host library name -> source, built with g++ (no CUDA, no PyTorch headers)
HOST_SOURCES = {"ds_aio": "csrc/aio/ds_aio.cpp"}
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-Wall"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default install prefix."""
    candidates = [os.path.join(os.environ[v], "bin", "nvcc") for v in ("CUDA_HOME", "CUDA_PATH") if v in os.environ]
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's CUDA kernels "
                       "are built from deepspeed_tpu_torch/csrc on first use")


def find_cxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the port's host libraries are built from deepspeed_tpu_torch/csrc on "
                           "first use")
    return cxx


def _spec(name: str) -> Tuple[Path, List[str], List[Path]]:
    """Library ``name``'s source, flags and the shared headers it may
    include (every ``csrc/*.cuh`` for a kernel, none for a host library)."""
    if name in HOST_SOURCES:
        return PACKAGE_ROOT / HOST_SOURCES[name], CXX_FLAGS, []
    return PACKAGE_ROOT / KERNEL_SOURCES[name], NVCC_FLAGS, sorted((PACKAGE_ROOT / "csrc").glob("*.cuh"))


def so_path(name: str) -> Path:
    """Where library ``name`` lives: hashed on its source, its shared
    headers and the flags."""
    source, flags, headers = _spec(name)
    h = hashlib.sha256(source.read_bytes())
    for header in headers:
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def build_kernel(name: str) -> str:
    """Compile library ``name`` (nvcc for a kernel, g++ for a host library)
    unless it exists.  Returns the compiler's output (for a kernel, ptxas's
    register and spill report), '' when already built."""
    so = so_path(name)
    if so.exists():
        return ""
    source, flags, _ = _spec(name)
    compiler = find_cxx() if name in HOST_SOURCES else find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([compiler, *flags, "-o", str(tmp), str(source)], capture_output=True, text=True)
    output = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{Path(compiler).name} failed to build {source} (exit {proc.returncode}):\n{output}")
    os.replace(tmp, so)   # atomic: a concurrent loader never sees half a library
    logger.info(f"built {name} from {source.name} in {time.perf_counter() - t0:.1f} s")
    return output


def load_kernel(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building it on first use."""
    if name not in _LIBS:
        build_kernel(name)
        _LIBS[name] = ctypes.CDLL(str(so_path(name)))
    return _LIBS[name]


class AsyncIOBuilder:
    """JAX's ``AsyncIOBuilder`` (``op_builder/builder.py:87``; ref:
    ``op_builder/async_io.py``): the library ``ds_aio`` (``csrc/aio/ds_aio.cpp``,
    a host thread pool of positional reads and writes) through the functions
    above."""

    NAME = "ds_aio"
    SOURCE = HOST_SOURCES[NAME]

    def so_path(self) -> Path:
        return so_path(self.NAME)

    def load(self) -> ctypes.CDLL:
        return load_kernel(self.NAME)
