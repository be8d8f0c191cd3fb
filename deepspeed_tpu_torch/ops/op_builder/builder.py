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
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

from ...utils.logging import logger

PACKAGE_ROOT = Path(__file__).resolve().parents[2]   # deepspeed_tpu_torch/
BUILD_DIR = PACKAGE_ROOT / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

#: kernel name -> source under deepspeed_tpu_torch/
KERNEL_SOURCES = {"paged_attention": "csrc/paged_attention.cu", "flash_attention": "csrc/flash_attention.cu",
                  "sparse_attention": "csrc/sparse_attention.cu", "quant": "csrc/quant.cu"}

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


def so_path(name: str) -> Path:
    """Where kernel ``name``'s library lives: hashed on its source, every
    shared header ``csrc/*.cuh`` (a source may include any of them) and the
    flags."""
    h = hashlib.sha256((PACKAGE_ROOT / KERNEL_SOURCES[name]).read_bytes())
    for header in sorted((PACKAGE_ROOT / "csrc").glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def build_kernel(name: str) -> str:
    """Compile kernel ``name`` unless its library exists.  Returns nvcc's
    output (ptxas's register and spill report), '' when already built."""
    so = so_path(name)
    if so.exists():
        return ""
    source = PACKAGE_ROOT / KERNEL_SOURCES[name]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)], capture_output=True, text=True)
    output = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {source} (exit {proc.returncode}):\n{output}")
    os.replace(tmp, so)   # atomic: a concurrent loader never sees half a library
    logger.info(f"built {name} kernel from {source.name} in {time.perf_counter() - t0:.1f} s")
    return output


def load_kernel(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it on first use."""
    if name not in _LIBS:
        build_kernel(name)
        _LIBS[name] = ctypes.CDLL(str(so_path(name)))
    return _LIBS[name]
