"""Read an HF checkpoint directory without ``transformers`` or
``safetensors`` (the counterpart of the JAX package's
``engine_factory._load_state_dict`` and ``AutoConfig``).

  * ``read_config``: ``config.json`` as a ``SimpleNamespace``;
  * ``load_safetensors``: one ``*.safetensors`` file, parsed here: an 8-byte
    little-endian header length, a JSON header of ``{name: {dtype, shape,
    data_offsets}}`` (and ``__metadata__``), then the data, viewed through
    ``torch.frombuffer`` over a copy-on-write map of the file;
  * ``load_state_dict``: every ``*.safetensors`` shard of a directory, else
    every ``pytorch_model*.bin`` (then ``*.bin``) through
    ``torch.load(weights_only=True)``.
"""

import glob
import json
import mmap
import os
import struct
from types import SimpleNamespace
from typing import Dict

import torch

#: safetensors dtype names → torch dtypes
SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16, "I64": torch.int64,
                      "I32": torch.int32, "BOOL": torch.bool}


def read_config(path: str) -> SimpleNamespace:
    """``<path>/config.json`` as a namespace (the fields ``from_hf`` reads)."""
    with open(os.path.join(path, "config.json")) as f:
        return SimpleNamespace(**json.load(f))


def load_safetensors(filename: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, as CPU tensors that view a
    private (copy-on-write) map of the file."""
    with open(filename, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if os.fstat(f.fileno()).st_size else b""
    header.pop("__metadata__", None)
    out = {}
    for name, info in header.items():
        if info["dtype"] not in SAFETENSORS_DTYPES:
            raise ValueError(f"{filename}: tensor {name!r} has dtype {info['dtype']}, not one of "
                             f"{sorted(SAFETENSORS_DTYPES)}")
        dtype = SAFETENSORS_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        shape = info["shape"]
        if end == start:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        count = (end - start) // torch.empty((), dtype=dtype).element_size()
        out[name] = torch.frombuffer(buf, dtype=dtype, count=count, offset=8 + n + start).reshape(shape)
    return out


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The whole state dict of a local HF checkpoint directory."""
    shards = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if shards:
        sd = {}
        for f in shards:
            sd.update(load_safetensors(f))
        return sd
    bins = sorted(glob.glob(os.path.join(path, "pytorch_model*.bin"))) or sorted(glob.glob(os.path.join(path, "*.bin")))
    if bins:
        sd = {}
        for f in bins:
            sd.update(torch.load(f, map_location="cpu", weights_only=True))
        return sd
    raise FileNotFoundError(f"no weight files (*.safetensors / pytorch_model*.bin) under {path}")
