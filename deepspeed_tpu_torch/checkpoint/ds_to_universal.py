"""Universal checkpoint converter (port of
``deepspeed_tpu/checkpoint/ds_to_universal.py``; ref:
``deepspeed/checkpoint/ds_to_universal.py``).

The port's checkpoints hold whole tensors at any ZeRO stage and world
(``checkpoint/engine.py``), so the conversion is a relabelling: each
parameter becomes one directory of float32 "atoms" — its weight and the
optimizer's moments — under the JAX package's canonical leaf name, in the
JAX leaf's shape:

    <output_folder>/<tag>/zero/<param>/{fp32,exp_avg,exp_avg_sq}.npy
    <output_folder>/<tag>/universal_meta.json
    <output_folder>/latest_universal

The names and shapes are those of the JAX model's unrolled param tree
(``scan_layers=False``): ``models/convert.jax_leaves`` gives each port
parameter its JAX path (``model/layers_0/self_attn/q_proj/kernel`` becomes
the atom ``model.layers_0.self_attn.q_proj.kernel``) and whether the port
tensor is the JAX kernel's transpose.  The engine stores that map in its
checkpoint, so the converter needs no model.  An atom directory written here
loads into a JAX engine through the JAX package's
``load_universal_checkpoint``, and one the JAX converter wrote (from an
unrolled JAX model) loads into a port engine through
``checkpoint/universal.py``.

The float32 weight is the master, or the parameter upcast in float32
training.  The moments are the optimizer's (Adam's ``exp_avg``/
``exp_avg_sq``; Lion's and SGD's momentum is ``exp_avg``, Adagrad's
accumulator ``exp_avg_sq``, as JAX names them).  A streamed offload tier's
checkpoint holds no master or moments (they stay in its host groups or swap
files): its atoms are the parameters upcast, as JAX's converter gives.

CLI:  python -m deepspeed_tpu_torch.checkpoint.ds_to_universal \\
          --input_folder ckpts --output_folder ckpts_universal [--tag ...]
"""

import argparse
import json
import os
import shutil
from typing import Dict, Optional

import numpy as np
import torch

from ..utils.logging import logger

# atom file names (the reference's universal checkpoint vocabulary)
FP32_WEIGHT = "fp32"
EXP_AVG = "exp_avg"
EXP_AVG_SQ = "exp_avg_sq"
STEP = "step"

#: optimizer-state field (the port's and JAX's) → atom name
_MOMENT_NAMES = {
    "mu": EXP_AVG,
    "nu": EXP_AVG_SQ,
    "m": EXP_AVG,
    "v": EXP_AVG_SQ,
    "exp_avg": EXP_AVG,
    "exp_avg_sq": EXP_AVG_SQ,
    "momentum": EXP_AVG,
    "accumulator": EXP_AVG_SQ,
    "accum": EXP_AVG_SQ,
    "trace": EXP_AVG,
}


def canonicalize_param_name(name: str) -> str:
    """The topology-invariant atom name (JAX :56): a pipeline stage's
    ``body.block.*`` becomes ``model.layers.*`` and a ``layer_N.`` prefix
    goes, so an atom saved at one layout loads at any other."""
    parts = name.split(".")
    if len(parts) > 2 and parts[0] == "body" and parts[1] == "block":
        return ".".join(["model", "layers"] + parts[2:])
    if len(parts) > 1 and parts[0].startswith("layer_") and parts[0][len("layer_"):].isdigit():
        return ".".join(parts[1:])
    return name


def to_jax_layout(value: torch.Tensor, leaf: dict) -> np.ndarray:
    """A port tensor as its JAX leaf (``leaf``: ``shape``, ``transposed``),
    float32 numpy."""
    t = value.detach().to("cpu", torch.float32)
    if leaf["transposed"]:
        t = t.t()
    return t.reshape(tuple(leaf["shape"])).numpy().copy()


def to_port_layout(value: np.ndarray, leaf: dict, port_shape) -> torch.Tensor:
    """A JAX leaf's value as the port tensor of ``port_shape``."""
    t = torch.from_numpy(np.ascontiguousarray(value, dtype=np.float32))
    if tuple(t.shape) != tuple(leaf["shape"]):
        raise ValueError(f"atom {leaf['path']}: shape {tuple(t.shape)}, the model's JAX leaf is {tuple(leaf['shape'])}")
    if leaf["transposed"]:
        return t.reshape(port_shape[1], port_shape[0]).t().contiguous()
    return t.reshape(tuple(port_shape))


def convert_to_universal(input_folder: str, output_folder: str, tag: Optional[str] = None) -> str:
    """Read a port checkpoint and write the universal atom layout (see the
    module docstring); returns the tag's output directory."""
    from ..runtime.checkpoint_engine import make_checkpoint_engine
    input_folder = os.path.abspath(input_folder)
    if tag is None:
        with open(os.path.join(input_folder, "latest")) as f:
            tag = f.read().strip()
    src = os.path.join(input_folder, str(tag))
    state = make_checkpoint_engine("torch").load(os.path.join(src, "state"), map_location="cpu")
    leaves = state.get("jax_leaves")
    if not leaves:
        raise ValueError(f"{src}: the checkpoint carries no JAX leaf map (its model is not one "
                         "models/convert.jax_leaves knows), so its atoms have no JAX names")
    names = state["param_names"]
    master = state.get("master") or {n: state["params"][n] for n in names}
    moments: Dict[str, Dict[str, torch.Tensor]] = {}
    for i, st in (state.get("opt_state") or {}).get("state", {}).items():
        for key, value in st.items():
            if key in _MOMENT_NAMES and isinstance(value, torch.Tensor) and value.dim() > 0:
                moments.setdefault(_MOMENT_NAMES[key], {})[names[int(i)]] = value

    atom_names = {n: canonicalize_param_name(leaves[n]["path"].replace("/", ".")) for n in names}
    if len(set(atom_names.values())) != len(atom_names):
        raise ValueError(f"canonical atom name collision among {sorted(atom_names.values())[:5]}...")
    dst = os.path.join(os.path.abspath(output_folder), str(tag))
    zero_dir = os.path.join(dst, "zero")
    if os.path.exists(zero_dir):
        shutil.rmtree(zero_dir)
    for n in names:
        pdir = os.path.join(zero_dir, atom_names[n])
        os.makedirs(pdir, exist_ok=True)
        np.save(os.path.join(pdir, f"{FP32_WEIGHT}.npy"), to_jax_layout(master[n], leaves[n]))
        for atom, tree in moments.items():
            if n in tree:
                np.save(os.path.join(pdir, f"{atom}.npy"), to_jax_layout(tree[n], leaves[n]))

    meta = {"tag": str(tag), "step": int(state.get("step", 0)), "param_names": sorted(atom_names.values()),
            "atoms": [FP32_WEIGHT] + sorted(moments), "source": src}
    src_meta = os.path.join(src, "meta.json")
    if os.path.exists(src_meta):
        with open(src_meta) as f:
            meta["source_meta"] = json.load(f)
    from ..resilience.atomic_io import atomic_write_json, atomic_write_text
    atomic_write_json(os.path.join(dst, "universal_meta.json"), meta, indent=2)
    # the pointer lands after the converted checkpoint it names is on disk
    atomic_write_text(os.path.join(os.path.abspath(output_folder), "latest_universal"), str(tag))
    logger.info(f"universal checkpoint written: {dst} ({len(names)} params, atoms={meta['atoms']})")
    return dst


def load_universal_atoms(universal_dir: str) -> Dict[str, Dict[str, np.ndarray]]:
    """``{atom name: {"fp32": ndarray, "exp_avg": ..., "exp_avg_sq": ...}}``."""
    zero_dir = os.path.join(universal_dir, "zero")
    out = {}
    for root, _dirs, files in os.walk(zero_dir):
        npys = [f for f in files if f.endswith(".npy")]
        if not npys:
            continue
        pname = os.path.relpath(root, zero_dir).replace(os.sep, ".")
        out[pname] = {os.path.splitext(f)[0]: np.load(os.path.join(root, f)) for f in npys}
    return out


def main(args=None):
    p = argparse.ArgumentParser(description="Convert a deepspeed_tpu_torch checkpoint to the universal atom layout")
    p.add_argument("--input_folder", required=True)
    p.add_argument("--output_folder", required=True)
    p.add_argument("--tag", default=None)
    a = p.parse_args(args)
    convert_to_universal(a.input_folder, a.output_folder, tag=a.tag)


if __name__ == "__main__":
    main()
