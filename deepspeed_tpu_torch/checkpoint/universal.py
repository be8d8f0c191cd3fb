"""Load a universal (atom-layout) checkpoint into a live engine (port of
``deepspeed_tpu/checkpoint/universal.py``; ref: ``runtime/engine.py:958``,
``checkpoint/universal_checkpoint.py`` ``load_hp_checkpoint_state``).

Each atom is a whole float32 JAX leaf (``ds_to_universal.py``); the engine's
JAX leaf map (``models/convert.jax_leaves``, kept as ``engine.jax_leaf_map``)
names the atom of each port parameter and turns the leaf back into the port
tensor's layout.  The whole values then go through the engine's own writers
(``engine.load_full_state``), which cut them to its partition and put them
where its tier keeps them: any ZeRO stage and world, and any offload tier.
The step in ``universal_meta.json`` becomes the engine's and its optimizer's
step, so Adam's bias correction resumes where the run left off.

The ``checkpoint.load_universal`` config key stays refused: the JAX engine
stores it without reading it, and this function is the way in.
"""

import json
import os
from typing import Optional

from ..utils.logging import log_dist
from .ds_to_universal import EXP_AVG, EXP_AVG_SQ, FP32_WEIGHT, canonicalize_param_name, load_universal_atoms, \
    to_port_layout


def load_universal_checkpoint(engine, universal_dir: str, tag: Optional[str] = None,
                              load_optimizer_states: bool = True):
    """Load ``<universal_dir>/<tag>`` (``latest_universal`` by default, or
    ``universal_dir`` itself when it holds ``zero/``) into ``engine``;
    returns the engine."""
    universal_dir = os.path.abspath(universal_dir)
    if os.path.isdir(os.path.join(universal_dir, "zero")):
        path = universal_dir
    else:
        if tag is None:
            with open(os.path.join(universal_dir, "latest_universal")) as f:
                tag = f.read().strip()
        path = os.path.join(universal_dir, str(tag))
    leaves = engine.jax_leaf_map
    if leaves is None:
        raise ValueError(f"{type(engine.module).__name__}: no JAX leaf map (models/convert.jax_leaves), so its "
                         "parameters have no universal atoms")
    atoms = {canonicalize_param_name(k): v for k, v in load_universal_atoms(path).items()}
    wanted = {n: canonicalize_param_name(leaves[n]["path"].replace("/", ".")) for n in engine.param_names}
    missing = sorted(a for a in wanted.values() if a not in atoms)
    if missing:
        raise ValueError(f"universal checkpoint does not cover the engine's parameters (missing e.g. {missing[:5]})")
    values = {n: to_port_layout(atoms[a][FP32_WEIGHT], leaves[n], leaves[n]["port_shape"]) for n, a in wanted.items()}
    moments = None
    if load_optimizer_states:
        moments = {}
        for key in (EXP_AVG, EXP_AVG_SQ):
            have = {n: a for n, a in wanted.items() if key in atoms[a]}
            if have and len(have) != len(wanted):
                raise ValueError(f"universal checkpoint '{key}' atoms do not cover the engine's parameters; refusing "
                                 "a partial optimizer restore — pass load_optimizer_states=False to load weights only")
            if have:
                moments[key] = {n: to_port_layout(atoms[a][key], leaves[n], leaves[n]["port_shape"])
                                for n, a in have.items()}
    step = None
    meta_path = os.path.join(path, "universal_meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            step = json.load(f).get("step")
    engine.load_full_state(values, moments, step)
    log_dist(f"loaded universal checkpoint from {path} ({len(values)} params)", ranks=[0])
    return engine
