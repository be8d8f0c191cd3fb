"""Consolidate a checkpoint into one float32 state dict (port of
``deepspeed_tpu/checkpoint/zero_to_fp32.py``; ref:
``deepspeed/utils/zero_to_fp32.py``).

The port's checkpoints hold whole tensors (``checkpoint/engine.py``), so
consolidation reads the state tree on the host and takes the float32
master, or the compute-dtype parameters upcast where the run kept no
master (float32 training).  Names are the model's parameter names.

Also usable as a CLI:
    python -m deepspeed_tpu_torch.checkpoint.zero_to_fp32 <ckpt_dir> <out_file.pt|.npz> [--tag t]
"""

import argparse
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..utils.logging import logger


def get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir: str,
                                             tag: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """``{parameter name: float32 CPU tensor}`` from the saved master,
    falling back to the compute-dtype parameters upcast."""
    from ..runtime.checkpoint_engine import make_checkpoint_engine
    checkpoint_dir = os.path.abspath(checkpoint_dir)
    if tag is None:
        with open(os.path.join(checkpoint_dir, "latest")) as f:
            tag = f.read().strip()
    state = make_checkpoint_engine("torch").load(os.path.join(checkpoint_dir, str(tag), "state"),
                                                map_location="cpu")
    src = state.get("master") or state["params"]
    return {k: v.float() for k, v in src.items()}


def convert_zero_checkpoint_to_fp32_state_dict(checkpoint_dir: str,
                                               output_file: str,
                                               tag: Optional[str] = None) -> str:
    """Write the consolidated float32 state dict to ``output_file``: ``.pt``
    or ``.bin`` (``torch.save``), else a ``.npz`` numpy archive."""
    sd = get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag=tag)
    if output_file.endswith(".pt") or output_file.endswith(".bin"):
        torch.save(sd, output_file)
    else:
        if not output_file.endswith(".npz"):
            output_file += ".npz"
        from ..resilience.atomic_io import atomic_savez
        atomic_savez(output_file, {k: np.ascontiguousarray(v.numpy()) for k, v in sd.items()})
    logger.info(f"consolidated fp32 state dict: {output_file} ({len(sd)} tensors)")
    return output_file


@torch.no_grad()
def load_state_dict_from_zero_checkpoint(engine, checkpoint_dir: str, tag: Optional[str] = None):
    """Load the consolidated float32 weights into a live engine: the
    parameters (cast to their dtype) and the float32 master (ref:
    zero_to_fp32.load_state_dict_from_zero_checkpoint)."""
    sd = get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag=tag)
    engine.load_module_state_dict(sd)
    if engine.use_master:
        engine.load_full_master(sd)
    return engine


def main(args=None):
    p = argparse.ArgumentParser()
    p.add_argument("checkpoint_dir")
    p.add_argument("output_file")
    p.add_argument("--tag", default=None)
    a = p.parse_args(args)
    convert_zero_checkpoint_to_fp32_state_dict(a.checkpoint_dir, a.output_file, tag=a.tag)


if __name__ == "__main__":
    main()
