"""Checkpointing (port of ``deepspeed_tpu/checkpoint``): the crash-safe
save/load of the training engine and the float32 consolidation (ref:
``deepspeed/utils/zero_to_fp32.py``), and the universal checkpoint: the
atom layout under the JAX package's names (``ds_to_universal``) and its
loader into an engine of any stage, world and offload tier (``universal``).
The files hold whole tensors whatever the ZeRO stage and world."""

from .engine import (checkpoint_tag_valid, find_newest_valid_tag, list_tags, load_checkpoint, read_meta,
                     save_checkpoint)
from .ds_to_universal import convert_to_universal, load_universal_atoms
from .universal import load_universal_checkpoint
from .zero_to_fp32 import (convert_zero_checkpoint_to_fp32_state_dict, get_fp32_state_dict_from_zero_checkpoint,
                           load_state_dict_from_zero_checkpoint)

__all__ = ["checkpoint_tag_valid", "find_newest_valid_tag", "list_tags", "load_checkpoint", "read_meta",
           "save_checkpoint", "convert_to_universal", "load_universal_atoms", "load_universal_checkpoint",
           "convert_zero_checkpoint_to_fp32_state_dict",
           "get_fp32_state_dict_from_zero_checkpoint", "load_state_dict_from_zero_checkpoint"]
