"""Import-path parity: the reference ships this as deepspeed/utils/zero_to_fp32.py.

Implementation lives in deepspeed_tpu_torch/checkpoint/zero_to_fp32.py.
"""

from ..checkpoint.zero_to_fp32 import (convert_zero_checkpoint_to_fp32_state_dict,
                                       get_fp32_state_dict_from_zero_checkpoint,
                                       load_state_dict_from_zero_checkpoint, main)

__all__ = ["convert_zero_checkpoint_to_fp32_state_dict", "get_fp32_state_dict_from_zero_checkpoint",
           "load_state_dict_from_zero_checkpoint", "main"]

if __name__ == "__main__":
    main()
