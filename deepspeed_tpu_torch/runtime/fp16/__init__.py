"""Mixed-precision loss scaling (port of ``deepspeed_tpu/runtime/fp16``)."""
