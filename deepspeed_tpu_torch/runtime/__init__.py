"""The training runtime of the port (``deepspeed_tpu/runtime``): config, engine, LR schedules, loss scaling."""
