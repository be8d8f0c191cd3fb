"""ZeRO over the data-parallel ranks (port of ``deepspeed_tpu/runtime/zero``;
ref: ``deepspeed/runtime/zero/``): the partition rules, MiCS/hpZ, the
``Init`` and ``GatheredParameters`` contexts, ``TiledLinear``, and the
engine's partitioned state (``partitioned.py``)."""

from .partition import (Partition, estimate_partitioned_bytes, grad_shardings, master_and_optstate_shardings,
                        zero_shard_spec)
from .mics import MiCS_Init, mics_zero_axes, resolve_partition_axes
from .partition_parameters import GatheredParameters, Init
from .tiling import TiledLinear, copy_params_from_dense
