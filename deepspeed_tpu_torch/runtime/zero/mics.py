"""MiCS and ZeRO++ hpZ: over how many ranks ZeRO-3 partitions (port of
``deepspeed_tpu/runtime/zero/mics.py``; ref: ``runtime/zero/mics.py`` and
``partition_parameters.py:1673 _partition_param_sec``).

* MiCS (``mics_shard_size``): parameters, gradients and optimizer state
  shard within groups of ``shard_size`` ranks and replicate across them.
* hpZ (``zero_hpz_partition_size``): the parameters shard within a group of
  that many ranks; the gradients and the optimizer state over all of them.

The JAX package answers with the innermost data-parallel mesh axes whose
sizes multiply to the group size.  The port's mesh has the ``data`` axis
only, so a size of the world or more takes it whole, a size of 1 takes no
axis (nothing shards), and any other size raises JAX's ``ValueError``.
"""

from typing import Tuple

from ...comm.mesh import ZERO_AXES, Mesh
from ...utils.logging import log_dist


def mics_zero_axes(mesh: Mesh, shard_size: int, zero_axes=ZERO_AXES) -> Tuple[str, ...]:
    """The innermost active ZeRO axes whose sizes multiply to
    ``shard_size`` (JAX :27)."""
    active = [a for a in zero_axes if mesh.shape.get(a, 1) > 1]
    total = 1
    for a in active:
        total *= mesh.shape[a]
    if shard_size >= total:
        return tuple(active)
    chosen = []
    acc = 1
    for a in reversed(active):   # innermost first
        if acc == shard_size:
            break
        acc *= mesh.shape[a]
        chosen.append(a)
    if acc != shard_size:
        raise ValueError(f"mics/hpz shard size {shard_size} must equal the product of innermost data-parallel mesh "
                         f"axes; available suffix products from {dict(mesh.shape)}: {_suffix_products(mesh, active)}")
    return tuple(reversed(chosen))


def _suffix_products(mesh: Mesh, active):
    out, acc = [], 1
    for a in reversed(active):
        acc *= mesh.shape[a]
        out.append(acc)
    return out


def resolve_partition_axes(mesh: Mesh, zero_config, zero_stage: int):
    """``(param_axes, state_axes)`` for the stage and the MiCS/hpZ knobs
    (JAX :63): MiCS restricts both at stage 3; hpZ the parameters' only."""
    param_axes = state_axes = ZERO_AXES
    mics = getattr(zero_config, "mics_shard_size", -1) or -1
    hpz = getattr(zero_config, "zero_hpz_partition_size", 1) or 1
    if zero_stage == 3 and mics > 0:
        param_axes = state_axes = mics_zero_axes(mesh, mics)
        log_dist(f"MiCS: sharding over axes {param_axes} (shard_size={mics})", ranks=[0])
    elif zero_stage == 3 and hpz > 1:
        param_axes = mics_zero_axes(mesh, hpz)
        log_dist(f"ZeRO++ hpZ: secondary param partition over {param_axes} (partition_size={hpz})", ranks=[0])
    return param_axes, state_axes


class MiCS_Init:
    """The reference's context manager (JAX :82): the engine partitions at
    construction, so the context only carries the arguments."""

    def __init__(self, module=None, data_parallel_group=None, mem_efficient_linear=True, remote_device=None,
                 pin_memory=False, config_dict_or_path=None, config=None, enabled=True, dtype=None, mpu=None):
        self.enabled = enabled

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
