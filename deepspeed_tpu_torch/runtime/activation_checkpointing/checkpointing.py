"""Activation checkpointing over ``torch.utils.checkpoint`` (port of
``deepspeed_tpu/runtime/activation_checkpointing/checkpointing.py``; ref:
``deepspeed/runtime/activation_checkpointing/checkpointing.py``).

  * ``checkpoint(fn, *args)`` runs ``fn`` under ``torch.utils.checkpoint``
    (non-reentrant): its activations are recomputed in the backward, or
    those the configured policy saves are kept (``policy_from_config``, the
    names of ``models/llama.remat_context_fn``: ``nothing_saveable`` by
    default, ``flash_saveable`` with ``number_checkpoints``, JAX's "keep the
    matmul outputs");
  * ``configure`` records the config (``activation_checkpointing``; the
    training engine maps it onto the model's ``remat_policy``);
  * ``RNGStatesTracker`` keeps named ``torch.Generator`` streams; ``fork``
    derives a fresh generator from a stream deterministically, so a
    recomputed forward that draws from what it was handed draws the same;
  * ``checkpoint_name`` tags a residual in JAX's model code for its
    name-based policies; the port's policies choose by op, so the tag is
    the identity.

``partition_activations`` (activation shards over the tensor-parallel
ranks) over more than one rank raises, and so does ``cpu_checkpointing``;
``contiguous_memory_optimization`` is a no-op (the caching allocator owns
the memory).
"""

from typing import Any, Callable, Dict, Optional

import torch

from ...comm import comm
from ...comm.mesh import ROADMAP_TENSOR_PARALLEL
from ...utils.logging import logger

_CONFIG = None
_MPU = None

#: the tag of JAX's offloadable/saveable residuals
CHECKPOINT_NAME = "ds_act_ckpt"


class RNGStatesTracker:
    """Named random streams (ref: ``CudaRNGStatesTracker``, JAX ``:42``):
    ``add(name, seed)`` makes one, ``fork(name)`` derives a fresh generator
    from it and advances it, ``get_states``/``set_states`` save and restore
    every stream."""

    def __init__(self):
        self.states_: Dict[str, torch.Generator] = {}

    def reset(self) -> None:
        self.states_ = {}

    def get_states(self) -> Dict[str, torch.Tensor]:
        return {name: g.get_state() for name, g in self.states_.items()}

    def set_states(self, states: Dict[str, torch.Tensor]) -> None:
        self.states_ = {}
        for name, state in states.items():
            g = torch.Generator()
            g.set_state(state)
            self.states_[name] = g

    def add(self, name: str, seed: int) -> None:
        if name in self.states_:
            raise Exception(f"rng state {name} already exists")
        self.states_[name] = torch.Generator().manual_seed(seed)

    def fork(self, name: str = "model-parallel-rng", device="cpu") -> torch.Generator:
        """A generator on ``device`` seeded from the next draw of stream ``name``."""
        if name not in self.states_:
            raise Exception(f"rng state {name} is not added")
        seed = int(torch.randint(0, 2**62, (), generator=self.states_[name]))
        return torch.Generator(device).manual_seed(seed)


_RNG_TRACKER = RNGStatesTracker()


def get_cuda_rng_tracker() -> RNGStatesTracker:
    """The name kept from the reference (``checkpointing.py get_cuda_rng_tracker``)."""
    return _RNG_TRACKER


def model_parallel_cuda_manual_seed(seed: int) -> RNGStatesTracker:
    """The data-parallel stream at ``seed`` and the model-parallel one at
    ``seed + 2718`` (ref: ``model_parallel_cuda_manual_seed``)."""
    _RNG_TRACKER.reset()
    _RNG_TRACKER.add("model-parallel-rng", seed + 2718)
    _RNG_TRACKER.add("data-parallel-rng", seed)
    return _RNG_TRACKER


def policy_from_config(cfg) -> str:
    """The ``remat_policy`` of an ``activation_checkpointing`` config (JAX
    ``_policy_from_config`` :104): ``number_checkpoints`` keeps the matmul
    (and flash) outputs, ``flash_saveable``; otherwise every activation is
    recomputed, ``nothing_saveable``."""
    if cfg is None:
        return "nothing_saveable"
    if getattr(cfg, "cpu_checkpointing", False):
        from ..config import ROADMAP_AUXILIARIES
        raise NotImplementedError(f"cpu_checkpointing: host offload of activations is not ported "
                                  f"({ROADMAP_AUXILIARIES})")
    return "flash_saveable" if getattr(cfg, "number_checkpoints", None) else "nothing_saveable"


def checkpoint_name(x: torch.Tensor, name: str = CHECKPOINT_NAME) -> torch.Tensor:
    """``x`` unchanged: the port's policies choose what to save by op, not by tag."""
    return x


def configure(mpu_=None, deepspeed_config=None, partition_activations=None, contiguous_checkpointing=None,
              num_checkpoints=None, checkpoint_in_cpu=None, synchronize=None, profile=None) -> None:
    """Record the checkpointing config (JAX ``:132``): the config's block,
    or one made of the keywords."""
    global _CONFIG, _MPU
    from ..config import ActivationCheckpointingConfig
    if deepspeed_config is not None and hasattr(deepspeed_config, "activation_checkpointing_config"):
        cfg = deepspeed_config.activation_checkpointing_config
    else:
        cfg = ActivationCheckpointingConfig(partition_activations=bool(partition_activations),
                                            contiguous_memory_optimization=bool(contiguous_checkpointing),
                                            cpu_checkpointing=bool(checkpoint_in_cpu),
                                            number_checkpoints=num_checkpoints,
                                            synchronize_checkpoint_boundary=bool(synchronize), profile=bool(profile))
    if cfg.partition_activations and comm.get_world_size() > 1:
        raise NotImplementedError(f"partition_activations over {comm.get_world_size()} ranks is not ported "
                                  f"({ROADMAP_TENSOR_PARALLEL})")
    _CONFIG, _MPU = cfg, mpu_
    if cfg.contiguous_memory_optimization:
        logger.debug("contiguous_memory_optimization is a no-op here (the caching allocator owns the memory)")


def is_configured() -> bool:
    return _CONFIG is not None


def reset() -> None:
    global _CONFIG
    _CONFIG = None


def checkpoint(function: Callable, *args, **kwargs) -> Any:
    """``function(*args, **kwargs)`` with its activations checkpointed under
    the configured policy (JAX ``:197``; ref: ``checkpointing.py:948``)."""
    from ...models.llama import remat_context_fn
    context_fn = remat_context_fn(policy_from_config(_CONFIG))
    extra = {} if context_fn is None else {"context_fn": context_fn}
    return torch.utils.checkpoint.checkpoint(function, *args, use_reentrant=False, **extra, **kwargs)


def checkpoint_wrapper(function: Callable) -> Callable:
    """The decorator form: ``layer = checkpoint_wrapper(layer)``."""

    def inner(*args, **kwargs):
        return checkpoint(function, *args, **kwargs)

    return inner


def non_reentrant_checkpoint(function: Callable, *args, **kwargs) -> Any:
    """ref: ``checkpointing.py:704``: ``checkpoint`` is already non-reentrant."""
    return checkpoint(function, *args, **kwargs)


def partition_activations_in_checkpoint(partition_activation: bool) -> None:
    if _CONFIG is None:
        configure(partition_activations=partition_activation)
    else:
        if partition_activation and comm.get_world_size() > 1:
            raise NotImplementedError(f"partition_activations over several ranks is not ported "
                                      f"({ROADMAP_TENSOR_PARALLEL})")
        _CONFIG.partition_activations = partition_activation
