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
    derives a fresh generator (on the card unless the caller names another
    device) from a stream deterministically, so a recomputed forward that
    draws from what it was handed draws the same; ``model_parallel_rng_key``
    gives a generator that differs per tensor rank and is equal over the
    data ranks;
  * ``checkpoint_name`` tags a residual in JAX's model code for its
    name-based policies; the port's policies choose by op, so the tag is
    the identity.

``partition_activations`` (JAX ``:174-212``): at ``tensor`` N > 1 on the
global mesh ``checkpoint`` runs ``function`` through ``CheckpointFunction``
(ref: ``checkpointing.py`` ``CheckpointFunction``), which keeps each
floating input whose last dim N divides as this rank's slice of that dim
(a copy of 1/N of its bytes; JAX's sharding constraint on the saved
residuals) and the others whole, as JAX leaves them, and in the backward
all-gathers the slices over the tensor group (kind
``partition_activations`` in ``comm.tensor_parallel_kinds``), recomputes
``function`` under the forward's RNG state and back-propagates through it:
every activation inside is recomputed, the values and gradients are
unchanged.  At tensor 1 (any world) it is JAX's no-op.  ``cpu_checkpointing``
raises; ``contiguous_memory_optimization`` is a no-op (the caching allocator
owns the memory).
"""

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ...accelerator import DeviceLike, resolve_device
from ...comm import comm
from ...comm.mesh import TENSOR_AXIS, get_global_mesh
from ...module_inject.layers import NO_TENSOR_PARALLEL, TensorParallel, all_gather_last
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

    def fork(self, name: str = "model-parallel-rng", device: DeviceLike = "cuda") -> torch.Generator:
        """A generator on ``device`` (the card unless the caller names
        another) seeded from the next draw of stream ``name``."""
        if name not in self.states_:
            raise Exception(f"rng state {name} is not added")
        seed = int(torch.randint(0, 2**62, (), generator=self.states_[name]))
        return torch.Generator(resolve_device(device)).manual_seed(seed)


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


def model_parallel_rng_key(seed: int, device: DeviceLike = "cuda") -> torch.Generator:
    """A generator on ``device`` that differs per tensor rank of the global
    mesh and is equal over its data ranks (JAX ``:91-98`` folds
    ``axis_index("tensor")`` into ``PRNGKey(seed)``; the port hashes
    ``(seed, t)`` with numpy's ``SeedSequence`` and cannot match JAX's
    bits).  Without a tensor axis of more than one rank, ``seed``'s own
    generator, as JAX's key outside a mapped axis."""
    mesh = get_global_mesh()
    gen = torch.Generator(resolve_device(device))
    if mesh.shape.get(TENSOR_AXIS, 1) <= 1:
        return gen.manual_seed(seed)
    t = mesh.coords(comm.get_rank())[TENSOR_AXIS]
    return gen.manual_seed(int(np.random.SeedSequence([seed, t]).generate_state(1, np.uint64)[0] >> np.uint64(1)))


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
    _CONFIG, _MPU = cfg, mpu_
    if cfg.contiguous_memory_optimization:
        logger.debug("contiguous_memory_optimization is a no-op here (the caching allocator owns the memory)")


def is_configured() -> bool:
    return _CONFIG is not None


def reset() -> None:
    global _CONFIG
    _CONFIG = None


def _tensor_parallel() -> TensorParallel:
    """This rank's place on the global mesh's tensor axis (degree 1 without one)."""
    n = get_global_mesh().shape.get(TENSOR_AXIS, 1)
    if n <= 1:
        return NO_TENSOR_PARALLEL
    from ...utils import groups
    return TensorParallel(n, groups.get_tensor_model_parallel_rank(), groups.get_tensor_model_parallel_group())


def _partitioned(x: Any, tp: TensorParallel) -> bool:
    """Whether ``checkpoint`` keeps ``x`` as this rank's slice of its last
    dim: a floating tensor whose last dim ``tp.size`` divides (JAX ``:188``)."""
    return tp.size > 1 and isinstance(x, torch.Tensor) and x.is_floating_point() and x.dim() >= 1 \
        and x.shape[-1] % tp.size == 0


class CheckpointFunction(torch.autograd.Function):
    """``run_function(*args)`` without its activations, its inputs kept cut
    over ``tp`` (see the module docstring).  At least one input must
    require a gradient, as in the reference, or the backward never runs."""

    @staticmethod
    def forward(ctx, run_function, tp, *args):
        ctx.run_function, ctx.tp = run_function, tp
        ctx.cut = [_partitioned(a, tp) for a in args]
        ctx.needs = [isinstance(a, torch.Tensor) and a.requires_grad for a in args]
        ctx.tensor = [isinstance(a, torch.Tensor) for a in args]
        ctx.others = [None if tensor else a for a, tensor in zip(args, ctx.tensor)]
        cuda = [a.device for a in args if isinstance(a, torch.Tensor) and a.is_cuda]
        ctx.cuda = cuda[0] if cuda else None
        ctx.cpu_rng = torch.get_rng_state()
        ctx.cuda_rng = torch.cuda.get_rng_state(ctx.cuda) if ctx.cuda is not None else None
        with torch.no_grad():
            outputs = run_function(*args)
        n = lambda a: a.shape[-1] // tp.size
        ctx.save_for_backward(*[a.narrow(-1, tp.rank * n(a), n(a)).clone() if cut else a
                                for a, cut in zip(args, ctx.cut) if isinstance(a, torch.Tensor)])
        return outputs

    @staticmethod
    def backward(ctx, *grads):
        saved = iter(ctx.saved_tensors)
        inputs = []
        for tensor, other, cut, needs in zip(ctx.tensor, ctx.others, ctx.cut, ctx.needs):
            if not tensor:
                inputs.append(other)
                continue
            t = next(saved)
            if cut:
                t = all_gather_last(t, ctx.tp, "partition_activations", "backward")
            inputs.append(t.detach().requires_grad_(needs))
        devices = [ctx.cuda] if ctx.cuda is not None else []
        with torch.random.fork_rng(devices=devices):
            torch.set_rng_state(ctx.cpu_rng)
            if ctx.cuda is not None:
                torch.cuda.set_rng_state(ctx.cuda_rng, ctx.cuda)
            with torch.enable_grad():
                outputs = ctx.run_function(*inputs)
        outputs = outputs if isinstance(outputs, tuple) else (outputs, )
        pairs = [(o, g) for o, g in zip(outputs, grads)
                 if isinstance(o, torch.Tensor) and o.requires_grad and g is not None]
        if pairs:
            torch.autograd.backward([o for o, _ in pairs], [g for _, g in pairs])
        return (None, None) + tuple(t.grad if needs else None for t, needs in zip(inputs, ctx.needs))


def checkpoint(function: Callable, *args, **kwargs) -> Any:
    """``function(*args, **kwargs)`` with its activations checkpointed under
    the configured policy (JAX ``:197``; ref: ``checkpointing.py:948``);
    with ``partition_activations`` at tensor > 1 through
    ``CheckpointFunction`` (positional arguments only, as the reference)."""
    if _CONFIG is not None and _CONFIG.partition_activations:
        tp = _tensor_parallel()
        if tp.size > 1:
            if kwargs:
                raise TypeError(f"partition_activations: checkpoint takes positional arguments only, got "
                                f"{sorted(kwargs)}")
            return CheckpointFunction.apply(function, tp, *args)
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
        _CONFIG.partition_activations = partition_activation
