"""Access to the parameters, gradients and optimizer states of a training
engine whatever its ZeRO partitioning (port of
``deepspeed_tpu/utils/tensor_fragment.py``; ref:
``deepspeed/utils/tensor_fragment.py:132 safe_get_full_fp32_param``,
``:148 safe_set_full_fp32_param``, ``:199 safe_get_full_grad`` and the
``safe_{get,set}_{full,local}_optimizer_state`` family).

Paths are the port's parameter names (``layers.0.self_attn.q_proj.weight``;
``/`` separators are read as ``.``).

  * **full**: the whole tensor in the port's layout, float32 (a collective
    over the ranks when it is partitioned: every rank calls).
  * **local**: this rank's slice, as the engine keeps it: the JAX leaf's
    shape cut on its sharded dim (``runtime/zero/partition.py``), the whole
    tensor where it is not partitioned.  JAX's "local" is its first
    addressable shard, which is rank 0's.
  * **set full**: the float32 master and the compute-dtype copy (the
    reference's hp write and lp sync).
  * **grads**: the engine keeps no gradient between steps, so the accessor
    recomputes those of a batch (the engine's last by default) through the
    engine's own accumulation and reduction, unscaled as the step unscales
    them (``1/(scale·gas)`` and the predivide factor): the step's gradients
    before clipping, at the current parameters (JAX :139-195).

An expert bank cut over the expert group (``moe.expert_parallel_size`` > 1)
raises naming ROADMAP item 6.1; a tensor slice cut over the tensor group
(``tensor_parallel.autotp_size`` > 1) naming item 6.2.
"""

from typing import List

import torch

#: the JAX optimizer-state names of each port state key
_STATE_ALIASES = {"exp_avg": ("exp_avg", "mu", "m"), "exp_avg_sq": ("exp_avg_sq", "nu", "v"),
                  "momentum": ("momentum", "trace"), "accum": ("accum", "sum_of_squares")}


def _index(engine, path: str) -> int:
    name = path.replace("/", ".")
    if name.startswith("params."):
        name = name[len("params."):]
    try:
        i = engine.param_names.index(name)
    except ValueError:
        raise KeyError(f"no parameter {name!r} (parameters: {engine.param_names[:4]}...)") from None
    if name in engine._banks:
        from ..comm.mesh import ROADMAP_EXPERT_PARALLEL
        raise NotImplementedError(f"tensor_fragment of the expert bank {name!r} cut over {engine.ep} expert-parallel "
                                  f"ranks is not ported ({ROADMAP_EXPERT_PARALLEL})")
    if name in engine._tp_cut:
        from ..comm.mesh import ROADMAP_TENSOR_PARALLEL
        raise NotImplementedError(f"tensor_fragment of {name!r} cut over {engine.tp_size} tensor-parallel ranks is "
                                  f"not ported ({ROADMAP_TENSOR_PARALLEL})")
    return i


def _state_key(engine, i: int, state_name: str) -> str:
    st = engine.optimizer.state[engine._targets[i]]
    for key, names in _STATE_ALIASES.items():
        if state_name in names and key in st:
            return key
    if state_name in st:
        return state_name
    raise KeyError(f"optimizer state has no field {state_name!r} (fields: {sorted(st)})")


def _full(engine, i: int, local: List[torch.Tensor]) -> torch.Tensor:
    """Whole tensor ``i`` from a list of every tensor's state slices."""
    if engine.zero is None:
        return local[i].detach().float().clone()
    return engine.zero.full_state(local)[i].float()


# ------------------------------------------------------------------ params

def safe_get_full_fp32_param(engine, path: str) -> torch.Tensor:
    """The whole float32 value of a parameter: the master, or the
    parameter in float32 training (ref: tensor_fragment.py:132)."""
    i = _index(engine, path)
    return _full(engine, i, engine._targets)


def safe_get_local_fp32_param(engine, path: str) -> torch.Tensor:
    """This rank's slice of the float32 value (ref: safe_get_local_fp32_param)."""
    return engine._targets[_index(engine, path)].detach().float().clone()


def safe_set_full_fp32_param(engine, path: str, value) -> None:
    """Write a whole float32 value: this rank's master slice and its
    compute-dtype parameter (ref: tensor_fragment.py:148)."""
    i = _index(engine, path)
    value = torch.as_tensor(value, dtype=torch.float32)
    shape = engine.zero.param_parts[i].shape if engine.zero is not None else tuple(engine.params[i].shape)
    if tuple(value.shape) != tuple(shape):
        raise ValueError(f"shape mismatch writing {path}: {tuple(value.shape)} vs {tuple(shape)}")
    engine.set_full_param(engine.param_names[i], value)


# ------------------------------------------------------------------- grads

@torch.no_grad()
def _unscale(engine, grads: List[torch.Tensor]) -> List[torch.Tensor]:
    scale = engine.scaler_state.cur_scale
    inv = 1.0 / (scale * engine.gas)
    if engine._config.gradient_predivide_factor != 1.0:
        inv = inv / engine._config.gradient_predivide_factor
    return [g * inv for g in grads]


def _recompute_grads(engine, batch) -> List[torch.Tensor]:
    """The reduced gradients of ``batch`` in the engine's gradient
    partition, unscaled; the engine's own pending state is left as it was."""
    batch = batch if batch is not None else engine.last_batch
    if batch is None:
        raise RuntimeError("no batch: train a step first or pass batch=")
    batch = engine._to_device(batch)
    saved = engine._pending, engine._pending_loss, (engine.zero.pending if engine.zero is not None else None)
    engine._pending = None
    if engine.zero is not None:
        engine.zero.pending = None
    try:
        for i in range(engine.gas):
            global_mb = engine._rank_micro_batch(batch, i, ranks=engine.dp_world) if engine._gather_loss else None
            engine._backward_micro(engine._rank_micro_batch(batch, i), global_mb)
        grads = engine._pending
        zero_loss = torch.zeros((), device=engine.device)
        grads, _ = engine._reduce_over_ranks(grads, zero_loss, reduce_loss=False)
        return _unscale(engine, grads)
    finally:
        engine._pending, engine._pending_loss = saved[0], saved[1]
        if engine.zero is not None:
            engine.zero.pending = saved[2]


def safe_get_full_grad(engine, path: str, batch=None) -> torch.Tensor:
    """The whole float32 gradient of a parameter for ``batch`` (default: the
    engine's last ``train_batch`` batch), recomputed (ref:
    tensor_fragment.py:199)."""
    i = _index(engine, path)
    grads = _recompute_grads(engine, batch)
    z = engine.zero
    if z is None or z.stage < 2:
        return grads[i].float()
    from ..runtime.zero.partitioned import all_gather_parts
    full = all_gather_parts(z.grad_parts, grads)
    return z.grad_parts[i].port_view(full[i]).contiguous()


def safe_get_local_grad(engine, path: str, batch=None) -> torch.Tensor:
    """This rank's slice of the recomputed gradient (the whole gradient
    where the gradients are summed whole: stages 0 and 1)."""
    i = _index(engine, path)
    return _recompute_grads(engine, batch)[i].float()


# --------------------------------------------------------- optimizer state

def _moments(engine, key: str) -> List[torch.Tensor]:
    return [engine.optimizer.state[t][key] for t in engine._targets]


def safe_get_full_optimizer_state(engine, path: str, state_name: str) -> torch.Tensor:
    """The whole float32 optimizer state of a parameter, e.g. ``exp_avg``
    or ``exp_avg_sq`` (JAX's ``mu``/``nu`` are read as these)."""
    i = _index(engine, path)
    return _full(engine, i, _moments(engine, _state_key(engine, i, state_name)))


def safe_get_local_optimizer_state(engine, path: str, state_name: str) -> torch.Tensor:
    """This rank's slice of the optimizer state."""
    i = _index(engine, path)
    return engine.optimizer.state[engine._targets[i]][_state_key(engine, i, state_name)].detach().float().clone()


@torch.no_grad()
def safe_set_full_optimizer_state(engine, path: str, value, state_name: str) -> None:
    """Write a whole optimizer-state value; each rank keeps its slice."""
    i = _index(engine, path)
    t = engine.optimizer.state[engine._targets[i]][_state_key(engine, i, state_name)]
    value = torch.as_tensor(value, dtype=t.dtype).to(t.device)
    full_shape = engine.zero.param_parts[i].shape if engine.zero is not None else tuple(t.shape)
    if tuple(value.shape) != tuple(full_shape):
        raise ValueError(f"shape mismatch writing {state_name} {path}: {tuple(value.shape)} vs {tuple(full_shape)}")
    t.copy_(value if engine.zero is None else engine.zero.local_state(i, value))
