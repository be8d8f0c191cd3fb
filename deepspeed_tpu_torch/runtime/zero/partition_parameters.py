"""``zero.Init`` and ``GatheredParameters`` (port of
``deepspeed_tpu/runtime/zero/partition_parameters.py``; ref:
``runtime/zero/partition_parameters.py`` ``Init`` :825,
``GatheredParameters`` :2120).

``Init`` is the same thin context as the JAX package's: the engine
partitions the state when it is built (``runtime/zero/partitioned.py``),
after rank 0's weights are broadcast, so the context only records the
intent.  ``GatheredParameters`` gathers the whole tensors of the named
parameters (the port's names and layout, in the compute dtype): from an
engine whatever its stage (a collective at stage 3, which every rank
enters), or from a module.  With ``modifier_rank`` the values that rank
writes go back, on exit, into every rank's parameters (its slices at stage
3) and float32 master; without it a write raises, as JAX asserts.
"""

from typing import Dict, Optional, Sequence

import torch

from ...comm import comm
from ...utils.logging import logger


class Init:
    """ref: partition_parameters.py:825; the reference's arguments are
    accepted and the engine partitions at construction."""

    def __init__(self, module=None, data_parallel_group=None, mem_efficient_linear: bool = True,
                 remote_device: Optional[str] = None, pin_memory: bool = False, config_dict_or_path=None, config=None,
                 enabled: bool = True, dtype=None, mpu=None, zero_param_parallel_group=None,
                 zero_quantized_weights: bool = False, zero_quantized_nontrainable_weights: bool = False,
                 sequence_data_parallel_group=None, param_swapper=None):
        self.enabled = enabled
        if enabled:
            logger.debug("zero.Init: the engine partitions the parameters when it is built")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class GatheredParameters:
    """ref: partition_parameters.py:2120.

        with GatheredParameters(engine, ["layers.0.mlp"], modifier_rank=0) as g:
            full = g["layers.0.mlp.down_proj.weight"]     # the whole tensor
            g["layers.0.mlp.down_proj.weight"] = full * 2  # written back on exit

    ``names`` selects the parameters whose name starts with or contains one
    of them (all when None).  Pass an engine (its parameters, written back
    with ``modifier_rank``) or an ``nn.Module`` (a read-only gather)."""

    def __init__(self, params_or_engine, names: Optional[Sequence[str]] = None, modifier_rank: Optional[int] = None,
                 fwd_module=None, enabled: bool = True):
        self.enabled = enabled
        self._engine = params_or_engine if hasattr(params_or_engine, "module_state_dict") else None
        self._module = None if self._engine is not None else params_or_engine
        self.names = names
        self.modifier_rank = modifier_rank
        self._gathered: Dict[str, torch.Tensor] = {}
        self._dirty = set()

    def _wanted(self, name: str) -> bool:
        return self.names is None or any(name.startswith(n) or n in name for n in self.names)

    def __enter__(self):
        if not self.enabled:
            return self
        if self._engine is not None:
            eng = self._engine
            idxs = [i for i, n in enumerate(eng.param_names) if self._wanted(n)]
            full = eng.zero.full_params(idxs) if eng.zero is not None else [eng.params[i].detach() for i in idxs]
            # an expert bank cut over the expert group: whole over it too
            self._gathered = eng._whole_experts({eng.param_names[i]: f.clone() for i, f in zip(idxs, full)})
        else:
            self._gathered = {k: v.detach().clone() for k, v in self._module.named_parameters() if self._wanted(k)}
        return self

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._gathered[name]

    def keys(self):
        return self._gathered.keys()

    def __setitem__(self, name: str, value) -> None:
        if self.modifier_rank is None:
            raise RuntimeError("GatheredParameters: writes require modifier_rank (the reference's contract)")
        old = self._gathered[name]
        value = torch.as_tensor(value).to(device=old.device, dtype=old.dtype)
        if value.shape != old.shape:
            raise ValueError(f"shape mismatch writing {name}: {tuple(value.shape)} vs {tuple(old.shape)}")
        self._gathered[name] = value
        self._dirty.add(name)

    @torch.no_grad()
    def __exit__(self, *exc):
        if not self.enabled or self.modifier_rank is None or exc[0] is not None:
            return False
        if self._engine is None:
            if self._dirty:
                logger.warning("GatheredParameters writes dropped: constructed from a module, pass the engine to "
                               "persist them")
            return False
        eng = self._engine
        names = list(self._gathered)
        # the modifier rank's writes, on every rank
        dirty = torch.tensor([n in self._dirty for n in names], dtype=torch.uint8, device=eng.device)
        if comm.get_world_size() > 1:
            with comm.unrecorded():
                comm.broadcast(dirty, src=self.modifier_rank)
        for name, flag in zip(names, dirty.tolist()):
            if not flag:
                continue
            value = self._gathered[name].contiguous()
            if comm.get_world_size() > 1:
                with comm.unrecorded():
                    comm.broadcast(value, src=self.modifier_rank)
            eng.set_full_param(name, value)
        return False
