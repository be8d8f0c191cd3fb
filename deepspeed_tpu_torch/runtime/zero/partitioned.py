"""The training state of ZeRO stages 1-3 over several data-parallel ranks:
what the JAX package's GSPMD step does with its shardings, done with
explicit collectives on ``torch.distributed``.

Each parameter has three partitions (``partition.py``): its own
(``module_inject/tp_rules.py``: sharded at stage 3), its float32 master's
and moments' (stage >= 1) and its reduced gradient's (stage >= 2).  Rank r
keeps only its slice of each.  The step's arithmetic is the JAX step's,
which does not depend on the stage:

  * stage 1: the gradients are summed whole over the ranks (the float32
    wire of stage 0); each rank updates its slice of the master and the
    moments;
  * stage 2: each micro-batch's gradients are reduce-scattered in float32
    onto the slices and accumulated there, never summed whole;
  * stage 3: the compute-dtype parameters are slices too.  Each block of the
    model (an element of a ``ModuleList``, such as ``layers``; the rest of
    the model is one more unit, around the whole forward) is gathered by a
    forward pre-hook (``_GatherUnit``, an ``autograd.Function``: one
    all-gather of the block's slices) and released by the forward hook, so
    no whole weight outlives its block.  Under remat
    (``torch.utils.checkpoint``) the recompute gathers again; the
    function's backward reduce-scatters the block's gradients onto the
    slices (and releases what the recompute gathered).

Then, on the slices: ``found_inf`` is reduced with a sum of counts over the
ranks (a rank sees only its slices); the global norm is the sum of squares
over the slices, summed over the ranks, plus each whole tensor's once;
LAMB's trust ratio takes its norms per whole tensor (``lamb_norms``); the
optimizer updates the slices, and the new compute-dtype parameters are
all-gathered (stages 1-2) or cast in place (stage 3).  In float32 the
optimizer's tensors are views of the parameters (the JAX state has no
separate master there).

With ``offload_param`` (ZeRO-Infinity's parameter offload) the
compute-dtype slices live in host memory (pinned on CUDA, ``offload.HostArena``)
at any stage and world: the units are installed as at stage 3, and each
unit's gather first copies its slices in (one copy per unit and use, the
remat recompute included; ``h2d_copies`` counts them), then all-gathers the
sharded ones; on one rank the gather is the copy alone and the backward adds
the unit's gradients into the pending sums.

Expert parallelism (``moe.expert_parallel_size`` > 1): each rank's expert
banks are its E/ep experts, partitioned over the ranks that hold the same
experts, its expert-data-parallel group (``Partition.within_held``).  Their
gradients are reduced, and their slices gathered, inside that group; the
dense tensors' over the world.  The norms count each expert slice once:
the ranks that share a slice add it on the first of them only.  The state
is active at stage 0 too, to reduce the banks' gradients in their group.

Tensor parallelism (``tensor`` N > 1): each rank holds its tensor slices
(``held`` over ``tensor``) and the replicated tensors; both are
partitioned over the data-parallel group of the rank's tensor coordinate
(``Partition.within_held``, ``group="data"``), the state is active at
every stage, and the gradients are reduced and the slices gathered inside
that group.  The norms add each distinct slice once over every rank: a
tensor slice by the ranks that hold a distinct part of it, a replicated
tensor by the ranks of tensor coordinate 0 only.

Every collective of a step is one flat buffer per group of the tensors
concerned (``all_gather_parts``, ``reduce_scatter_parts``); bf16 and fp16
slices are gathered as their bit patterns, bit for bit.  The collectives are not
recorded into the CommsLogger (``comm.unrecorded``), as JAX logs its jitted
step.
"""

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ...comm import comm
from ...comm.mesh import EXPERT_AXIS, TENSOR_AXIS, get_global_mesh
from ...models.convert import jax_leaves
from ...module_inject.tp_rules import param_shardings
from ...utils import groups
from ..fp16.loss_scaler import found_inf_or_nan
from .mics import resolve_partition_axes
from .partition import Partition, grad_shardings, master_and_optstate_shardings


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """The contiguous ``t`` as its bytes: an all-gather moves bit patterns
    (gloo gathers no 16-bit floats)."""
    return t.view(-1).view(torch.uint8)


def all_gather_parts(parts: Sequence[Partition], local: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """The whole JAX-shaped tensors from the slices of ``group``'s ranks
    (``local``: this rank's, of one dtype; one sharded dim each, sliced in
    the group's rank order): one all-gather of the sharded ones; a whole
    tensor is returned as it is."""
    out: List[Optional[torch.Tensor]] = list(local)
    idx = [i for i, p in enumerate(parts) if p.sharded]
    if not idx:
        return out
    world = comm.get_world_size(group)
    flat = torch.cat([local[i].reshape(-1) for i in idx])
    full = flat.new_empty((world, flat.numel()))
    with comm.unrecorded():
        comm.all_gather_into_tensor(_bytes(full), _bytes(flat), group=group)
    off = 0
    for i in idx:
        p = parts[i]
        n = p.local_numel
        out[i] = full[:, off:off + n].reshape((world, ) + p.local_shape).movedim(0, p.dim).reshape(p.jax_shape)
        off += n
    return out


def reduce_scatter_parts(parts: Sequence[Partition], full: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """The sum over ``group``'s ranks of the JAX-shaped tensors ``full``
    (any float dtype, summed in float32), this rank's slice of each: one
    reduce-scatter of the sharded ones and one all-reduce of the whole ones."""
    world = comm.get_world_size(group)
    if world == 1:   # the host-sourced units of one rank: nothing to sum
        return [f.float() for f in full]
    out: List[Optional[torch.Tensor]] = [None] * len(parts)
    sharded = [i for i, p in enumerate(parts) if p.sharded]
    whole = [i for i, p in enumerate(parts) if not p.sharded]
    with comm.unrecorded():
        if sharded:
            total = sum(parts[i].local_numel for i in sharded)
            buf = full[sharded[0]].new_empty((world, total), dtype=torch.float32)
            off = 0
            for i in sharded:
                p, n = parts[i], parts[i].local_numel
                d = p.dim
                split = full[i].reshape(p.jax_shape[:d] + (world, p.jax_shape[d] // world) + p.jax_shape[d + 1:])
                buf[:, off:off + n].view((world, ) + p.local_shape).copy_(split.movedim(d, 0))
                off += n
            mine = buf.new_empty(total)
            comm.reduce_scatter_tensor(mine, buf.view(-1), group=group)
            off = 0
            for i in sharded:
                n = parts[i].local_numel
                out[i] = mine[off:off + n].view(parts[i].local_shape)
                off += n
        if whole:
            flat = torch.cat([full[i].reshape(-1).float() for i in whole])
            comm.all_reduce(flat, comm.ReduceOp.SUM, group=group)
            off = 0
            for i in whole:
                n = full[i].numel()
                out[i] = flat[off:off + n].view(parts[i].jax_shape)
                off += n
    return out


class _GatherUnit(torch.autograd.Function):
    """Forward: the unit's whole compute-dtype parameters from the ranks'
    slices.  Backward: their gradients reduce-scattered in float32 onto this
    rank's slices (added into the partitioned state's pending sums); the
    slices themselves get no ``.grad``."""

    @staticmethod
    def forward(ctx, unit, *shards):
        ctx.unit = unit
        return tuple(unit.gather(shards))

    @staticmethod
    def backward(ctx, *grads):
        ctx.unit.reduce(grads)
        ctx.unit.release()
        return (None, ) * (1 + len(grads))


class _Unit:
    """The parameters of one gathered unit (a block, or the rest of the
    model), and the module attributes they fill while gathered."""

    def __init__(self, zero: "PartitionedState", idxs: List[int], owners: List[Tuple[nn.Module, str]]):
        self.zero = zero
        self.idxs = idxs
        self.owners = owners

    def gather(self, shards) -> List[torch.Tensor]:
        z = self.zero
        parts = [z.param_parts[i] for i in self.idxs]
        if z.param_host:   # the slices live in host memory: copy them in first
            z.h2d_copies += 1
            shards = [s.to(z.device, non_blocking=True) for s in shards]
            full = z.per_group(all_gather_parts, parts, shards)
            return [p.port_view(f) for p, f in zip(parts, full)]
        full = z.per_group(all_gather_parts, parts, list(shards))
        return [p.port_view(f if p.sharded else f.clone()) for p, f in zip(parts, full)]

    def reduce(self, grads) -> None:
        z = self.zero
        parts = [z.grad_parts[i] for i in self.idxs]
        full = [p.jax_view(g.float()) for p, g in zip(parts, grads)]
        z.add_pending(self.idxs, z.per_group(reduce_scatter_parts, parts, full))

    def fill(self) -> None:
        shards = [self.zero.params[i] for i in self.idxs]
        full = _GatherUnit.apply(self, *shards)
        for (mod, attr), t in zip(self.owners, full):
            mod.__dict__[attr] = t

    def release(self) -> None:
        for mod, attr in self.owners:
            mod.__dict__[attr] = None


def _units(module: nn.Module) -> List[Tuple[str, nn.Module]]:
    """The gathered units of ``module``: each element of its outermost
    ``ModuleList``s, then the module itself (its remaining parameters)."""
    units: List[Tuple[str, nn.Module]] = []
    for name, mod in module.named_modules():
        if isinstance(mod, nn.ModuleList) and not any(name.startswith(u + ".") for u, _ in units):
            units.extend((f"{name}.{i}" if name else str(i), child) for i, child in enumerate(mod))
    return units + [("", module)]


class PartitionedState:
    """The partitions of a model's parameters for ZeRO ``stage`` over the
    process group, and the slices this rank keeps (see the module
    docstring).  ``active`` is False when nothing is sharded (no dim divides
    the world, or MiCS takes one rank): the engine then runs stage 0."""

    def __init__(self, module: nn.Module, names: Sequence[str], stage: int, zero_config, param_host: bool = False):
        mesh = get_global_mesh()
        self.stage = stage
        self.rank = comm.get_rank()
        #: per partition group: its process group and this rank's place in it
        self._groups = {None: (None, self.rank)}
        if mesh.shape.get(EXPERT_AXIS, 1) > 1:
            self._groups["expert_data"] = (groups.get_expert_data_parallel_group(),
                                           groups.get_expert_data_parallel_rank())
        #: the tensor degree and this rank's coordinate on it
        self.tp_size = mesh.shape.get(TENSOR_AXIS, 1)
        self.tp_rank = mesh.coords(self.rank)[TENSOR_AXIS]
        if self.tp_size > 1:
            self._groups["data"] = (groups.get_data_parallel_group(), groups.get_data_parallel_rank())
        #: offload_param: the compute-dtype slices live in host memory and
        #: each unit copies its own in (``_Unit.gather``); counted per copy
        self.param_host = param_host
        self.h2d_copies = 0
        #: the parameters are moved out of the module into gathered units
        #: (stage 3, or any stage with ``param_host``)
        self.units_on = stage >= 3 or param_host
        #: the reduced gradients accumulate in ``pending`` (stage 2
        #: reduce-scatters each micro-batch; units reduce in their backward)
        self.grads_pending = stage >= 2 or self.units_on
        self.device: Optional[torch.device] = None
        leaves = jax_leaves(module)
        param_axes, state_axes = resolve_partition_axes(mesh, zero_config, stage)
        params = param_shardings(leaves, mesh, stage, fsdp_axes=param_axes)
        state = master_and_optstate_shardings(params, mesh, stage, zero_axes=state_axes)
        grads = grad_shardings(params, mesh, stage, zero_axes=state_axes)
        self.names = list(names)
        #: the partitions of the port tensors (an expert bank's within its held experts)
        self.param_parts = [params[n].within_held() for n in self.names]
        self.state_parts = [state[n].within_held() for n in self.names]
        self.grad_parts = [grads[n].within_held() for n in self.names]
        #: per tensor: an expert bank of this rank's experts; a tensor slice
        self.held = [EXPERT_AXIS in params[n].held for n in self.names]
        self.tp_sliced = [TENSOR_AXIS in params[n].held for n in self.names]
        self.active = param_host or any(self.held) or self.tp_size > 1 or \
            any(p.sharded for p in self.state_parts + self.grad_parts + self.param_parts)
        self.params: List[torch.Tensor] = []
        self.targets: List[torch.Tensor] = []
        self.pending: Optional[List[torch.Tensor]] = None
        self.use_master = False
        self._units: List[_Unit] = []

    # ------------------------------------------------------------ set-up

    @torch.no_grad()
    def setup(self, module: nn.Module, params: Sequence[nn.Parameter], compute_dtype: torch.dtype,
              use_master: bool) -> Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]:
        """Take the module's (whole, replicated) float parameters: keep this
        rank's master slices, cast the parameters to ``compute_dtype`` and,
        at stage 3, replace them by their slices.  Returns ``(params,
        master, optimizer targets)``."""
        self.use_master = use_master
        self.device = params[0].device
        master = [self._local(sp, sp.jax_view(p.detach().float())).clone() for sp, p in zip(self.state_parts, params)] \
            if use_master else []
        for p in params:
            p.data = p.data.to(compute_dtype)
        if not self.units_on:
            self.params = list(params)
        else:
            slices = [self._local(pp, pp.jax_view(p.detach())) for pp, p in zip(self.param_parts, params)]
            if self.param_host:
                from .offload import HostArena
                self._param_arena = HostArena(sum(t.numel() for t in slices), compute_dtype,
                                              pin=self.device.type == "cuda")
                slices = [self._param_arena.take(t.shape).copy_(t) for t in slices]
            else:
                slices = [t.clone() for t in slices]
            self.params = [nn.Parameter(t, requires_grad=p.requires_grad) for t, p in zip(slices, params)]
            self._install_units(module)
        if use_master:
            self.targets = master
        else:
            self.targets = [self.own_view(i) for i in range(len(self.names))]
        return self.params, master, self.targets

    def own_view(self, i: int) -> torch.Tensor:
        """This rank's slice of parameter ``i`` under the state partition, a
        view of the parameter (float32 training: the optimizer's tensor)."""
        pp, sp, p = self.param_parts[i], self.state_parts[i], self.params[i]
        if pp.sharded:   # stage 3: the parameter is the slice
            return p.data
        return self._local(sp, sp.jax_view(p.data) if not self.units_on else p.data)

    # ------------------------------------------------------------ groups

    def _local(self, part: Partition, j: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the JAX-shaped ``j`` under ``part``."""
        return part.local(j, self._groups[part.group][1])

    def _by_group(self, parts: Sequence[Partition]):
        """The indices of ``parts`` by partition group, with the group's process group."""
        out = {}
        for i, p in enumerate(parts):
            out.setdefault(p.group, []).append(i)
        return [(self._groups[g][0], idx) for g, idx in out.items()]

    def per_group(self, fn, parts: Sequence[Partition], tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """``fn(parts, tensors, group)`` (``all_gather_parts`` or
        ``reduce_scatter_parts``) in each partition group; the results in
        the order of ``parts``."""
        out = list(tensors)
        for group, idx in self._by_group(parts):
            for i, f in zip(idx, fn([parts[i] for i in idx], [tensors[i] for i in idx], group)):
                out[i] = f
        return out

    def reduce_whole(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Stages 0-1: the whole gradients summed over the ranks, an expert
        bank's over its expert-data-parallel group (one all-reduce per group)."""
        full = self.per_group(reduce_scatter_parts, self.grad_parts,
                              [gp.jax_view(g) for gp, g in zip(self.grad_parts, grads)])
        return [gp.port_view(f) for gp, f in zip(self.grad_parts, full)]

    def _counted(self, parts: Sequence[Partition], sliced: Sequence[bool]) -> Tuple[List[bool], List[bool]]:
        """Per tensor: whether its norm is summed over the ranks, and
        whether this rank adds its value to that sum.  A dense tensor's
        slices are summed (a whole one counts once, locally); an expert
        bank's are summed over the world, each slice added by the first of
        the ranks that share it (its slices, ``sliced``, by every rank).  At
        ``tensor`` > 1 every tensor's is summed over the world: a slice of
        the partition group is added by every rank holding it, a whole one
        by the group's first rank, and a tensor replicated over the tensor
        axis by the ranks of tensor coordinate 0 only."""
        if self.tp_size > 1:
            adds = [(cut or self._groups[p.group][1] == 0) and (tp or self.tp_rank == 0)
                    for p, tp, cut in zip(parts, self.tp_sliced, sliced)]
            return [True] * len(parts), adds
        summed, adds = [], []
        for p, held, cut in zip(parts, self.held, sliced):
            summed.append(held or cut)
            adds.append(cut or not held or self._groups[p.group][1] == 0)
        return summed, adds

    def _install_units(self, module: nn.Module) -> None:
        """Move the parameters out of the module into the units that gather
        them, and hook each unit's forward."""
        index = {n: i for i, n in enumerate(self.names)}
        claimed = set()
        for prefix, mod in _units(module):
            idxs, owners = [], []
            for pname, _ in mod.named_parameters():
                name = f"{prefix}.{pname}" if prefix else pname
                if name in claimed or name not in index:
                    continue
                claimed.add(name)
                owner_name, _, attr = name.rpartition(".")
                owner = module.get_submodule(owner_name)
                idxs.append(index[name])
                owners.append((owner, attr))
            if not idxs:
                continue
            unit = _Unit(self, idxs, owners)
            for owner, attr in owners:
                del owner._parameters[attr]
            unit.release()
            mod.register_forward_pre_hook(lambda m, a, u=unit: u.fill())
            mod.register_forward_hook(lambda m, a, o, u=unit: u.release())
            self._units.append(unit)

    # ------------------------------------------------------------ gradients

    def add_pending(self, idxs: Sequence[int], slices: Sequence[torch.Tensor]) -> None:
        """Add reduced gradient slices into the step's float32 sums."""
        if self.pending is None:
            self.pending = [torch.zeros(g.local_shape, dtype=torch.float32, device=self.device)
                            for g in self.grad_parts]
        for i, s in zip(idxs, slices):
            self.pending[i].add_(s)

    def reduce_micro(self, grads: Sequence[Optional[torch.Tensor]], like: Sequence[torch.Tensor]) -> None:
        """Stage 2: one micro-batch's whole local gradients (port layout;
        None as zeros) reduce-scattered onto the slices; each is widened to
        float32 as it is copied into the group's buffer (no whole float32
        copy of the gradients)."""
        full = [gp.jax_view(g if g is not None else torch.zeros_like(p, dtype=torch.float32))
                for gp, g, p in zip(self.grad_parts, grads, like)]
        self.add_pending(range(len(full)), self.per_group(reduce_scatter_parts, self.grad_parts, full))

    def state_grads(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The reduced gradients on the optimizer's slices: stage 1 cuts
        them from the whole sums; from stage 2 they are the slices."""
        if self.stage >= 2:
            return list(grads)
        if self.units_on:   # whole sums, already in the JAX layout
            return [self._local(sp, g) for sp, g in zip(self.state_parts, grads)]
        return [self._local(sp, sp.jax_view(g)) for sp, g in zip(self.state_parts, grads)]

    def norm_and_found_inf(self, grads: Sequence[torch.Tensor],
                           check_inf: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The global norm of the reduced gradients (``grads`` in the
        gradient partition) and, with ``check_inf``, whether any value is
        not finite, the same on every rank."""
        summed, adds = self._counted(self.grad_parts, [self.stage >= 2 and p.sharded for p in self.grad_parts])
        sq = torch.stack(torch._foreach_norm([g.float() for g in grads])).square()
        sq = torch.where(torch.tensor(adds, device=sq.device), sq, torch.zeros_like(sq))
        mask = torch.tensor(summed, device=sq.device)
        local = torch.where(mask, sq, torch.zeros_like(sq)).sum()
        whole = torch.where(mask, torch.zeros_like(sq), sq).sum()
        inf = found_inf_or_nan(list(grads)).float() if check_inf else None
        if any(summed):
            vec = torch.stack([local, inf if inf is not None else torch.zeros_like(local)])
            with comm.unrecorded():
                comm.all_reduce(vec, comm.ReduceOp.SUM)
            local, inf = vec[0], (vec[1] if inf is not None else None)
        norm = (local + whole).sqrt()
        return norm, (None if inf is None else inf > 0)

    def lamb_norms(self, params: Sequence[torch.Tensor], w_norm: torch.Tensor,
                   u_norm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """LAMB's per-tensor norms of the parameter and the update, of the
        whole tensors: the squares of the sharded slices' norms summed over
        the ranks (one all-reduce)."""
        summed, adds = self._counted(self.state_parts, [sp.sharded for sp in self.state_parts])
        by_id = {id(t): i for i, t in enumerate(self.targets)}
        order = [by_id[id(p)] for p in params]
        if not any(summed[i] for i in order):
            return w_norm, u_norm
        mask = torch.tensor([summed[i] for i in order], device=w_norm.device)
        sq = torch.stack([w_norm, u_norm]).square()
        added = torch.where(torch.tensor([adds[i] for i in order], device=w_norm.device), sq, torch.zeros_like(sq))
        # the host optimizer tier's norms are on the host: the wire takes the device's
        red = torch.where(mask, added, torch.zeros_like(sq)).to(self.device)
        with comm.unrecorded():
            comm.all_reduce(red, comm.ReduceOp.SUM)
        sq = torch.where(mask, red.to(sq.device), sq).sqrt()
        return sq[0], sq[1]

    # ------------------------------------------------------------ parameters

    @torch.no_grad()
    def refresh_params(self, compute_dtype: torch.dtype) -> None:
        """The compute-dtype parameters from the updated optimizer slices:
        cast in place where the parameter is partitioned as its state, else
        all-gathered whole."""
        gather = [i for i in range(len(self.names)) if self.param_parts[i].spec != self.state_parts[i].spec]
        for i in range(len(self.names)):
            if i not in gather and self.use_master:
                self._param_jax(i).copy_(self.targets[i])
        if not gather:
            return
        local = [self.targets[i].to(device=self.device, dtype=compute_dtype) for i in gather]
        full = self.per_group(all_gather_parts, [self.state_parts[i] for i in gather], local)
        for i, f in zip(gather, full):
            self._param_jax(i).copy_(f)

    def _param_jax(self, i: int) -> torch.Tensor:
        """Parameter ``i`` as this rank holds it, JAX-shaped (a view)."""
        p = self.params[i].data
        return self.param_parts[i].jax_view(p) if not self.units_on else p

    def full_params(self, idxs: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
        """Whole compute-dtype parameters ``idxs`` (all by default), port
        layout (a collective at stage 3)."""
        idxs = range(len(self.names)) if idxs is None else idxs
        if not self.units_on:
            return [self.params[i].detach() for i in idxs]
        parts = [self.param_parts[i] for i in idxs]
        full = self.per_group(all_gather_parts, parts, [self.params[i].detach().to(self.device) for i in idxs])
        return [p.port_view(f).contiguous() for p, f in zip(parts, full)]

    def full_state(self, local: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Whole port-layout tensors from slices in the state partition
        (the master, a moment: one collective)."""
        full = self.per_group(all_gather_parts, self.state_parts, [t.detach().to(self.device) for t in local])
        return [p.port_view(f).contiguous() for p, f in zip(self.state_parts, full)]

    def local_state(self, i: int, full: torch.Tensor) -> torch.Tensor:
        """This rank's state slice of tensor ``i`` from its port-layout value
        (an expert bank: this rank's experts)."""
        sp = self.state_parts[i]
        return self._local(sp, sp.jax_view(full))

    @torch.no_grad()
    def set_full_param(self, i: int, value: torch.Tensor, master: bool = True) -> None:
        """Write the whole value of parameter ``i`` (port layout) into this
        rank's parameter (its slice at stage 3) and, with ``master``, its
        master slice."""
        pp = self.param_parts[i]
        own = self._local(pp, pp.jax_view(value)) if self.units_on else pp.jax_view(value)
        self._param_jax(i).copy_(own)
        if master and self.use_master:
            self.targets[i].copy_(self.local_state(i, value))
