"""The training engine (port of ``deepspeed_tpu/runtime/engine.py``
``DeepSpeedEngine``; ref: ``deepspeed/runtime/engine.py``).

The state is the model's parameters in the compute dtype, a float32
master copy when that dtype is not float32 (JAX ``TrainState``,
``engine.py:70-80``), the optimizer's moments and the loss-scaler state.
``train_batch`` runs one optimizer step over ``gradient_accumulation_steps``
contiguous micro-batches, with the arithmetic of the JAX step
(``_grads_for_batch`` :703, ``_apply_grads`` :742-848):

  1. per micro-batch, the backward of ``loss·scale`` against the compute-dtype
     parameters; the gradients are summed in float32;
  2. ``g·inv`` with ``inv = 1/gas`` (``1/(scale·gas)`` under a loss scale) and
     the predivide factor; ``found_inf`` (skipped on the static-unity
     bf16/f32 path, as in JAX :757-760); the global norm; clipping by
     ``min(1, clip/(norm + 1e-6))``;
  3. the optimizer on the float32 master; on overflow the master and the
     moments keep their values (``torch.where`` on the device, no host sync);
  4. the master recast into the compute-dtype parameters.

Data parallelism.  The ranks of the default process group are the JAX
mesh's ``data`` axis.  The state is replicated (ZeRO stage 0; rank 0's
parameters are broadcast at construction); ``train_batch`` takes the global
batch, and rank r differentiates its contiguous share of each micro-batch.
The gradients then become the mean over the ranks on one of two wires:

  * the float32 wire, what the JAX engine's GSPMD step computes: one token
    mean over the global micro-batch (JAX ``llama.py:535-537``).  Each rank
    divides its token sum by the global count (with a ``loss_mask``, one
    scalar all-reduce of the mask sum per micro-batch), and the gradients
    and the loss are summed over the ranks, one all-reduce per tensor;
  * the ZeRO++ quantized wire (``zero_quantized_gradients``), the JAX manual
    data-parallel step (``_build_compressed_train_step`` :944-1037), taken
    when ``_manual_ddp_eligible`` holds (stage 0, gas 1, no fp16, world > 1;
    otherwise a warning and the float32 wire): ``padded_quant_allreduce``
    of every gradient tensor (qgZ: int8 all-to-all reduce-scatter and int8
    all-gather), all of them in one grouped exchange
    (``GroupedQuantAllreduce``: 2 launches each of the grouped kernels
    K4a/K4b and 4 collectives a step, every tensor still padded apart), then
    ``_apply_grads`` with the norm ``sqrt(pmean(norm²))``.  With
    ``zeropp_loco_param`` (LoCo, JAX ``_maybe_loco_wrap`` :298-358) the
    local gradients are not clipped; the update quantizes each of them plus
    ``err_beta`` times its error state (one float32 tensor per parameter
    beside the moments) in the same grouped exchange, takes the pmean of the
    new error per tensor, and clips the reduced gradients.

The quantized wire carries each tensor in the JAX package's layout: flax
kernels are the transposes of ``nn.Linear`` weights, so the 256-element
blocks cover the same elements and every code and scale equals the JAX
engine's.  The returned loss is a device tensor: reading it is the caller's
sync.

ZeRO stages 1-3 on one rank are the single-device update, as JAX at
``data=1`` shards nothing.  Over several ranks they partition the state as
the JAX package's shardings do (``runtime/zero/partitioned.py``, a model
whose JAX leaves ``models/convert.jax_leaves`` knows: the Llama family,
Falcon, OPT, Phi, GPT-2): the master and the moments from stage 1, the reduced
gradients from stage 2 (reduce-scattered), the compute-dtype parameters at
stage 3 (gathered block by block around each block's forward, and again for
its remat recompute).  The arithmetic stays the JAX step's; the global
norm, ``found_inf`` and LAMB's norms are reduced over the slices.
``module_state_dict()`` and the checkpoints hold whole tensors whatever the
stage; a layout in which nothing shards (MiCS over one rank, no dim the
world divides) runs stage 0.

Offload (ZeRO-Offload and ZeRO-Infinity; JAX ``_materialize_state``
:501-600), by the JAX engine's rules (``_select_offload_tiers``):

  a. ``offload_optimizer: {device: cpu}``: the optimizer's float32 tensors
     and moments in pinned host memory, stepped on the host CPU
     (``runtime/zero/offload.py``; any optimizer, stage and world);
  b. ``{device: cpu, pipeline_read or pipeline_write: true}`` and
  c. ``{device: nvme, nvme_path: ...}``: the master and Adam's moments in
     host memory or in swap files, updated group by group on the device
     (``runtime/swap_tensor``; one rank, an Adam-family optimizer, static
     unity scaling, else a warning and tier a).  The forward and backward
     are dispatched, the first groups' state is prefetched under the
     backward, and the tier's loop updates the parameters in place; the
     imperative ``backward``/``step`` raise, as JAX's;
  d. ``offload_param: {device: cpu}``: the compute-dtype parameters in
     pinned host memory at any stage, copied in block by block by the
     stage-3 units of ``runtime/zero/partitioned.py``.

On the CPU host and device are one memory; the tiers run their whole path.

The CommsLogger sees the step as JAX logs its jitted step: the qgZ/LoCo
exchange as one ``all_to_all_quant_reduce`` entry per step, and none of
the collectives inside the step (``comm.unrecorded``).

Hooks, as in JAX: ``model_inputs_fn(batch) -> (args, kwargs)`` feeds the
model and ``loss_fn(outputs, batch)`` reduces its outputs to the loss
(defaults: ``input_ids`` (+ ``positions``, ``segment_ids``) and the
causal-LM token mean); a model that returns ``(logits, l_aux)``, as
``MixtralForCausalLM`` does, trains through its ``loss_fn``
(``make_mixtral_loss_fn``).  A ``loss_fn`` with a ``rank_share(outputs,
batch, denom, world, tp)`` (the default's and Mixtral's) gives at world > 1
each rank's share of JAX's loss over the global micro-batch (``denom`` the
global token count, ``tp`` the engine's ``TensorParallel``: the logits are
vocab-parallel over more than one tensor rank), and the shares are summed.  Any other custom loss
must equal the JAX GSPMD step's over the global micro-batch for any loss,
not only a mean: every rank gathers the micro-batch's outputs from all
ranks (``_GatherRows``) and evaluates ``loss_fn`` over them and the global
micro-batch, and the gradient comes back to each rank for its own rows.
The manual qgZ/LoCo step keeps per-rank losses, as JAX's manual step does.

MoE over several ranks (JAX ``engine.py:128-136``, ``moe/layer.py``): the
engine's mesh is ``data`` × ``expert`` (``moe.expert_parallel_size``;
``comm/mesh.py``), each rank one gating group of its rows.  With ``expert``
> 1 each ``MoE`` layer keeps its rank's experts (a model built whole is cut
here; ``MixtralForCausalLM(expert_parallel_size=)`` builds them so), the
dispatch crosses the expert group by all-to-all, the initial broadcast
sends each bank from the first rank of its expert-data group, and the
banks' gradients are summed in that group (``runtime/zero/partitioned.py``,
active at every stage then).  ``module_state_dict``, the master, the
moments and the checkpoints hold whole banks, gathered over the expert
group.  The qgZ/LoCo wire, MiCS/hpZ and the offload tiers with ``MoE``
layers over several ranks raise naming ROADMAP item 6.1.

Tensor parallelism (``tensor_parallel.autotp_size`` N > 1; JAX's mesh
``data`` × ``tensor``, or ``data`` × ``expert`` × ``tensor`` with MoE
layers, ``engine.py:128-136``): the model is the Llama family's
(``LlamaForCausalLM``, q/k/v biases included), ``MixtralForCausalLM``,
``Qwen2MoeForCausalLM``, ``FalconForCausalLM``, ``OPTForCausalLM`` or
``PhiForCausalLM``, cut to this rank's slices by the Megatron layout
(``module_inject/layers.py``; an expert bank on its ``expert_mlp`` dim; a
model built whole is cut here) and given its tensor group.  The rows of a
batch split over the data axis only (``dp_rank``/``dp_world`` are the data
coordinate and degree): the N ranks of a tensor group see the same rows.  The loss is vocab-parallel: the
engine hands its ``tp`` to the loss's ``rank_share``; the ranks of
a tensor group gate the same rows, so ``l_aux`` enters the loss once a
data group and ``exp_counts`` sums over the data-parallel group only.  At
expert × tensor an expert group is the ranks of one data and tensor
coordinate (N apart) and a bank, held over ``(expert, tensor)``, is
partitioned, reduced and broadcast within the ranks that share both
coordinates.  The loss, the token count and the gradients are summed over
the data-parallel group, the ranks of one tensor coordinate, by ``runtime/zero/partitioned.py`` at every stage (each
tensor a rank holds is partitioned within that group); the global norm sums
the squares of the tensor slices over the tensor group once and the
replicated tensors' once, and ``found_inf`` is taken over every rank.  The
initial broadcast sends the replicated tensors from rank 0 and each slice
from the first rank of its data-parallel group.  ``module_state_dict``,
the master, the moments and the checkpoints hold whole tensors, gathered
over the tensor group as well, so a checkpoint loads at any tensor degree.
The v1 families (GPT-2, BLOOM, GPT-NeoX, GPT-J, GPT-Neo), BERT and CLIP,
a custom loss without ``rank_share``, the qgZ/LoCo wire, MiCS/hpZ and the
offload tiers at ``tensor`` > 1 raise naming ROADMAP item 6.2.

``forward``, ``eval_batch`` and ``backward`` take the global micro-batch, as
``train_batch`` does, and return JAX's loss over all of it (its ``forward``
and ``backward``, ``engine.py:1381``/``:1394``): each rank computes its own
rows, and the shares of the token mean are summed over the ranks
(``_SumOverRanks``; a gathered custom loss is already the global one).  The
gradient stays the rank's share, which ``step()`` sums as ``train_batch``
does.

Also ported: the optimizers of the JAX engine's ``OPTIMIZER_FACTORIES``
(Adam/AdamW, LAMB, Lion, Adagrad, SGD; the 1-bit family raises),
progressive layer drop (the mask of the step that starts with ``n`` steps
taken is drawn from ``n`` alone, ``runtime/progressive_layer_drop.py``), the
synchronized timers of ``wall_clock_breakdown``, the monitor, ``eval_batch``,
the crash-safe ``save_checkpoint``/``load_checkpoint``
(``checkpoint/engine.py``), the flops profiler (``flops_profiler``: the step
at ``profile_step`` counted, printed and published through
``set_telemetry``'s registry), ``activation_checkpointing`` (the model's
remat policy), ``comms_logger``, ``offload_states``/``reload_states``,
``measure_stream_overlap`` and the universal checkpoint's loader
(``load_full_state``, ``checkpoint/universal.py``).
"""

import contextlib
import dataclasses
import math
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..accelerator import DeviceLike, resolve_device
from ..comm import comm
from ..comm.mesh import (EXPERT_AXIS, ROADMAP_EXPERT_PARALLEL, ROADMAP_MULTI_DEVICE, ROADMAP_TENSOR_PARALLEL,
                         TENSOR_AXIS, create_mesh, set_global_mesh)
from ..models.falcon import FalconForCausalLM
from ..models.llama import LlamaForCausalLM, causal_lm_loss
from ..models.mixtral import MixtralForCausalLM
from ..models.opt import OPTForCausalLM
from ..models.phi import PhiForCausalLM
from ..models.qwen2_moe import Qwen2MoeForCausalLM
from ..module_inject.layers import (NO_TENSOR_PARALLEL, TensorParallel, cut_tensor_parallel_, gather_dim,
                                    set_tensor_parallel_, slice_state, tensor_parallel_of, tp_dims)
from ..moe.layer import MoE
from ..utils import groups
from ..resilience import fault_injection
from ..telemetry.trace import NULL_TRACER
from ..ops.adagrad import SGD, Adagrad
from ..ops.adam import FusedAdam
from ..ops.lamb import FusedLamb
from ..ops.lion import FusedLion
from ..ops.optimizer import global_norm
from ..utils.logging import log_dist, logger
from ..utils.timer import (BACKWARD_GLOBAL_TIMER, FORWARD_GLOBAL_TIMER, STEP_GLOBAL_TIMER, TRAIN_BATCH_TIMER,
                           NoopTimer, SynchronizedWallClockTimer, ThroughputTimer)
from .comm.compressed import GroupedQuantAllreduce
from .config import ROADMAP_TRAINING_FEATURES, DeepSpeedConfig
from .constants import (ACTIVATION_CHECKPOINTING, ADAGRAD_OPTIMIZER, ADAM_OPTIMIZER, ADAMW_OPTIMIZER,
                        CPU_ADAM_OPTIMIZER, FUSED_ADAM_OPTIMIZER, FUSED_LAMB_OPTIMIZER, LAMB_OPTIMIZER,
                        LION_OPTIMIZER, ONEBIT_OPTIMIZERS, SGD_OPTIMIZER)
from .fp16.loss_scaler import StaticLossScaler, create_loss_scaler, found_inf_or_nan
from .lr_schedules import LRSchedulerShim, get_lr_schedule
from .progressive_layer_drop import ProgressiveLayerDrop, pld_scale_for_step
from .zero.offload import HostOffloadOptimizer
from .zero.partitioned import PartitionedState

#: the optimizers of the JAX engine's ``OPTIMIZER_FACTORIES`` (``engine.py:54-67``)
#: that the port builds; the 1-bit family raises (``ONEBIT_OPTIMIZERS``)
OPTIMIZER_FACTORIES = {
    ADAM_OPTIMIZER: FusedAdam,
    ADAMW_OPTIMIZER: FusedAdam,
    FUSED_ADAM_OPTIMIZER: FusedAdam,
    CPU_ADAM_OPTIMIZER: FusedAdam,
    LAMB_OPTIMIZER: FusedLamb,
    FUSED_LAMB_OPTIMIZER: FusedLamb,
    LION_OPTIMIZER: FusedLion,
    ADAGRAD_OPTIMIZER: Adagrad,
    SGD_OPTIMIZER: SGD,
}


def _leaf_map(module: nn.Module) -> Optional[Dict[str, dict]]:
    """Each parameter's JAX leaf, its port shape the whole tensor's (an
    expert bank's whole shape is its JAX leaf's)."""
    from ..axes import EXPERTS
    from ..models.convert import jax_leaves
    try:
        leaves = jax_leaves(module)
    except NotImplementedError:
        return None
    return {n: {"path": lf.path, "shape": list(lf.shape),
                "port_shape": list(lf.shape if EXPERTS in lf.logical else lf.whole_port_shape),
                "transposed": lf.transposed} for n, lf in leaves.items()}


def _default_model_inputs(batch):
    """The model's positional and keyword inputs from a micro-batch (JAX
    ``engine.py:91``): ``input_ids``, and ``positions``/``segment_ids`` when
    present."""
    kw = {}
    for k in ("positions", "segment_ids"):
        if k in batch:
            kw[k] = batch[k]
    return (batch["input_ids"], ), kw


def _default_loss_fn(outputs, batch):
    """The causal-LM token mean of ``labels`` (and ``loss_mask``) (JAX
    ``engine.py:99``).  The engine calls its ``rank_share``, with the global
    token count as the denominator on the float32 wire at world > 1 and its
    ``TensorParallel`` (vocab-parallel logits over more than one rank)."""
    if "labels" not in batch:
        raise KeyError("batch must contain 'labels' for the default causal-LM loss; "
                       "pass loss_fn= to initialize() for custom losses")
    return causal_lm_loss(outputs, batch["labels"], batch.get("loss_mask"))


_default_loss_fn.rank_share = lambda outputs, batch, denom, world, tp: causal_lm_loss(
    outputs, batch["labels"], batch.get("loss_mask"), denom, tp=tp)


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0 over the data-parallel ranks (``group``), in
    rank order.  The backward hands back this rank's rows of the gradient
    unreduced: every rank computes the same loss over the gathered rows, so
    each holds the whole gradient of the gathered tensor, and its rows of it
    are its share of the parameters' gradient (the float32 wire sums the
    shares)."""

    @staticmethod
    def forward(ctx, x, group):
        world, rank = comm.get_world_size(group), comm.get_rank(group)
        ctx.rows, ctx.rank = x.shape[0], rank
        out = x.new_empty((world * x.shape[0], ) + tuple(x.shape[1:]))
        with comm.unrecorded():
            comm.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


class _SumOverRanks(torch.autograd.Function):
    """The sum of a scalar over the data-parallel ranks (``group``).  The
    backward hands the gradient back unreduced: each rank's share of the
    loss is taken over its own rows, so its gradient is that rank's share
    of the parameters' gradient (the float32 wire sums the shares)."""

    @staticmethod
    def forward(ctx, x, group):
        with comm.unrecorded():
            return comm.all_reduce(x.detach().clone().reshape(1), comm.ReduceOp.SUM, group=group).reshape(())

    @staticmethod
    def backward(ctx, g):
        return g, None


class StepMetrics(NamedTuple):
    """Device tensors of one optimizer step (JAX ``StepMetrics``)."""
    loss: torch.Tensor
    grad_norm: torch.Tensor
    found_inf: torch.Tensor
    lr: float
    loss_scale: torch.Tensor


class DeepSpeedEngine:

    def __init__(self, model: nn.Module, config: DeepSpeedConfig, optimizer: Optional[Callable] = None,
                 lr_scheduler=None, params: Optional[Dict[str, torch.Tensor]] = None, device: DeviceLike = None,
                 loss_fn: Optional[Callable] = None, model_inputs_fn: Optional[Callable] = None):
        self.device = resolve_device(device)
        self._config = config
        self.loss_fn = loss_fn or _default_loss_fn
        self.model_inputs_fn = model_inputs_fn or _default_model_inputs
        self.zero_stage = config.zero_optimization_stage
        self.compute_dtype = config.precision_dtype
        self.gas = config.gradient_accumulation_steps
        # ---- the mesh (JAX engine.py:128-136), its expert and tensor groups
        world = comm.get_world_size()
        self.mesh = create_mesh(config.mesh_spec, world)
        set_global_mesh(self.mesh)
        self.ep = self.mesh.shape[EXPERT_AXIS]
        self.tp_size = self.mesh.shape[TENSOR_AXIS]
        #: the data coordinate and degree (the batch axes): the ranks of one
        #: tensor group share them
        self.dp_rank, self.dp_world = comm.get_rank() // self.tp_size, world // self.tp_size
        if self.dp_world != config.dp_world_size:
            raise ValueError(f"the config was resolved for {config.dp_world_size} data-parallel ranks, the process "
                             f"group has {self.dp_world}: create the process group first")
        self.moe_layers = [m for m in model.modules() if isinstance(m, MoE)]
        if self.tp_size > 1:
            self._check_tensor_parallel_features(model, loss_fn)
        self._check_moe_features()
        if self.ep > 1:
            groups.create_expert_groups()
        #: this rank's place on the tensor axis, and the data-parallel group
        #: its collectives run in (None: every rank, at tensor 1)
        self.tp, self.dp_group = NO_TENSOR_PARALLEL, None
        if self.tp_size > 1:
            groups.create_tensor_groups()
            self.tp = TensorParallel(self.tp_size, groups.get_tensor_model_parallel_rank(),
                                     groups.get_tensor_model_parallel_group())
            self.dp_group = groups.get_data_parallel_group()
            built = tensor_parallel_of(model)
            if built.size == 1:
                cut_tensor_parallel_(model, self.tp)
            elif built.rank != self.tp.rank:
                raise ValueError(f"the model holds the slices of tensor rank {built.rank}; this rank's tensor "
                                 f"coordinate is {self.tp.rank}")
            else:
                set_tensor_parallel_(model, self.tp)
        #: parameter name → the dim of the port tensor cut over the tensor axis
        self._tp_cut: Dict[str, int] = tp_dims(model) if self.tp_size > 1 else {}

        # ---- the comms logger and activation checkpointing (config blocks)
        comm.configure(deepspeed_config=config)
        self._configure_activation_checkpointing(model)

        # ---- state: compute-dtype params + f32 master (JAX TrainState)
        self.module = model.to(self.device)
        if params is not None:
            params = {k: torch.as_tensor(v) for k, v in params.items()}
            self.module.load_state_dict(self._local_experts(params), strict=True)
        self._setup_expert_parallel()
        if world > 1:
            self._broadcast_state()
        self.use_master = self.compute_dtype != torch.float32
        #: the module's state-dict names, in order (stage 3 moves the
        #: parameters out of the module)
        self._state_names = list(self.module.state_dict())
        named = [(n, p) for n, p in self.module.named_parameters() if p.is_floating_point()]
        #: the names of ``params`` (and of ``master``), in order
        self.param_names: List[str] = [n for n, _ in named]
        float_params = [p for _, p in named]
        #: each parameter's JAX leaf (path, shape, port shape, transposed):
        #: the universal checkpoint's names and layouts; None for a model
        #: ``models/convert.jax_leaves`` does not know
        self.jax_leaf_map = _leaf_map(self.module)
        # loss scaling first: the streamed offload tiers need static unity
        self.loss_scaler = create_loss_scaler(config.fp16_config, self.compute_dtype)
        self.scaler_state = self.loss_scaler.init_state(self.device)
        # fp16 keeps the overflow check even at a static scale of 1 (JAX :757)
        self.static_unity = isinstance(self.loss_scaler, StaticLossScaler) and \
            self.loss_scaler.init_scale == 1.0 and self.compute_dtype != torch.float16
        self._select_offload_tiers()
        #: the partitioned state of stages 1-3 over several ranks (or of
        #: offload_param at any stage), or None
        self.zero: Optional[PartitionedState] = None
        if self.dp_world > 1 and (self.zero_stage >= 1 or self.ep > 1) or self.param_host or self.tp_size > 1:
            zero = PartitionedState(self.module, self.param_names, self.zero_stage, config.zero_config,
                                    param_host=self.param_host)
            self.zero = zero if zero.active else None
        if self.zero is not None:
            #: the compute-dtype parameters (this rank's slices at stage 3),
            #: the float32 master (this rank's slices), and the tensors the
            #: optimizer updates (the master, or in float32 the parameters' slices)
            self.params, self.master, self._targets = self.zero.setup(self.module, float_params, self.compute_dtype,
                                                                      self.use_master and not self.streamed)
        elif self.streamed:
            # the master and the moments live in the streamed tier: the
            # device holds the compute-dtype parameters only
            with torch.no_grad():
                for p in float_params:
                    p.data = p.data.to(self.compute_dtype)
            self.params, self.master, self._targets = float_params, [], []
        else:
            with torch.no_grad():
                self.master: List[torch.Tensor] = [p.detach().float().clone() for p in float_params] \
                    if self.use_master else []
                for p in float_params:
                    p.data = p.data.to(self.compute_dtype)
            self.params: List[nn.Parameter] = float_params
            self._targets = self.master if self.use_master else self.params

        # ---- LR schedule, the offload tiers, optimizer
        self.lr_base, self.lr_schedule = self._build_lr_schedule(lr_scheduler)
        #: tier a: the optimizer's tensors in host memory, stepped on the host
        self._host_opt: Optional[HostOffloadOptimizer] = None
        #: tiers b and c: the streamed optimizer (JAX's ``_nvme_opt``), or None
        self._nvme_opt = None
        self._nvme_step_mode: Optional[str] = None
        if self.streamed:
            if optimizer is not None:
                raise ValueError("the streamed offload tiers run their own Adam: pass the optimizer in the config")
            self._build_streamed_tier()
            self.optimizer = None
        else:
            if self.host_optimizer:
                self._build_host_tier()
            self.optimizer = self._build_optimizer(optimizer)
            if self._host_opt is not None and hasattr(self.optimizer, "init_state"):
                self._host_opt.init_optimizer_state(self.optimizer)
        if self.zero is not None and hasattr(self.optimizer, "reduce_norms"):
            self.optimizer.reduce_norms = self.zero.lamb_norms   # LAMB's trust ratio per whole tensor
        self._configure_gradient_wire()
        if lr_scheduler is None or callable(lr_scheduler) and not hasattr(lr_scheduler, "step"):
            self.lr_scheduler = LRSchedulerShim(self.lr_schedule)
        else:
            self.lr_scheduler = lr_scheduler

        self.skipped = torch.zeros((), dtype=torch.int32, device=self.device)
        self.global_steps = 0
        self.global_samples = 0

        # ---- timers and monitor (JAX engine.py:161-165)
        self.timers = SynchronizedWallClockTimer(self.device) if config.wall_clock_breakdown else NoopTimer()
        self.tput_timer = ThroughputTimer(batch_size=config.train_batch_size,
                                          steps_per_output=config.steps_per_print, device=self.device)
        self.monitor = self._build_monitor()
        # ---- flops profiler (JAX engine.py:169-173)
        self.flops_profiler = None
        if config.flops_profiler_config.enabled:
            from ..profiling.flops_profiler import FlopsProfiler
            self.flops_profiler = FlopsProfiler(model=self.module, ds_engine=self,
                                                recompute_fwd_factor=config.flops_profiler_config.recompute_fwd_factor)
        # ---- telemetry (JAX engine.py:176-181): one engine/step trace a
        # train_batch with fwd_bwd/optim children, off until set_telemetry()
        self.tracer = NULL_TRACER
        self.metrics_registry = None

        # ---- progressive layer drop (JAX engine.py:189-195)
        self.progressive_layer_drop = None
        if config.pld_config.enabled:
            self.progressive_layer_drop = ProgressiveLayerDrop(theta=config.pld_config.theta,
                                                               gamma=config.pld_config.gamma)
        self._pld_scale: Optional[torch.Tensor] = None
        #: a custom loss without rank shares over the gathered micro-batch (float32 wire, world > 1)
        self._gather_loss = not hasattr(self.loss_fn, "rank_share") and self.dp_world > 1 and not self.qgz
        self.last_metrics: Optional[StepMetrics] = None
        self._pending: Optional[List[torch.Tensor]] = None
        self._pending_loss: Optional[torch.Tensor] = None
        self._micro_step_count = 0
        self._last_batch = None
        #: the last global batch ``train_batch`` took (``utils/tensor_fragment`` recomputes its gradients)
        self.last_batch = None
        n_params = sum(p.numel() for p in self.params) if self.zero is None else \
            sum(math.prod(pp.shape) for pp in self.zero.param_parts)
        log_dist(f"DeepSpeedEngine: device={self.device} zero_stage={self.zero_stage} dtype={self.compute_dtype} "
                 f"gas={self.gas} params={n_params / 1e6:.1f}M dp_world={self.dp_world} tensor={self.tp_size} "
                 f"partitioned={self.zero is not None} "
                 f"wire={'qgZ' if self.qgz else 'fp32'}{'+LoCo' if self.loco_error is not None else ''}",
                 ranks=[0])

    # ------------------------------------------------------------------ build

    def _check_moe_features(self) -> None:
        """What of MoE over several ranks is not ported raises naming
        ROADMAP item 6.1: the qgZ/LoCo wire (JAX's manual data-parallel
        step), MiCS/hpZ and the offload tiers, with MoE layers at world > 1."""
        if not self.moe_layers or self.dp_world == 1:
            return
        on = self._zero_wire_and_offload_features()
        if on:
            raise NotImplementedError(f"{', '.join(on)} with MoE layers over {self.dp_world} ranks is not ported "
                                      f"({ROADMAP_EXPERT_PARALLEL})")

    def _zero_wire_and_offload_features(self) -> List[str]:
        """The ``zero_optimization`` features set in the config that MoE over
        ranks and tensor parallelism do not take: the qgZ/LoCo wire,
        MiCS/hpZ, the offload blocks."""
        zc = self._config.zero_config
        off = [b for b in ("offload_optimizer", "offload_param")
               if getattr(zc, b) is not None and getattr(zc, b).device in ("cpu", "nvme")]
        named = {"zero_quantized_gradients": bool(zc.zero_quantized_gradients),
                 "zeropp_loco_param": zc.zeropp_loco_param is not None,
                 "mics_shard_size": (zc.mics_shard_size or -1) > 0,
                 "zero_hpz_partition_size": (zc.zero_hpz_partition_size or 1) > 1,
                 **{b: True for b in off}}
        return [k for k, v in named.items() if v]

    #: the models that train at ``tensor`` > 1
    TENSOR_PARALLEL_MODELS = (LlamaForCausalLM, MixtralForCausalLM, Qwen2MoeForCausalLM, FalconForCausalLM,
                              OPTForCausalLM, PhiForCausalLM)

    def _check_tensor_parallel_features(self, model: nn.Module, loss_fn) -> None:
        """What of tensor parallelism is not ported raises naming ROADMAP
        item 6.2: a model other than ``TENSOR_PARALLEL_MODELS`` (the v1
        families, BERT, CLIP), a custom loss without ``rank_share``, the
        qgZ/LoCo wire, MiCS/hpZ and the offload tiers."""
        what = []
        if type(model) not in self.TENSOR_PARALLEL_MODELS:
            names = ", ".join(c.__name__ for c in self.TENSOR_PARALLEL_MODELS)
            what.append(f"{type(model).__name__} (ported: {names})")
        if loss_fn is not None and not hasattr(loss_fn, "rank_share"):
            what.append("a custom loss_fn without rank_share (it would see vocab-parallel logits)")
        what += self._zero_wire_and_offload_features()
        if what:
            raise NotImplementedError(f"{', '.join(what)} at tensor_parallel.autotp_size {self.tp_size} is not "
                                      f"ported ({ROADMAP_TENSOR_PARALLEL})")

    def _setup_expert_parallel(self) -> None:
        """Cut whole expert banks to this rank's experts, and give every MoE
        layer its expert group and the ranks its counts sum over."""
        if self.ep > 1:
            e = self.mesh.coords(comm.get_rank())[EXPERT_AXIS]
            for m in self.moe_layers:
                if m.experts.ep_size == 1:
                    m.experts.shard_(self.ep, e)
                elif m.experts.ep_size != self.ep or m.experts.first_expert != e * m.experts.local_experts:
                    raise ValueError(f"an MoE layer built for {m.experts.ep_size} expert-parallel ranks (first expert "
                                     f"{m.experts.first_expert}) in an engine of moe.expert_parallel_size {self.ep}")
        elif any(m.experts.ep_size > 1 for m in self.moe_layers):
            raise ValueError("an MoE layer built for expert parallelism in an engine of moe.expert_parallel_size 1")
        group = groups.get_expert_parallel_group() if self.ep > 1 else None
        for m in self.moe_layers:
            m.set_expert_parallel(group, self.dp_world, self.dp_group)

    @torch.no_grad()
    def _broadcast_state(self) -> None:
        """Replicated state: every rank starts from rank 0's (ref:
        _broadcast_model); an expert bank from the first rank of its
        expert-data-parallel group (its expert coordinate), in that group;
        a tensor slice from the first rank of its data-parallel group (its
        tensor coordinate), in that group."""
        banks = self._banks
        ed_group = groups.get_expert_data_parallel_group() if banks else None
        ed_world = comm.get_world_size(ed_group) if banks else 1
        at = self.mesh.coords(comm.get_rank())
        # the first rank of a bank's expert-data group: data 0 at its expert and tensor coordinates
        bank_src = self.mesh.rank({EXPERT_AXIS: at[EXPERT_AXIS], TENSOR_AXIS: at[TENSOR_AXIS]})
        for name, t in self.module.state_dict().items():
            if name in banks:
                if ed_world > 1:
                    comm.broadcast(t, bank_src, group=ed_group)
            elif name in self._tp_cut:
                if self.dp_world > 1:
                    comm.broadcast(t, self.tp.rank, group=self.dp_group)
            else:
                comm.broadcast(t, 0)

    @property
    def _banks(self) -> Dict[str, MoE]:
        """Parameter name → the MoE layer of each expert bank that holds
        this rank's experts only."""
        return {f"{name}.experts.{w}": m for name, m in self.module.named_modules()
                if isinstance(m, MoE) and m.experts.ep_size > 1 for w in m.experts.WEIGHTS}

    def _local_experts(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Whole tensors by name with each expert bank cut to this rank's
        experts and each tensor slice to this rank's slice."""
        out = dict(tensors)
        for name, m in self._banks.items():
            if name in out:
                out[name] = out[name].narrow(0, m.experts.first_expert, m.experts.local_experts)
        return slice_state(out, self._tp_cut, self.tp)

    def _whole_experts(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Tensors by name with each expert bank gathered whole over its
        expert group and each tensor slice over its tensor group (a
        collective on every rank)."""
        tensors = self._whole_tensor_slices(tensors)
        banks = self._banks
        names = [n for n in tensors if n in banks]
        if not names:
            return tensors
        out = dict(tensors)
        group = groups.get_expert_parallel_group()
        for n in names:
            local = tensors[n].detach().contiguous()
            whole = local.new_empty((self.ep * local.shape[0], ) + tuple(local.shape[1:]))
            with comm.unrecorded():
                comm.all_gather_into_tensor(whole.view(-1).view(torch.uint8), local.view(-1).view(torch.uint8),
                                            group=group)
            out[n] = whole
        return out

    def _whole_tensor_slices(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Tensors by name with each tensor slice gathered whole over the
        tensor group, in rank order along its cut dim (bits moved as bytes)."""
        names = [n for n in tensors if n in self._tp_cut]
        if not names:
            return tensors
        out = dict(tensors)
        for n in names:
            out[n] = gather_dim(tensors[n].detach(), self.tp, self._tp_cut[n])
        return out

    def _configure_activation_checkpointing(self, model: nn.Module) -> None:
        """An ``activation_checkpointing`` block turns the model's per-block
        remat on under the block's policy (``checkpointing.policy_from_config``,
        JAX ``_policy_from_config``): the model's config gains ``remat=True``
        and that ``remat_policy``."""
        if ACTIVATION_CHECKPOINTING not in self._config._param_dict:
            return
        from .activation_checkpointing import checkpointing
        checkpointing.configure(deepspeed_config=self._config)
        cfg = getattr(model, "cfg", None)
        if cfg is None or not dataclasses.is_dataclass(cfg) or not hasattr(cfg, "remat_policy"):
            logger.warning("activation_checkpointing: the model's config has no remat_policy; checkpoint its "
                           "blocks with runtime.activation_checkpointing.checkpointing.checkpoint")
            return
        policy = checkpointing.policy_from_config(self._config.activation_checkpointing_config)
        model.cfg = dataclasses.replace(cfg, remat=True, remat_policy=policy)

    def _build_lr_schedule(self, client_scheduler):
        cfg = self._config
        base_lr = 1e-3
        if cfg.optimizer_config is not None:
            base_lr = cfg.optimizer_config.params.get("lr", 1e-3)
        if client_scheduler is not None and callable(client_scheduler) and not hasattr(client_scheduler, "step"):
            return base_lr, client_scheduler
        if cfg.scheduler_config is not None and cfg.scheduler_config.type:
            return base_lr, get_lr_schedule(cfg.scheduler_config.type, cfg.scheduler_config.params, base_lr)
        return base_lr, (lambda step: base_lr)

    def _build_optimizer(self, client_optimizer):
        target = self._targets
        if client_optimizer is not None:
            if isinstance(client_optimizer, torch.optim.Optimizer) or not callable(client_optimizer):
                raise TypeError("optimizer= must be a factory params -> torch.optim.Optimizer: the engine builds "
                                "it over the float32 master parameters it owns")
            return client_optimizer(target)
        factory, params = self._optimizer_spec()
        return factory(target, lr=self.lr_schedule, **params)

    def _optimizer_spec(self):
        """The config's optimizer: its class and keyword arguments but the LR."""
        cfg = self._config.optimizer_config
        name = (cfg.type or "adamw").lower() if cfg is not None else "adamw"
        params = dict(cfg.params) if cfg is not None else {}
        params.pop("lr", None)
        params.pop("torch_adam", None)
        if name in ONEBIT_OPTIMIZERS:
            raise NotImplementedError(f"optimizer {cfg.type} is not ported ({ROADMAP_TRAINING_FEATURES})")
        if name not in OPTIMIZER_FACTORIES:
            raise ValueError(f"Unknown optimizer {cfg.type}; known: "
                             f"{sorted(list(OPTIMIZER_FACTORIES) + list(ONEBIT_OPTIMIZERS))}")
        if name == ADAMW_OPTIMIZER:
            params.setdefault("weight_decay", 0.01)   # JAX adamw() default
            params["adam_w_mode"] = True
        elif OPTIMIZER_FACTORIES[name] is FusedAdam:
            params.setdefault("adam_w_mode", True)    # the reference's FusedAdam flag
        return OPTIMIZER_FACTORIES[name], params

    def _build_monitor(self):
        """The MonitorMaster of the config's monitor blocks, attached to the
        ``resilience/*`` event bus when enabled (JAX ``engine.py:423-436``);
        None if it cannot be built (a monitor must never break training)."""
        try:
            from ..monitor.monitor import MonitorMaster
            monitor = MonitorMaster(self._config.monitor_config)
            if monitor.enabled:
                from ..resilience import events as res_events
                res_events.attach_monitor(monitor)
            return monitor
        except Exception as e:
            logger.debug(f"monitor disabled: {e}")
            return None

    # ------------------------------------------------------------ offload

    def _streamed_offload_ok(self, what: str) -> bool:
        """JAX ``_streamed_offload_ok`` (:360-378): the streamed tiers need
        one data-parallel rank, an Adam-family optimizer and static unity
        scaling that is not fp16; otherwise a warning and the host tier."""
        cfg = self._config.optimizer_config
        name = (cfg.type or "").lower() if cfg is not None else ADAMW_OPTIMIZER
        ok = (self.dp_world == 1 and name in (ADAM_OPTIMIZER, ADAMW_OPTIMIZER, FUSED_ADAM_OPTIMIZER, CPU_ADAM_OPTIMIZER)
              and self.static_unity)
        if not ok:
            logger.warning(f"offload_optimizer {what}: the streamed update needs a single data-parallel rank, an "
                           "Adam-family optimizer and non-fp16 static-unity scaling — falling back to the host "
                           "optimizer tier")
        return ok

    def _select_offload_tiers(self) -> None:
        """Which offload tiers run, by JAX's rules (``_nvme_pipelined_active``
        :380, ``_host_streamed_active`` :390, ``_materialize_state``
        :552-567): ``nvme`` with an ``nvme_path`` is the NVMe tier, ``cpu``
        with ``pipeline_read``/``pipeline_write`` the host-streamed tier
        (both if eligible), any other ``cpu``/``nvme`` the host-optimizer
        tier; ``offload_param`` to ``cpu`` or ``nvme`` keeps the parameters in
        host memory (JAX keeps both in host memory)."""
        zc = self._config.zero_config
        off = zc.offload_optimizer
        device = off.device if off is not None else "none"
        self.nvme_tier = device == "nvme" and bool(off.nvme_path) and self._streamed_offload_ok("device=nvme")
        self.host_stream_tier = not self.nvme_tier and device == "cpu" and \
            (off.pipeline_read or off.pipeline_write) and self._streamed_offload_ok("device=cpu pipelined")
        self.streamed = self.nvme_tier or self.host_stream_tier
        self.host_optimizer = device in ("cpu", "nvme") and not self.streamed
        p_off = zc.offload_param
        self.param_host = p_off is not None and p_off.device in ("cpu", "nvme")
        if self.param_host and p_off.device == "nvme":
            logger.warning("offload_param device=nvme: the parameters live in host memory, as in the JAX engine")
        if self.param_host and not self.use_master and not self.streamed:
            # the optimizer's tensors are the parameters themselves: where
            # they live, the update runs (and its moments with it)
            self.host_optimizer = True

    def _build_host_tier(self) -> None:
        """Tier a: the optimizer's float32 tensors copied into host memory
        (``runtime/zero/offload.py``); the device master is dropped."""
        if self.zero is not None:   # a partitioned master refreshes the parameters itself
            writeback = [None if self.use_master else t for t in self._targets]
        else:
            writeback = [p.data for p in self.params]
        self._host_opt = HostOffloadOptimizer(self._targets, writeback, self.device)
        if self.use_master:
            self.master = self._host_opt.host
        if self.zero is not None:   # the tensors the optimizer steps (LAMB's norms are keyed by them)
            self.zero.targets = self._host_opt.host
        self._targets = self._host_opt.host
        log_dist(f"offload_optimizer: the optimizer's state in host memory ({self._host_opt.arena.nbytes / 1e9:.2f} "
                 f"GB of float32 tensors, pinned={self._host_opt.pin}), stepped on the host", ranks=[0])

    def _build_streamed_tier(self) -> None:
        """Tiers b and c over the compute-dtype parameters; their float32
        master starts as those parameters (JAX builds it from
        ``state.params``, already cast), or resumes from matching swap files."""
        from ..ops.adam import adam_hyper
        from .swap_tensor.host_streamed_optimizer import HostStreamedOptimizer
        from .swap_tensor.pipelined_optimizer_swapper import PipelinedNVMeOptimizer
        _, kwargs = self._optimizer_spec()
        hyper = adam_hyper(lr=self.lr_schedule, **kwargs)
        params = [p.data for p in self.params]
        off = self._config.zero_config.offload_optimizer
        if self.nvme_tier:
            self._nvme_opt = PipelinedNVMeOptimizer(hyper, params, off.nvme_path, compute_dtype=self.compute_dtype)
        else:
            self._nvme_opt = HostStreamedOptimizer(hyper, params, n_groups=max(1, off.buffer_count),
                                                   compute_dtype=self.compute_dtype)

    def _manual_ddp_eligible(self) -> bool:
        """The JAX engine's condition for its manual data-parallel step
        (``engine.py:915-922``): a data axis larger than 1 (every other axis
        is 1 here), ZeRO stage 0, gas 1 and no fp16."""
        return self.dp_world > 1 and self.zero_stage == 0 and self.gas == 1 and self.compute_dtype != torch.float16

    def _configure_gradient_wire(self) -> None:
        """Decide once which wire the gradients take (JAX ``_qgz_active``
        :924-942 and ``_maybe_loco_wrap`` :310-323, with their warnings),
        and for qgZ the bytes it moves per step (``:1016-1026``)."""
        zc = self._config.zero_config
        self.qgz = bool(zc.zero_quantized_gradients) and self._manual_ddp_eligible()
        if zc.zero_quantized_gradients and not self.qgz:
            logger.warning("zero_quantized_gradients needs a pure-DP mesh, zero stage 0, gas=1 and non-fp16 "
                           "compute — gradients stay on the fp32 wire")
        loco = zc.zeropp_loco_param
        if loco is not None and not self.qgz:
            logger.warning("zeropp_loco_param set but LoCo transport needs zero_quantized_gradients plus the "
                           "manual-DDP requirements (pure-DP mesh, stage 0, gas=1, non-fp16) — ignored")
        # the quantized wire carries nn.Linear weights transposed, in the JAX
        # package's [in, out] kernel layout (see the module docstring)
        linear = {id(m.weight) for m in self.module.modules() if isinstance(m, nn.Linear)}
        self._wire_transposed = [id(p) in linear for p in self.params]
        self.loco_beta = loco["err_beta"] if loco is not None and self.qgz else None
        #: LoCo's error state, one float32 tensor per parameter in the wire's layout
        self.loco_error: Optional[List[torch.Tensor]] = None
        if self.loco_beta is not None:
            self.loco_error = [torch.zeros_like(self._to_wire(p, t), dtype=torch.float32)
                               for p, t in zip(self.params, self._wire_transposed)]
            log_dist(f"ZeRO++ LoCo gradient transport active (err_beta={self.loco_beta})", ranks=[0])
        #: the grouped exchange of the step's gradients in the wire's layout;
        #: its input is the compute dtype (LoCo: float32, as JAX feeds it)
        self._wire: Optional[GroupedQuantAllreduce] = None
        if self.qgz:
            shapes = [self._to_wire(p, t).shape for p, t in zip(self.params, self._wire_transposed)]
            self._wire = GroupedQuantAllreduce(shapes, torch.float32 if self.loco_beta is not None else
                                               self.compute_dtype, self.device)
        # per direction: every code row of the table (each tensor padded to
        # world·block) and its float32 scale
        self._compressed_wire_bytes = 0
        if self.qgz:
            table = self._wire.table
            self._compressed_wire_bytes = 2 * table.rows * (table.block + 4)

    @staticmethod
    def _to_wire(t: torch.Tensor, transposed: bool) -> torch.Tensor:
        return t.t() if transposed else t

    # ---------------------------------------------------------------- batches

    def _to_device(self, batch):
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
            out[k] = t.to(self.device)
        return out

    def _microbatch_loss(self, mb, training: bool = False, global_mb=None) -> torch.Tensor:
        """The loss of one micro-batch (JAX ``_microbatch_loss`` :659): the
        model on ``model_inputs_fn(mb)`` (with this step's PLD gate when
        training), then ``loss_fn``: its ``rank_share`` where it has one (the
        rank's share of the loss over the global micro-batch on the float32
        wire at world > 1); otherwise a custom one sees the gathered
        outputs when ``global_mb`` is given."""
        args, kwargs = self.model_inputs_fn(mb)
        if training and self.progressive_layer_drop is not None and getattr(self.module, "supports_pld", False):
            kwargs["pld_scale"] = self._pld_scale
        outputs = self.module(*args, **kwargs)
        if self.loss_fn is _default_loss_fn and "labels" not in mb:
            raise KeyError("batch must contain 'labels' for the default causal-LM loss; "
                           "pass loss_fn= to initialize() for custom losses")
        share = getattr(self.loss_fn, "rank_share", None)
        if share is not None:
            per_rank = training and self.qgz
            return share(outputs, mb, self._global_token_count(mb, per_rank=per_rank),
                         1 if per_rank else self.dp_world, self.tp)
        if global_mb is not None:
            if not isinstance(outputs, torch.Tensor):
                raise NotImplementedError("a custom loss_fn over several data-parallel ranks gathers the model's "
                                          f"output, which must be one tensor ({ROADMAP_MULTI_DEVICE})")
            return self.loss_fn(_GatherRows.apply(outputs, self.dp_group), global_mb)
        return self.loss_fn(outputs, mb)

    def _step_pld_scale(self) -> None:
        """The PLD gate of the step that starts now (JAX draws it at the
        state's step, before the increment): drawn on the CPU, copied once."""
        if self.progressive_layer_drop is None:
            return
        scale = pld_scale_for_step(self.progressive_layer_drop, self.module.cfg.num_hidden_layers,
                                   self.global_steps)
        self._pld_scale = scale.to(self.device)

    def _global_token_count(self, mb, per_rank: bool = False) -> Optional[torch.Tensor]:
        """The denominator of the token mean at world > 1: the tokens
        (masked-in tokens, at least 1) of the whole micro-batch over all
        ranks, so that the summed per-rank losses are JAX's one mean.  None
        on one rank and with ``per_rank`` (the manual qgZ/LoCo step, which
        keeps per-device means as JAX's manual step does)."""
        if self.dp_world == 1 or per_rank:
            return None
        mask = mb.get("loss_mask")
        if mask is None:   # every rank holds as many tokens: no collective
            return torch.tensor(float(mb["labels"].numel() * self.dp_world), device=self.device)
        with comm.unrecorded():
            count = comm.all_reduce(mask.float().sum().reshape(1), comm.ReduceOp.SUM, group=self.dp_group)
        return count.reshape(()).clamp_min(1.0)

    def _backward_micro(self, mb, global_mb=None) -> torch.Tensor:
        """One micro-batch: backward of ``loss·scale``, grads added in float32
        into the pending sums.  Returns the (unscaled) loss."""
        for p in self.params:
            p.grad = None
        loss = self._microbatch_loss(mb, training=True, global_mb=global_mb)
        self._accumulate(loss)
        return loss.detach()

    def _accumulate(self, loss: torch.Tensor) -> None:
        (loss * self.scaler_state.cur_scale).float().backward()
        if self.zero is not None and self.zero.grads_pending:
            # the units' backward reduced their gradients block by block
            if not self.zero.units_on:
                self.zero.reduce_micro([p.grad for p in self.params], self.params)
            for p in self.params:
                p.grad = None
            self._pending = self.zero.pending
            return
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if self._pending is None:
            self._pending = [g.float() for g in grads]
        else:
            torch._foreach_add_(self._pending, [g.float() for g in grads])
        for p in self.params:
            p.grad = None

    def _rank_micro_batch(self, batch, i: int, ranks: Optional[int] = None, gas: Optional[int] = None):
        """Micro-batch ``i`` of the global batch (its rows ``[i·B/gas,
        (i+1)·B/gas)``, as JAX splits it) and, of those, this rank's
        contiguous share (JAX shards dim 0 over ``data``); with ``ranks=
        dp_world``, the shares of every rank (the whole micro-batch).
        ``gas=1`` takes ``batch`` as one global micro-batch."""
        gas = self.gas if gas is None else gas
        out = {}
        for k, v in batch.items():
            if v.dim() == 0:
                out[k] = v
                continue
            rows, rem = divmod(v.shape[0], gas * self.dp_world)
            if (rem or not rows) and self.moe_layers and self.dp_world > 1:
                # JAX gates such a micro-batch as one group across its devices
                raise NotImplementedError(f"batch[{k!r}] has {v.shape[0]} rows, not a multiple of gas {gas} × "
                                          f"{self.dp_world} ranks: JAX gates it as one group, the port gates each "
                                          f"rank's rows as one group ({ROADMAP_EXPERT_PARALLEL})")
            if rem or not rows:
                raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows: not a multiple of gas {gas} × "
                                 f"{self.dp_world} data-parallel ranks")
            if ranks is None:
                start, take = (i * self.dp_world + self.dp_rank) * rows, rows
            else:
                start, take = i * self.dp_world * rows, ranks * rows
            out[k] = v[start:start + take]
        return out

    # ------------------------------------------------------------------ the wire

    @contextlib.contextmanager
    def _timed_wire(self):
        """Record the qgZ exchange into the CommsLogger (JAX :1315-1324)
        with its bytes and its host time, on every step but the first
        (which loads the kernels).  While the logger is on, the exchange is
        fenced with synchronizes so the time is its own."""
        timed = comm.comms_logger() is not None and self.global_steps > 0
        cuda = self.device.type == "cuda"
        if timed and cuda:
            torch.cuda.synchronize(self.device)
        t0 = time.time()
        with comm.unrecorded():   # one entry for the exchange, not one per collective
            yield
        if timed:
            if cuda:
                torch.cuda.synchronize(self.device)
            comm._record("all_to_all_quant_reduce", t0, self._compressed_wire_bytes)

    def _reduce_over_ranks(self, grads: List[torch.Tensor], loss: torch.Tensor, reduce_loss: bool = True):
        """The gradients and the loss over the data-parallel ranks: sums of
        the per-rank shares of the global token mean on the float32 wire,
        means of the per-rank means on the manual qgZ/LoCo step (unchanged on
        one rank; under LoCo the gradients stay local here and the update
        reduces them).  ``reduce_loss=False``: ``loss`` is the global one
        already."""
        if self.dp_world == 1:
            return grads, loss
        op = comm.ReduceOp.AVG if self.qgz else comm.ReduceOp.SUM
        with comm.unrecorded():
            if reduce_loss:
                loss = comm.all_reduce(loss.reshape(1), op, group=self.dp_group).reshape(())
            if self.zero is not None and self.zero.grads_pending:   # reduced already
                return grads, loss
            if self.zero is not None and (any(self.zero.held) or self.tp_size > 1):
                # a bank's in its expert-data group, a tensor's in its data-parallel group
                return self.zero.reduce_whole(grads), loss
            if not self.qgz:
                return [comm.all_reduce(g, op) for g in grads], loss
        if self.loco_error is not None:
            return grads, loss
        # qgZ (JAX :981-987): the wire takes each gradient in the compute
        # dtype and gives it back in that dtype (widened to float32 here)
        with self._timed_wire():
            full = self._wire([self._to_wire(g, t) for g, t in zip(grads, self._wire_transposed)])
            out = [self._to_wire(f, t).contiguous() for f, t in zip(full, self._wire_transposed)]
        return out, loss

    def _loco_reduce(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """LoCo (JAX ``_maybe_loco_wrap`` :332-355): each local gradient plus
        ``err_beta`` times its error goes on the qgZ wire; the new error
        state is the pmean of what the wire lost; the reduced gradients are
        clipped by their own global norm."""
        with self._timed_wire():
            full, err = self._wire([self._to_wire(g, t) for g, t in zip(grads, self._wire_transposed)],
                                   errors=self.loco_error, err_beta=self.loco_beta)
            self.loco_error = [comm.all_reduce(e, comm.ReduceOp.AVG) for e in err]
            out = [self._to_wire(f, t).contiguous() for f, t in zip(full, self._wire_transposed)]
        clip = self._config.gradient_clipping
        if clip and clip > 0:
            torch._foreach_mul_(out, torch.clamp(clip / (global_norm(out) + 1e-6), max=1.0))
        return out

    # ------------------------------------------------------------------ update

    @torch.no_grad()
    def _apply_grads(self, grads: List[torch.Tensor], loss: torch.Tensor) -> StepMetrics:
        cfg = self._config
        scale = self.scaler_state.cur_scale
        inv = 1.0 / self.gas if self.static_unity else 1.0 / (scale * self.gas)
        if cfg.gradient_predivide_factor != 1.0:
            inv = inv / cfg.gradient_predivide_factor
        torch._foreach_mul_(grads, inv)
        if self.zero is not None:
            grad_norm, found_inf = self.zero.norm_and_found_inf(grads, check_inf=not self.static_unity)
        else:
            found_inf = None if self.static_unity else found_inf_or_nan(grads)
            grad_norm = global_norm(grads)
        if self.qgz:
            # per-rank values in the manual step (JAX :795-802): reduce so
            # that every rank clips with the same scale
            with comm.unrecorded():
                grad_norm = comm.all_reduce(grad_norm.square().reshape(1), comm.ReduceOp.AVG).sqrt().reshape(())
                if found_inf is not None:
                    found_inf = comm.all_reduce(found_inf.int().reshape(1), comm.ReduceOp.MAX).reshape(()).bool()
        if self.loco_error is not None:
            grads = self._loco_reduce(grads)   # clips the reduced gradients itself
        elif cfg.gradient_clipping and cfg.gradient_clipping > 0:
            clip_scale = torch.clamp(cfg.gradient_clipping / (grad_norm + 1e-6), max=1.0)
            torch._foreach_mul_(grads, clip_scale)
        if self.zero is not None:
            grads = self.zero.state_grads(grads)
        if self._host_opt is not None:   # tier a: the gradients to the host, the step there, the values back
            self._host_opt.step(self.optimizer, grads, found_inf)
        else:
            for t, g in zip(self._targets, grads):
                t.grad = g
            if found_inf is None:
                self.optimizer.step()
            else:
                self.optimizer.step(found_inf=found_inf)
            for t in self._targets:
                t.grad = None
        if self.zero is not None:
            self.zero.refresh_params(self.compute_dtype)
        elif self.use_master and self._host_opt is None:
            torch._foreach_copy_([p.data for p in self.params], self.master)
        self.scaler_state = self.loss_scaler.update(self.scaler_state, found_inf)
        if found_inf is None:
            found_inf = torch.zeros((), dtype=torch.bool, device=self.device)
        self.skipped += found_inf.int()
        self.global_steps += 1
        self.global_samples += cfg.train_batch_size
        metrics = StepMetrics(loss=loss.float(), grad_norm=grad_norm, found_inf=found_inf,
                              lr=float(self.lr_schedule(self.global_steps)), loss_scale=scale)
        self.last_metrics = metrics
        spp = cfg.steps_per_print
        if spp and self.global_steps % spp == 0:
            log_dist(f"step={self.global_steps} loss={float(metrics.loss):.4f} lr={metrics.lr:.3e} "
                     f"gnorm={float(grad_norm):.3f} scale={float(scale):.0f} skipped={self.skipped_steps}",
                     ranks=[0])
        return metrics

    # ------------------------------------------------------------- public API

    def train_batch(self, data_iter=None, batch=None) -> torch.Tensor:
        """One optimizer step over ``gas`` contiguous micro-batches (JAX
        ``engine.py:1274``): ``batch`` is the global batch, or ``data_iter``
        yields its ``gas`` global micro-batches (``DeepSpeedDataLoader``).
        Returns the mean loss as a device tensor."""
        if batch is None:
            if data_iter is None:
                raise ValueError("provide data_iter or batch")
            micro = [next(data_iter) for _ in range(self.gas)]
            batch = {k: np.concatenate([np.asarray(m[k]) for m in micro]) for k in micro[0]} \
                if self.gas > 1 else micro[0]
        self.last_batch = batch = self._to_device(batch)
        # the chaos site around the step (JAX :1290): one ``is None`` test
        # when no plan is armed
        fault_injection.check("engine.step")
        prof_cfg = self._config.flops_profiler_config
        profiling_now = self.flops_profiler is not None and self.global_steps == prof_cfg.profile_step
        if profiling_now:
            self.flops_profiler.start_profile(example_batch=batch)
        self.tput_timer.start()
        self.timers(TRAIN_BATCH_TIMER).start()
        step_span = self.tracer.start_span("engine/step", track="engine",
                                           attrs={"global_step": self.global_steps} if self.tracer.enabled else None)
        try:
            with self.tracer.span("engine/fwd_bwd", parent=step_span, track="engine"):
                self._step_pld_scale()
                self._pending, self._pending_loss = None, None
                if self.zero is not None:
                    self.zero.pending = None
                loss_sum = None
                for i in range(self.gas):
                    global_mb = self._rank_micro_batch(batch, i, ranks=self.dp_world) if self._gather_loss else None
                    loss = self._backward_micro(self._rank_micro_batch(batch, i), global_mb).float()
                    loss_sum = loss if loss_sum is None else loss_sum + loss
                grads, self._pending = self._pending, None
                grads, loss = self._reduce_over_ranks(grads, loss_sum / self.gas, reduce_loss=not self._gather_loss)
            if self._nvme_opt is not None:
                metrics = self._streamed_update(grads, loss, step_span)
            else:
                with self.tracer.span("engine/optim", parent=step_span, track="engine"):
                    metrics = self._apply_grads(grads, loss)
        finally:
            self.tracer.end(step_span)
        self.timers(TRAIN_BATCH_TIMER).stop()
        self.tput_timer.stop(global_step=True)
        if profiling_now:   # JAX :1327-1335
            self.flops_profiler.stop_profile()
            self.flops_profiler.print_model_profile(profile_step=self.global_steps - 1,
                                                    module_depth=prof_cfg.module_depth,
                                                    top_modules=prof_cfg.top_modules, detailed=prof_cfg.detailed,
                                                    output_file=prof_cfg.output_file)
            self.flops_profiler.end_profile()
        self._after_step(metrics, [TRAIN_BATCH_TIMER])
        return metrics.loss

    def _no_imperative_streamed(self) -> None:
        if self._nvme_opt is not None:   # JAX _build_nvme_train_step :1065
            raise RuntimeError("the imperative forward/backward/step path does not support the streamed optimizer "
                               "offload tiers (host-streamed, NVMe); use train_batch()")

    @torch.no_grad()
    def _streamed_update(self, grads: List[torch.Tensor], loss: torch.Tensor, step_span) -> StepMetrics:
        """Tiers b and c (JAX ``_nvme_train_step`` :1070): the forward and
        backward are dispatched; the first groups' state uploads (or disk
        reads) are issued now, so they run under the backward; the norm of
        ``g/gas`` and the clip give one scale; the tier's group loop updates
        the parameters in place."""
        nv = self._nvme_opt
        nv.events.append(("step_entry_pending_writes", nv.pending_writes()))
        mode = self._nvme_step_mode
        if mode != "serialize":
            nv.prefetch(0)
            nv.prefetch(1)
        cfg = self._config
        inv = 1.0 / self.gas
        if cfg.gradient_predivide_factor != 1.0:
            inv = inv / cfg.gradient_predivide_factor
        gnorm = global_norm(torch._foreach_mul(grads, inv))
        scale = torch.full((), inv, dtype=torch.float32, device=self.device)
        if cfg.gradient_clipping and cfg.gradient_clipping > 0:
            scale = scale * torch.clamp(cfg.gradient_clipping / (gnorm + 1e-6), max=1.0)
        self.timers(STEP_GLOBAL_TIMER).start()
        opt_span = self.tracer.start_span("engine/optim", parent=step_span, track="engine")
        if self.tracer.enabled:
            # the instrumentation's clock is mapped into the tracer's by offset
            from .swap_tensor.overlap_instrumentation import now as _inst_now
            anchor_inst, anchor_trace = _inst_now(), self.tracer.now()
        try:
            nv.step(grads, self.global_steps, scale, serialize=(mode == "serialize"), flush=(mode == "flush"))
        except Exception as e:
            opt_span.set(error=f"{type(e).__name__}: {e}")
            raise
        finally:
            if self.tracer.enabled:
                nv.instrumentation.lift_spans(self.tracer, opt_span, track="stream", since_ts=anchor_inst,
                                              offset=anchor_trace - anchor_inst)
            self.tracer.end(opt_span)
        self.timers(STEP_GLOBAL_TIMER).stop()
        self.global_steps += 1
        self.global_samples += cfg.train_batch_size
        metrics = StepMetrics(loss=loss.float(), grad_norm=gnorm, found_inf=torch.zeros((), dtype=torch.bool,
                                                                                         device=self.device),
                              lr=float(self.lr_schedule(self.global_steps)), loss_scale=self.scaler_state.cur_scale)
        self.last_metrics = metrics
        spp = cfg.steps_per_print
        if spp and self.global_steps % spp == 0:
            log_dist(f"step={self.global_steps} loss={float(metrics.loss):.4f} lr={metrics.lr:.3e} "
                     f"gnorm={float(gnorm):.3f}", ranks=[0])
        return metrics

    def measure_stream_overlap(self, batch, pipelined_steps: int = 1):
        """JAX ``measure_stream_overlap`` (:1340-1363): ``pipelined_steps``
        flushed steps and one serialized probe step (real training steps:
        the state advances), then the streamed tier's overlap report
        (per-group upload/compute/download seconds, the overlap fraction,
        the transfer/compute bound)."""
        if self._nvme_opt is None:
            raise RuntimeError("measure_stream_overlap needs a streamed optimizer tier (offload_optimizer "
                               "device=cpu + pipeline_read, or device=nvme)")
        try:
            self._nvme_step_mode = "flush"
            for _ in range(max(1, pipelined_steps)):
                self.train_batch(batch=batch)
            self._nvme_step_mode = "serialize"
            self.train_batch(batch=batch)
        finally:
            self._nvme_step_mode = None
        return self._nvme_opt.overlap_report()

    def _after_step(self, metrics: StepMetrics, timer_names) -> None:
        """The PLD theta, the monitor's rows and the timers' log at a
        ``steps_per_print`` boundary (JAX ``train_batch`` :1329-1341)."""
        if self.progressive_layer_drop is not None:
            self.progressive_layer_drop.update_state(self.global_steps)
        self._write_monitor(metrics)
        spp = self._config.steps_per_print
        if self._config.wall_clock_breakdown and spp and self.global_steps % spp == 0:
            self.timers.log(timer_names)

    def _write_monitor(self, metrics: StepMetrics) -> None:
        """``Train/Samples/{train_loss,lr,loss_scale}`` at the global sample
        count (JAX ``_write_monitor`` :1473), and a streamed tier's
        ``stream_*`` overlap figures after each fresh measurement; reads the
        loss (a host sync) only when a monitor is on."""
        if self.monitor is not None and self.monitor.enabled:
            events = [
                ("Train/Samples/train_loss", float(metrics.loss), self.global_samples),
                ("Train/Samples/lr", float(metrics.lr), self.global_samples),
                ("Train/Samples/loss_scale", float(metrics.loss_scale), self.global_samples),
            ]
            nv = self._nvme_opt
            ver = nv.instrumentation.version if nv is not None else 0
            if nv is not None and ver != getattr(self, "_stream_report_ver", 0):
                # the streamed tier's overlap, once per fresh measurement
                rep = nv.overlap_report()
                if rep is not None:
                    for key in ("upload_s", "compute_s", "download_s", "overlap_fraction", "pipelined_wall_s"):
                        if rep.get(key) is not None:
                            events.append((f"Train/Samples/stream_{key}", float(rep[key]), self.global_samples))
                self._stream_report_ver = ver
            self.monitor.write_events(events)

    def _global_micro_loss(self, batch, training: bool = False) -> torch.Tensor:
        """JAX's loss of the global micro-batch ``batch``: this rank's rows
        through the model, the per-rank shares summed over the ranks (a
        gathered custom loss is the global one already).  It keeps the graph
        of this rank's share."""
        if self.dp_world == 1:
            return self._microbatch_loss(batch, training=training)
        gathered = not hasattr(self.loss_fn, "rank_share")
        loss = self._microbatch_loss(self._rank_micro_batch(batch, 0, gas=1), training=training,
                                     global_mb=batch if gathered else None)
        return loss if gathered else _SumOverRanks.apply(loss, self.dp_group)

    def forward(self, batch) -> torch.Tensor:
        """The loss of one global micro-batch (JAX ``engine.py:1381``), with
        the graph of this rank's share when grad is enabled (the imperative
        ``forward``/``backward``/``step`` path)."""
        self._last_batch = batch = self._to_device(batch)
        self.timers(FORWARD_GLOBAL_TIMER).start()
        loss = self._global_micro_loss(batch)
        self.timers(FORWARD_GLOBAL_TIMER).stop()
        return loss

    __call__ = forward

    def eval_batch(self, data_iter=None, batch=None) -> torch.Tensor:
        """The loss of one global micro-batch without gradients (JAX
        ``engine.py:1438``): ``batch``, or the next one of ``data_iter``."""
        if batch is None:
            batch = next(data_iter)
        with torch.no_grad():
            return self.forward(batch)

    def backward(self, loss: Optional[torch.Tensor] = None, batch=None) -> torch.Tensor:
        """Accumulate the gradients of one global micro-batch (ref:
        engine.py:2204): of ``loss`` from ``forward`` when it carries a graph,
        else of a fresh forward of ``batch`` (or the last forwarded batch).
        Returns JAX's loss of the micro-batch (``engine.py:1394``)."""
        if self.qgz:
            raise RuntimeError("the imperative forward/backward/step path does not support compressed gradient "
                               "transport; use train_batch()")
        self._no_imperative_streamed()
        self.timers(BACKWARD_GLOBAL_TIMER).start()
        for p in self.params:
            p.grad = None
        if loss is None or loss.grad_fn is None:
            batch = self._to_device(batch) if batch is not None else self._last_batch
            if batch is None:
                raise ValueError("call forward(batch) first or pass batch=")
            if self._micro_step_count == 0:
                self._step_pld_scale()
            loss = self._global_micro_loss(batch, training=True)
        self._accumulate(loss)
        loss = loss.detach().float()
        self._pending_loss = loss if self._pending_loss is None else self._pending_loss + loss
        self._micro_step_count += 1
        self.timers(BACKWARD_GLOBAL_TIMER).stop()
        return loss

    def is_gradient_accumulation_boundary(self) -> bool:
        return self._micro_step_count % self.gas == 0

    def step(self) -> Optional[StepMetrics]:
        """Apply the optimizer at a gradient-accumulation boundary (ref:
        engine.py:2338): the pending grads are summed over ``backward``
        calls and divided by ``gas``."""
        self._no_imperative_streamed()
        if self._pending is None:
            raise RuntimeError("backward() must run before step()")
        if not self.is_gradient_accumulation_boundary():
            return None
        self.timers(STEP_GLOBAL_TIMER).start()
        grads, self._pending = self._pending, None
        if self.zero is not None:
            self.zero.pending = None
        grads, loss = self._reduce_over_ranks(grads, self._pending_loss / self._micro_step_count, reduce_loss=False)
        metrics = self._apply_grads(grads, loss)
        self._pending_loss, self._micro_step_count = None, 0
        self.timers(STEP_GLOBAL_TIMER).stop()
        self._after_step(metrics, [FORWARD_GLOBAL_TIMER, BACKWARD_GLOBAL_TIMER, STEP_GLOBAL_TIMER])
        self.lr_scheduler.step()
        return metrics

    def set_telemetry(self, tracer=None, metrics=None):
        """Attach a telemetry ``Tracer`` and/or ``MetricsRegistry`` (JAX
        ``engine.py:1455``): every later ``train_batch`` emits one
        ``engine/step`` trace with ``engine/fwd_bwd`` and ``engine/optim``
        children, and the flops profiler, when on, publishes its gauges into
        the registry; ``set_telemetry()`` detaches both."""
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics_registry = metrics
        if self.flops_profiler is not None:
            self.flops_profiler.attach_metrics(metrics)

    # ------------------------------------------------------------ checkpoints

    def save_checkpoint(self, save_dir, tag=None, client_state=None, save_latest=True,
                        exclude_frozen_parameters=False):
        """Crash-safe save of the whole training state under
        ``<save_dir>/<tag>`` (``checkpoint/engine.py``; JAX ``engine.py:1563``)."""
        from ..checkpoint.engine import save_checkpoint as _save
        from .swap_tensor.host_streamed_optimizer import HostStreamedOptimizer
        nv = self._nvme_opt
        if nv is not None and not isinstance(nv, HostStreamedOptimizer):
            # the NVMe tier's state is on disk already: the checkpoint holds
            # the parameters and the step; the swap files are flushed durable
            nv.swapper.flush_writes()
            logger.warning("save_checkpoint with pipelined NVMe offload: optimizer moments stay in the nvme_path "
                           "swap files — keep that directory alongside the checkpoint to resume exactly")
        # the host tier's state is process memory: its groups are written
        # into the tag directory inside the durability fence
        extra = nv.save_state if isinstance(nv, HostStreamedOptimizer) else None
        return _save(self, save_dir, tag=tag, client_state=client_state or {}, save_latest=save_latest,
                     extra_state_cb=extra)

    def load_checkpoint(self, load_dir, tag=None, load_optimizer_states=True, load_lr_scheduler_states=True,
                        load_module_only=False):
        """Restore a checkpoint into this engine; returns ``(path,
        client_state)``, or ``(None, {})`` without a ``latest`` file (JAX
        ``engine.py:1585``).  A streamed tier restores its own state: the
        host tier from the tag's ``host_opt_group*.npz``, the NVMe tier from
        its swap files; either is resynced from the loaded parameters (the
        moments reset, with a warning) when its master does not match them."""
        from ..checkpoint.engine import load_checkpoint as _load
        from .swap_tensor.host_streamed_optimizer import HostStreamedOptimizer
        out = _load(self, load_dir, tag=tag, load_optimizer_states=load_optimizer_states,
                    load_module_only=load_module_only)
        nv = self._nvme_opt
        if nv is not None and out[0] is not None:
            params = [p.data for p in self.params]
            restored = isinstance(nv, HostStreamedOptimizer) and load_optimizer_states and nv.load_state(out[0])
            if not nv.master_matches_params(params, self.compute_dtype):
                logger.warning("streamed optimizer offload: the stored optimizer state does not match the loaded "
                               "checkpoint's parameters" + (" (same shapes, another run?)" if restored else "") +
                               " — reinitializing the master from them (Adam moments reset)")
                nv.resync_master_from_params(params)
        if out[0] is not None and self.progressive_layer_drop is not None:
            self.progressive_layer_drop.update_state(self.global_steps)
        return out

    # ------------------------------------------------------------ state offload

    def offload_states(self, include=None, device: str = "cpu", nvme_path=None, pin_memory: bool = True,
                       non_blocking: bool = False):
        """Move the optimizer's state and the float32 master off the device
        (JAX ``offload_states`` :1509; ref: ``runtime/zero/offload_states.py``,
        used between the train and generate phases of RLHF): ``device="cpu"``
        to host tensors (pinned on CUDA with ``pin_memory``), ``"nvme"`` to
        swap files under ``nvme_path`` through the aio engine.  The tensors
        keep their identity (their storage moves), so the optimizer is
        untouched; ``reload_states`` brings them back, and is needed before
        the next step.  A streamed tier holds no such state on the device."""
        include = set(include or ("optimizer_states", "master_weights"))
        self._offloaded = getattr(self, "_offloaded", {})
        groups = {}
        if "optimizer_states" in include and self.optimizer is not None:
            groups["optimizer_states"] = [v for st in self.optimizer.state.values() for v in st.values()
                                          if isinstance(v, torch.Tensor) and v.dim() > 0]
        if "master_weights" in include and self.use_master and self.master:
            groups["master_weights"] = list(self.master)
        pin = pin_memory and self.device.type == "cuda"
        for name, tensors in groups.items():
            if not tensors or name in self._offloaded:
                continue
            if device == "nvme":
                from .swap_tensor import AioSwapConfig, TensorSwapper
                if getattr(self, "_nvme_swapper", None) is None:
                    if nvme_path is None:
                        raise ValueError("offload_states(device='nvme') needs nvme_path")
                    self._nvme_swapper = TensorSwapper(nvme_path, AioSwapConfig(), pin_memory=pin)
                self._nvme_swapper.swap_out(name, [t.data for t in tensors])
                homes = [t.device for t in tensors]
                for t in tensors:
                    t.data = torch.empty(0, dtype=t.dtype)
            elif device == "cpu":
                homes = [t.device for t in tensors]
                for t in tensors:
                    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
                    host.copy_(t.data, non_blocking=non_blocking)
                    t.data = host
                if non_blocking and self.device.type == "cuda":
                    torch.cuda.current_stream(self.device).synchronize()
            else:
                raise ValueError(f"offload_states: device must be 'cpu' or 'nvme', got {device!r}")
            self._offloaded[name] = (device, tensors, homes)
        log_dist(f"offload_states: {sorted(groups)} -> {device}", ranks=[0])

    def reload_states(self, non_blocking: bool = False):
        """Bring back what ``offload_states`` moved (JAX :1545)."""
        for name, (device, tensors, homes) in getattr(self, "_offloaded", {}).items():
            values = self._nvme_swapper.swap_in(name) if device == "nvme" else [t.data for t in tensors]
            for t, v, home in zip(tensors, values, homes):
                t.data = v.to(home, non_blocking=non_blocking)
        if non_blocking and self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self._offloaded = {}

    # ------------------------------------------------------------- properties

    def train_micro_batch_size_per_gpu(self):
        return self._config.train_micro_batch_size_per_gpu

    def train_batch_size(self):
        return self._config.train_batch_size

    def gradient_accumulation_steps(self):
        return self.gas

    def get_global_grad_norm(self) -> Optional[float]:
        return None if self.last_metrics is None else float(self.last_metrics.grad_norm)

    def zero_optimization(self):
        return self.zero_stage > 0

    def zero_optimization_stage(self):
        return self.zero_stage

    @property
    def loss_scale(self) -> float:
        return float(self.scaler_state.cur_scale)

    @property
    def skipped_steps(self) -> int:
        return int(self.skipped)

    def get_lr(self):
        return [float(self.lr_schedule(self.global_steps))]

    def module_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's state dict with whole tensors whatever the stage and
        the expert parallelism (JAX returns global arrays); at stage 3, or
        with expert banks cut over the expert group, a collective."""
        if self.zero is None or not self.zero.units_on:
            return self._whole_experts(self.module.state_dict())
        sd = self.module.state_dict()
        sd.update(zip(self.param_names, self.zero.full_params()))
        return self._whole_experts({k: sd[k] for k in self._state_names})

    @torch.no_grad()
    def load_module_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        """Load whole tensors (``module_state_dict``'s) into the model: at
        stage 3 each rank keeps its slices, an expert bank its experts."""
        sd = self._local_experts(sd)
        if self.zero is None or not self.zero.units_on:
            self.module.load_state_dict(sd, strict=True)
            return
        missing = set(self._state_names) - set(sd)
        if missing:
            raise KeyError(f"state dict lacks {sorted(missing)}")
        params = set(self.param_names)
        self.module.load_state_dict({k: v for k, v in sd.items() if k not in params}, strict=False)
        for i, name in enumerate(self.param_names):
            self.zero.set_full_param(i, sd[name].to(device=self.device, dtype=self.compute_dtype), master=False)

    @torch.no_grad()
    def set_full_param(self, name: str, value: torch.Tensor) -> None:
        """Write the whole value of parameter ``name`` (port layout) into
        the compute-dtype parameter (this rank's slice at stage 3) and the
        float32 master (its slice from stage 1)."""
        i = self.param_names.index(name)
        value = self._local_experts({name: value.to(self.device)})[name]
        if self.zero is not None:
            self.zero.set_full_param(i, value)
        else:
            self.params[i].data.copy_(value)
            if self.use_master:
                self.master[i].copy_(value)
        if self._host_opt is not None and not self.use_master:   # float32: the host copy the optimizer steps
            target = self.params[i].data if self.zero is None else self.zero.own_view(i)
            self._host_opt.host[i].copy_(target)
        if self._nvme_opt is not None:   # the streamed tier's master, its moments kept
            nv = self._nvme_opt
            master = nv.leaves("master")
            master[i] = value.float()
            nv.load_leaves(master, nv.leaves("mu"), nv.leaves("nu"))

    @torch.no_grad()
    def load_full_state(self, values: Dict[str, torch.Tensor],
                        moments: Optional[Dict[str, Dict[str, torch.Tensor]]] = None, step: Optional[int] = None):
        """Whole float32 values by parameter name (port layout) into the
        parameters and the master; ``moments`` (``{"exp_avg": {name: ...},
        ...}``) into the optimizer's state, wherever the tier keeps it; the
        step into the engine's and the optimizer's count.  The universal
        checkpoint's loader (``checkpoint/universal.py``)."""
        names = self.param_names
        moments = moments or {}
        if self._nvme_opt is not None:
            for p, n in zip(self.params, names):
                p.data.copy_(values[n])
            pick = lambda key: [moments[key][n] for n in names] if key in moments else None
            self._nvme_opt.load_leaves([values[n] for n in names], pick("exp_avg"), pick("exp_avg_sq"))
        else:
            for n in names:
                self.set_full_param(n, values[n])
            for key, tree in moments.items():
                for i, (n, t) in enumerate(zip(names, self._targets)):
                    local = self.local_state(i, tree[n])
                    st = self.optimizer.state[t]
                    if key in st:
                        st[key].copy_(local.reshape(st[key].shape))
                    else:
                        st[key] = local.to(t.device).clone()
        if step is not None:
            self.global_steps = int(step)
            self.global_samples = self.global_steps * self._config.train_batch_size
            if self.optimizer is not None:
                self.optimizer.step_count = int(step)
                self.optimizer._device_step = None

    def full_master(self) -> Optional[Dict[str, torch.Tensor]]:
        """The float32 master by parameter name, whole tensors (None in
        float32, and under a streamed tier, whose checkpoint holds no master:
        ``streamed_state`` reads it)."""
        if not self.use_master or self._nvme_opt is not None:
            return None
        tensors = self.master if self.zero is None else self.zero.full_state(self.master)
        return self._whole_experts(dict(zip(self.param_names, tensors)))

    @torch.no_grad()
    def load_full_master(self, master: Dict[str, torch.Tensor]) -> None:
        if self._nvme_opt is not None:   # a streamed tier: its moments kept
            nv = self._nvme_opt
            nv.load_leaves([master[n] for n in self.param_names], nv.leaves("mu"), nv.leaves("nu"))
            return
        for i, (name, m) in enumerate(zip(self.param_names, self.master)):
            m.copy_(self.local_state(i, master[name]).to(m.device))

    def local_state(self, i: int, full: torch.Tensor) -> torch.Tensor:
        """This rank's float32 state slice of parameter ``i`` from its whole
        value (port layout): its experts of a bank, then its ZeRO slice."""
        full = self._local_experts({self.param_names[i]: full.to(device=self.device, dtype=torch.float32)})
        full = full[self.param_names[i]]
        return full if self.zero is None else self.zero.local_state(i, full)

    def full_optimizer_state_dict(self) -> dict:
        """The optimizer's ``state_dict()`` with each per-parameter tensor
        whole (port layout), as a stage-0 engine's."""
        if self.optimizer is None:   # a streamed tier keeps its own state
            return {}
        sd = self.optimizer.state_dict()
        if self.zero is None:
            return sd
        # the packed per-tensor dicts are the optimizer's own: copy before replacing
        state = sd["state"] = {i: dict(st) for i, st in sd["state"].items()}
        keys = sorted({k for st in state.values() for k, v in st.items()
                       if isinstance(v, torch.Tensor) and v.dim() > 0})
        for key in keys:
            full = self.zero.full_state([state[i][key] for i in range(len(self._targets))])
            full = self._whole_experts(dict(zip(self.param_names, full)))
            for i, name in enumerate(self.param_names):
                state[i][key] = full[name]
        return sd

    def load_full_optimizer_state_dict(self, sd: dict) -> None:
        """Load ``full_optimizer_state_dict``'s form: each rank keeps its slices."""
        if self.zero is not None:
            sd = {**sd, "state": {i: {k: (self.local_state(i, v).clone()
                                         if isinstance(v, torch.Tensor) and v.dim() > 0 else v)
                                      for k, v in st.items()}
                                  for i, st in sd["state"].items()}}
        self.optimizer.load_state_dict(sd)

    def state_bytes(self) -> Dict[str, int]:
        """The bytes of training state this rank holds on its device: its
        compute-dtype parameters, float32 master and optimizer moments
        (what an offload tier holds in host memory counts in
        ``offload_bytes``)."""
        nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
        moments = [] if self.optimizer is None else [v for st in self.optimizer.state.values() for v in st.values()
                                                     if isinstance(v, torch.Tensor) and v.dim() > 0]
        host_opt = self._host_opt is not None
        return {"params": 0 if self.param_host else nbytes(self.params),
                "master": 0 if host_opt else nbytes(self.master), "moments": 0 if host_opt else nbytes(moments)}

    def offload_bytes(self) -> Dict[str, int]:
        """The bytes of host memory the offload tiers hold (pinned on CUDA):
        the parameters (``offload_param``), the optimizer's float32 tensors
        and moments (host-optimizer or host-streamed tier; the NVMe tier's
        are on disk), and the host tier's chunk staging."""
        out = {"params": 0, "optimizer": 0, "staging": 0}
        if self.param_host and self.zero is not None:
            out["params"] = self.zero._param_arena.nbytes
        if self._host_opt is not None:
            hb = self._host_opt.host_bytes()
            out["optimizer"], out["staging"] = hb["targets"] + hb["state"], hb["staging"]
        elif self._nvme_opt is not None and hasattr(self._nvme_opt, "host_bytes"):
            out["optimizer"] = self._nvme_opt.host_bytes()
        return out

    def streamed_state(self) -> Optional[Dict[str, Dict[str, torch.Tensor]]]:
        """A streamed tier's whole state by parameter name: ``master``,
        ``exp_avg`` and ``exp_avg_sq`` (host tensors); None without one."""
        if self._nvme_opt is None:
            return None
        nv = self._nvme_opt
        return {key: dict(zip(self.param_names, nv.leaves(which)))
                for key, which in (("master", "master"), ("exp_avg", "mu"), ("exp_avg_sq", "nu"))}
