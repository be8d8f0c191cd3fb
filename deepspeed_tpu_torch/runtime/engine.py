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
engine's.  ZeRO stages 1-2 are the single-device update on one rank and
raise over several (partitioning is not ported); stage 3 raises.  The
returned loss is a device tensor: reading it is the caller's sync.

The CommsLogger sees the step as JAX logs its jitted step: the qgZ/LoCo
exchange as one ``all_to_all_quant_reduce`` entry per step, and none of
the collectives inside the step (``comm.unrecorded``).
"""

import contextlib
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..accelerator import DeviceLike, resolve_device
from ..comm import comm
from ..models.llama import causal_lm_loss
from ..ops.adam import FusedAdam
from ..ops.optimizer import global_norm
from ..utils.logging import log_dist, logger
from .comm.compressed import GroupedQuantAllreduce
from .config import ROADMAP_OFFLOAD, ROADMAP_TRAINING_FEATURES, DeepSpeedConfig
from .constants import ADAM_OPTIMIZER, ADAMW_OPTIMIZER, FUSED_ADAM_OPTIMIZER, ONEBIT_OPTIMIZERS
from .fp16.loss_scaler import StaticLossScaler, create_loss_scaler, found_inf_or_nan
from .lr_schedules import LRSchedulerShim, get_lr_schedule


class StepMetrics(NamedTuple):
    """Device tensors of one optimizer step (JAX ``StepMetrics``)."""
    loss: torch.Tensor
    grad_norm: torch.Tensor
    found_inf: torch.Tensor
    lr: float
    loss_scale: torch.Tensor


class DeepSpeedEngine:

    def __init__(self, model: nn.Module, config: DeepSpeedConfig, optimizer: Optional[Callable] = None,
                 lr_scheduler=None, params: Optional[Dict[str, torch.Tensor]] = None, device: DeviceLike = None):
        self.device = resolve_device(device)
        self._config = config
        self.zero_stage = config.zero_optimization_stage
        if self.zero_stage == 3:
            raise NotImplementedError(f"ZeRO stage 3 is not ported ({ROADMAP_OFFLOAD}); stages 0-2 are one "
                                      "single-device update here")
        self.compute_dtype = config.precision_dtype
        self.gas = config.gradient_accumulation_steps
        self.dp_rank, self.dp_world = comm.get_rank(), comm.get_world_size()
        if self.dp_world != config.dp_world_size:
            raise ValueError(f"the config was resolved for {config.dp_world_size} data-parallel ranks, the process "
                             f"group has {self.dp_world}: create the process group first")

        # ---- state: compute-dtype params + f32 master (JAX TrainState)
        self.module = model.to(self.device)
        if params is not None:
            self.module.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()}, strict=True)
        if self.dp_world > 1:
            with torch.no_grad():   # replicated state: every rank starts from rank 0's (ref: _broadcast_model)
                for t in self.module.state_dict().values():
                    comm.broadcast(t, 0)
        self.use_master = self.compute_dtype != torch.float32
        with torch.no_grad():
            float_params = [p for p in self.module.parameters() if p.is_floating_point()]
            self.master: List[torch.Tensor] = [p.detach().float().clone() for p in float_params] \
                if self.use_master else []
            for p in float_params:
                p.data = p.data.to(self.compute_dtype)
        self.params: List[nn.Parameter] = float_params

        # ---- loss scaling, LR schedule, optimizer
        self.loss_scaler = create_loss_scaler(config.fp16_config, self.compute_dtype)
        self.scaler_state = self.loss_scaler.init_state(self.device)
        # fp16 keeps the overflow check even at a static scale of 1 (JAX :757)
        self.static_unity = isinstance(self.loss_scaler, StaticLossScaler) and \
            self.loss_scaler.init_scale == 1.0 and self.compute_dtype != torch.float16
        self.lr_base, self.lr_schedule = self._build_lr_schedule(lr_scheduler)
        self.optimizer = self._build_optimizer(optimizer)
        self._configure_gradient_wire()
        if lr_scheduler is None or callable(lr_scheduler) and not hasattr(lr_scheduler, "step"):
            self.lr_scheduler = LRSchedulerShim(self.lr_schedule)
        else:
            self.lr_scheduler = lr_scheduler

        self.skipped = torch.zeros((), dtype=torch.int32, device=self.device)
        self.global_steps = 0
        self.global_samples = 0
        self.last_metrics: Optional[StepMetrics] = None
        self._pending: Optional[List[torch.Tensor]] = None
        self._pending_loss: Optional[torch.Tensor] = None
        self._micro_step_count = 0
        self._last_batch = None
        n_params = sum(p.numel() for p in self.params)
        log_dist(f"DeepSpeedEngine: device={self.device} zero_stage={self.zero_stage} dtype={self.compute_dtype} "
                 f"gas={self.gas} params={n_params / 1e6:.1f}M dp_world={self.dp_world} "
                 f"wire={'qgZ' if self.qgz else 'fp32'}{'+LoCo' if self.loco_error is not None else ''}",
                 ranks=[0])

    # ------------------------------------------------------------------ build

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
        target = self.master if self.use_master else self.params
        if client_optimizer is not None:
            if isinstance(client_optimizer, torch.optim.Optimizer) or not callable(client_optimizer):
                raise TypeError("optimizer= must be a factory params -> torch.optim.Optimizer: the engine builds "
                                "it over the float32 master parameters it owns")
            return client_optimizer(target)
        cfg = self._config.optimizer_config
        name = (cfg.type or "adamw").lower() if cfg is not None else "adamw"
        params = dict(cfg.params) if cfg is not None else {}
        params.pop("lr", None)
        params.pop("torch_adam", None)
        if name in ONEBIT_OPTIMIZERS:
            raise NotImplementedError(f"optimizer {cfg.type} is not ported ({ROADMAP_TRAINING_FEATURES})")
        if name not in (ADAM_OPTIMIZER, ADAMW_OPTIMIZER, FUSED_ADAM_OPTIMIZER):
            raise NotImplementedError(f"optimizer {cfg.type} is not ported: the PyTorch package has Adam, AdamW "
                                      "and FusedAdam (ROADMAP Queue 1, training features)")
        if name == ADAMW_OPTIMIZER or cfg is None:
            params.setdefault("weight_decay", 0.01)   # JAX adamw() default
            params["adam_w_mode"] = True
        else:
            params.setdefault("adam_w_mode", True)    # the reference's FusedAdam flag
        return FusedAdam(target, lr=self.lr_schedule, **params)

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

    def _microbatch_loss(self, mb) -> torch.Tensor:
        """The causal-LM loss of one micro-batch: ``input_ids`` and ``labels``,
        optionally ``positions``, ``segment_ids`` and ``loss_mask``."""
        if "labels" not in mb:
            raise KeyError("batch must contain 'labels' for the causal-LM loss")
        logits = self.module(mb["input_ids"], positions=mb.get("positions"), segment_ids=mb.get("segment_ids"))
        return causal_lm_loss(logits, mb["labels"], mb.get("loss_mask"), self._global_token_count(mb))

    def _global_token_count(self, mb) -> Optional[torch.Tensor]:
        """The denominator of the token mean on the float32 wire at world > 1:
        the tokens (masked-in tokens, at least 1) of the whole micro-batch over
        all ranks, so that the summed per-rank losses are JAX's one mean.
        None on one rank and on the manual qgZ/LoCo step, which keep
        per-device means as JAX's manual step does."""
        if self.dp_world == 1 or self.qgz:
            return None
        mask = mb.get("loss_mask")
        if mask is None:   # every rank holds as many tokens: no collective
            return torch.tensor(float(mb["labels"].numel() * self.dp_world), device=self.device)
        with comm.unrecorded():
            count = comm.all_reduce(mask.float().sum().reshape(1), comm.ReduceOp.SUM)
        return count.reshape(()).clamp_min(1.0)

    def _backward_micro(self, mb) -> torch.Tensor:
        """One micro-batch: backward of ``loss·scale``, grads added in float32
        into the pending sums.  Returns the (unscaled) loss."""
        for p in self.params:
            p.grad = None
        loss = self._microbatch_loss(mb)
        self._accumulate(loss)
        return loss.detach()

    def _accumulate(self, loss: torch.Tensor) -> None:
        (loss * self.scaler_state.cur_scale).float().backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if self._pending is None:
            self._pending = [g.float() for g in grads]
        else:
            torch._foreach_add_(self._pending, [g.float() for g in grads])
        for p in self.params:
            p.grad = None

    def _rank_micro_batch(self, batch, i: int):
        """Micro-batch ``i`` of the global batch (its rows ``[i·B/gas,
        (i+1)·B/gas)``, as JAX splits it) and, of those, this rank's
        contiguous share (JAX shards dim 0 over ``data``)."""
        out = {}
        for k, v in batch.items():
            if v.dim() == 0:
                out[k] = v
                continue
            rows, rem = divmod(v.shape[0], self.gas * self.dp_world)
            if rem or not rows:
                raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows: not a multiple of gas {self.gas} × "
                                 f"{self.dp_world} data-parallel ranks")
            start = (i * self.dp_world + self.dp_rank) * rows
            out[k] = v[start:start + rows]
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

    def _reduce_over_ranks(self, grads: List[torch.Tensor], loss: torch.Tensor):
        """The gradients and the loss over the data-parallel ranks: sums of
        the per-rank shares of the global token mean on the float32 wire,
        means of the per-rank means on the manual qgZ/LoCo step (unchanged on
        one rank; under LoCo the gradients stay local here and the update
        reduces them)."""
        if self.dp_world == 1:
            return grads, loss
        op = comm.ReduceOp.AVG if self.qgz else comm.ReduceOp.SUM
        with comm.unrecorded():
            loss = comm.all_reduce(loss.reshape(1), op).reshape(())
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
        target = self.master if self.use_master else self.params
        for t, g in zip(target, grads):
            t.grad = g
        if found_inf is None:
            self.optimizer.step()
        else:
            self.optimizer.step(found_inf=found_inf)
        for t in target:
            t.grad = None
        if self.use_master:
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
        ``engine.py:1274``).  Returns the mean loss as a device tensor."""
        if batch is None:
            if data_iter is None:
                raise ValueError("provide data_iter or batch")
            micro = [next(data_iter) for _ in range(self.gas)]
            batch = {k: np.concatenate([np.asarray(m[k]) for m in micro]) for k in micro[0]} \
                if self.gas > 1 else micro[0]
        batch = self._to_device(batch)
        t0 = time.perf_counter() if self._config.wall_clock_breakdown else None
        self._pending, self._pending_loss = None, None
        loss_sum = None
        for i in range(self.gas):
            loss = self._backward_micro(self._rank_micro_batch(batch, i)).float()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        grads, self._pending = self._pending, None
        grads, loss = self._reduce_over_ranks(grads, loss_sum / self.gas)
        metrics = self._apply_grads(grads, loss)
        if t0 is not None:
            log_dist(f"train_batch {1e3 * (time.perf_counter() - t0):.1f} ms (host, not synchronized)", ranks=[0])
        return metrics.loss

    def forward(self, batch) -> torch.Tensor:
        """The loss of one micro-batch, with its autograd graph when grad is
        enabled (the imperative ``forward``/``backward``/``step`` path)."""
        self._last_batch = batch = self._to_device(batch)
        return self._microbatch_loss(batch)

    def backward(self, loss: Optional[torch.Tensor] = None, batch=None) -> torch.Tensor:
        """Accumulate the gradients of one micro-batch (ref: engine.py:2204):
        of ``loss`` from ``forward`` when it carries a graph, else of a fresh
        forward of ``batch`` (or the last forwarded batch)."""
        if self.qgz:
            raise RuntimeError("the imperative forward/backward/step path does not support compressed gradient "
                               "transport; use train_batch()")
        for p in self.params:
            p.grad = None
        if loss is None or loss.grad_fn is None:
            batch = self._to_device(batch) if batch is not None else self._last_batch
            if batch is None:
                raise ValueError("call forward(batch) first or pass batch=")
            loss = self._microbatch_loss(batch)
        self._accumulate(loss)
        loss = loss.detach().float()
        self._pending_loss = loss if self._pending_loss is None else self._pending_loss + loss
        self._micro_step_count += 1
        return loss

    def is_gradient_accumulation_boundary(self) -> bool:
        return self._micro_step_count % self.gas == 0

    def step(self) -> Optional[StepMetrics]:
        """Apply the optimizer at a gradient-accumulation boundary (ref:
        engine.py:2338): the pending grads are summed over ``backward``
        calls and divided by ``gas``."""
        if self._pending is None:
            raise RuntimeError("backward() must run before step()")
        if not self.is_gradient_accumulation_boundary():
            return None
        grads, self._pending = self._pending, None
        grads, loss = self._reduce_over_ranks(grads, self._pending_loss / self._micro_step_count)
        metrics = self._apply_grads(grads, loss)
        self._pending_loss, self._micro_step_count = None, 0
        self.lr_scheduler.step()
        return metrics

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

    def module_state_dict(self):
        return self.module.state_dict()
