"""The training engine (port of ``deepspeed_tpu/runtime/engine.py``
``DeepSpeedEngine``; ref: ``deepspeed/runtime/engine.py``).

One device.  The state is the model's parameters in the compute dtype, an
float32 master copy when that dtype is not float32 (JAX ``TrainState``,
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

ZeRO stages 0-2 are the same single-device update here (partitioning comes
with the multi-device slice); stage 3 raises.  The returned loss is a device
tensor: reading it is the caller's sync.
"""

import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..accelerator import DeviceLike, resolve_device
from ..models.llama import causal_lm_loss
from ..ops.adam import FusedAdam
from ..ops.optimizer import global_norm
from ..utils.logging import log_dist
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

        # ---- state: compute-dtype params + f32 master (JAX TrainState)
        self.module = model.to(self.device)
        if params is not None:
            self.module.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()}, strict=True)
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
                 f"gas={self.gas} params={n_params / 1e6:.1f}M", ranks=[0])

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
        return causal_lm_loss(logits, mb["labels"], mb.get("loss_mask"))

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
        if cfg.gradient_clipping and cfg.gradient_clipping > 0:
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
            mb = {k: (v if v.dim() == 0 else v.reshape((self.gas, v.shape[0] // self.gas) + v.shape[1:])[i])
                  for k, v in batch.items()}
            loss = self._backward_micro(mb).float()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        grads, self._pending = self._pending, None
        metrics = self._apply_grads(grads, loss_sum / self.gas)
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
        metrics = self._apply_grads(grads, self._pending_loss / self._micro_step_count)
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
