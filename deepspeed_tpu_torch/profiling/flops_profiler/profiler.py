"""The flops profiler (port of ``deepspeed_tpu/profiling/flops_profiler/
profiler.py``; ref: ``deepspeed/profiling/flops_profiler/profiler.py``).

The JAX profiler reads XLA's cost analysis of the compiled step.  Here the
flops are counted by ``torch.utils.flop_counter.FlopCounterMode`` over the
step as it runs, forward and backward (a recomputed forward counts again,
as XLA counts it).  That mode counts the matmul-like aten ops; the port's
attention ops are custom ops whose kernels it cannot see, so each gets a
formula here, the per-visible-pair counts that ``PERF.md`` §6 uses for the
kernels' bounds: the flash forward (K1) 4·D a (query, key) pair and head,
its backward (K2a then K2b) 6·D + 8·D; the block-sparse forward (K6a) 4·D,
its backward (K6b, K6c) 6·D + 8·D, over the pairs of the layout's blocks.
The serving kernel K3 is a launch inside the step, not a torch op, so it
is not counted (the profiler profiles training steps).

Same surface as JAX: ``start_profile`` / ``stop_profile`` / ``end_profile``
/ ``reset_profile``, the ``get_total_*`` getters, ``print_model_profile``,
``attach_metrics`` (gauges ``profiler/*`` of a telemetry registry), and
``get_model_profile(model, input_shape)``.  No byte count exists without a
cost model: ``get_total_bytes`` reads 0 and the printout says so.
"""

import sys
import time
from typing import Optional

import torch
from torch.utils.flop_counter import FlopCounterMode, register_flop_formula

# ------------------------------------------------------------------ helpers


def number_to_string(num, units=None, precision=2):
    if units is None:
        if num >= 1e12:
            return f"{num / 1e12:.{precision}f} T"
        if num >= 1e9:
            return f"{num / 1e9:.{precision}f} G"
        if num >= 1e6:
            return f"{num / 1e6:.{precision}f} M"
        if num >= 1e3:
            return f"{num / 1e3:.{precision}f} K"
        return f"{num:.{precision}f} "
    scale = {"T": 1e12, "G": 1e9, "M": 1e6, "K": 1e3, "": 1.0}[units]
    return f"{num / scale:.{precision}f} {units}"


def flops_to_string(flops, units=None, precision=2):
    return number_to_string(flops, units=units, precision=precision) + "FLOPS"


def macs_to_string(macs, units=None, precision=2):
    return number_to_string(macs, units=units, precision=precision) + "MACs"


def params_to_string(params_num, units=None, precision=2):
    return number_to_string(params_num, units=units, precision=precision).strip()


def duration_to_string(duration, units=None, precision=2):
    if duration > 1:
        return f"{duration:.{precision}f} s"
    if duration > 1e-3:
        return f"{duration * 1e3:.{precision}f} ms"
    return f"{duration * 1e6:.{precision}f} us"


# ------------------------------------------------------- the custom ops' flops


def causal_pairs(sq: int, sk: int, q_offset: int = 0) -> int:
    """(query, key) pairs a causal head sees: query i at position q_offset + i
    sees the keys at positions <= it."""
    full = max(0, min(sq, sk - q_offset))          # rows whose visible keys are q_offset + i + 1 < sk
    return full * (2 * q_offset + full + 1) // 2 + (sq - full) * sk


def _flash_pairs(q_shape, k_shape, causal: bool, q_offset: int) -> int:
    b, sq, h, _ = q_shape
    sk = k_shape[1]
    return b * h * (causal_pairs(sq, sk, int(q_offset)) if causal else sq * sk)


def _sparse_pairs(q: torch.Tensor, tables, block: int, causal: bool) -> int:
    """The pairs of a block-sparse layout's admitted blocks (a causal
    diagonal block half and its diagonal), times the batch."""
    row_ptr, row_idx = tables[0], tables[1]
    pairs = row_idx.numel() * block * block
    if causal:
        nb = q.shape[2] // block
        rows = torch.repeat_interleave(torch.arange(row_ptr.numel() - 1, device=row_ptr.device),
                                       (row_ptr[1:] - row_ptr[:-1]).long())
        pairs -= int((row_idx.long() == rows % nb).sum()) * block * (block - 1) // 2
    return q.shape[0] * pairs


def _register_attention_formulas() -> None:
    from ...ops import flash_attention  # noqa: F401  (registers ds_torch::flash_fwd / flash_bwd)
    from ...ops.sparse_attention import kernel  # noqa: F401  (registers ds_torch::sparse_attn_fwd / _bwd)
    ops = torch.ops.ds_torch

    @register_flop_formula(ops.flash_fwd)
    def _flash_fwd(q_shape, k_shape, v_shape, causal, q_offset, *args, out_shape=None, **kwargs):
        return 4 * q_shape[-1] * _flash_pairs(q_shape, k_shape, causal, q_offset)

    @register_flop_formula(ops.flash_bwd)
    def _flash_bwd(q_shape, k_shape, v_shape, o_shape, lse_shape, do_shape, causal, q_offset, *args,
                   out_shape=None, **kwargs):
        return (6 + 8) * q_shape[-1] * _flash_pairs(q_shape, k_shape, causal, q_offset)

    @register_flop_formula(ops.sparse_attn_fwd, get_raw=True)
    def _sparse_fwd(q, k, v, tables, key_padding_mask, block, causal, scale, *args, out_val=None, **kwargs):
        return 4 * q.shape[-1] * _sparse_pairs(q, tables, block, causal)

    @register_flop_formula(ops.sparse_attn_bwd, get_raw=True)
    def _sparse_bwd(q, k, v, o, lse, do, tables, key_padding_mask, block, causal, scale, *args, out_val=None,
                    **kwargs):
        return (6 + 8) * q.shape[-1] * _sparse_pairs(q, tables, block, causal)


_register_attention_formulas()


def cost_analysis(fn, *args, **kwargs) -> dict:
    """``{"flops": n}`` of one call of ``fn`` (the counterpart of JAX's
    ``xla_cost_analysis``), counted as it runs."""
    with FlopCounterMode(display=False) as mode:
        fn(*args, **kwargs)
    return {"flops": mode.get_total_flops()}


# ------------------------------------------------------------------ profiler


class FlopsProfiler:
    """ref: ``flops_profiler/profiler.py:30`` (JAX ``:81``).  ``model`` an
    ``nn.Module``; ``ds_engine`` the training engine, whose step between
    ``start_profile`` and ``stop_profile`` is counted."""

    def __init__(self, model=None, ds_engine=None, recompute_fwd_factor=0.0):
        self.model = model
        self.ds_engine = ds_engine
        self.recompute_fwd_factor = recompute_fwd_factor
        self.started = False
        self.metrics_registry = None
        self._mode: Optional[FlopCounterMode] = None
        self.reset_profile()

    def attach_metrics(self, registry) -> "FlopsProfiler":
        """Publish each profile into a telemetry ``MetricsRegistry``: gauges
        ``profiler/flops_per_step``, ``profiler/macs_per_step``,
        ``profiler/params``, ``profiler/bytes_per_step`` and
        ``profiler/step_duration_s``, set at every ``stop_profile``; None
        detaches."""
        self.metrics_registry = registry
        return self

    def start_profile(self, ignore_list=None, example_batch=None) -> None:
        self.reset_profile()
        self.started = True
        self._mode = FlopCounterMode(display=False)
        self._mode.__enter__()
        self._t0 = time.perf_counter()

    def stop_profile(self) -> None:
        if not self.started or self._mode is None:
            return
        device = getattr(self.ds_engine, "device", None)
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
        self._duration = time.perf_counter() - self._t0
        self._mode.__exit__(None, None, None)
        self._flops = int(self._mode.get_total_flops())
        self._macs = self._flops // 2
        self._table = self._mode.get_table(depth=999)
        self._mode = None
        source = self.ds_engine.params if self.ds_engine is not None else \
            (self.model.parameters() if self.model is not None else ())
        self._params = sum(p.numel() for p in source)
        if self.metrics_registry is not None:
            reg = self.metrics_registry
            reg.gauge("profiler/flops_per_step").set(self._flops)
            reg.gauge("profiler/macs_per_step").set(self._macs)
            reg.gauge("profiler/params").set(self._params)
            reg.gauge("profiler/bytes_per_step").set(self._bytes)
            reg.gauge("profiler/step_duration_s").set(self._duration)

    def reset_profile(self) -> None:
        self._duration = 0.0
        self._flops = 0
        self._macs = 0
        self._params = 0
        self._bytes = 0
        self._table = None

    def end_profile(self) -> None:
        if self._mode is not None:
            self._mode.__exit__(None, None, None)
            self._mode = None
        self.started = False

    def get_total_flops(self, as_string=False):
        return flops_to_string(self._flops) if as_string else self._flops

    def get_total_macs(self, as_string=False):
        return macs_to_string(self._macs) if as_string else self._macs

    def get_total_duration(self, as_string=False):
        return duration_to_string(self._duration) if as_string else self._duration

    def get_total_params(self, as_string=False):
        return params_to_string(self._params) if as_string else self._params

    def get_total_bytes(self, as_string=False):
        return number_to_string(self._bytes) + "B" if as_string else self._bytes

    def print_model_profile(self, profile_step=1, module_depth=-1, top_modules=1, detailed=True, output_file=None):
        out = open(output_file, "w") if output_file else sys.stdout
        dur = self._duration or 1e-9
        print("\n-------------------------- DeepSpeed-TPU Flops Profiler --------------------------", file=out)
        print(f"Profile Summary at step {profile_step}:", file=out)
        print("Notations:\n"
              "data parallel size (dp_size), model parallel size(mp_size),\n"
              "number of parameters (params), number of multiply-accumulate operations(MACs),\n"
              "number of floating-point operations (flops), floating-point operations per second (FLOPS)",
              file=out)
        if self.ds_engine is not None:
            print(f"dp/world size:                                          {self.ds_engine.dp_world}", file=out)
        print(f"params:                                                 {self.get_total_params(True)}", file=out)
        print(f"fwd+bwd MACs per step:                                  {self.get_total_macs(True)}", file=out)
        print(f"fwd+bwd flops per step:                                 {self.get_total_flops(True)}", file=out)
        print("HBM bytes accessed per step:                            not counted (no cost model)", file=out)
        print(f"step latency:                                           {self.get_total_duration(True)}", file=out)
        print(f"achieved FLOPS:                                         {flops_to_string(self._flops / dur)}", file=out)
        if detailed and self._table:
            print(self._table, file=out)
        print("-----------------------------------------------------------------------------------", file=out)
        if output_file:
            out.close()

    def print_model_aggregated_profile(self, module_depth=-1, top_modules=1):
        self.print_model_profile(module_depth=module_depth, top_modules=top_modules, detailed=False)


# -------------------------------------------------------- standalone profile


def get_model_profile(model, input_shape=None, args=(), kwargs=None, print_profile=True, detailed=True,
                      module_depth=-1, top_modules=1, warm_up=1, as_string=True, output_file=None,
                      ignore_modules=None, mode="forward", rngs=None):
    """``(flops, macs, params)`` of one forward of ``model`` (JAX ``:235``):
    on ``args`` (or ``torch.ones(input_shape)`` of int64 ids); ``mode="train"``
    adds the backward of the sum of the (first) output."""
    kwargs = kwargs or {}
    if input_shape is not None:
        if not isinstance(input_shape, (tuple, list)):
            raise TypeError("input_shape must be a tuple or a list")
        device = next(model.parameters()).device
        args = (torch.ones(input_shape, dtype=torch.long, device=device), )
    params = sum(p.numel() for p in model.parameters())
    depth = 999 if module_depth < 0 else module_depth
    with FlopCounterMode(display=False, depth=depth) as counter:
        if mode == "train":
            out = model(*args, **kwargs)
            leaf = out[0] if isinstance(out, (tuple, list)) else out
            leaf.float().sum().backward()
        else:
            with torch.no_grad():
                model(*args, **kwargs)
    flops = int(counter.get_total_flops())
    macs = flops // 2
    if print_profile:
        out_file = open(output_file, "w") if output_file else sys.stdout
        print(f"params: {params_to_string(params)}  flops: {flops_to_string(flops)}  macs: {macs_to_string(macs)}",
              file=out_file)
        if detailed:
            print(counter.get_table(depth), file=out_file)
        if output_file:
            out_file.close()
    if as_string:
        return flops_to_string(flops), macs_to_string(macs), params_to_string(params)
    return flops, macs, params
