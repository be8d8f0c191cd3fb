"""The v1 inference engine, ``deepspeed_tpu_torch.init_inference`` (port of
``deepspeed_tpu/inference/engine.py``; ref: ``deepspeed/inference/engine.py:40``).

``InferenceEngine`` wraps a model of the port (an ``nn.Module`` whose
``cfg`` is a dataclass) for serving without a KV cache:

  * kernel injection (``replace_with_kernel_inject``) rebuilds the model
    with ``attention_impl="flash"`` where its config has that field, as JAX
    does, so its attention runs K1 on the card at sequence lengths that
    are a multiple of 128 (others take the chunked path, JAX's dispatch).
    K1 takes head dims 64, 80, 96 and 128: any other head dim (GPT-J's
    256), or an attention bias K1 does not take (BLOOM's and Falcon-RW's
    alibi), raises rather than quietly running the plain attention;
  * ``forward`` runs the model under ``torch.no_grad`` with its floating
    parameters cast to ``config.dtype``;
  * ``generate`` decodes greedily, or samples from the engine's
    ``torch.Generator``, over one ``[B, S0 + max_new]`` buffer refilled each
    step (every forward has the same shape; causal attention never sees the
    padding ahead of the current position), with ``min_out_tokens``, the
    EOS blanking and the ragged cut of the JAX engine.

The engine runs on the card unless the caller passes ``device="cpu"``.

Tensor parallelism (``tensor_parallel`` N > 1; JAX ``:59-71``, ``:117``):
the process group holds N ranks (gloo ranks may share one card), the mesh
is ``data`` 1 × ``tensor`` N (``utils/groups``' tensor group), and the
model, built whole, is cut to the rank's slices after kernel injection
(``module_inject/layers.cut_tensor_parallel_``: the Megatron layout of
``models/gpt2.py`` and ``gpt_family.py``, GPT-2's fused ``c_attn`` cut by
heads within each of q, k and v).  ``forward`` returns the whole logits,
gathered over the vocab on every rank (kind ``logits``), and ``generate``
gathers the last position's, so every rank emits the same tokens.  GPT-2,
BLOOM, GPT-NeoX, GPT-J and GPT-Neo are cut; any other model (BERT, CLIP,
the v2 families) at N > 1 raises naming ROADMAP item 6.2.
"""

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..accelerator import DeviceLike, resolve_device
from ..comm.mesh import ROADMAP_TENSOR_PARALLEL, MeshSpec, create_mesh, process_world_size, set_global_mesh
from ..module_inject.layers import (NO_TENSOR_PARALLEL, TensorParallel, cut_tensor_parallel_,
                                    gather_from_tensor_region)
from ..ops.flash_attention import SUPPORTED_HEAD_DIMS
from ..utils.logging import log_dist, logger

#: ``dtype`` strings of the reference's config
DTYPES = {"fp16": torch.float16, "half": torch.float16, "float16": torch.float16, "bf16": torch.bfloat16,
          "bfloat16": torch.bfloat16, "fp32": torch.float32, "float32": torch.float32, "float": torch.float32}
#: the kernel gap that kernel injection names when K1 cannot take a model
ROADMAP_FLASH_GAP = ("ROADMAP Queue 1 item 5, the kernel gaps: K1/K2 take head dims 64, 80, 96 and 128 and no "
                     "attention bias")


@dataclasses.dataclass
class DeepSpeedInferenceConfig:
    """The subset of the reference's ``DeepSpeedInferenceConfig`` that the
    engine reads (JAX ``:30``)."""
    dtype: torch.dtype = torch.bfloat16
    tensor_parallel: int = 1
    replace_with_kernel_inject: bool = False
    max_out_tokens: int = 256
    min_out_tokens: int = 1
    eos_token_id: Optional[int] = None

    @staticmethod
    def from_dict(d: Optional[Mapping]) -> "DeepSpeedInferenceConfig":
        """From the reference's dict: ``tensor_parallel`` (or ``mp_size``, or
        ``{"tp_size": n}``), ``dtype`` as a string or a torch dtype; unknown
        keys are ignored, as JAX ignores them."""
        d = dict(d or {})
        tp = d.pop("tensor_parallel", d.pop("mp_size", 1))
        if isinstance(tp, dict):
            tp = tp.get("tp_size", 1)
        dtype = d.pop("dtype", torch.bfloat16)
        if isinstance(dtype, str):
            dtype = DTYPES[dtype]
        known = {f.name for f in dataclasses.fields(DeepSpeedInferenceConfig)}
        return DeepSpeedInferenceConfig(dtype=dtype, tensor_parallel=int(tp),
                                        **{k: v for k, v in d.items() if k in known})


class InferenceEngine:
    """``model`` an ``nn.Module`` of the port, ``config`` a dict or a
    ``DeepSpeedInferenceConfig``; ``params`` an optional state dict loaded
    into the model; ``generator`` the sampling generator (default: seed 0
    on the engine's device)."""

    def __init__(self, model: nn.Module = None, config=None, params: Optional[Mapping[str, torch.Tensor]] = None,
                 device: DeviceLike = "cuda", generator: Optional[torch.Generator] = None):
        if model is None:
            raise ValueError("init_inference: model is required")
        self.config = config if isinstance(config, DeepSpeedInferenceConfig) \
            else DeepSpeedInferenceConfig.from_dict(config)
        #: this rank's place on the tensor axis, and the mesh (None on one rank)
        self.tp, self.mesh = NO_TENSOR_PARALLEL, None
        if self.config.tensor_parallel > 1:
            self._setup_tp(model)
        self.device = resolve_device(device)
        if params is not None:
            model.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()}, strict=True, assign=True)
        module = self._maybe_inject_kernels(model)
        if self.tp.size > 1:
            cut_tensor_parallel_(module, self.tp)
        with torch.no_grad():
            module = module.to(self.device)
            for p in module.parameters():
                if p.is_floating_point():
                    p.data = p.data.to(self.config.dtype)
        self.module = module.eval().requires_grad_(False)
        self.generator = generator if generator is not None else torch.Generator(self.device).manual_seed(0)
        log_dist(f"InferenceEngine: device={self.device} dtype={self.config.dtype} tp={self.tp.size} "
                 f"kernel_inject={self.config.replace_with_kernel_inject}", ranks=[0])

    def _setup_tp(self, model: nn.Module) -> None:
        """The mesh ``data`` 1 × ``tensor`` N over the process group and
        this rank's place on it; a model the engine does not cut, or a
        degree that does not divide its heads or vocab, raises."""
        from ..models.gpt2 import GPT2LMHeadModel
        from ..models.gpt_family import BloomForCausalLM, GPTJForCausalLM, GPTNeoForCausalLM, GPTNeoXForCausalLM
        from ..models.llama import check_divides
        from ..utils import groups
        n = self.config.tensor_parallel
        cut = (GPT2LMHeadModel, BloomForCausalLM, GPTNeoXForCausalLM, GPTJForCausalLM, GPTNeoForCausalLM)
        if type(model) not in cut:
            raise NotImplementedError(f"tensor_parallel={n}: the v1 engine cuts {', '.join(c.__name__ for c in cut)} "
                                      f"over tensor-parallel ranks, not {type(model).__name__} "
                                      f"({ROADMAP_TENSOR_PARALLEL})")
        check_divides(n, num_attention_heads=model.cfg.num_attention_heads, vocab_size=model.cfg.vocab_size)
        world = process_world_size()
        if world != n:
            raise ValueError(f"tensor_parallel={n} but the process group has {world} ranks: start {n} ranks and "
                             "create the process group first (comm.init_distributed)")
        self.mesh = create_mesh(MeshSpec(data=1, tensor=n), world)
        set_global_mesh(self.mesh)
        groups.create_tensor_groups()
        self.tp = TensorParallel(n, groups.get_tensor_model_parallel_rank(), groups.get_tensor_model_parallel_group())

    def _maybe_inject_kernels(self, model: nn.Module) -> nn.Module:
        """``attention_impl="flash"`` on a config that has the field (JAX
        ``:82``): the model rebuilt over the same tensors."""
        if not self.config.replace_with_kernel_inject:
            return model
        cfg = getattr(model, "cfg", None)
        if cfg is None or not dataclasses.is_dataclass(cfg) or not hasattr(cfg, "attention_impl"):
            logger.warning("replace_with_kernel_inject: the model has no attention_impl config; running it unchanged")
            return model
        head_dim = getattr(cfg, "head_dim", cfg.hidden_size // cfg.num_attention_heads)
        if head_dim not in SUPPORTED_HEAD_DIMS:
            raise NotImplementedError(f"replace_with_kernel_inject: {type(model).__name__} has head dim {head_dim}, "
                                      f"K1 takes {SUPPORTED_HEAD_DIMS} ({ROADMAP_FLASH_GAP})")
        bias = getattr(model, "attention_bias_kind", None)
        if bias is not None:
            raise NotImplementedError(f"replace_with_kernel_inject: {type(model).__name__} attends with {bias}, "
                                      f"which K1 does not take ({ROADMAP_FLASH_GAP})")
        injected = type(model)(dataclasses.replace(cfg, attention_impl="flash"), device="meta")
        injected.load_state_dict(model.state_dict(), strict=True, assign=True)
        return injected

    @torch.no_grad()
    def forward(self, *args, **kwargs):
        """The model on its inputs (tensors moved to the engine's device);
        over tensor-parallel ranks the whole logits on every rank."""
        move = lambda x: torch.as_tensor(x).to(self.device) if isinstance(x, (torch.Tensor, np.ndarray)) else x
        out = self.module(*[move(a) for a in args], **{k: move(v) for k, v in kwargs.items()})
        return gather_from_tensor_region(out, self.tp, "logits")

    __call__ = forward

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: Optional[int] = None, do_sample: bool = False,
                 temperature: float = 1.0, **kwargs) -> np.ndarray:
        """``input_ids`` [B, S0] → the tokens, numpy ``[B, S0 + n]`` with n
        the most new tokens of any row (JAX ``:149-199``)."""
        max_new = max_new_tokens or self.config.max_out_tokens
        ids = torch.as_tensor(np.asarray(input_ids)).to(self.device)
        b, s0 = ids.shape
        buf = torch.zeros((b, s0 + max_new), dtype=ids.dtype, device=self.device)
        buf[:, :s0] = ids
        eos = self.config.eos_token_id
        done = np.zeros(b, bool)
        n_done_at = np.full(b, s0 + max_new, np.int64)
        for t in range(max_new):
            cur = s0 + t
            out = self.module(buf)
            last = gather_from_tensor_region((out[0] if isinstance(out, tuple) else out)[:, cur - 1], self.tp,
                                             "logits")                              # [B, V]
            if do_sample:
                probs = torch.softmax(last.float() / temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=self.generator)[:, 0]
            else:
                nxt = torch.argmax(last, dim=-1)
            buf[:, cur] = nxt.to(buf.dtype)
            if eos is not None and t + 1 >= self.config.min_out_tokens:
                done |= nxt.cpu().numpy() == eos
                n_done_at = np.minimum(n_done_at, np.where(done, cur + 1, s0 + max_new))
                if done.all():
                    break
        out = buf.cpu().numpy()
        if eos is not None:
            # blank everything after each row's EOS (the ragged stop)
            out = np.where(np.arange(out.shape[1])[None, :] < n_done_at[:, None], out, eos)
        return out[:, :int(n_done_at.max())]
