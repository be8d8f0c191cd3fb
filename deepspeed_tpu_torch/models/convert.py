"""Carry the JAX package's Llama weights across to the port.

``jax_llama_to_state_dict`` takes the flax param tree of
``deepspeed_tpu.models.llama.LlamaForCausalLM`` (or its cache twin) as
nested dicts of numpy arrays — with or without the ``{"params": ...}``
wrapper and the logical-partitioning boxes — and returns the state dict
that ``models/llama.py`` and ``models/llama_cache.py`` load.  Both layer layouts are accepted:

  * scan-stacked ``model/layers/*``, each leaf with a leading ``[L, ...]``
    axis (the training default, ``scan_layers=True``);
  * unrolled ``model/layers_{i}/*`` (see the JAX ``unstack_layer_params``).

Leaf mapping (flax ``DenseGeneral`` kernels are ``[in..., out...]``;
``nn.Linear`` weights are ``[out, in]``):

  embed_tokens/embedding [V, E]        → embed_tokens.weight [V, E]
  {q,k,v}_proj/kernel [E, N, D]        → layers.i.self_attn.{q,k,v}_proj.weight [N·D, E]
  {q,k,v}_proj/bias [N, D]             → ….bias [N·D]                 (attention_bias)
  o_proj/kernel [H, D, E]              → layers.i.self_attn.o_proj.weight [E, H·D]
  o_proj/bias [E]                      → ….bias                       (attention_out_bias)
  mlp/{gate,up}_proj/kernel [E, I]     → layers.i.mlp.{gate,up}_proj.weight [I, E]
  mlp/down_proj/kernel [I, E]          → layers.i.mlp.down_proj.weight [E, I]
  {input,post_attention}_layernorm/weight, norm/weight [E] → unchanged
  lm_head/kernel [E, V]                → lm_head.weight [V, E]        (absent when tied)

``jax_falcon_to_state_dict``, ``jax_opt_to_state_dict`` and
``jax_phi_to_state_dict`` carry the JAX training models (``FalconForCausalLM``,
``OPTForCausalLM``, ``PhiForCausalLM``) and their cache twins across to the
port's (``models/{falcon,opt,phi}.py``, ``models/cache_zoo.py``) by the same
rules, leaf by leaf (``_flax_to_state``): the stack ``h``
(Falcon) or ``layers`` (OPT, Phi, and Llama's under ``model``), scanned or
unrolled (``h_{i}``, ``layers_{i}``), becomes ``h.{i}`` / ``layers.{i}``;
flax LayerNorm's ``scale`` becomes ``weight``; a 3-d kernel is an attention
projection, ``[E, N, D]`` in, ``[H, D, E]`` out (``o_proj``, ``dense``,
``out_proj``); every leaf of the tree is carried, so the tree's biases are
the config's.  ``jax_mixtral_to_state_dict`` and ``jax_qwen2_moe_to_state_dict``
do the same for the MoE families (scanned ``layers`` or unrolled
``layers_{i}``, as a Qwen2-MoE mixed stack is): their expert banks
(``w_gate``, ``w_up``, ``w_down``, ``[E, in, out]``) keep the JAX layout, and
a router's kernel ``[hidden, E]`` becomes its ``gate.weight`` ``[E,
hidden]``.  The training and the serving twins of a family share their
names, so one function serves both.

The v1-only families go across by the same rules: ``jax_gpt2_to_state_dict``
(stack ``h``), ``jax_gpt_family_to_state_dict`` (BLOOM, GPT-J and GPT-Neo
stack ``h``, GPT-NeoX ``layers``), ``jax_bert_to_state_dict`` (the stack
``encoder`` under ``bert``, for BERT and DistilBERT) and
``jax_clip_to_state_dict`` (each tower's unrolled ``layers_{i}``).  Their
fused projections (``query_key_value`` ``[E, H, 3, D]``, GPT-2's ``c_attn``
``[E, 3, H, D]``) flatten their output axes in order; GPT-2's attention
``c_proj`` and BERT's attention ``output`` are output projections; the raw
parameters (``position_embedding``, ``class_embedding``, ``logit_scale``)
keep their names, and CLIP's patch kernel ``[ph, pw, C, E]`` becomes the
``Conv2d`` weight ``[E, C, ph, pw]``.

``jax_train_state_to_engine`` carries a whole JAX training state across: a
``deepspeed_tpu`` engine's ``TrainState`` as numpy (``jax.tree.map(np.asarray,
engine.state)``) goes into a port engine built over the same model config —
parameters, float32 master, the optimizer's moments (any state tree shaped
like the parameters, by the JAX state's field names: Adam/LAMB ``exp_avg``
and ``exp_avg_sq``, Lion ``exp_avg``, Adagrad ``accum``, SGD ``momentum``)
and its step, the loss scaler, the skipped steps and the step count.  A JAX
run can then be continued by the port.

``tp_slice_state`` cuts a whole Llama-family state dict (port names; a
JAX tree through ``jax_llama_to_state_dict`` first) to tensor-parallel rank
t's slices by the Megatron layout of ``models/llama.py``'s
tensor-parallel layers (q/k/v, gate, up, ``lm_head`` and the embedding on
their output dim, o and down on their input dim); ``tp_gather_state`` puts
every rank's slices back together.

``jax_leaves`` goes the other way for the ZeRO partition rules
(``runtime/zero/partition.py``) and the universal checkpoint
(``checkpoint/ds_to_universal.py``): for each parameter of a port Llama,
Falcon, OPT, Phi, GPT-2, Mixtral or Qwen2-MoE training model, the shape of its JAX leaf in the
unrolled tree (``scan_layers=False``), whether the port tensor is that
leaf's transpose (an ``nn.Linear`` weight), the leaf's logical axes (the JAX
models' ``with_logical_partitioning``; a leaf without them, as a
``DenseGeneral`` bias or a flax ``LayerNorm`` outside GPT-2, has none) and
its path in the JAX tree.  Mixtral's expert banks ``[E, in, out]`` keep
the JAX layout (logical ``(experts, expert_embed, expert_mlp)``, ``w_down``
``(experts, expert_mlp, expert_embed)``) with the whole bank's shape, also
where the port tensor holds one rank's experts or its tensor slice of
them; its router's weight is the transpose of the kernel ``[hidden, E]``
(``(embed, experts_gate)``).  Qwen2-MoE's banks are its sparse MLP's own
``w_gate``/``w_up``/``w_down`` with the same axes, its shared expert
``(expert_embed, mlp)`` then ``(mlp, expert_embed)``, and its two gates
carry no logical axes (flax ``Dense``).
"""

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..axes import (EMBED, EXPERT_EMBED, EXPERT_MLP, EXPERTS, EXPERTS_GATE, HEAD_DIM, HEADS, KV_HEADS, MLP,
                    POSITIONS, VOCAB)
from .llama import LayerNorm, LlamaConfig, RMSNorm


def _as_np(x) -> np.ndarray:
    # a leaf may still sit in its logical-partitioning box (flax's
    # ``LogicallyPartitioned``), whose array is ``.value``
    return np.asarray(getattr(x, "value", x))


def _slice_tree(tree, i: int):
    if isinstance(tree, Mapping):
        return {k: _slice_tree(v, i) for k, v in tree.items()}
    return _as_np(tree)[i]


#: the kernels of more than two axes laid out [H, D, E] (attention output
#: projections; GPT-2's MLP ``c_proj`` and BERT's layer ``output`` are 2-d)
_OUT_PROJECTIONS = ("o_proj", "dense", "out_proj", "c_proj", "output")
#: parameters of their module kept in the JAX layout: the MoE expert banks,
#: CLIP's raw position and class embeddings and its logit scale
_RAW_LEAVES = ("w_gate", "w_up", "w_down", "position_embedding", "class_embedding", "logit_scale")


def _leaf_state(name: str, leaf: str, x: np.ndarray) -> Tuple[str, np.ndarray]:
    """One flax leaf of module ``name`` → its state-dict suffix and array."""
    if leaf == "kernel":
        if x.ndim == 4 and name == "patch_embedding":   # flax Conv [ph, pw, C, E] → Conv2d [E, C, ph, pw]
            return "weight", x.transpose(3, 2, 0, 1)
        if x.ndim > 2:
            x = x.reshape(-1, x.shape[-1]) if name in _OUT_PROJECTIONS else x.reshape(x.shape[0], -1)
        return "weight", x.T
    if leaf == "bias":
        return "bias", x.reshape(-1)
    if leaf in ("embedding", "scale", "weight"):
        return "weight", x
    if leaf in _RAW_LEAVES:
        return leaf, x
    raise KeyError(f"unknown flax leaf {name}/{leaf}")


def _flax_to_state(tree: Mapping, prefix: str, out: Dict[str, np.ndarray], module: str = "") -> None:
    """The leaves of ``tree`` (module ``module``'s, at ``prefix``) and of
    its submodules."""
    for key, sub in tree.items():
        if isinstance(sub, Mapping):
            _flax_to_state(sub, f"{prefix}{key}.", out, key)
        else:
            suffix, arr = _leaf_state(module, key, _as_np(sub))
            out[prefix + suffix] = arr


def _tree_state(tree: Mapping, stack: str, num_layers: int, prefix: str, state: Dict[str, np.ndarray]) -> None:
    """The leaves of ``tree`` (a layer stack ``stack`` scanned, or unrolled
    as ``{stack}_{i}``) into ``state`` under ``prefix``."""
    p = dict(tree)
    if stack in p:
        scanned = p.pop(stack)
        layers = [_slice_tree(scanned, i) for i in range(num_layers)]
    else:
        layers = [p.pop(f"{stack}_{i}") for i in range(num_layers)]
    _flax_to_state(p, prefix, state)
    for i, layer in enumerate(layers):
        _flax_to_state(layer, f"{prefix}{stack}.{i}.", state)


def _torch_state(state: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in state.items()}


def _unwrap(params: Mapping) -> Dict[str, Any]:
    return dict(params["params"] if "params" in params else params)


def _zoo_state(params: Mapping, stack: str, num_layers: int) -> Dict[str, torch.Tensor]:
    """A JAX model's params (scanned ``stack`` or unrolled ``{stack}_{i}``)
    as the port's state dict."""
    state: Dict[str, np.ndarray] = {}
    _tree_state(_unwrap(params), stack, num_layers, "", state)
    return _torch_state(state)


def jax_llama_to_state_dict(params: Mapping, cfg: LlamaConfig) -> Dict[str, torch.Tensor]:
    """The port's state dict (contiguous CPU tensors in the tree's dtype)."""
    p = dict(params["params"] if "params" in params else params)
    p.update(p.pop("model"))   # the trunk's layers sit under ``model`` in the JAX tree
    return _zoo_state(p, "layers", cfg.num_hidden_layers)


def jax_falcon_to_state_dict(params: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """JAX ``FalconForCausalLM`` (or its cache twin) params → the state dict of
    ``falcon.FalconForCausalLM`` and ``cache_zoo.FalconForCausalLMWithCache``."""
    return _zoo_state(params, "h", cfg.num_hidden_layers)


def jax_opt_to_state_dict(params: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """JAX ``OPTForCausalLM`` (or its cache twin) params → the state dict of
    ``opt.OPTForCausalLM`` and ``cache_zoo.OPTForCausalLMWithCache``."""
    return _zoo_state(params, "layers", cfg.num_hidden_layers)


def jax_phi_to_state_dict(params: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """JAX ``PhiForCausalLM`` (or its cache twin) params → the state dict of
    ``phi.PhiForCausalLM`` and ``cache_zoo.PhiForCausalLMWithCache``."""
    return _zoo_state(params, "layers", cfg.num_hidden_layers)


def jax_mixtral_to_state_dict(params: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """JAX ``MixtralForCausalLM`` (or its cache twin) params → the state dict
    of ``mixtral.MixtralForCausalLM`` and ``mixtral_cache.MixtralForCausalLMWithCache``."""
    return _zoo_state(params, "layers", cfg.num_hidden_layers)


def jax_qwen2_moe_to_state_dict(params: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """JAX ``Qwen2MoeForCausalLM`` (or its cache twin) params → the state
    dict of ``qwen2_moe.Qwen2MoeForCausalLM`` and
    ``cache_zoo.Qwen2MoeForCausalLMWithCache``."""
    return _zoo_state(params, "layers", cfg.num_hidden_layers)


def jax_gpt2_to_state_dict(params: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """JAX ``GPT2LMHeadModel`` params → ``gpt2.GPT2LMHeadModel``'s state dict."""
    return _zoo_state(params, "h", cfg.num_hidden_layers)


def jax_gpt_family_to_state_dict(params: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """JAX BLOOM, GPT-NeoX, GPT-J or GPT-Neo params → the state dict of the
    matching ``gpt_family`` model (GPT-NeoX stacks ``layers``, the others ``h``)."""
    from .gpt_family import GPTNeoXConfig
    return _zoo_state(params, "layers" if isinstance(cfg, GPTNeoXConfig) else "h", cfg.num_hidden_layers)


def jax_bert_to_state_dict(params: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """JAX ``BertForMaskedLM`` / ``BertForSequenceClassification`` (or a bare
    ``BertModel``'s) params → the port's state dict."""
    p = _unwrap(params)
    state: Dict[str, np.ndarray] = {}
    if "bert" in p:
        _tree_state(p.pop("bert"), "encoder", cfg.num_hidden_layers, "bert.", state)
        _flax_to_state(p, "", state)
    else:
        _tree_state(p, "encoder", cfg.num_hidden_layers, "", state)
    return _torch_state(state)


def jax_clip_to_state_dict(params: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """JAX ``ClipModel`` params → ``clip.ClipModel``'s state dict (``cfg`` a
    ``ClipConfig``)."""
    p = _unwrap(params)
    state: Dict[str, np.ndarray] = {}
    for tower, tcfg in (("text_model", cfg.text), ("vision_model", cfg.vision)):
        _tree_state(p.pop(tower), "layers", tcfg.num_hidden_layers, tower + ".", state)
    _flax_to_state(p, "", state)
    return _torch_state(state)


@dataclasses.dataclass(frozen=True)
class JaxLeaf:
    """A port parameter's JAX leaf: its shape, the port tensor's, whether
    the port tensor is the leaf's transpose (reshaped), the leaf's logical
    axes (``()`` for a leaf without them), its path in the JAX model's
    unrolled param tree (``model/layers_0/self_attn/q_proj/kernel``) and,
    for a tensor-parallel layer's tensor that holds one rank's slice, the
    dim of the port tensor it is cut on (``tp_dim``, the whole tensor's
    size there ``tp_size`` times the port tensor's)."""
    shape: Tuple[int, ...]
    port_shape: Tuple[int, ...]
    transposed: bool
    logical: Tuple[Optional[str], ...]
    path: str = ""
    tp_dim: Optional[int] = None
    tp_size: int = 1

    @property
    def whole_port_shape(self) -> Tuple[int, ...]:
        """The port tensor's shape whole over the tensor axis (an expert
        bank keeps its rank's experts)."""
        if self.tp_dim is None:
            return self.port_shape
        shape = list(self.port_shape)
        shape[self.tp_dim] *= self.tp_size
        return tuple(shape)


#: the kinds of JAX projection behind an ``nn.Linear``: ``heads`` a
#: ``DenseGeneral`` to ``(N, D)`` (kernel ``[E, N, D]``, bias ``[N, D]``),
#: ``out`` one over ``(H, D)`` (kernel ``[H, D, E]``), ``dense`` a 2-d kernel,
#: ``qkv3`` GPT-2's fused ``c_attn`` (kernel ``[E, 3, H, D]``, bias ``[3, H, D]``)
_HEADS, _OUT, _DENSE, _QKV3 = "heads", "out", "dense", "qkv3"

_Q = (_HEADS, (EMBED, HEADS, HEAD_DIM), ())
_KV = (_HEADS, (EMBED, KV_HEADS, HEAD_DIM), ())
_O = (_OUT, (HEADS, HEAD_DIM, EMBED), ())
_UP = (_DENSE, (EMBED, MLP), ())
_DOWN = (_DENSE, (MLP, EMBED), ())
_HEAD = (_DENSE, (EMBED, VOCAB), ())

#: per family, each ``nn.Linear`` by its module's name (or ``parent.name``)
#: → (kind, the kernel's logical axes, the bias's), from the JAX models'
#: ``with_logical_partitioning`` calls (``deepspeed_tpu/models/{llama,falcon,
#: opt,phi,gpt2}.py``); a kernel the JAX model leaves unannotated has ``()``
_LINEARS = {
    "llama": {"q_proj": _Q, "k_proj": _KV, "v_proj": _KV, "o_proj": _O, "gate_proj": _UP, "up_proj": _UP,
              "down_proj": _DOWN, "lm_head": _HEAD},
    "falcon": {"q_proj": _Q, "k_proj": _KV, "v_proj": _KV, "dense": _O, "dense_h_to_4h": _UP,
               "dense_4h_to_h": _DOWN, "lm_head": _HEAD},
    "opt": {"q_proj": _Q, "k_proj": _KV, "v_proj": _KV, "out_proj": _O, "fc1": _UP, "fc2": _DOWN, "lm_head": _HEAD,
            "project_in": (_DENSE, (), ()), "project_out": (_DENSE, (), ())},
    "phi": {"q_proj": _Q, "k_proj": _KV, "v_proj": _KV, "dense": _O, "fc1": _UP, "fc2": _DOWN, "lm_head": _HEAD},
    "mixtral": {"q_proj": _Q, "k_proj": _KV, "v_proj": _KV, "o_proj": _O, "lm_head": _HEAD},
    "qwen2_moe": {"q_proj": _Q, "k_proj": _KV, "v_proj": _KV, "o_proj": _O, "gate_proj": _UP, "up_proj": _UP,
                  "down_proj": _DOWN, "lm_head": _HEAD, "shared_gate_proj": (_DENSE, (EXPERT_EMBED, MLP), ()),
                  "shared_up_proj": (_DENSE, (EXPERT_EMBED, MLP), ()),
                  "shared_down_proj": (_DENSE, (MLP, EXPERT_EMBED), ())},
    "gpt2": {"attn.c_attn": (_QKV3, (EMBED, None, HEADS, HEAD_DIM), (None, HEADS, HEAD_DIM)),
             "attn.c_proj": (_OUT, (HEADS, HEAD_DIM, EMBED), (EMBED, )),
             "mlp.c_fc": (_DENSE, (EMBED, MLP), (MLP, )), "mlp.c_proj": (_DENSE, (MLP, EMBED), (EMBED, )),
             "lm_head": _HEAD},
}
#: per family, each ``nn.Embedding`` by name → its logical axes
_EMBEDDINGS = {"llama": {"embed_tokens": (VOCAB, EMBED)}, "mixtral": {"embed_tokens": (VOCAB, EMBED)},
               "qwen2_moe": {"embed_tokens": (VOCAB, EMBED)},
               "falcon": {"word_embeddings": (VOCAB, EMBED)},
               "opt": {"embed_tokens": (VOCAB, EMBED), "embed_positions": ()}, "phi": {"embed_tokens": (VOCAB, EMBED)},
               "gpt2": {"wte": (VOCAB, EMBED), "wpe": (POSITIONS, EMBED)}}


def _family(model: nn.Module) -> str:
    from .falcon import FalconForCausalLM
    from .gpt2 import GPT2LMHeadModel
    from .llama import LlamaForCausalLM
    from .mixtral import MixtralForCausalLM
    from .opt import OPTForCausalLM
    from .phi import PhiForCausalLM
    from .qwen2_moe import Qwen2MoeForCausalLM
    for cls, name in ((LlamaForCausalLM, "llama"), (FalconForCausalLM, "falcon"), (OPTForCausalLM, "opt"),
                      (PhiForCausalLM, "phi"), (GPT2LMHeadModel, "gpt2"), (MixtralForCausalLM, "mixtral"),
                      (Qwen2MoeForCausalLM, "qwen2_moe")):
        if type(model) is cls:
            return name
    raise NotImplementedError(f"{type(model).__name__}: its JAX leaves are known for the Llama, Falcon, OPT, Phi, "
                              "GPT-2, Mixtral and Qwen2-MoE training models only, so it cannot be partitioned over "
                              "several ranks")


def _jax_path(family: str, module_name: str, leaf: str) -> str:
    """The JAX unrolled tree's path of a port module's leaf: ``<stack>.<i>``
    becomes ``<stack>_<i>``; Llama's blocks sit under ``model``."""
    parts = module_name.split(".") if module_name else []
    out = []
    for p in parts:
        if p.isdigit() and out:
            out[-1] = f"{out[-1]}_{p}"
        else:
            out.append(p)
    if family == "llama" and out and out[0].startswith("layers_"):
        out.insert(0, "model")
    return "/".join(out + [leaf])


def jax_leaves(model: nn.Module) -> Dict[str, JaxLeaf]:
    """For each parameter of a port training model of the Llama family
    (Llama, Mistral, Qwen2, InternLM, Phi-3), Falcon, OPT, Phi, GPT-2,
    Mixtral or Qwen2-MoE, its JAX leaf in the unrolled tree
    (``scan_layers=False``).  A tensor-parallel slice has the whole tensor's
    leaf (a q/k/v bias too, whose JAX leaf carries no logical axes).
    Another model raises ``NotImplementedError``."""
    from ..module_inject.layers import tp_dims
    from ..moe.experts import ExpertsFFN
    from ..moe.layer import Router
    from .qwen2_moe import Qwen2MoeSparseMLP
    family = _family(model)
    cfg = model.cfg
    hd = cfg.head_dim
    linears, embeds = _LINEARS[family], _EMBEDDINGS[family]
    cut = tp_dims(model)
    out: Dict[str, JaxLeaf] = {}
    for mname, mod in model.named_modules():
        short = mname.rsplit(".", 1)[-1]
        pair = ".".join(mname.split(".")[-2:])
        n_tp = getattr(getattr(mod, "tp", None), "size", 1)
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            local = tuple(p.shape)
            tp_dim = cut.get(name) if n_tp > 1 else None
            shape = local if tp_dim is None else local[:tp_dim] + (local[tp_dim] * n_tp, ) + local[tp_dim + 1:]
            if isinstance(mod, (ExpertsFFN, Qwen2MoeSparseMLP)):
                logical = (EXPERTS, EXPERT_MLP, EXPERT_EMBED) if pname == "w_down" else \
                    (EXPERTS, EXPERT_EMBED, EXPERT_MLP)
                experts = mod.num_experts if isinstance(mod, ExpertsFFN) else shape[0]
                leaf = JaxLeaf((experts, ) + shape[1:], local, False, logical, _jax_path(family, mname, pname))
            elif isinstance(mod, Router):
                # Qwen2-MoE's gates are flax ``Dense`` kernels without logical axes
                logical = () if family == "qwen2_moe" else (EMBED, EXPERTS_GATE)
                leaf = JaxLeaf(shape[::-1], shape, True, logical, _jax_path(family, mname, "kernel"))
            elif isinstance(mod, nn.Embedding) and short in embeds:
                leaf = JaxLeaf(shape, local, False, embeds[short], _jax_path(family, mname, "embedding"))
            elif isinstance(mod, RMSNorm):
                leaf = JaxLeaf(shape, shape, False, (EMBED, ), _jax_path(family, mname, "weight"))
            elif isinstance(mod, LayerNorm):
                # flax LayerNorm: ``scale`` and ``bias``, annotated in GPT-2 only
                logical = (EMBED, ) if family == "gpt2" else ()
                leaf = JaxLeaf(shape, shape, False, logical,
                               _jax_path(family, mname, "scale" if pname == "weight" else "bias"))
            elif isinstance(mod, nn.Linear) and (pair in linears or short in linears):
                kind, kernel_axes, bias_axes = linears[pair] if pair in linears else linears[short]
                if pname == "weight":
                    fan_out, fan_in = shape
                    jshape = {_HEADS: (fan_in, fan_out // hd, hd), _OUT: (fan_in // hd, hd, fan_out),
                              _DENSE: (fan_in, fan_out), _QKV3: (fan_in, 3, fan_out // (3 * hd), hd)}[kind]
                    leaf = JaxLeaf(jshape, local, True, kernel_axes, _jax_path(family, mname, "kernel"))
                else:
                    jshape = {_HEADS: (shape[0] // hd, hd), _QKV3: (3, shape[0] // (3 * hd), hd)}.get(kind, shape)
                    leaf = JaxLeaf(jshape, local, False, bias_axes, _jax_path(family, mname, "bias"))
            else:
                raise NotImplementedError(f"parameter {name!r} of {type(model).__name__}: no JAX leaf is known for it")
            if tp_dim is not None:
                leaf = dataclasses.replace(leaf, tp_dim=tp_dim, tp_size=n_tp)
            out[name] = leaf
    return out


def _fields(x: Any) -> Dict[str, Any]:
    """A NamedTuple's (or a mapping's) fields as a dict."""
    return dict(x._asdict()) if hasattr(x, "_asdict") else dict(x)


@torch.no_grad()
def jax_train_state_to_engine(state: Any, engine, cfg: LlamaConfig):
    """Load a JAX ``TrainState`` (as numpy) into the port ``engine`` (see
    the module docstring); returns the engine."""
    from ..runtime.fp16.loss_scaler import LossScalerState
    fields = _fields(state)
    engine.load_module_state_dict(jax_llama_to_state_dict(fields["params"], cfg))
    if engine.use_master:
        engine.load_full_master(jax_llama_to_state_dict(fields["master"], cfg))
    opt = engine.optimizer
    opt_fields = _fields(fields["opt_state"])
    step = opt_fields.pop("step", None)
    for key, tree in opt_fields.items():
        if isinstance(tree, tuple) and not tree:   # SGD without momentum keeps no state
            continue
        moments = jax_llama_to_state_dict(tree, cfg)
        for i, (name, t) in enumerate(zip(engine.param_names, engine._targets)):
            opt.state[t][key] = engine.local_state(i, moments[name]).to(t.device).clone()
    if step is not None:
        opt.step_count = int(np.asarray(step))
        opt._device_step = None   # rebuilt from step_count at the next overflow-checked step
    engine.scaler_state = LossScalerState(**{k: torch.as_tensor(np.array(v)).to(engine.device)
                                             for k, v in _fields(fields["scaler"]).items()})
    engine.skipped.fill_(int(np.asarray(fields["skipped_steps"])))
    engine.global_steps = int(np.asarray(fields["step"]))
    engine.global_samples = engine.global_steps * engine.train_batch_size()
    return engine


def _llama_tp_dims(cfg, tp_size: int) -> Dict[str, int]:
    """Parameter name → the dim cut over ``tp_size`` tensor-parallel ranks,
    from the layers of a Llama-family model built on the meta device."""
    from ..module_inject.layers import tp_dims
    from .llama import LlamaForCausalLM
    return tp_dims(LlamaForCausalLM(cfg, device="meta", tensor_parallel=tp_size))


def tp_slice_state(state: Mapping[str, Any], cfg, tp_size: int, tp_rank: int) -> Dict[str, torch.Tensor]:
    """Rank ``tp_rank``'s slices of a whole Llama-family state dict over
    ``tp_size`` ranks (config ``cfg``): each cut tensor narrowed to rows (or
    columns) ``[t·n, (t+1)·n)`` (a view of the whole tensor), the rest as
    they are."""
    from ..module_inject.layers import TensorParallel, slice_state
    dims = _llama_tp_dims(cfg, tp_size) if tp_size > 1 else {}
    return slice_state({name: torch.as_tensor(v) for name, v in state.items()}, dims, TensorParallel(tp_size, tp_rank))


def tp_gather_state(slices, cfg) -> Dict[str, torch.Tensor]:
    """The whole state dict from every rank's ``tp_slice_state`` (in rank order)."""
    dims = _llama_tp_dims(cfg, len(slices)) if len(slices) > 1 else {}
    return {name: torch.cat([torch.as_tensor(s[name]) for s in slices], dim=dims[name]) if name in dims
            else torch.as_tensor(slices[0][name]) for name in slices[0]}
