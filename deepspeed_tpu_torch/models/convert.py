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
  mlp/{gate,up}_proj/kernel [E, I]     → layers.i.mlp.{gate,up}_proj.weight [I, E]
  mlp/down_proj/kernel [I, E]          → layers.i.mlp.down_proj.weight [E, I]
  {input,post_attention}_layernorm/weight, norm/weight [E] → unchanged
  lm_head/kernel [E, V]                → lm_head.weight [V, E]        (absent when tied)
"""

from typing import Dict, Mapping

import numpy as np
import torch

from .llama import LlamaConfig


def _as_np(x) -> np.ndarray:
    # a leaf may still sit in its logical-partitioning box (flax's
    # ``LogicallyPartitioned``), whose array is ``.value``
    return np.asarray(getattr(x, "value", x))


def _layer_state(layer: Mapping, prefix: str, cfg: LlamaConfig) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    attn = layer["self_attn"]
    for name in ("q_proj", "k_proj", "v_proj"):
        kernel = _as_np(attn[name]["kernel"])                      # [E, N, D]
        out[f"{prefix}.self_attn.{name}.weight"] = kernel.reshape(kernel.shape[0], -1).T
        if cfg.attention_bias:
            out[f"{prefix}.self_attn.{name}.bias"] = _as_np(attn[name]["bias"]).reshape(-1)
    o = _as_np(attn["o_proj"]["kernel"])                          # [H, D, E]
    out[f"{prefix}.self_attn.o_proj.weight"] = o.reshape(-1, o.shape[-1]).T
    for name in ("gate_proj", "up_proj", "down_proj"):
        out[f"{prefix}.mlp.{name}.weight"] = _as_np(layer["mlp"][name]["kernel"]).T
    for name in ("input_layernorm", "post_attention_layernorm"):
        out[f"{prefix}.{name}.weight"] = _as_np(layer[name]["weight"])
    return out


def _slice_tree(tree, i: int):
    if isinstance(tree, Mapping):
        return {k: _slice_tree(v, i) for k, v in tree.items()}
    return _as_np(tree)[i]


def jax_llama_to_state_dict(params: Mapping, cfg: LlamaConfig) -> Dict[str, torch.Tensor]:
    """The port's state dict (contiguous CPU tensors in the tree's dtype)."""
    p = params["params"] if "params" in params else params
    model = p["model"]
    if "layers" in model:
        layers = [_slice_tree(model["layers"], i) for i in range(cfg.num_hidden_layers)]
    else:
        layers = [model[f"layers_{i}"] for i in range(cfg.num_hidden_layers)]
    state: Dict[str, np.ndarray] = {"embed_tokens.weight": _as_np(p["embed_tokens"]["embedding"]),
                                    "norm.weight": _as_np(p["norm"]["weight"])}
    for i, layer in enumerate(layers):
        state.update(_layer_state(layer, f"layers.{i}", cfg))
    if not cfg.tie_word_embeddings:
        state["lm_head.weight"] = _as_np(p["lm_head"]["kernel"]).T
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in state.items()}
