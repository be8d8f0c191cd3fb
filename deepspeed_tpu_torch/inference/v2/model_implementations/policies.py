"""HF checkpoint → the port's paged twins (port of
``deepspeed_tpu/inference/v2/model_implementations/policies.py``).

A policy is (a) a config translation, HF ``config.json`` (a mapping or a
namespace) → the family's config, and (b) a weight translation, an HF state
dict → the state dict of the family's paged twin (``build_cache_model``).
The port's modules keep torch's ``[out, in]`` weights, so most tensors map
by name; the fused ones are split by rows: Phi-3's ``qkv_proj`` and
``gate_up_proj``, Falcon's ``query_key_value`` in its MQA, new-architecture
(per KV group ``[q…, k, v]``) and per-head MHA layouts (JAX ``:366-470``);
the MoE families' per-expert ``[out, in]`` weights are stacked into the
twins' ``[E, in, out]`` banks (JAX ``_experts``).
A policy makes the twin's keys from the config and takes each from the
checkpoint: a tensor the twin needs and the checkpoint lacks raises
``KeyError``; tensors the twin does not use (rotary caches) are left.
Tensors keep their dtype and device, and a split makes contiguous copies,
so a checkpoint already on the card converts there.

Served: llama, mistral, qwen2, internlm, phi3 (Llama twin), opt, phi,
falcon and qwen2_moe (``models/cache_zoo.py``), and mixtral
(``models/mixtral_cache.py``).  The other model types of the JAX
registry raise ``NotImplementedError`` naming their ROADMAP item; an
unknown one raises ``ValueError``.
"""

import re
from typing import Callable, Dict, Mapping

import torch

from ....models.cache_zoo import build_cache_model
from ....models.falcon import FalconConfig
from ....models.llama import LlamaConfig, hf_value
from ....models.mixtral import MixtralConfig
from ....models.opt import OPTConfig
from ....models.phi import PhiConfig
from ....models.qwen2_moe import Qwen2MoeConfig

ROADMAP_V1 = "ROADMAP Queue 1 item 5.4 (the v1 engine, inference/quantization.py, and the v1-only families)"

StateDict = Dict[str, torch.Tensor]


def _lm_head(sd: Mapping, embedding: str) -> torch.Tensor:
    """``lm_head.weight``, or the embedding where the checkpoint has no head
    (JAX ``_tied_lm_head``)."""
    return sd["lm_head.weight"] if "lm_head.weight" in sd else sd[embedding]


def _take(sd: Mapping, cfg, name: Callable[[str], str], head: str) -> StateDict:
    """The twin's state dict: each of its keys from the checkpoint's
    ``name(key)``; the LM head's under its own name, its weight by
    ``_lm_head``."""
    out = {}
    for k in build_cache_model(cfg, 16, device="meta").state_dict():
        if k == "lm_head.weight":
            out[k] = _lm_head(sd, head)
        else:
            out[k] = sd[k if k.startswith("lm_head.") else name(k)]
    return out


class InferenceV2Policy:
    """The Llama layout (ref: ``inference_policy_base.py``): ``model.`` +
    the port's key."""
    model_type = None

    def build_config(self, hf_cfg):
        return LlamaConfig.from_hf(hf_cfg)

    def convert(self, sd: Mapping[str, torch.Tensor], cfg) -> StateDict:
        return _take(sd, cfg, lambda k: "model." + k, "model.embed_tokens.weight")


class LlamaPolicy(InferenceV2Policy):
    """HF Llama's ``attention_bias`` covers q/k/v AND o_proj."""
    model_type = "llama"

    def build_config(self, hf_cfg):
        return LlamaConfig.from_hf(hf_cfg, attention_out_bias=hf_value(hf_cfg, "attention_bias", False))


class MistralPolicy(InferenceV2Policy):
    """The Llama layout; the sliding window goes to K3."""
    model_type = "mistral"


class Qwen2Policy(InferenceV2Policy):
    """The Llama layout with q/k/v biases (o_proj has none)."""
    model_type = "qwen2"

    def build_config(self, hf_cfg):
        return LlamaConfig.from_hf(hf_cfg, attention_bias=True)


class InternLMPolicy(InferenceV2Policy):
    """InternLM-1: its config spells the attention bias ``bias``, and its
    checkpoints carry q/k/v AND o_proj biases."""
    model_type = "internlm"

    def build_config(self, hf_cfg):
        bias = bool(hf_value(hf_cfg, "bias", False))
        return LlamaConfig.from_hf(hf_cfg, attention_bias=bias, attention_out_bias=bias)


class Phi3Policy(InferenceV2Policy):
    """The fused ``qkv_proj`` (rows q, k, v) and ``gate_up_proj`` (rows
    gate, up) split into the Llama layout."""
    model_type = "phi3"

    def convert(self, sd, cfg):
        q_rows, kv_rows = cfg.num_attention_heads * cfg.head_dim, cfg.num_key_value_heads * cfg.head_dim
        expanded = {}
        for name, t in sd.items():
            m = re.fullmatch(r"(model\.layers\.\d+)\.self_attn\.qkv_proj\.weight", name)
            if m:
                for part, w in zip(("q", "k", "v"), torch.split(t, [q_rows, kv_rows, kv_rows])):
                    expanded[f"{m.group(1)}.self_attn.{part}_proj.weight"] = w.contiguous()
                continue
            m = re.fullmatch(r"(model\.layers\.\d+)\.mlp\.gate_up_proj\.weight", name)
            if m:
                gate, up = torch.chunk(t, 2)
                expanded[f"{m.group(1)}.mlp.gate_proj.weight"] = gate.contiguous()
                expanded[f"{m.group(1)}.mlp.up_proj.weight"] = up.contiguous()
                continue
            expanded[name] = t
        return super().convert(expanded, cfg)


class OPTPolicy(InferenceV2Policy):
    """``model.decoder.`` + the port's key (learned positions, the optional
    ``project_in``/``project_out`` of OPT-350M)."""
    model_type = "opt"

    def build_config(self, hf_cfg):
        return OPTConfig.from_hf(hf_cfg)

    def convert(self, sd, cfg):
        return _take(sd, cfg, lambda k: "model.decoder." + k, "model.decoder.embed_tokens.weight")


class PhiPolicy(InferenceV2Policy):
    """``model.`` + the port's key, the MLP under ``mlp.`` in HF."""
    model_type = "phi"

    def build_config(self, hf_cfg):
        return PhiConfig.from_hf(hf_cfg)

    def convert(self, sd, cfg):
        return _take(sd, cfg, lambda k: "model." + re.sub(r"^(layers\.\d+)\.(fc[12])", r"\1.mlp.\2", k),
                     "model.embed_tokens.weight")


class FalconPolicy(InferenceV2Policy):
    """``transformer.`` + the port's key (the MLP under ``mlp.`` in HF); the
    fused ``query_key_value`` split by its layout."""
    model_type = "falcon"

    def build_config(self, hf_cfg):
        return FalconConfig.from_hf(hf_cfg)

    @staticmethod
    def split_qkv(t: torch.Tensor, cfg: FalconConfig):
        """q, k, v rows of a fused weight ``[rows, E]`` or bias ``[rows]``:
        per KV group ``[q × H/KV, k, v]`` (new architecture), ``[q × H, k,
        v]`` (Falcon-7B's MQA), or per head ``[q, k, v]`` (Falcon-RW)."""
        h, kv, d = cfg.num_attention_heads, cfg.num_kv_heads, cfg.head_dim
        trailing = tuple(t.shape[1:])
        if cfg.new_decoder_architecture:
            qpk = h // kv
            g = t.reshape(kv, qpk + 2, d, *trailing)
            parts = g[:, :qpk], g[:, qpk], g[:, qpk + 1]
        elif kv == 1:
            g = t.reshape(h + 2, d, *trailing)
            parts = g[:h], g[h:h + 1], g[h + 1:]
        else:
            g = t.reshape(h, 3, d, *trailing)
            parts = g[:, 0], g[:, 1], g[:, 2]
        return [p.reshape((-1, ) + trailing).contiguous() for p in parts]

    def convert(self, sd, cfg):
        expanded = dict(sd)
        for name, t in sd.items():
            m = re.fullmatch(r"(transformer\.h\.\d+\.self_attention)\.query_key_value\.(weight|bias)", name)
            if m:
                for part, w in zip(("q", "k", "v"), self.split_qkv(t, cfg)):
                    expanded[f"{m.group(1)}.{part}_proj.{m.group(2)}"] = w
        return _take(expanded, cfg,
                     lambda k: "transformer." + re.sub(r"^(h\.\d+)\.(dense_h_to_4h|dense_4h_to_h)", r"\1.mlp.\2", k),
                     "transformer.word_embeddings.weight")


def stack_experts(sd: Mapping, fmt: str, num_experts: int) -> torch.Tensor:
    """``[E, in, out]`` from the per-expert ``[out, in]`` weights named
    ``fmt.format(e=e)`` (JAX ``_experts``)."""
    return torch.stack([sd[fmt.format(e=e)].T for e in range(num_experts)])


class MixtralPolicy(InferenceV2Policy):
    """The Llama layout with ``block_sparse_moe.{gate, experts.{e}.w1/w3/w2}``:
    HF's w1 is the gate projection, w3 the up and w2 the down (JAX ``:258``)."""
    model_type = "mixtral"

    def build_config(self, hf_cfg):
        return MixtralConfig.from_hf(hf_cfg)

    def convert(self, sd, cfg):
        expanded = dict(sd)
        for i in range(cfg.num_hidden_layers):
            p = f"model.layers.{i}.block_sparse_moe.experts"
            for ours, theirs in (("w_gate", "w1"), ("w_up", "w3"), ("w_down", "w2")):
                expanded[f"{p}.{ours}"] = stack_experts(sd, f"{p}.{{e}}.{theirs}.weight", cfg.num_local_experts)
        return _take(expanded, cfg, lambda k: "model." + k, "model.embed_tokens.weight")


class Qwen2MoePolicy(InferenceV2Policy):
    """The Llama layout with q/k/v biases; a sparse layer's ``mlp.{gate,
    experts.{e}.{gate,up,down}_proj, shared_expert.*, shared_expert_gate}``,
    a dense one's ``mlp.{gate,up,down}_proj`` (JAX ``:473``)."""
    model_type = "qwen2_moe"

    def build_config(self, hf_cfg):
        return Qwen2MoeConfig.from_hf(hf_cfg)

    def convert(self, sd, cfg):
        expanded = dict(sd)
        for i in range(cfg.num_hidden_layers):
            if cfg.layer_is_sparse(i):
                p = f"model.layers.{i}.mlp"
                for proj in ("gate", "up", "down"):
                    expanded[f"{p}.w_{proj}"] = stack_experts(sd, f"{p}.experts.{{e}}.{proj}_proj.weight",
                                                              cfg.num_experts)
        shared = lambda k: re.sub(r"\.mlp\.shared_(gate|up|down)_proj\.", r".mlp.shared_expert.\1_proj.", k)
        return _take(expanded, cfg, lambda k: "model." + shared(k), "model.embed_tokens.weight")


class UnportedPolicy(InferenceV2Policy):
    """A model type of the JAX registry the port does not serve yet."""

    def __init__(self, model_type: str, item: str):
        self.model_type, self.item = model_type, item

    def _refuse(self):
        raise NotImplementedError(f"model_type {self.model_type!r} is not served by the port yet ({self.item})")

    def build_config(self, hf_cfg):
        self._refuse()

    def convert(self, sd, cfg):
        self._refuse()


POLICY_REGISTRY = {
    "llama": LlamaPolicy(),
    "mistral": MistralPolicy(),
    "qwen2": Qwen2Policy(),
    "internlm": InternLMPolicy(),
    "phi3": Phi3Policy(),
    "opt": OPTPolicy(),
    "phi": PhiPolicy(),
    "falcon": FalconPolicy(),
    "mixtral": MixtralPolicy(),
    "qwen2_moe": Qwen2MoePolicy(),
    # megatron-gpt-moe is Megatron GPT (the v1 engine's NeoX twin) with an expert bank
    **{t: UnportedPolicy(t, ROADMAP_V1)
       for t in ("megatron-gpt", "megatron-gpt-moe", "bloom", "gpt_neox", "gptj", "gpt_neo", "bert", "distilbert",
                 "clip", "qwen")},
}


def policy_for(model_type: str) -> InferenceV2Policy:
    if model_type not in POLICY_REGISTRY:
        raise ValueError(f"no inference policy for model_type={model_type!r}; known: {sorted(POLICY_REGISTRY)}")
    return POLICY_REGISTRY[model_type]


def convert_hf_state_dict(sd: Mapping[str, torch.Tensor], hf_cfg, model_type=None):
    """(the family's config, the twin's state dict) from an HF state dict and config."""
    policy = policy_for(model_type or hf_value(hf_cfg, "model_type", "llama"))
    cfg = policy.build_config(hf_cfg)
    return cfg, policy.convert(sd, cfg)
