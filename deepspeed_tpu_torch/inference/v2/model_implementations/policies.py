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

Served by the paged engine: llama, mistral, qwen2, internlm, phi3 and
qwen (v1, its fused ``c_attn`` split into q/k/v) on the Llama twin; opt,
phi, falcon and qwen2_moe (``models/cache_zoo.py``); mixtral
(``models/mixtral_cache.py``).  The families without a paged twin
(``paged = False``: bloom, gpt_neox, gptj, gpt_neo, bert, distilbert,
clip, megatron-gpt and megatron-gpt-moe) map onto the v1 models
(``models/gpt_family.py``, ``bert.py``, ``clip.py``), which
``build_model`` makes and ``init_inference`` serves
(``engine_factory.build_hf_engine``).  An unknown model type raises
``ValueError``.
"""

import dataclasses
import re
from typing import Callable, Dict, Mapping

import torch

from ....accelerator import DeviceLike
from ....models import bert as bert_models
from ....models import clip as clip_models
from ....models import gpt_family
from ....models.cache_zoo import build_cache_model
from ....models.falcon import FalconConfig
from ....models.llama import LlamaConfig, hf_value
from ....models.mixtral import MixtralConfig
from ....models.opt import OPTConfig
from ....models.phi import PhiConfig
from ....models.qwen2_moe import Qwen2MoeConfig

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
    #: served by the paged engine (a cache twin), or by the v1 engine
    paged = True

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


class QwenV1Policy(InferenceV2Policy):
    """Qwen (v1, ``QWenLMHeadModel``) on the Llama twin: the fused biased
    ``c_attn`` (rows q, k, v) split, the SwiGLU as ``c_proj(w1(x)·silu(w2(x)))``
    so gate = ``w2`` and up = ``w1``, RMSNorm ``ln_1``/``ln_2`` (JAX ``:1013``)."""
    model_type = "qwen"

    def build_config(self, hf_cfg):
        heads, e = hf_value(hf_cfg, "num_attention_heads"), hf_value(hf_cfg, "hidden_size")
        return LlamaConfig(vocab_size=hf_value(hf_cfg, "vocab_size"), hidden_size=e,
                           intermediate_size=hf_value(hf_cfg, "intermediate_size", 4 * e) // 2,
                           num_hidden_layers=hf_value(hf_cfg, "num_hidden_layers"), num_attention_heads=heads,
                           num_key_value_heads=heads,
                           max_position_embeddings=hf_value(hf_cfg, "max_position_embeddings", 8192),
                           rope_theta=hf_value(hf_cfg, "rotary_emb_base", 10000.0),
                           rms_norm_eps=hf_value(hf_cfg, "layer_norm_epsilon", 1e-6), attention_bias=True,
                           tie_word_embeddings=False)

    def convert(self, sd, cfg):
        names = {"embed_tokens.weight": "transformer.wte.weight", "norm.weight": "transformer.ln_f.weight"}
        expanded = dict(sd)
        for i in range(cfg.num_hidden_layers):
            p = f"transformer.h.{i}"
            for part in ("weight", "bias"):
                for proj, t in zip("qkv", torch.chunk(sd[f"{p}.attn.c_attn.{part}"], 3)):
                    expanded[f"{p}.{proj}_proj.{part}"] = t.contiguous()
            names.update({f"layers.{i}.{ours}": f"{p}.{theirs}" for ours, theirs in (
                ("input_layernorm.weight", "ln_1.weight"), ("post_attention_layernorm.weight", "ln_2.weight"),
                ("self_attn.o_proj.weight", "attn.c_proj.weight"), ("mlp.gate_proj.weight", "mlp.w2.weight"),
                ("mlp.up_proj.weight", "mlp.w1.weight"), ("mlp.down_proj.weight", "mlp.c_proj.weight"))})
        return _take(expanded, cfg, lambda k: names.get(k) or re.sub(r"^layers\.(\d+)\.self_attn\.",
                                                                     r"transformer.h.\1.", k),
                     "transformer.wte.weight")


# ------------------------------------------------------------ the v1 families


class V1Policy(InferenceV2Policy):
    """A family without a paged twin: the v1 model of ``model_class``, its
    keys each taken from the checkpoint's ``hf_name(key)``."""
    paged = False
    model_class = None

    def build_model(self, cfg, device: DeviceLike = "cuda") -> torch.nn.Module:
        return self.model_class(cfg, device=device)

    def hf_name(self, key: str, sd: Mapping) -> str:
        raise NotImplementedError

    def convert(self, sd, cfg):
        return {k: sd[self.hf_name(k, sd)] for k in self.build_model(cfg, device="meta").state_dict()}


def _sub(key: str, *rules) -> str:
    for pattern, repl in rules:
        key = re.sub(pattern, repl, key)
    return key


class BloomPolicy(V1Policy):
    """BLOOM: the fused ``query_key_value`` rows are ``(H, 3, D)`` as the v1
    model reads them; the MLP under ``mlp.``; an optional ``transformer.``
    prefix (JAX ``:580``)."""
    model_type = "bloom"
    model_class = gpt_family.BloomForCausalLM

    def build_config(self, hf_cfg):
        return gpt_family.BloomConfig.from_hf(hf_cfg)

    def hf_name(self, key, sd):
        pre = "transformer." if any(k.startswith("transformer.") for k in sd) else ""
        return pre + _sub(key, (r"^(h\.\d+)\.(dense_h_to_4h|dense_4h_to_h)", r"\1.mlp.\2"))


class GPTNeoXPolicy(V1Policy):
    """GPT-NeoX: ``gpt_neox.`` + the attention under ``attention.`` (its
    fused rows per head ``[q | k | v]``, the v1 model's ``(H, 3, D)``) and
    the MLP under ``mlp.``; the untied ``embed_out`` at the top (JAX ``:633``)."""
    model_type = "gpt_neox"
    model_class = gpt_family.GPTNeoXForCausalLM

    def build_config(self, hf_cfg):
        return gpt_family.GPTNeoXConfig.from_hf(hf_cfg)

    def hf_name(self, key, sd):
        if key.startswith("embed_out."):
            return key
        return "gpt_neox." + _sub(key, (r"^(layers\.\d+)\.(query_key_value|dense)\.", r"\1.attention.\2."),
                                  (r"^(layers\.\d+)\.(dense_h_to_4h|dense_4h_to_h)", r"\1.mlp.\2"))


class GPTJPolicy(V1Policy):
    """GPT-J: ``transformer.`` + the attention under ``attn.`` and the MLP
    under ``mlp.``; the biased ``lm_head`` at the top (JAX ``:681``)."""
    model_type = "gptj"
    model_class = gpt_family.GPTJForCausalLM

    def build_config(self, hf_cfg):
        return gpt_family.GPTJConfig.from_hf(hf_cfg)

    def hf_name(self, key, sd):
        if key.startswith("lm_head."):
            return key
        return "transformer." + _sub(key, (r"^(h\.\d+)\.(q_proj|k_proj|v_proj|out_proj)", r"\1.attn.\2"),
                                     (r"^(h\.\d+)\.(fc_in|fc_out)", r"\1.mlp.\2"))


class GPTNeoPolicy(V1Policy):
    """GPT-Neo: ``transformer.`` + the attention under ``attn.attention.``
    and the MLP under ``mlp.`` (JAX ``:724``)."""
    model_type = "gpt_neo"
    model_class = gpt_family.GPTNeoForCausalLM

    def build_config(self, hf_cfg):
        return gpt_family.GPTNeoConfig.from_hf(hf_cfg)

    def hf_name(self, key, sd):
        return "transformer." + _sub(key, (r"^(h\.\d+)\.(q_proj|k_proj|v_proj|out_proj)", r"\1.attn.attention.\2"),
                                     (r"^(h\.\d+)\.(c_fc|c_proj)", r"\1.mlp.\2"))


class BertPolicy(V1Policy):
    """BERT's ``BertForMaskedLM`` (JAX ``:771``): absolute positions and a
    GELU only; the decoder from ``cls.predictions.decoder`` (its weight, or
    the tied word embeddings; its bias, or ``cls.predictions.bias``)."""
    model_type = "bert"
    model_class = bert_models.BertForMaskedLM
    RULES = ((r"^bert\.word_embeddings\.", "bert.embeddings.word_embeddings."),
             (r"^bert\.position_embeddings\.", "bert.embeddings.position_embeddings."),
             (r"^bert\.token_type_embeddings\.", "bert.embeddings.token_type_embeddings."),
             (r"^bert\.embeddings_ln\.", "bert.embeddings.LayerNorm."),
             (r"^bert\.encoder\.(\d+)\.attention\.(query|key|value)\.", r"bert.encoder.layer.\1.attention.self.\2."),
             (r"^bert\.encoder\.(\d+)\.attention\.output\.", r"bert.encoder.layer.\1.attention.output.dense."),
             (r"^bert\.encoder\.(\d+)\.attention_output_ln\.", r"bert.encoder.layer.\1.attention.output.LayerNorm."),
             (r"^bert\.encoder\.(\d+)\.intermediate\.", r"bert.encoder.layer.\1.intermediate.dense."),
             (r"^bert\.encoder\.(\d+)\.output\.", r"bert.encoder.layer.\1.output.dense."),
             (r"^bert\.encoder\.(\d+)\.output_ln\.", r"bert.encoder.layer.\1.output.LayerNorm."),
             (r"^transform\.", "cls.predictions.transform.dense."),
             (r"^transform_ln\.", "cls.predictions.transform.LayerNorm."))

    def build_config(self, hf_cfg):
        pet = hf_value(hf_cfg, "position_embedding_type", "absolute")
        if pet != "absolute":
            raise ValueError(f"bert position_embedding_type={pet!r} is not supported (no translation of distance "
                             "embeddings; dropping them would serve wrong logits)")
        act = hf_value(hf_cfg, "hidden_act", "gelu")
        if act not in ("gelu", "gelu_new", "gelu_python"):
            raise ValueError(f"bert hidden_act={act!r} is not supported (the model uses gelu)")
        return bert_models.BertConfig.from_hf(hf_cfg)

    def hf_name(self, key, sd):
        if key == "decoder.weight":
            return "cls.predictions.decoder.weight" if "cls.predictions.decoder.weight" in sd \
                else "bert.embeddings.word_embeddings.weight"
        if key == "decoder.bias":
            return "cls.predictions.decoder.bias" if "cls.predictions.decoder.bias" in sd else "cls.predictions.bias"
        return _sub(key, *self.RULES)


class DistilBertPolicy(V1Policy):
    """DistilBERT on the BERT model (JAX ``:844``): no token types (a zero
    table makes their add a no-op), renamed modules."""
    model_type = "distilbert"
    model_class = bert_models.BertForMaskedLM
    RULES = ((r"^bert\.(word|position)_embeddings\.", r"distilbert.embeddings.\1_embeddings."),
             (r"^bert\.embeddings_ln\.", "distilbert.embeddings.LayerNorm."),
             (r"^bert\.encoder\.(\d+)\.attention\.query\.", r"distilbert.transformer.layer.\1.attention.q_lin."),
             (r"^bert\.encoder\.(\d+)\.attention\.key\.", r"distilbert.transformer.layer.\1.attention.k_lin."),
             (r"^bert\.encoder\.(\d+)\.attention\.value\.", r"distilbert.transformer.layer.\1.attention.v_lin."),
             (r"^bert\.encoder\.(\d+)\.attention\.output\.", r"distilbert.transformer.layer.\1.attention.out_lin."),
             (r"^bert\.encoder\.(\d+)\.attention_output_ln\.", r"distilbert.transformer.layer.\1.sa_layer_norm."),
             (r"^bert\.encoder\.(\d+)\.intermediate\.", r"distilbert.transformer.layer.\1.ffn.lin1."),
             (r"^bert\.encoder\.(\d+)\.output\.", r"distilbert.transformer.layer.\1.ffn.lin2."),
             (r"^bert\.encoder\.(\d+)\.output_ln\.", r"distilbert.transformer.layer.\1.output_layer_norm."),
             (r"^transform\.", "vocab_transform."), (r"^transform_ln\.", "vocab_layer_norm."),
             (r"^decoder\.", "vocab_projector."))

    def build_config(self, hf_cfg):
        act = hf_value(hf_cfg, "activation", "gelu")
        if act != "gelu":
            raise ValueError(f"distilbert activation={act!r} is not supported (the model uses gelu)")
        return bert_models.BertConfig(vocab_size=hf_value(hf_cfg, "vocab_size"), hidden_size=hf_value(hf_cfg, "dim"),
                                      num_hidden_layers=hf_value(hf_cfg, "n_layers"),
                                      num_attention_heads=hf_value(hf_cfg, "n_heads"),
                                      intermediate_size=hf_value(hf_cfg, "hidden_dim"),
                                      max_position_embeddings=hf_value(hf_cfg, "max_position_embeddings"),
                                      type_vocab_size=2, layer_norm_eps=1e-12)

    def convert(self, sd, cfg):
        key = "bert.token_type_embeddings.weight"
        ref = sd["distilbert.embeddings.word_embeddings.weight"]
        return super().convert({**sd, key: torch.zeros(cfg.type_vocab_size, cfg.hidden_size, dtype=ref.dtype,
                                                       device=ref.device)}, cfg)

    def hf_name(self, key, sd):
        return key if key == "bert.token_type_embeddings.weight" else _sub(key, *self.RULES)


class ClipPolicy(V1Policy):
    """CLIP's dual encoder (JAX ``:918``): quick-GELU towers only; HF's
    ``Conv2d`` patch kernel is the v1 model's as it is."""
    model_type = "clip"
    RULES = ((r"^text_model\.token_embedding\.", "text_model.embeddings.token_embedding."),
             (r"^(text|vision)_model\.position_embedding$", r"\1_model.embeddings.position_embedding.weight"),
             (r"^vision_model\.(patch_embedding\.weight|class_embedding)$", r"vision_model.embeddings.\1"),
             (r"^(text|vision)_model\.layers\.(\d+)\.(fc1|fc2)\.", r"\1_model.encoder.layers.\2.mlp.\3."),
             (r"^(text|vision)_model\.layers\.", r"\1_model.encoder.layers."))

    def build_config(self, hf_cfg):
        t, v = (hf_value(hf_cfg, name) for name in ("text_config", "vision_config"))
        for tower in (t, v):
            act = hf_value(tower, "hidden_act", "quick_gelu")
            if act != "quick_gelu":
                raise ValueError(f"clip hidden_act={act!r} is not supported (the towers compute quick_gelu)")
        text = clip_models.ClipTextConfig(
            vocab_size=hf_value(t, "vocab_size"), hidden_size=hf_value(t, "hidden_size"),
            num_hidden_layers=hf_value(t, "num_hidden_layers"), num_attention_heads=hf_value(t, "num_attention_heads"),
            intermediate_size=hf_value(t, "intermediate_size"),
            max_position_embeddings=hf_value(t, "max_position_embeddings"),
            layer_norm_eps=hf_value(t, "layer_norm_eps"), eos_token_id=hf_value(t, "eos_token_id", 49407))
        vision = clip_models.ClipVisionConfig(
            hidden_size=hf_value(v, "hidden_size"), num_hidden_layers=hf_value(v, "num_hidden_layers"),
            num_attention_heads=hf_value(v, "num_attention_heads"), intermediate_size=hf_value(v, "intermediate_size"),
            image_size=hf_value(v, "image_size"), patch_size=hf_value(v, "patch_size"),
            num_channels=hf_value(v, "num_channels", 3), layer_norm_eps=hf_value(v, "layer_norm_eps"))
        return clip_models.ClipConfig(text=text, vision=vision, projection_dim=hf_value(hf_cfg, "projection_dim"))

    def build_model(self, cfg, device: DeviceLike = "cuda"):
        return clip_models.ClipModel(dataclasses.replace(cfg.text, dtype=cfg.dtype, param_dtype=cfg.param_dtype),
                                     dataclasses.replace(cfg.vision, dtype=cfg.dtype, param_dtype=cfg.param_dtype),
                                     projection_dim=cfg.projection_dim, device=device)

    def hf_name(self, key, sd):
        return _sub(key, *self.RULES)


class MegatronGPTPolicy(V1Policy):
    """Megatron-LM GPT (megatron_v2) on the GPT-NeoX model with the
    sequential residual (JAX ``:1074``): ``language_model.encoder.layers``
    or ``transformer.layers`` naming, ``self_attention`` or ``attention``;
    the padded vocabulary cut to ``vocab_size``; a tied head where the
    checkpoint has no output layer.  Learned-position (megatron v1)
    checkpoints raise."""
    model_type = "megatron-gpt"
    model_class = gpt_family.GPTNeoXForCausalLM

    def build_config(self, hf_cfg):
        g = lambda *names, d: next((hf_value(hf_cfg, n) for n in names if hf_value(hf_cfg, n, None) is not None), d)
        hidden = g("hidden_size", d=64)
        return gpt_family.GPTNeoXConfig(vocab_size=g("padded_vocab_size", "vocab_size", d=50432), hidden_size=hidden,
                                        intermediate_size=g("ffn_hidden_size", "intermediate_size", d=4 * hidden),
                                        num_hidden_layers=g("num_layers", "num_hidden_layers", d=2),
                                        num_attention_heads=g("num_attention_heads", d=8),
                                        rotary_pct=g("rotary_percent", "rotary_pct", d=1.0),
                                        use_parallel_residual=False)

    @staticmethod
    def layer_names(sd: Mapping):
        """(the layer stack's prefix, the attention module's name) of a checkpoint."""
        for enc, attn in (("language_model.encoder.layers", "self_attention"), ("transformer.layers", "attention"),
                          ("transformer.layers", "self_attention")):
            if any(k.startswith(f"{enc}.0.{attn}.query_key_value") for k in sd):
                return enc, attn
        raise KeyError("state dict has no recognizable Megatron layer naming "
                       "(language_model.encoder.layers / transformer.layers)")

    def convert(self, sd, cfg):
        if any("position_embeddings" in k for k in sd):
            raise ValueError("classic megatron-v1 checkpoints with learned position embeddings are not supported: "
                             "the serving model is rotary (megatron_v2)")
        enc, attn = self.layer_names(sd)
        modern = enc.startswith("language_model")
        embed = sd["language_model.embedding.word_embeddings.weight" if modern else
                   "transformer.word_embeddings.weight"][:cfg.vocab_size]
        out_name = "language_model.output_layer.weight" if modern else "lm_head.weight"
        final_ln = "language_model.encoder.final_layernorm" if modern else "transformer.final_layernorm"
        head = sd[out_name] if out_name in sd else embed
        fixed = {"embed_in.weight": embed, "embed_out.weight": head[:cfg.vocab_size],
                 "final_layer_norm.weight": sd[final_ln + ".weight"], "final_layer_norm.bias": sd[final_ln + ".bias"]}
        out = {}
        for k in self.build_model(cfg, device="meta").state_dict():
            out[k] = fixed[k] if k in fixed else sd[_sub(k, (r"^layers\.(\d+)\.(query_key_value|dense)\.",
                                                             rf"{enc}.\1.{attn}.\2."),
                                                         (r"^layers\.(\d+)\.(dense_h_to_4h|dense_4h_to_h)\.",
                                                          rf"{enc}.\1.mlp.\2."),
                                                         (r"^layers\.", f"{enc}."))]
        return {k: v.contiguous() for k, v in out.items()}


class MegatronGPTMoEPolicy(MegatronGPTPolicy):
    """Megatron GPT whose MLP is a DeepSpeed-MoE expert bank (JAX ``:1162``):
    ``convert_experts`` stacks ``mlp.deepspeed_moe.experts.deepspeed_experts.
    {e}.dense_*`` into ``[L, E, in, out]`` weights and ``[L, E, out]`` biases;
    the dense trunk is the parent's."""
    model_type = "megatron-gpt-moe"

    def convert_experts(self, sd: Mapping, cfg, num_experts: int) -> StateDict:
        enc, _ = self.layer_names(sd)
        moe = "mlp.deepspeed_moe.experts.deepspeed_experts"
        bank = lambda fmt, conv: torch.stack([torch.stack([conv(sd[f"{enc}.{i}.{moe}.{e}.{fmt}"])
                                                           for e in range(num_experts)])
                                              for i in range(cfg.num_hidden_layers)])
        return {"wi": bank("dense_h_to_4h.weight", lambda w: w.T), "wi_bias": bank("dense_h_to_4h.bias", lambda b: b),
                "wo": bank("dense_4h_to_h.weight", lambda w: w.T), "wo_bias": bank("dense_4h_to_h.bias", lambda b: b)}


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
    "qwen": QwenV1Policy(),
    "bloom": BloomPolicy(),
    "gpt_neox": GPTNeoXPolicy(),
    "gptj": GPTJPolicy(),
    "gpt_neo": GPTNeoPolicy(),
    "bert": BertPolicy(),
    "distilbert": DistilBertPolicy(),
    "clip": ClipPolicy(),
    "megatron-gpt": MegatronGPTPolicy(),
    "megatron-gpt-moe": MegatronGPTMoEPolicy(),
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
