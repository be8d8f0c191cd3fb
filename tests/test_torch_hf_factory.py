"""HF checkpoints into the port: ``checkpoint_io``, the policies and
``build_hf_engine``, against transformers, safetensors and the JAX package
on the CPU.

  * a tiny Falcon (its ``model.safetensors``) and a tiny Mistral with a
    window that bites (its ``pytorch_model.bin``), both saved by
    transformers' ``save_pretrained`` in float32: ``build_hf_engine(path,
    device="cpu")`` serves them in bfloat16, weights included, as JAX's
    computes; built the same way with the model forced to float32 on both
    sides, the greedy streams and the free pages after them equal the JAX
    engine's (exactly: same tokens, same pages);
  * ``checkpoint_io.load_safetensors`` equals ``safetensors.torch.load_file``
    bit for bit on the file transformers wrote and on one holding every
    dtype of its map; ``read_config`` feeds ``from_hf`` as transformers'
    config does;
  * each policy's state dict equals the JAX policy's params carried by
    ``models/convert.py`` (Falcon's three ``query_key_value`` layouts, OPT
    and OPT-350M, Phi with ``qk_layernorm``, Phi-3's fused projections,
    Llama with ``attention_bias``, Qwen2, InternLM), bit for bit;
  * every model type of the JAX registry is served, by the paged engine or
    (the v1 families) by the v1 engine, so none is left to raise naming its
    ROADMAP item; ``quantization_mode`` on a family without a paged twin
    raises as JAX's does; an unknown model type raises ``ValueError``, and a
    config of no served family has no paged twin (``TypeError``).
"""

import dataclasses
from types import SimpleNamespace

import pytest
import torch

from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2, PagedKVConfig, RaggedInferenceEngineConfig,
                                              SchedulerConfig, build_cache_model, build_hf_engine)
from deepspeed_tpu_torch.inference.v2 import checkpoint_io
from deepspeed_tpu_torch.inference.v2.model_implementations import policies as tpol
from deepspeed_tpu_torch.models import convert
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse fixture)

KV = dict(num_pages=48, page_size=4, max_pages_per_seq=12)
SCHED = dict(token_budget=64, max_seqs=4, prefill_chunk=8, decode_bucket=4)
PROMPTS = [[5, 9, 2, 7, 1, 3, 8, 4, 6, 10, 11], [3, 3, 8], [12, 4, 7, 7, 9, 1]]
NEW_TOKENS = 10


def _hf(kind: str, **fields):
    """A tiny transformers model of ``kind`` from a fixed torch seed."""
    import transformers
    config_cls, model_cls = {
        "falcon": ("FalconConfig", "FalconForCausalLM"), "mistral": ("MistralConfig", "MistralForCausalLM"),
        "opt": ("OPTConfig", "OPTForCausalLM"), "phi": ("PhiConfig", "PhiForCausalLM"),
        "phi3": ("Phi3Config", "Phi3ForCausalLM"), "llama": ("LlamaConfig", "LlamaForCausalLM"),
        "qwen2": ("Qwen2Config", "Qwen2ForCausalLM")}[kind]
    torch.manual_seed(0)
    cfg = getattr(transformers, config_cls)(**fields)
    return getattr(transformers, model_cls)(cfg), cfg


FALCON = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2, num_attention_heads=4)
MISTRAL = dict(vocab_size=64, hidden_size=32, intermediate_size=48, num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, max_position_embeddings=64, sliding_window=6)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("hf")
    falcon, _ = _hf("falcon", **FALCON)
    falcon.save_pretrained(root / "falcon")
    mistral, _ = _hf("mistral", **MISTRAL)
    mistral.save_pretrained(root / "mistral", safe_serialization=False)
    return {"falcon": str(root / "falcon"), "mistral": str(root / "mistral")}


def _jax_streams(path):
    """JAX's ``build_hf_engine`` with the model in float32."""
    import jax.numpy as jnp
    from transformers import AutoConfig

    from deepspeed_tpu.inference.v2 import InferenceEngineV2
    from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JaxEngineConfig
    from deepspeed_tpu.inference.v2.engine_factory import _load_state_dict
    from deepspeed_tpu.inference.v2.model_implementations import convert_hf_state_dict
    from deepspeed_tpu.inference.v2.scheduler import SchedulerConfig as JaxSchedulerConfig
    from deepspeed_tpu.models.llama_cache import PagedKVConfig as JaxPagedKVConfig
    cfg, params = convert_hf_state_dict(_load_state_dict(path), AutoConfig.from_pretrained(path, local_files_only=True))
    cfg = dataclasses.replace(cfg, dtype=jnp.float32)
    eng = InferenceEngineV2(cfg, {"params": params}, engine_config=JaxEngineConfig(
        kv=JaxPagedKVConfig(**KV), scheduler=JaxSchedulerConfig(**SCHED), kv_dtype=jnp.float32))
    return eng.generate(PROMPTS, max_new_tokens=NEW_TOKENS), eng.kv.allocator.free_pages


@pytest.mark.parametrize("family", ["falcon", "mistral"])
def test_build_hf_engine_streams_equal_jax(checkpoints, family):
    path = checkpoints[family]
    engine_config = RaggedInferenceEngineConfig(kv=PagedKVConfig(**KV), scheduler=SchedulerConfig(**SCHED),
                                                kv_dtype=torch.float32)
    served = build_hf_engine(path, engine_config, device="cpu")
    assert served.cfg.dtype == served.cfg.param_dtype == torch.bfloat16   # saved in float32, served in bf16
    assert {p.dtype for p in served.model.parameters()} == {torch.bfloat16}
    assert [len(g) for g in served.generate(PROMPTS, max_new_tokens=NEW_TOKENS)] == [NEW_TOKENS] * len(PROMPTS)
    # the same checkpoint with the model forced to float32, as the JAX side is
    cfg, state = tpol.convert_hf_state_dict(checkpoint_io.load_state_dict(path), checkpoint_io.read_config(path))
    cfg = dataclasses.replace(cfg, dtype=torch.float32, param_dtype=torch.float32)
    if family == "mistral":
        assert cfg.sliding_window == 6 < len(PROMPTS[0]) + NEW_TOKENS
    eng = InferenceEngineV2(cfg, state, engine_config, device="cpu")
    got = eng.generate(PROMPTS, max_new_tokens=NEW_TOKENS)
    assert [len(g) for g in got] == [NEW_TOKENS] * len(PROMPTS)
    assert (got, eng.kv.allocator.free_pages) == _jax_streams(path)


def test_safetensors_reader_matches_the_library(checkpoints, tmp_path):
    from safetensors.torch import load_file, save_file
    mixed = {"f32": torch.randn(3, 5), "f16": torch.randn(4).half(), "bf16": torch.randn(2, 2, 3).bfloat16(),
             "i64": torch.arange(7), "i32": torch.arange(6, dtype=torch.int32).reshape(2, 3),
             "bool": torch.tensor([True, False, True]), "empty": torch.zeros(0, 4)}
    save_file(mixed, str(tmp_path / "mixed.safetensors"), metadata={"format": "pt"})
    for f in (checkpoints["falcon"] + "/model.safetensors", str(tmp_path / "mixed.safetensors")):
        want, got = load_file(f), checkpoint_io.load_safetensors(f)
        assert want.keys() == got.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_read_config_builds_what_transformers_config_builds(checkpoints):
    from transformers import AutoConfig
    for family, policy in (("falcon", tpol.FalconPolicy()), ("mistral", tpol.MistralPolicy())):
        path = checkpoints[family]
        assert policy.build_config(checkpoint_io.read_config(path)) == \
            policy.build_config(AutoConfig.from_pretrained(path, local_files_only=True))


#: case → (transformers kind, config fields, the converter carrying the JAX policy's tree across)
POLICY_CASES = {
    "falcon-7b": ("falcon", dict(FALCON), "falcon"),
    "falcon-new-arch": ("falcon", dict(FALCON, new_decoder_architecture=True, num_kv_heads=2, bias=True,
                                       tie_word_embeddings=False), "falcon"),
    "falcon-rw": ("falcon", dict(FALCON, multi_query=False, parallel_attn=False, alibi=True, bias=True), "falcon"),
    "opt": ("opt", dict(vocab_size=64, hidden_size=32, ffn_dim=48, num_hidden_layers=2, num_attention_heads=4,
                        max_position_embeddings=32), "opt"),
    "opt-350m": ("opt", dict(vocab_size=64, hidden_size=32, ffn_dim=48, num_hidden_layers=2, num_attention_heads=4,
                             max_position_embeddings=32, do_layer_norm_before=False, word_embed_proj_dim=16),
                 "opt"),
    "phi": ("phi", dict(vocab_size=64, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
                        num_attention_heads=4, qk_layernorm=True), "phi"),
    "phi3": ("phi3", dict(vocab_size=64, hidden_size=48, intermediate_size=48, num_hidden_layers=2,
                          num_attention_heads=4, num_key_value_heads=2, pad_token_id=0), "llama"),
    "llama": ("llama", dict(vocab_size=64, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
                            num_attention_heads=4, num_key_value_heads=2, attention_bias=True), "llama"),
    "qwen2": ("qwen2", dict(vocab_size=64, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
                            num_attention_heads=4, num_key_value_heads=2), "llama"),
}


@pytest.mark.parametrize("case", list(POLICY_CASES) + ["internlm"])
def test_policy_equals_the_jax_policy_carried_across(case):
    from deepspeed_tpu.inference.v2.model_implementations import policies as jpol
    kind, fields, conv = POLICY_CASES["llama" if case == "internlm" else case]
    model, hf_cfg = _hf(kind, **fields)
    sd = model.state_dict()
    model_type = hf_cfg.model_type
    if case == "internlm":   # Llama's names with a ``bias`` flag: q/k/v and o_proj biases
        hf_cfg = SimpleNamespace(**dict(hf_cfg.to_dict(), model_type="internlm", bias=True))
        model_type = "internlm"
    jcfg, params = jpol.convert_hf_state_dict(sd, hf_cfg, model_type=model_type)
    cfg, state = tpol.convert_hf_state_dict(sd, hf_cfg, model_type=model_type)
    want = getattr(convert, f"jax_{conv}_to_state_dict")(params, cfg)
    assert state.keys() == want.keys()
    for k in want:
        assert torch.equal(state[k].float(), want[k].float()), k
    build_cache_model(cfg, 4, device="meta").load_state_dict(state, strict=True, assign=True)


def test_every_unserved_model_type_raises_naming_its_item(tmp_path):
    from deepspeed_tpu.inference.v2.model_implementations.policies import POLICY_REGISTRY as JAX_REGISTRY
    assert set(tpol.POLICY_REGISTRY) == set(JAX_REGISTRY)
    paged = {"llama", "mistral", "qwen2", "internlm", "phi3", "opt", "phi", "falcon", "mixtral", "qwen2_moe", "qwen"}
    assert {t for t, p in tpol.POLICY_REGISTRY.items() if p.paged} == paged
    unserved = [t for t, p in tpol.POLICY_REGISTRY.items() if not p.paged and not hasattr(p, "build_model")]
    assert unserved == []
    with pytest.raises(ValueError, match="no inference policy"):
        tpol.policy_for("not-a-model")
    (tmp_path / "config.json").write_text('{"model_type": "gpt_neo"}')
    with pytest.raises(NotImplementedError, match="paged"):
        build_hf_engine(str(tmp_path), quantization_mode="wf6af16", device="cpu")

    class UnknownConfig:
        pass

    with pytest.raises(TypeError, match="no paged twin"):
        build_cache_model(UnknownConfig(), 16, device="meta")
