"""Weight-only int8 serving (``inference/quantization.py``) against the JAX
package on the CPU.

  * ``_quantize_leaf``'s codes and scales equal the JAX package's numpy bit
    for bit: random groups over nine orders of magnitude, a tensor padded to
    whole groups, an all-zero group and a group of half-way ties; the
    dequantized bf16 values too, and K4b's plain route into a bf16 ``out``;
  * ``quantize_inference_params`` over the tiny Llama of the JAX factory
    test (``tests/unit/inference/test_hf_factory.py:126``) quantizes the
    same tensors as JAX's over its scanned tree, to the same codes, and
    ``nbytes`` is JAX's;
  * the quantized ``InferenceEngineV2`` (float32 compute over the bf16
    dequantized weights, as JAX's) gives JAX's quantized engine's greedy
    streams and free pages; it equals an engine over the whole tree
    dequantized once, token for token, and dequantizes every quantized
    tensor once a forward; ``build_hf_engine(quantization_mode=...)``
    serves the directory with the int8 payload under half the float32 bytes.
"""

import dataclasses
import json
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import quantization as jq
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JaxEngineConfig
from deepspeed_tpu.inference.v2.model_implementations import policies as jpol
from deepspeed_tpu.inference.v2.scheduler import SchedulerConfig as JaxSchedulerConfig
from deepspeed_tpu.models.llama_cache import PagedKVConfig as JaxPagedKVConfig
from deepspeed_tpu_torch.inference import quantization as tq
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2, PagedKVConfig, RaggedInferenceEngineConfig,
                                              SchedulerConfig, build_hf_engine)
from deepspeed_tpu_torch.inference.v2.model_implementations import policies as tpol
from deepspeed_tpu_torch.ops import quant_kernels as tqk
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse fixture)

KV = dict(num_pages=48, page_size=4, max_pages_per_seq=12)
SCHED = dict(token_budget=64, max_seqs=4, prefill_chunk=8, decode_bucket=4)
PROMPTS = [[5, 9, 2, 7, 1, 3, 8, 4, 6, 10, 11], [3, 3, 8], [12, 4, 7, 7, 9, 1]]
NEW_TOKENS = 8
#: the JAX factory test's tiny Llama (vocab 128, hidden 64, 2 layers, 4:2 heads, untied)
LLAMA = dict(model_type="llama", vocab_size=128, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64, rope_theta=10000.0,
             rms_norm_eps=1e-6, tie_word_embeddings=False)


def _leaves():
    rng = np.random.default_rng(7)
    spread = rng.normal(size=(40, 128)) * 10.0**rng.uniform(-6, 3, size=(40, 1))
    # amax 63.5 (+ 1e-12, below its float32 ulp) → scale 0.5: x/scale = k + 0.5, a half-way tie, for all but amax
    ties = np.concatenate([(np.arange(-64, 63) + 0.5) * 0.5, [63.5]])
    return {"spread": spread.astype(np.float32), "padded": rng.normal(size=5 * 128 + 37).astype(np.float32),
            "zero_group": np.concatenate([np.zeros(128), rng.normal(size=128)]).astype(np.float32),
            "ties": ties.astype(np.float32)}


@pytest.mark.parametrize("name", ["spread", "padded", "zero_group", "ties"])
def test_codes_and_scales_are_bit_identical_to_jax(name):
    x = _leaves()[name]
    want = jq._quantize_leaf(x, 128)
    got = tq._quantize_leaf(torch.from_numpy(x), 128)
    np.testing.assert_array_equal(got["q"].numpy(), want["q"])
    np.testing.assert_array_equal(got["scale"].numpy().view(np.int32), want["scale"].reshape(-1).view(np.int32))
    jwant = np.asarray(jq._dequantize_leaf({k: jnp.asarray(v) for k, v in want.items()}, x.shape, jnp.bfloat16)
                       .astype(jnp.float32))
    deq = tq._dequantize_leaf(got, x.shape, torch.bfloat16)
    np.testing.assert_array_equal(deq.float().numpy(), jwant)
    out = torch.empty(x.size, dtype=torch.bfloat16)
    tqk.dequantize_int8(got["q"], got["scale"], x.shape, out=out)   # K4b's plain route: one rounding into bf16
    assert torch.equal(out.view(x.shape), deq)
    if name == "ties":
        assert set(np.abs(want["q"][0][:-1]) % 2) == {0}   # half-way values rounded to even codes


def _checkpoint(tmp_path):
    """The tiny Llama's seeded HF state dict, and its directory (config.json + pytorch_model.bin)."""
    rng = np.random.default_rng(0)
    e, i, h, kv, d = 64, 96, 4, 2, 16
    w = lambda *shape: torch.from_numpy((rng.normal(size=shape) * 0.08).astype(np.float32))
    sd = {"model.embed_tokens.weight": w(128, e), "model.norm.weight": 1.0 + w(e), "lm_head.weight": w(128, e)}
    for layer in range(2):
        p = f"model.layers.{layer}"
        sd.update({f"{p}.input_layernorm.weight": 1.0 + w(e), f"{p}.post_attention_layernorm.weight": 1.0 + w(e),
                   f"{p}.self_attn.q_proj.weight": w(h * d, e), f"{p}.self_attn.k_proj.weight": w(kv * d, e),
                   f"{p}.self_attn.v_proj.weight": w(kv * d, e), f"{p}.self_attn.o_proj.weight": w(e, h * d),
                   f"{p}.mlp.gate_proj.weight": w(i, e), f"{p}.mlp.up_proj.weight": w(i, e),
                   f"{p}.mlp.down_proj.weight": w(e, i)})
    path = tmp_path / "llama"
    path.mkdir()
    (path / "config.json").write_text(json.dumps(LLAMA))
    torch.save(sd, path / "pytorch_model.bin")
    return sd, str(path)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    sd, path = _checkpoint(tmp_path_factory.mktemp("q"))
    jcfg, jparams = jpol.convert_hf_state_dict(sd, SimpleNamespace(**LLAMA))
    cfg, state = tpol.convert_hf_state_dict(sd, LLAMA)
    return SimpleNamespace(sd=sd, path=path, jcfg=jcfg, jparams=jparams, cfg=cfg, state=state,
                           jq=jq.quantize_inference_params(jparams), q=tq.quantize_inference_params(state, cfg=cfg))


def test_quantize_inference_params_quantizes_what_jax_quantizes(tiny):
    assert tiny.q.nbytes == tiny.jq.nbytes
    assert len(tiny.q.shapes) == 2 * len(tiny.jq.shapes) - 2   # JAX stacks the 2 layers; embed and head are global
    assert "layers.0.self_attn.k_proj.weight" in tiny.q.shapes   # 2048 a layer, 4096 stacked: quantized as JAX does
    assert "norm.weight" not in tiny.q.shapes
    jnode = tiny.jq.tree["model"]["layers"]["self_attn"]["q_proj"]["kernel"]
    for layer in range(2):
        node = tiny.q.tree[f"layers.{layer}.self_attn.q_proj.weight"]
        rows = node["q"].shape[0]
        np.testing.assert_array_equal(node["q"].numpy(), jnode["q"][layer * rows:(layer + 1) * rows])
        np.testing.assert_array_equal(node["scale"].numpy(), jnode["scale"][layer * rows:(layer + 1) * rows, 0])


def _engine_config(kv_dtype):
    """One decode round a dispatch: fewer step programs for the JAX side to compile."""
    return RaggedInferenceEngineConfig(kv=PagedKVConfig(**KV), scheduler=SchedulerConfig(**SCHED), kv_dtype=kv_dtype,
                                       decode_steps_per_dispatch=1)


def test_quantized_engine_streams_equal_jax(tiny):
    jeng = JaxEngine(dataclasses.replace(tiny.jcfg, dtype=jnp.float32), tiny.jq, engine_config=JaxEngineConfig(
        kv=JaxPagedKVConfig(**KV), scheduler=JaxSchedulerConfig(**SCHED), kv_dtype=jnp.float32,
        decode_steps_per_dispatch=1))
    want = (jeng.generate(PROMPTS, max_new_tokens=NEW_TOKENS), jeng.kv.allocator.free_pages)
    cfg = dataclasses.replace(tiny.cfg, dtype=torch.float32, param_dtype=torch.float32)
    eng = InferenceEngineV2(cfg, tiny.q, _engine_config(torch.float32), device="cpu")
    assert (eng.generate(PROMPTS, max_new_tokens=NEW_TOKENS), eng.kv.allocator.free_pages) == want


def test_per_layer_dequantization_equals_the_tree_dequantized_once(tiny, monkeypatch):
    calls = []
    real = tq.dequantize_int8
    monkeypatch.setattr(tq, "dequantize_int8", lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = dataclasses.replace(tiny.cfg, dtype=torch.float32, param_dtype=torch.float32)
    eng = InferenceEngineV2(cfg, tiny.q, _engine_config(torch.float32), device="cpu")
    once = InferenceEngineV2(cfg, tiny.q.dequantize(), _engine_config(torch.float32), device="cpu")
    assert eng.generate(PROMPTS, max_new_tokens=NEW_TOKENS) == once.generate(PROMPTS, max_new_tokens=NEW_TOKENS)
    assert len(calls) == len(tiny.q.shapes) * eng.forward_calls > 0
    # the layers' weights view one scratch buffer: only one layer's exist at a time
    w0, w1 = (eng.model.layers[i].mlp.up_proj.weight for i in range(2))
    assert w0.data_ptr() == w1.data_ptr() and eng.dequantizer.scratch_bytes < tiny.q.nbytes * 2


def test_build_hf_engine_serves_int8_weights(tiny):
    eng = build_hf_engine(tiny.path, _engine_config(torch.float32), quantization_mode="wf6af16", device="cpu")
    assert eng.dequantizer is not None and eng.dequantizer.params.nbytes < 0.5 * 4 * sum(
        t.numel() for t in tiny.state.values())
    assert [len(g) for g in eng.generate(PROMPTS, max_new_tokens=NEW_TOKENS)] == [NEW_TOKENS] * len(PROMPTS)
