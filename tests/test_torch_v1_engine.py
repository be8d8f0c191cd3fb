"""The v1 inference engine (``deepspeed_tpu_torch.init_inference``) against
the JAX package's ``InferenceEngine`` on the CPU, in float32.

A tiny Llama and a tiny GPT-NeoX get the same numpy-seeded weights in both
packages (``models/convert.py``): ``forward``'s logits agree within
``LOGIT_TOL`` of their largest magnitude, greedy ``generate`` gives the
same tokens, and so do the EOS blanking, the ragged cut and
``min_out_tokens``.  ``from_dict`` takes the reference's aliases; kernel
injection rebuilds the model with ``attention_impl="flash"`` (the same
logits on the CPU, where the op runs its plain version) and raises where K1
cannot take the model (head dim 256, BLOOM's alibi); ``tensor_parallel`` > 1
raises naming ROADMAP item 6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.models import gpt_family as jgf
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu_torch.inference.engine import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models import gpt_family as tgf
from deepspeed_tpu_torch.models import llama as tl
from test_torch_gpt_family import one_intra_op_thread, seeded_params  # noqa: F401 (autouse fixture)

LOGIT_TOL = 1e-5   # of the largest |logit|
LLAMA = dict(vocab_size=96, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=64, rope_theta=1e4)
NEOX = dict(vocab_size=96, hidden_size=128, intermediate_size=256, num_hidden_layers=2, num_attention_heads=2,
            rotary_pct=0.25)
PROMPTS = np.array([[5, 9, 2, 7, 1, 3], [8, 4, 6, 10, 11, 2]], np.int32)


def _pair(family):
    """(JAX model, JAX params, port model) with the same seeded weights, float32."""
    if family == "llama":
        jcfg = jl.LlamaConfig(**LLAMA, dtype=jnp.float32, attention_impl="reference")
        jmodel = jl.LlamaForCausalLM(jcfg)
        tcfg = tl.LlamaConfig(**LLAMA, dtype=torch.float32, attention_impl="reference")
        model, carry = tl.LlamaForCausalLM(tcfg, device="cpu"), convert.jax_llama_to_state_dict
    else:
        jcfg = jgf.GPTNeoXConfig(**NEOX, dtype=jnp.float32)
        jmodel = jgf.GPTNeoXForCausalLM(jcfg)
        tcfg = tgf.GPTNeoXConfig(**NEOX, dtype=torch.float32)
        model, carry = tgf.GPTNeoXForCausalLM(tcfg, device="cpu"), convert.jax_gpt_family_to_state_dict
    params = seeded_params(jmodel, jnp.zeros((1, 8), jnp.int32), seed=1)
    model.load_state_dict(carry(jax.tree.map(np.asarray, params), tcfg), strict=True)
    return jmodel, params, model


@pytest.fixture(scope="module", params=["llama", "gpt_neox"])
def engines(request):
    """One engine a package (JAX compiles one generate step per buffer
    shape); a test that sets the EOS fields restores them."""
    jmodel, params, model = _pair(request.param)
    return (jds.init_inference(model=jmodel, config={"dtype": "fp32"}, params={"params": params}),
            tds.init_inference(model=model, config={"dtype": "fp32"}, device="cpu"))


def test_forward_and_greedy_generate_match_jax(engines):
    jeng, eng = engines
    want = np.asarray(jeng.forward(jnp.asarray(PROMPTS)))
    got = eng.forward(torch.from_numpy(PROMPTS)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL * np.abs(want).max())
    tokens = eng.generate(PROMPTS, max_new_tokens=8)
    np.testing.assert_array_equal(tokens, np.asarray(jeng.generate(PROMPTS, max_new_tokens=8)))
    assert tokens.shape == (2, 14)


def test_eos_blanking_and_min_out_tokens_match_jax(engines):
    """EOS is the token row 0 emits 3rd: rows stop at their first EOS after
    ``min_out_tokens``, later positions read EOS, the output is cut at the
    longest row."""
    jeng, eng = engines
    eos = int(eng.generate(PROMPTS, max_new_tokens=8)[0, PROMPTS.shape[1] + 2])
    try:
        for min_out in (1, 4):
            for e in (jeng, eng):
                e.config.eos_token_id, e.config.min_out_tokens = eos, min_out
            got = eng.generate(PROMPTS, max_new_tokens=8)
            np.testing.assert_array_equal(got, np.asarray(jeng.generate(PROMPTS, max_new_tokens=8)))
            if min_out == 1:   # row 0 stops at its 3rd token: EOS from there on
                assert (got[0, PROMPTS.shape[1] + 2:] == eos).all()
    finally:
        for e in (jeng, eng):
            e.config.eos_token_id, e.config.min_out_tokens = None, 1


def test_config_from_dict_takes_the_reference_aliases():
    c = DeepSpeedInferenceConfig.from_dict({"mp_size": 1, "dtype": "half", "max_out_tokens": 7, "unknown": 1})
    assert (c.tensor_parallel, c.dtype, c.max_out_tokens) == (1, torch.float16, 7)
    c = DeepSpeedInferenceConfig.from_dict({"tensor_parallel": {"tp_size": 3}, "dtype": torch.float32})
    assert (c.tensor_parallel, c.dtype) == (3, torch.float32)
    assert DeepSpeedInferenceConfig.from_dict({"dtype": "bf16"}).dtype == torch.bfloat16
    assert DeepSpeedInferenceConfig.from_dict(None) == DeepSpeedInferenceConfig()
    with pytest.raises(NotImplementedError, match="item 6"):
        tds.init_inference(model=torch.nn.Linear(2, 2), config={"tensor_parallel": {"tp_size": 2}}, device="cpu")


def test_kernel_injection_sets_flash_and_refuses_what_k1_cannot_take():
    cfg = tgf.GPTNeoXConfig(**NEOX, dtype=torch.float32)
    model = tl.init_weights_(tgf.GPTNeoXForCausalLM(cfg, device="cpu"), torch.Generator().manual_seed(0))
    plain = tds.init_inference(model=model, config={"dtype": "fp32"}, device="cpu")
    eng = tds.init_inference(model=model, config={"dtype": "fp32", "replace_with_kernel_inject": True}, device="cpu")
    assert model.cfg.attention_impl == "reference"
    assert {m.cfg.attention_impl for m in eng.module.modules() if hasattr(m, "cfg")} == {"flash"}
    ids = torch.arange(128).remainder(96)[None]   # 128 positions: the flash op's plain version on the CPU
    want = plain.forward(ids)
    np.testing.assert_allclose(eng.forward(ids).numpy(), want.numpy(), rtol=0, atol=LOGIT_TOL * want.abs().max().item())
    gptj = tgf.GPTJForCausalLM(tgf.GPTJConfig(vocab_size=96, hidden_size=512, num_attention_heads=2), device="meta")
    with pytest.raises(NotImplementedError, match="head dim 256.*item 5"):
        tds.init_inference(model=gptj, config={"replace_with_kernel_inject": True}, device="cpu")
    bloom = tgf.BloomForCausalLM(tgf.BloomConfig(vocab_size=96, hidden_size=128, num_attention_heads=2), device="meta")
    with pytest.raises(NotImplementedError, match="alibi.*item 5"):
        tds.init_inference(model=bloom, config={"replace_with_kernel_inject": True}, device="cpu")


def test_kernel_injection_takes_head_dim_96_and_still_refuses_gptj_and_alibi():
    """K1/K2 take head dims 80 and 96: a GPT-NeoX at D 96 (GPT-NeoX-20B's and
    GPT-Neo-1.3B's head dim) is injected, its logits those of the plain
    model; GPT-J's 256 and Falcon-RW's alibi are still refused, naming the
    kernel gap (ROADMAP Queue 1 item 5)."""
    from deepspeed_tpu_torch.models import falcon as tfalcon
    cfg = tgf.GPTNeoXConfig(**{**NEOX, "hidden_size": 192}, dtype=torch.float32)
    assert cfg.head_dim == 96
    model = tl.init_weights_(tgf.GPTNeoXForCausalLM(cfg, device="cpu"), torch.Generator().manual_seed(1))
    plain = tds.init_inference(model=model, config={"dtype": "fp32"}, device="cpu")
    eng = tds.init_inference(model=model, config={"dtype": "fp32", "replace_with_kernel_inject": True}, device="cpu")
    assert {m.cfg.attention_impl for m in eng.module.modules() if hasattr(m, "cfg")} == {"flash"}
    ids = torch.arange(128).remainder(96)[None]
    want = plain.forward(ids)
    np.testing.assert_allclose(eng.forward(ids).numpy(), want.numpy(), rtol=0, atol=LOGIT_TOL * want.abs().max().item())
    gptj = tgf.GPTJForCausalLM(tgf.GPTJConfig(vocab_size=96, hidden_size=512, num_attention_heads=2), device="meta")
    with pytest.raises(NotImplementedError, match="head dim 256.*item 5"):
        tds.init_inference(model=gptj, config={"replace_with_kernel_inject": True}, device="cpu")
    rw = tfalcon.FalconConfig(vocab_size=96, hidden_size=128, num_hidden_layers=1, num_attention_heads=2,
                              num_kv_heads=2, parallel_attn=False, alibi=True, attention_impl="reference")
    with pytest.raises(NotImplementedError, match="alibi.*item 5"):
        tds.init_inference(model=tfalcon.FalconForCausalLM(rw, device="meta"),
                           config={"replace_with_kernel_inject": True}, device="cpu")
