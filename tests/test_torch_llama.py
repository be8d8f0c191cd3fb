"""Llama modules of the PyTorch port (``deepspeed_tpu_torch.models``) against
the JAX package's, on the CPU in float32: RMSNorm, the half-split RoPE, the
cache-free forward and the paged forward, with the weights carried across
by ``models/convert.py`` from both the scan-stacked and the unrolled JAX
param trees."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import llama as jl
from deepspeed_tpu.models import llama_cache as jlc
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.models import llama_cache as tlc
from deepspeed_tpu_torch.models.convert import jax_llama_to_state_dict
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse fixture)

JCFG = jl.LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128, rope_theta=1e4,
                      dtype=jnp.float32, remat=False)
TCFG = tl.LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128, rope_theta=1e4,
                      dtype=torch.float32)
# float32 through 2 layers; the frameworks sum matmuls in different orders
ATOL = RTOL = 1e-4


def _np_params(variables):
    return jax.tree.map(np.asarray, variables)


def _port_model(cls, cfg, state, **kw):
    model = cls(cfg, device="cpu", **kw)
    model.load_state_dict(state, strict=True)
    return model.eval()


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    w = rng.normal(size=(64, )).astype(np.float32)
    want = jl.RMSNorm(1e-5, jnp.float32, jnp.float32).apply({"params": {"weight": jnp.asarray(w)}}, jnp.asarray(x))
    norm = tl.RMSNorm(64, 1e-5, torch.float32, torch.float32, device="cpu")
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(w))
        got = norm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def test_rope_matches_jax():
    """Half-split layout: the two halves of D rotate together."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 500, size=(2, 7)).astype(np.int32)
    jc, js = jl.rotary_embedding(jnp.asarray(pos), 16, 1e4)
    want = jl.apply_rope(jnp.asarray(x), jc, js)
    tc, ts = tl.rotary_embedding(torch.from_numpy(pos), 16, 1e4)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    got = tl.apply_rope(torch.from_numpy(x), tc, ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-5)


VARIANTS = [pytest.param({}, "scan", id="scan-stacked"), pytest.param({}, "unrolled", id="unrolled"),
            pytest.param({"tie_word_embeddings": True}, "scan", id="tied"),
            pytest.param({"attention_bias": True}, "unrolled", id="qkv-bias")]


@pytest.mark.parametrize("overrides,layout", VARIANTS)
def test_cache_free_forward_matches_jax(overrides, layout):
    jcfg = dataclasses.replace(JCFG, scan_layers=(layout == "scan"), **overrides)
    tcfg = dataclasses.replace(TCFG, **overrides)
    ids = np.random.default_rng(2).integers(0, 128, size=(2, 11)).astype(np.int32)
    variables = jax.jit(jl.LlamaForCausalLM(jcfg).init)(jax.random.PRNGKey(0), jnp.asarray(ids))
    if overrides.get("attention_bias"):
        # flax initialises biases to zero: make them matter
        variables = jax.tree_util.tree_map_with_path(
            lambda p, x: x + 0.1 if "bias" in jax.tree_util.keystr(p) else x, variables)
    want = jax.jit(jl.LlamaForCausalLM(jcfg).apply)(variables, jnp.asarray(ids))
    state = jax_llama_to_state_dict(_np_params(variables), tcfg)
    assert ("lm_head.weight" in state) == (not tcfg.tie_word_embeddings)
    model = _port_model(tl.LlamaForCausalLM, tcfg, state)
    with torch.no_grad():
        got = model(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_scan_and_unrolled_trees_convert_alike():
    variables = jax.jit(jl.LlamaForCausalLM(JCFG).init)(jax.random.PRNGKey(3), jnp.zeros((1, 4), jnp.int32))
    stacked = jax_llama_to_state_dict(_np_params(variables), TCFG)
    unrolled = jax_llama_to_state_dict(_np_params(jlc.unstack_layer_params(variables, 2)), TCFG)
    assert stacked.keys() == unrolled.keys()
    for k in stacked:
        assert torch.equal(stacked[k], unrolled[k]), k


def test_paged_forward_matches_jax():
    """One chunked step of the paged twins from the same arena: logits and
    the K/V written into the arena agree (prefill row, continuation row,
    padding row)."""
    page, max_pages, n_pages = 8, 4, 16
    rng = np.random.default_rng(4)
    variables = jax.jit(jl.LlamaForCausalLM(JCFG).init)(jax.random.PRNGKey(5), jnp.zeros((1, 4), jnp.int32))
    state = jax_llama_to_state_dict(_np_params(variables), TCFG)
    ids = rng.integers(0, 128, size=(3, 8)).astype(np.int32)
    start = np.array([0, 9, 0], np.int32)
    clens = np.array([8, 5, 0], np.int32)
    bt = np.zeros((3, max_pages), np.int32)
    bt[0, :1], bt[1, :2] = [1], [2, 3]
    arena = rng.normal(size=(2, n_pages, page, 2, 2, 16)).astype(np.float32)
    arena[:, 0] = 0.0

    jmodel = jlc.LlamaForCausalLMWithCache(JCFG, page_size=page)
    want, jcache = jax.jit(jmodel.apply)(variables, jnp.asarray(ids), jnp.asarray(start), jnp.asarray(bt),
                                         jnp.asarray(arena), jnp.asarray(clens))
    model = _port_model(tlc.LlamaForCausalLMWithCache, TCFG, state, page_size=page)
    cache = [torch.from_numpy(arena[i].copy()) for i in range(2)]
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(start), torch.from_numpy(bt), cache,
                    torch.from_numpy(clens))
    np.testing.assert_allclose(got.numpy()[:2], np.asarray(want)[:2], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(np.stack([c.numpy() for c in cache]), np.asarray(jcache), atol=ATOL, rtol=RTOL)
