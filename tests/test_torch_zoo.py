"""The model zoo's paged twins against the JAX package on the CPU, in float32.

For each served family (Falcon in its three layouts, OPT and OPT-350M's
projection, Phi with and without ``qk_layernorm``, Mistral with a window that
bites, Qwen2, InternLM, Phi-3 and Llama with ``attention_bias``): the same
numpy-seeded params go into the JAX cache twin and, through
``models/convert.py``, into the port's; a prefill chunk (two rows, one
ragged) then two decode steps give the same logits, within 2e-5 of their
largest magnitude.  The JAX side runs each decode step as a padded chunk,
as its engine does, so one program serves the three steps.  InternLM's and biased Llama's o_proj bias is dropped by
JAX's Llama cache twin (its ``o_proj`` has no bias), so those two are held
to JAX's training model over the whole sequence instead.

The plain K3 (``models/llama_cache.paged_attention``) with a window and with
alibi slopes matches JAX's ``paged_attention`` golden within 1e-5, and the
plain split route (partials, then the merge) matches the plain K3 within
1e-5 with either.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import cache_zoo as jzoo
from deepspeed_tpu.models.falcon import alibi_slopes as jax_alibi_slopes
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.models import llama_cache as jlc
from deepspeed_tpu_torch.models import cache_zoo as tzoo
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models.falcon import FalconConfig, alibi_slopes
from deepspeed_tpu_torch.models.llama import LlamaConfig
from deepspeed_tpu_torch.models.llama_cache import LlamaForCausalLMWithCache, PagedKVConfig, init_kv_cache
from deepspeed_tpu_torch.models.llama_cache import paged_attention as plain_paged_attention
from deepspeed_tpu_torch.models.opt import OPTConfig
from deepspeed_tpu_torch.models.phi import PhiConfig
from deepspeed_tpu_torch.ops.paged_attention import merge_partials_plain, paged_attention_partials_plain
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse fixture)

PAGE, PAGES, MAXP = 4, 16, 6
CHUNK = 8
LOGIT_TOL = 2e-5   # of the largest |logit|
#: XLA's CPU backend without its slow passes: the reference programs are tiny
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
LLAMA = dict(vocab_size=96, hidden_size=64, intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=64, rope_theta=1e4)

#: family → (its config class name, the config fields both packages take)
FAMILIES = {
    "falcon-7b": ("FalconConfig", dict(vocab_size=96, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                                       num_kv_heads=1, parallel_attn=True, num_ln_in_parallel_attn=1)),
    "falcon-new-arch": ("FalconConfig", dict(vocab_size=96, hidden_size=64, num_hidden_layers=2,
                                             num_attention_heads=4, num_kv_heads=2, new_decoder_architecture=True,
                                             num_ln_in_parallel_attn=2, bias=True, tie_word_embeddings=False)),
    "falcon-rw": ("FalconConfig", dict(vocab_size=96, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                                       num_kv_heads=4, parallel_attn=False, alibi=True, bias=True)),
    "opt": ("OPTConfig", dict(vocab_size=96, hidden_size=64, ffn_dim=96, num_hidden_layers=2, num_attention_heads=4,
                              max_position_embeddings=64)),
    "opt-350m": ("OPTConfig", dict(vocab_size=96, hidden_size=64, ffn_dim=96, num_hidden_layers=2,
                                   num_attention_heads=4, max_position_embeddings=64, do_layer_norm_before=False,
                                   word_embed_proj_dim=32)),
    "phi": ("PhiConfig", dict(vocab_size=96, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
                              num_attention_heads=4, num_key_value_heads=4, partial_rotary_factor=0.5)),
    "phi-qk-layernorm": ("PhiConfig", dict(vocab_size=96, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
                                           num_attention_heads=4, num_key_value_heads=2, partial_rotary_factor=0.5,
                                           qk_layernorm=True)),
    "mistral": ("LlamaConfig", dict(LLAMA, sliding_window=5)),
    "qwen2": ("LlamaConfig", dict(LLAMA, attention_bias=True, tie_word_embeddings=True)),
    "phi3": ("LlamaConfig", dict(LLAMA, hidden_size=96, num_attention_heads=6, num_key_value_heads=6)),
    "internlm": ("LlamaConfig", dict(LLAMA, attention_bias=True, attention_out_bias=True)),
    "llama-attention-bias": ("LlamaConfig", dict(LLAMA, num_key_value_heads=4, attention_bias=True,
                                                 attention_out_bias=True)),
}
#: families whose o_proj bias JAX's cache twin drops: held to its training model
OUT_BIAS = ("internlm", "llama-attention-bias")

JAX_CFG = {"FalconConfig": jzoo.FalconConfig, "OPTConfig": jzoo.OPTConfig, "PhiConfig": jzoo.PhiConfig,
           "LlamaConfig": jllama.LlamaConfig}
PORT_CFG = {"FalconConfig": FalconConfig, "OPTConfig": OPTConfig, "PhiConfig": PhiConfig, "LlamaConfig": LlamaConfig}
JAX_TWIN = {"FalconConfig": jzoo.FalconForCausalLMWithCache, "OPTConfig": jzoo.OPTForCausalLMWithCache,
            "PhiConfig": jzoo.PhiForCausalLMWithCache, "LlamaConfig": jlc.LlamaForCausalLMWithCache}
PORT_TWIN = {"FalconConfig": tzoo.FalconForCausalLMWithCache, "OPTConfig": tzoo.OPTForCausalLMWithCache,
             "PhiConfig": tzoo.PhiForCausalLMWithCache, "LlamaConfig": LlamaForCausalLMWithCache}
CONVERT = {"FalconConfig": convert.jax_falcon_to_state_dict, "OPTConfig": convert.jax_opt_to_state_dict,
           "PhiConfig": convert.jax_phi_to_state_dict, "LlamaConfig": convert.jax_llama_to_state_dict}


def configs(family):
    kind, fields = FAMILIES[family]
    jcfg = JAX_CFG[kind](**fields, dtype=jnp.float32, remat=False)
    tcfg = PORT_CFG[kind](**fields, dtype=torch.float32, attention_impl="reference")
    return kind, jcfg, tcfg


def seeded_params(shapes, seed: int):
    """Every leaf from one numpy generator: norm scales 1 + N(0, 0.1²),
    everything else N(0, 0.3²)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        if name.endswith("scale") or ("norm" in name and name.endswith("weight")):
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (0.3 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


#: a prefill chunk (row 1 ragged: 5 real tokens), then two decode steps
ROWS = 2
STEPS = [(np.array([0, 0]), np.array([CHUNK, 5])), (np.array([CHUNK, 5]), np.array([1, 1])),
         (np.array([CHUNK + 1, 6]), np.array([1, 1]))]
BLOCK_TABLE = np.array([[1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 12]], np.int32)


def step_tokens(vocab: int):
    rng = np.random.default_rng(7)
    return [rng.integers(1, vocab, (ROWS, CHUNK)).astype(np.int32)] + \
        [rng.integers(1, vocab, (ROWS, 1)).astype(np.int32) for _ in range(2)]


def fast_jit(fn):
    """``jax.jit(fn)`` compiled with ``FAST_COMPILE``, once per shape of the
    arguments after the first (the variables)."""
    jitted, compiled = jax.jit(fn), {}

    def call(*args):
        key = tuple(np.shape(a) for a in jax.tree.leaves(args[1:]))
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(FAST_COMPILE)
        return compiled[key](*args)

    return call


def jax_paged_logits(kind, jcfg, variables):
    """The JAX twin over the three steps, each a chunk of CHUNK positions
    (a decode step's one token padded, as the JAX engine pads it into its
    chunk bucket): one compile."""
    apply = fast_jit(JAX_TWIN[kind](jcfg, page_size=PAGE).apply)
    cache = jlc.init_kv_cache(jcfg, jlc.PagedKVConfig(PAGES, PAGE, MAXP), dtype=jnp.float32)
    out = []
    for tokens, (start, lens) in zip(step_tokens(jcfg.vocab_size), STEPS):
        padded = np.zeros((ROWS, CHUNK), np.int32)
        padded[:, :tokens.shape[1]] = tokens
        logits, cache = apply(variables, padded, np.asarray(start, np.int32), BLOCK_TABLE, cache,
                              np.asarray(lens, np.int32))
        out.append(np.asarray(logits)[:, :tokens.shape[1]])
    return out


def jax_training_logits(jcfg, variables):
    """Each row's whole sequence through JAX's training model (the rows
    right-padded into one batch), cut into the paged steps' shapes."""
    toks = step_tokens(jcfg.vocab_size)
    out = [np.zeros((ROWS, t.shape[1], jcfg.vocab_size), np.float32) for t in toks]
    seqs = np.zeros((ROWS, CHUNK + 2), np.int32)
    for r in range(ROWS):
        n = STEPS[0][1][r]
        seqs[r, :n + 2] = np.concatenate([toks[0][r, :n], toks[1][r], toks[2][r]])
    full = np.asarray(fast_jit(jllama.LlamaForCausalLM(jcfg).apply)(variables, seqs))
    for r in range(ROWS):
        n = STEPS[0][1][r]
        out[0][r, :n] = full[r, :n]
        out[1][r, 0], out[2][r, 0] = full[r, n], full[r, n + 1]
    return out


def port_paged_logits(kind, tcfg, state):
    model = PORT_TWIN[kind](tcfg, page_size=PAGE, device="cpu")
    model.load_state_dict(state, strict=True)
    cache = init_kv_cache(tcfg, PagedKVConfig(PAGES, PAGE, MAXP), dtype=torch.float32, device="cpu")
    out = []
    with torch.no_grad():
        for tokens, (start, lens) in zip(step_tokens(tcfg.vocab_size), STEPS):
            out.append(model(torch.from_numpy(tokens), torch.from_numpy(start).int(), torch.from_numpy(BLOCK_TABLE),
                             cache, torch.from_numpy(lens).int()).numpy())
    return out


def jax_reference(family):
    """The family's seeded JAX variables and the JAX side's logits."""
    kind, jcfg, _ = configs(family)
    if family in OUT_BIAS:
        shapes = jax.eval_shape(jllama.LlamaForCausalLM(jcfg).init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 4), jnp.int32))
    else:
        cache = jlc.init_kv_cache(jcfg, jlc.PagedKVConfig(PAGES, PAGE, MAXP), dtype=jnp.float32)
        shapes = jax.eval_shape(JAX_TWIN[kind](jcfg, page_size=PAGE).init, jax.random.PRNGKey(0),
                                jnp.zeros((ROWS, CHUNK), jnp.int32), jnp.zeros((ROWS, ), jnp.int32),
                                jnp.asarray(BLOCK_TABLE), cache)
    variables = seeded_params(shapes, seed=len(family))
    want = jax_training_logits(jcfg, variables) if family in OUT_BIAS else jax_paged_logits(kind, jcfg, variables)
    return variables, want


@pytest.mark.parametrize("family", list(FAMILIES))
def test_paged_forward_matches_the_jax_twin(family):
    kind, _, tcfg = configs(family)
    variables, want = jax_reference(family)
    got = port_paged_logits(kind, tcfg, CONVERT[kind](variables, tcfg))
    for step, (g, w) in enumerate(zip(got, want)):
        lens = STEPS[step][1]
        for r in range(ROWS):
            scale = np.abs(w[r, :lens[r]]).max()
            np.testing.assert_allclose(g[r, :lens[r]], w[r, :lens[r]], rtol=0, atol=LOGIT_TOL * scale,
                                       err_msg=f"{family} step {step} row {r}")


def test_scanned_and_unrolled_jax_trees_convert_alike():
    """A JAX twin's scanned tree and its layers unrolled (``h_{i}``) give one
    state dict."""
    kind, jcfg, tcfg = configs("falcon-new-arch")
    cache = jlc.init_kv_cache(jcfg, jlc.PagedKVConfig(PAGES, PAGE, MAXP), dtype=jnp.float32)
    shapes = jax.eval_shape(JAX_TWIN[kind](jcfg, page_size=PAGE).init, jax.random.PRNGKey(0),
                            jnp.zeros((ROWS, CHUNK), jnp.int32), jnp.zeros((ROWS, ), jnp.int32),
                            jnp.asarray(BLOCK_TABLE), cache)
    params = seeded_params(shapes, seed=3)["params"]
    unrolled = {k: v for k, v in params.items() if k != "h"}
    unrolled.update({f"h_{i}": jax.tree.map(lambda x, i=i: x[i], params["h"]) for i in range(2)})
    a, b = convert.jax_falcon_to_state_dict(params, tcfg), convert.jax_falcon_to_state_dict(unrolled, tcfg)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    model = tzoo.FalconForCausalLMWithCache(tcfg, page_size=PAGE, device="cpu")
    assert set(model.state_dict()) == set(a)


def _attention_inputs(h=4, n_kv=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    b, c = 2, 6
    q = rng.standard_normal((b, c, h, d)).astype(np.float32)
    pages = rng.standard_normal((PAGES, PAGE, 2, n_kv, d)).astype(np.float32)
    start = np.array([9, 2], np.int32)
    lens = np.array([6, 4], np.int32)
    return q, pages, BLOCK_TABLE, start, lens


@pytest.mark.parametrize("mask", ["window", "alibi"])
def test_plain_k3_with_window_or_alibi_matches_the_jax_golden(mask):
    q, pages, bt, start, lens = _attention_inputs()
    kw = {"sliding_window": 5} if mask == "window" else {}
    slopes = jax_alibi_slopes(4)
    np.testing.assert_array_equal(alibi_slopes(4), slopes)
    jkw = dict(kw, alibi_slopes=jnp.asarray(slopes)) if mask == "alibi" else kw
    tkw = dict(kw, alibi_slopes=torch.from_numpy(slopes)) if mask == "alibi" else kw
    golden = fast_jit(lambda slopes, *a: jlc.paged_attention(*a, PAGE, alibi_slopes=slopes, **kw))
    want = np.asarray(golden(jkw.get("alibi_slopes"), q, pages, bt, start, lens))
    args = [torch.from_numpy(a) for a in (q, pages, bt, start, lens)]
    got = plain_paged_attention(*args, PAGE, **tkw)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # the split route's plain versions, three splits of 8 keys
    split = merge_partials_plain(*paged_attention_partials_plain(*args, PAGE, 3, **tkw), args[4])
    np.testing.assert_allclose(split.numpy(), got.numpy(), rtol=0, atol=1e-5)
