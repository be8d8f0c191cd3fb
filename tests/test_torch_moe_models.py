"""The MoE families of the port (Mixtral, Qwen2-MoE) against the JAX package
on the CPU, in float32, from the same numpy-seeded weights:

  * tiny Mixtral's training forward (``PRESETS["tiny"]``, capacity factor
    0.75 so that tokens are dropped): logits within 2e-5 of their largest
    magnitude and ``l_aux`` within 1e-5 relative; the gradient of
    ``mixtral_lm_loss`` per tensor within 1e-4 of its largest magnitude;
    then three ``train_batch`` steps of the port's engine (AdamW) against
    the JAX package's ``adamw`` on ``jax.value_and_grad``: losses within
    1e-5 relative, and the parameters within 1e-5 but for those Adam moves
    by lr either way on a gradient below the two sides' rounding (at most
    1e-3 of them, each within 2·Σlr);
  * Qwen2-MoE's training forward, every layer sparse and a mixed stack
    (a dense ``mlp_only`` layer, renormalised top-k, tied head): logits
    within 2e-5;
  * the paged twins (Mixtral, Qwen2-MoE uniform and mixed) over a prefill
    chunk and two decode steps against JAX's: logits within 2e-5; and
    through ``InferenceEngineV2`` against JAX's engine: greedy streams and
    free pages equal;
  * ``build_hf_engine`` on a directory of HF-named safetensors written from
    seeded numpy (Mixtral; Qwen2-MoE's mixed stack): the port serves it in
    bfloat16; in float32, its streams equal JAX's ``build_hf_engine``
    body's, and each policy's state dict equals the JAX policy's params
    carried by ``models/convert.py``, bit for bit.
"""

import dataclasses
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.comm.mesh import MeshSpec, create_mesh, set_global_mesh
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JaxEngineConfig
from deepspeed_tpu.inference.v2.scheduler import SchedulerConfig as JaxSchedulerConfig
from deepspeed_tpu.models import cache_zoo as jzoo
from deepspeed_tpu.models import llama_cache as jlc
from deepspeed_tpu.models import mixtral as jmix
from deepspeed_tpu.models import mixtral_cache as jmixc
from deepspeed_tpu.models import qwen2_moe as jqwen
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2, PagedKVConfig, RaggedInferenceEngineConfig,
                                              SchedulerConfig, build_cache_model, build_hf_engine, checkpoint_io)
from deepspeed_tpu_torch.inference.v2.model_implementations import policies as tpol
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models import mixtral as tmix
from deepspeed_tpu_torch.models import qwen2_moe as tqwen
from deepspeed_tpu_torch.models.llama_cache import init_kv_cache
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse fixture)

LOGIT_TOL = 2e-5   # of the largest |logit|
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
PAGE, PAGES, MAXP, CHUNK = 4, 16, 6, 8
KV = dict(num_pages=48, page_size=4, max_pages_per_seq=12)
SCHED = dict(token_budget=64, max_seqs=4, prefill_chunk=8, decode_bucket=4)
PROMPTS = [[5, 9, 2, 7, 1, 3, 8, 4, 6, 10, 11], [3, 3, 8], [12, 4, 7, 7, 9, 1]]
NEW_TOKENS = 8

QWEN = dict(vocab_size=96, hidden_size=32, intermediate_size=48, moe_intermediate_size=24,
            shared_expert_intermediate_size=40, num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            num_experts=6, num_experts_per_tok=2, max_position_embeddings=64)
FAMILIES = {
    "mixtral": ("mixtral", dict(vars(jmix.PRESETS["tiny"])), {}),
    "qwen2-moe": ("qwen2_moe", QWEN, {}),
    "qwen2-moe-mixed": ("qwen2_moe", dict(QWEN, num_hidden_layers=3, mlp_only_layers=(1, ), norm_topk_prob=True,
                                          tie_word_embeddings=True), {}),
}
JAX_MODEL_FIELDS = ("dtype", "param_dtype", "scan_layers", "remat", "remat_policy", "attention_impl")


@pytest.fixture(autouse=True)
def one_device_mesh():
    """One JAX device: one gating group, as on the port's one device."""
    set_global_mesh(create_mesh(MeshSpec(), devices=jax.devices()[:1]))


def configs(family, **jax_overrides):
    """(JAX config, port config) of a family in float32."""
    kind, fields, _ = FAMILIES[family]
    fields = {k: v for k, v in fields.items() if k not in JAX_MODEL_FIELDS}
    if kind == "mixtral":
        jcfg = jmix.MixtralConfig(**fields, dtype=jnp.float32, remat=False)
        tcfg = tmix.MixtralConfig(**fields, dtype=torch.float32)
    else:
        jcfg = jqwen.Qwen2MoeConfig(**fields, dtype=jnp.float32, remat=False)
        if jcfg.mixed_stack:
            jcfg = dataclasses.replace(jcfg, scan_layers=False)
        tcfg = tqwen.Qwen2MoeConfig(**fields, dtype=torch.float32)
    return dataclasses.replace(jcfg, **jax_overrides), tcfg


def to_state(family, params, tcfg):
    fn = convert.jax_mixtral_to_state_dict if FAMILIES[family][0] == "mixtral" else convert.jax_qwen2_moe_to_state_dict
    return fn(params, tcfg)


def seeded(shapes, seed):
    """Norm scales 1 + N(0, 0.1²), every other leaf N(0, 0.3²), from one
    numpy generator, out of flax's boxes."""
    from flax.linen import meta
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        if "norm" in name and (name.endswith("scale") or name.endswith("weight")):
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (0.3 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, meta.unbox(shapes))


def fast_jit(fn):
    """``jax.jit(fn)`` compiled with ``FAST_COMPILE``, once per argument shape."""
    jitted, compiled = jax.jit(fn), {}

    def call(*args):
        key = tuple(np.shape(a) for a in jax.tree.leaves(args[1:]))
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(FAST_COMPILE)
        return compiled[key](*args)

    return call


# ------------------------------------------------------------------ training

TRAIN_IDS = [np.random.default_rng(10 + i).integers(0, 128, (2, 16)).astype(np.int32) for i in range(3)]
LR, WD = 1e-3, 0.01


@pytest.fixture(scope="module")
def mixtral_training():
    """The JAX side of tiny Mixtral with drops: params, the first batch's
    loss, logits, l_aux and gradients, and three AdamW steps."""
    set_global_mesh(create_mesh(MeshSpec(), devices=jax.devices()[:1]))
    from deepspeed_tpu.ops.adam import adamw
    jcfg, _ = configs("mixtral", capacity_factor=0.75)
    model = jmix.MixtralForCausalLM(jcfg)
    params = seeded(jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((2, 16), jnp.int32)), 1)["params"]

    def loss_fn(p, ids):
        out = model.apply({"params": p}, ids)
        return jmix.mixtral_lm_loss(out, ids, None, jcfg.router_aux_loss_coef), out

    vg = fast_jit(jax.value_and_grad(loss_fn, has_aux=True))
    (loss, (logits, l_aux)), grads = vg(params, TRAIN_IDS[0])
    first = dict(params=params, loss=float(loss), logits=np.asarray(logits), l_aux=float(l_aux),
                 grads=jax.tree.map(np.asarray, grads))
    opt = adamw(lr=LR, weight_decay=WD)

    @jax.jit
    def apply_adamw(p, g, state):
        updates, state = opt.update(g, state, p)
        return jax.tree.map(lambda a, u: a + u, p, updates), state

    state, p, losses = opt.init(params), params, []
    for ids in TRAIN_IDS:
        (loss, _), g = vg(p, ids)
        p, state = apply_adamw(p, g, state)
        losses.append(float(loss))
    first.update(losses=losses, final=jax.tree.map(np.asarray, p))
    return first


def test_mixtral_forward_and_gradient_equal_jax(mixtral_training):
    jcfg, tcfg = configs("mixtral", capacity_factor=0.75)
    tcfg = dataclasses.replace(tcfg, capacity_factor=0.75)
    model = tmix.MixtralForCausalLM(tcfg, device="cpu")
    model.load_state_dict(to_state("mixtral", mixtral_training["params"], tcfg), strict=True)
    ids = torch.from_numpy(TRAIN_IDS[0])
    logits, l_aux = model(ids)
    want = mixtral_training["logits"]
    np.testing.assert_allclose(logits.detach().numpy(), want, rtol=0, atol=LOGIT_TOL * np.abs(want).max())
    np.testing.assert_allclose(float(l_aux.detach()), mixtral_training["l_aux"], rtol=1e-5)
    capacity = model.layers[0].block_sparse_moe.capacity(ids.numel(), train=True)
    with torch.no_grad():   # the first layer's router sends an expert more than its capacity: drops are live
        h = model.layers[0].post_attention_layernorm(model.embed(ids))
        _, _, counts = model.layers[0].block_sparse_moe(h)
    loss = tmix.mixtral_lm_loss((logits, l_aux), ids, None, tcfg.router_aux_loss_coef)
    np.testing.assert_allclose(float(loss), mixtral_training["loss"], rtol=1e-6)
    loss.backward()
    want_grads = to_state("mixtral", mixtral_training["grads"], tcfg)
    for name, p in model.named_parameters():
        w = want_grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=name)
    assert float(counts.max()) > capacity


def test_mixtral_train_batch_steps_equal_jax_adamw(mixtral_training):
    import deepspeed_tpu_torch
    _, tcfg = configs("mixtral")
    tcfg = dataclasses.replace(tcfg, capacity_factor=0.75)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=tmix.MixtralForCausalLM(tcfg, device="cpu"), params=to_state("mixtral", mixtral_training["params"], tcfg),
        config={"train_batch_size": 2, "optimizer": {"type": "AdamW", "params": {"lr": LR, "weight_decay": WD}}},
        loss_fn=tmix.make_mixtral_loss_fn(tcfg), device="cpu")
    losses = [float(engine.train_batch(batch={"input_ids": ids, "labels": ids})) for ids in TRAIN_IDS]
    np.testing.assert_allclose(losses, mixtral_training["losses"], rtol=1e-5)
    want = to_state("mixtral", mixtral_training["final"], tcfg)
    diff = torch.cat([(p.detach() - want[n]).abs().flatten() for n, p in engine.module.named_parameters()])
    assert float((diff > 1e-5).float().mean()) <= 1e-3 and float(diff.max()) <= 2 * 3 * LR


def test_qwen2_moe_training_forward_equals_jax():
    ids = np.random.default_rng(3).integers(0, 96, (2, 12)).astype(np.int32)
    for family in ("qwen2-moe", "qwen2-moe-mixed"):
        jcfg, tcfg = configs(family)
        jmodel = jqwen.Qwen2MoeForCausalLM(jcfg)
        variables = seeded(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((2, 12), jnp.int32)), 2)
        want = np.asarray(fast_jit(jmodel.apply)(variables, ids))
        model = tqwen.Qwen2MoeForCausalLM(tcfg, device="cpu")
        model.load_state_dict(to_state(family, variables, tcfg), strict=True)
        with torch.no_grad():
            got = model(torch.from_numpy(ids)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL * np.abs(want).max(), err_msg=family)
        assert [type(layer.mlp).__name__ for layer in model.layers] == \
            ["Qwen2MoeSparseMLP" if tcfg.layer_is_sparse(i) else "LlamaMLP" for i in range(tcfg.num_hidden_layers)]


# ------------------------------------------------------------------- serving

JAX_TWIN = {"mixtral": jmixc.MixtralForCausalLMWithCache, "qwen2_moe": jzoo.Qwen2MoeForCausalLMWithCache}
ROWS = 2
#: a prefill chunk (row 1 ragged: 5 real tokens), then two decode steps
STEPS = [(np.array([0, 0]), np.array([CHUNK, 5])), (np.array([CHUNK, 5]), np.array([1, 1])),
         (np.array([CHUNK + 1, 6]), np.array([1, 1]))]
BLOCK_TABLE = np.array([[1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 12]], np.int32)


@pytest.fixture(scope="module")
def twins():
    """Each family's seeded JAX twin variables (Mixtral with
    ``drop_tokens=False``, as JAX's ``build_cache_model`` serves it)."""
    set_global_mesh(create_mesh(MeshSpec(), devices=jax.devices()[:1]))
    out = {}
    for i, family in enumerate(FAMILIES):
        jcfg, tcfg = configs(family, **({"drop_tokens": False} if family == "mixtral" else {}))
        cache = jlc.init_kv_cache(jcfg, jlc.PagedKVConfig(PAGES, PAGE, MAXP), dtype=jnp.float32)
        shapes = jax.eval_shape(JAX_TWIN[FAMILIES[family][0]](jcfg, page_size=PAGE).init, jax.random.PRNGKey(0),
                                jnp.zeros((ROWS, CHUNK), jnp.int32), jnp.zeros((ROWS, ), jnp.int32),
                                jnp.asarray(BLOCK_TABLE), cache)
        variables = seeded(shapes, seed=20 + i)
        out[family] = (jcfg, tcfg, variables, to_state(family, variables, tcfg))
    return out


def step_tokens(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(1, vocab, (ROWS, CHUNK)).astype(np.int32)] + \
        [rng.integers(1, vocab, (ROWS, 1)).astype(np.int32) for _ in range(2)]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_paged_twin_logits_equal_jax(twins, family):
    jcfg, tcfg, variables, state = twins[family]
    apply = fast_jit(JAX_TWIN[FAMILIES[family][0]](jcfg, page_size=PAGE).apply)
    jcache = jlc.init_kv_cache(jcfg, jlc.PagedKVConfig(PAGES, PAGE, MAXP), dtype=jnp.float32)
    model = build_cache_model(tcfg, PAGE, device="cpu")
    model.load_state_dict(state, strict=True)
    cache = init_kv_cache(tcfg, PagedKVConfig(PAGES, PAGE, MAXP), dtype=torch.float32, device="cpu")
    for step, (tokens, (start, lens)) in enumerate(zip(step_tokens(tcfg.vocab_size), STEPS)):
        padded = np.zeros((ROWS, CHUNK), np.int32)   # a decode step padded into the chunk, as JAX's engine does
        padded[:, :tokens.shape[1]] = tokens
        want, jcache = apply(variables, padded, start.astype(np.int32), BLOCK_TABLE, jcache, lens.astype(np.int32))
        with torch.no_grad():
            got = model(torch.from_numpy(tokens), torch.from_numpy(start).int(), torch.from_numpy(BLOCK_TABLE), cache,
                        torch.from_numpy(lens).int()).numpy()
        for r in range(ROWS):
            w = np.asarray(want)[r, :lens[r]]
            np.testing.assert_allclose(got[r, :lens[r]], w, rtol=0, atol=LOGIT_TOL * np.abs(w).max(),
                                       err_msg=f"{family} step {step} row {r}")


def _port_engine_config():
    return RaggedInferenceEngineConfig(kv=PagedKVConfig(**KV), scheduler=SchedulerConfig(**SCHED),
                                       kv_dtype=torch.float32)


def _jax_streams(cfg, params):
    from deepspeed_tpu.models.llama_cache import PagedKVConfig as JaxPagedKVConfig
    eng = JaxEngine(cfg, {"params": params}, engine_config=JaxEngineConfig(
        kv=JaxPagedKVConfig(**KV), scheduler=JaxSchedulerConfig(**SCHED), kv_dtype=jnp.float32))
    return eng.generate(PROMPTS, max_new_tokens=NEW_TOKENS), eng.kv.allocator.free_pages


@pytest.mark.parametrize("family", list(FAMILIES))
def test_engine_streams_equal_jax(twins, family):
    jcfg, tcfg, variables, state = twins[family]
    if family == "mixtral":   # each engine's build_cache_model makes it dropless
        jcfg, tcfg = dataclasses.replace(jcfg, drop_tokens=True), dataclasses.replace(tcfg, drop_tokens=True)
    eng = InferenceEngineV2(tcfg, state, _port_engine_config(), device="cpu")
    if family == "mixtral":
        assert not eng.model.cfg.drop_tokens
    got = eng.generate(PROMPTS, max_new_tokens=NEW_TOKENS)
    assert [len(g) for g in got] == [NEW_TOKENS] * len(PROMPTS)
    assert (got, eng.kv.allocator.free_pages) == _jax_streams(jcfg, variables["params"])


# ------------------------------------------------------- HF checkpoint directory

HF_CONFIGS = {
    "mixtral": {"model_type": "mixtral", "vocab_size": 128, "hidden_size": 64, "intermediate_size": 96,
                "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
                "max_position_embeddings": 64, "rope_theta": 1e4, "rms_norm_eps": 1e-5, "num_local_experts": 4,
                "num_experts_per_tok": 2, "router_aux_loss_coef": 0.02, "torch_dtype": "float32"},
    "qwen2_moe": {"model_type": "qwen2_moe", "vocab_size": 96, "hidden_size": 32, "intermediate_size": 48,
                  "moe_intermediate_size": 24, "shared_expert_intermediate_size": 40, "num_hidden_layers": 3,
                  "num_attention_heads": 4, "num_key_value_heads": 4, "num_experts": 6, "num_experts_per_tok": 2,
                  "norm_topk_prob": False, "decoder_sparse_step": 1, "mlp_only_layers": [1],
                  "max_position_embeddings": 64, "rope_theta": 1e6, "rms_norm_eps": 1e-6,
                  "tie_word_embeddings": False, "torch_dtype": "float32"},
}


def hf_shapes(hf):
    """The HF tensor names and shapes of a Mixtral or Qwen2-MoE config."""
    e, v, h = hf["hidden_size"], hf["vocab_size"], hf["num_attention_heads"]
    d, kv = e // h, hf["num_key_value_heads"]
    out = {"model.embed_tokens.weight": (v, e), "model.norm.weight": (e, ), "lm_head.weight": (v, e)}
    for i in range(hf["num_hidden_layers"]):
        p = f"model.layers.{i}"
        out.update({f"{p}.self_attn.q_proj.weight": (h * d, e), f"{p}.self_attn.k_proj.weight": (kv * d, e),
                    f"{p}.self_attn.v_proj.weight": (kv * d, e), f"{p}.self_attn.o_proj.weight": (e, h * d),
                    f"{p}.input_layernorm.weight": (e, ), f"{p}.post_attention_layernorm.weight": (e, )})
        if hf["model_type"] == "mixtral":
            f, n = hf["intermediate_size"], hf["num_local_experts"]
            out[f"{p}.block_sparse_moe.gate.weight"] = (n, e)
            for x in range(n):
                q = f"{p}.block_sparse_moe.experts.{x}"
                out.update({f"{q}.w1.weight": (f, e), f"{q}.w3.weight": (f, e), f"{q}.w2.weight": (e, f)})
            continue
        for proj in ("q", "k", "v"):
            out[f"{p}.self_attn.{proj}_proj.bias"] = (out[f"{p}.self_attn.{proj}_proj.weight"][0], )
        if i in hf["mlp_only_layers"]:
            f = hf["intermediate_size"]
            out.update({f"{p}.mlp.gate_proj.weight": (f, e), f"{p}.mlp.up_proj.weight": (f, e),
                        f"{p}.mlp.down_proj.weight": (e, f)})
            continue
        m, si, n = hf["moe_intermediate_size"], hf["shared_expert_intermediate_size"], hf["num_experts"]
        out.update({f"{p}.mlp.gate.weight": (n, e), f"{p}.mlp.shared_expert_gate.weight": (1, e),
                    f"{p}.mlp.shared_expert.gate_proj.weight": (si, e), f"{p}.mlp.shared_expert.up_proj.weight": (si, e),
                    f"{p}.mlp.shared_expert.down_proj.weight": (e, si)})
        for x in range(n):
            q = f"{p}.mlp.experts.{x}"
            out.update({f"{q}.gate_proj.weight": (m, e), f"{q}.up_proj.weight": (m, e), f"{q}.down_proj.weight": (e, m)})
    return out


@pytest.mark.parametrize("model_type", list(HF_CONFIGS))
def test_build_hf_engine_equals_jax(tmp_path, model_type):
    from safetensors.numpy import save_file

    from deepspeed_tpu.inference.v2.engine_factory import _load_state_dict
    from deepspeed_tpu.inference.v2.model_implementations import policies as jpol
    hf = HF_CONFIGS[model_type]
    rng = np.random.default_rng(30)
    tensors = {n: ((1.0 if "norm" in n else 0.0) + 0.3 * rng.standard_normal(s)).astype(np.float32)
               for n, s in hf_shapes(hf).items()}
    save_file(tensors, str(tmp_path / "model.safetensors"), metadata={"format": "pt"})
    (tmp_path / "config.json").write_text(json.dumps(hf))
    path = str(tmp_path)
    served = build_hf_engine(path, _port_engine_config(), device="cpu")
    assert {p.dtype for p in served.model.parameters()} == {torch.bfloat16}
    assert [len(g) for g in served.generate(PROMPTS, max_new_tokens=NEW_TOKENS)] == [NEW_TOKENS] * len(PROMPTS)
    # float32 on both sides: JAX's build_hf_engine body with its model in float32
    cfg, state = tpol.convert_hf_state_dict(checkpoint_io.load_state_dict(path), checkpoint_io.read_config(path))
    jcfg, params = jpol.convert_hf_state_dict(_load_state_dict(path), SimpleNamespace(**hf))
    want = convert.jax_mixtral_to_state_dict(params, cfg) if model_type == "mixtral" else \
        convert.jax_qwen2_moe_to_state_dict(params, cfg)
    assert state.keys() == want.keys() and all(torch.equal(state[k], want[k]) for k in want)
    eng = InferenceEngineV2(dataclasses.replace(cfg, dtype=torch.float32), state, _port_engine_config(), device="cpu")
    got = eng.generate(PROMPTS, max_new_tokens=NEW_TOKENS)
    assert (got, eng.kv.allocator.free_pages) == _jax_streams(dataclasses.replace(jcfg, dtype=jnp.float32), params)
