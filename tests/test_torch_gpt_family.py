"""The v1-only families of the port against the JAX package on the CPU, in
float32: BLOOM, GPT-NeoX (parallel and sequential residual), GPT-J, GPT-Neo
(a window of 4 that bites at 16 positions), BERT, DistilBERT and CLIP.

One seeded HF-named state dict per family (numpy) goes through both
packages' policies.  The port's state dict equals the JAX params carried
across by ``models/convert.py``, bit for bit; the logits (CLIP's four
outputs) agree within ``LOGIT_TOL`` of their largest magnitude (the two
frameworks sum matmuls in other orders); ``models/convert.py`` carries the
JAX tree stacked and unrolled alike.  Qwen (v1) and the Megatron GPT
translations (both namings, the MoE expert bank) are held bit for bit to
JAX's.  ``build_hf_engine`` serves a BLOOM directory through the v1 engine
with JAX's greedy tokens; GPT-2 trains 3 steps in float32
with JAX's losses, grad norms and parameters.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.comm.mesh import MeshSpec, create_mesh
from deepspeed_tpu.inference.v2.model_implementations import policies as jpol
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.models import gpt_family as jgf
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu_torch.inference.v2 import build_hf_engine
from deepspeed_tpu_torch.inference.v2.model_implementations import policies as tpol
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models import gpt_family as tgf
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse fixture; other modules import it from here)

V, E, H, L, I, P = 96, 64, 4, 2, 128, 64
LOGIT_TOL = 2e-5   # of the largest |output|
IDS = np.array([[5, 9, 2, 7, 1, 3, 11, 4, 8, 6, 10, 12, 14, 13, 15, 0]], np.int64)


def seeded_params(model, *args, seed: int = 0):
    """A flax model's params from numpy, without compiling its ``init``:
    norm scales 1 + N(0, 0.05²), every other leaf N(0, 0.05²)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = next(p.key for p in reversed(path) if hasattr(p, "key"))
        x = rng.normal(size=leaf.shape) * 0.05
        return (x + (name == "scale" or (name == "weight" and len(leaf.shape) == 1))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)["params"])


def _w(rng, *shape, scale=0.05):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))


def _ln(rng, sd, name):
    sd[name + ".weight"] = 1.0 + _w(rng, E if "vision" not in name else 64)
    sd[name + ".bias"] = _w(rng, E if "vision" not in name else 64)


def _lin(rng, sd, name, fan_out, fan_in, bias=True):
    sd[name + ".weight"] = _w(rng, fan_out, fan_in)
    if bias:
        sd[name + ".bias"] = _w(rng, fan_out)


def hf_checkpoint(kind: str, seed: int = 0):
    """(HF config as a namespace, an HF-named float32 state dict) of a tiny ``kind``."""
    rng = np.random.default_rng(seed)
    sd = {}
    if kind == "bloom":
        sd["transformer.word_embeddings.weight"] = _w(rng, V, E, scale=1.0)
        _ln(rng, sd, "transformer.word_embeddings_layernorm")
        _ln(rng, sd, "transformer.ln_f")
        for i in range(L):
            p = f"transformer.h.{i}"
            _ln(rng, sd, f"{p}.input_layernorm")
            _ln(rng, sd, f"{p}.post_attention_layernorm")
            _lin(rng, sd, f"{p}.self_attention.query_key_value", 3 * E, E)
            _lin(rng, sd, f"{p}.self_attention.dense", E, E)
            _lin(rng, sd, f"{p}.mlp.dense_h_to_4h", 4 * E, E)
            _lin(rng, sd, f"{p}.mlp.dense_4h_to_h", E, 4 * E)
        cfg = dict(vocab_size=V, hidden_size=E, n_layer=L, n_head=H, layer_norm_epsilon=1e-5)
    elif kind in ("gpt_neox", "gpt_neox_seq"):
        sd["gpt_neox.embed_in.weight"] = _w(rng, V, E, scale=1.0)
        _ln(rng, sd, "gpt_neox.final_layer_norm")
        sd["embed_out.weight"] = _w(rng, V, E)
        for i in range(L):
            p = f"gpt_neox.layers.{i}"
            _ln(rng, sd, f"{p}.input_layernorm")
            _ln(rng, sd, f"{p}.post_attention_layernorm")
            _lin(rng, sd, f"{p}.attention.query_key_value", 3 * E, E)
            _lin(rng, sd, f"{p}.attention.dense", E, E)
            _lin(rng, sd, f"{p}.mlp.dense_h_to_4h", I, E)
            _lin(rng, sd, f"{p}.mlp.dense_4h_to_h", E, I)
        seq = kind == "gpt_neox_seq"
        cfg = dict(model_type="gpt_neox", vocab_size=V, hidden_size=E, intermediate_size=I, num_hidden_layers=L,
                   num_attention_heads=H, rotary_pct=1.0 if seq else 0.25, rotary_emb_base=10000.0,
                   use_parallel_residual=not seq, layer_norm_eps=1e-5)
        kind = "gpt_neox"
    elif kind == "gptj":
        sd["transformer.wte.weight"] = _w(rng, V, E, scale=1.0)
        _ln(rng, sd, "transformer.ln_f")
        _lin(rng, sd, "lm_head", V, E)
        for i in range(L):
            p = f"transformer.h.{i}"
            _ln(rng, sd, f"{p}.ln_1")
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                _lin(rng, sd, f"{p}.attn.{proj}", E, E, bias=False)
            _lin(rng, sd, f"{p}.mlp.fc_in", I, E)
            _lin(rng, sd, f"{p}.mlp.fc_out", E, I)
        cfg = dict(vocab_size=V, n_embd=E, n_layer=L, n_head=H, rotary_dim=8, n_inner=I, layer_norm_epsilon=1e-5)
    elif kind == "gpt_neo":
        sd["transformer.wte.weight"] = _w(rng, V, E, scale=1.0)
        sd["transformer.wpe.weight"] = _w(rng, P, E, scale=0.5)
        _ln(rng, sd, "transformer.ln_f")
        for i in range(L):
            p = f"transformer.h.{i}"
            _ln(rng, sd, f"{p}.ln_1")
            _ln(rng, sd, f"{p}.ln_2")
            for proj in ("q_proj", "k_proj", "v_proj"):
                _lin(rng, sd, f"{p}.attn.attention.{proj}", E, E, bias=False)
            _lin(rng, sd, f"{p}.attn.attention.out_proj", E, E)
            _lin(rng, sd, f"{p}.mlp.c_fc", I, E)
            _lin(rng, sd, f"{p}.mlp.c_proj", E, I)
        cfg = dict(vocab_size=V, hidden_size=E, num_layers=L, num_heads=H, max_position_embeddings=P,
                   attention_layers=["global", "local"], window_size=4, intermediate_size=I, layer_norm_epsilon=1e-5)
    elif kind == "bert":
        b = "bert.embeddings"
        sd[f"{b}.word_embeddings.weight"] = _w(rng, V, E, scale=1.0)
        sd[f"{b}.position_embeddings.weight"] = _w(rng, P, E, scale=0.5)
        sd[f"{b}.token_type_embeddings.weight"] = _w(rng, 2, E, scale=0.5)
        _ln(rng, sd, f"{b}.LayerNorm")
        for i in range(L):
            p = f"bert.encoder.layer.{i}"
            for proj in ("query", "key", "value"):
                _lin(rng, sd, f"{p}.attention.self.{proj}", E, E)
            _lin(rng, sd, f"{p}.attention.output.dense", E, E)
            _ln(rng, sd, f"{p}.attention.output.LayerNorm")
            _lin(rng, sd, f"{p}.intermediate.dense", I, E)
            _lin(rng, sd, f"{p}.output.dense", E, I)
            _ln(rng, sd, f"{p}.output.LayerNorm")
        _lin(rng, sd, "cls.predictions.transform.dense", E, E)
        _ln(rng, sd, "cls.predictions.transform.LayerNorm")
        sd["cls.predictions.decoder.weight"] = _w(rng, V, E)
        sd["cls.predictions.bias"] = _w(rng, V)
        cfg = dict(vocab_size=V, hidden_size=E, num_hidden_layers=L, num_attention_heads=H, intermediate_size=I,
                   max_position_embeddings=P, type_vocab_size=2, layer_norm_eps=1e-12, hidden_act="gelu")
    elif kind == "distilbert":
        sd["distilbert.embeddings.word_embeddings.weight"] = _w(rng, V, E, scale=1.0)
        sd["distilbert.embeddings.position_embeddings.weight"] = _w(rng, P, E, scale=0.5)
        _ln(rng, sd, "distilbert.embeddings.LayerNorm")
        for i in range(L):
            p = f"distilbert.transformer.layer.{i}"
            for proj in ("q_lin", "k_lin", "v_lin", "out_lin"):
                _lin(rng, sd, f"{p}.attention.{proj}", E, E)
            _ln(rng, sd, f"{p}.sa_layer_norm")
            _lin(rng, sd, f"{p}.ffn.lin1", I, E)
            _lin(rng, sd, f"{p}.ffn.lin2", E, I)
            _ln(rng, sd, f"{p}.output_layer_norm")
        _lin(rng, sd, "vocab_transform", E, E)
        _ln(rng, sd, "vocab_layer_norm")
        _lin(rng, sd, "vocab_projector", V, E)
        cfg = dict(vocab_size=V, dim=E, n_layers=L, n_heads=H, hidden_dim=I, max_position_embeddings=P,
                   activation="gelu")
    elif kind == "clip":
        sd["text_model.embeddings.token_embedding.weight"] = _w(rng, V, E, scale=1.0)
        sd["text_model.embeddings.position_embedding.weight"] = _w(rng, 16, E, scale=0.5)
        sd["vision_model.embeddings.patch_embedding.weight"] = _w(rng, 64, 3, 8, 8, scale=0.1)
        sd["vision_model.embeddings.class_embedding"] = _w(rng, 64, scale=0.5)
        sd["vision_model.embeddings.position_embedding.weight"] = _w(rng, 17, 64, scale=0.5)
        for tower in ("text_model", "vision_model"):
            for i in range(L):
                p = f"{tower}.encoder.layers.{i}"
                for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                    _lin(rng, sd, f"{p}.self_attn.{proj}", E, E)
                _ln(rng, sd, f"{p}.layer_norm1")
                _ln(rng, sd, f"{p}.layer_norm2")
                _lin(rng, sd, f"{p}.mlp.fc1", I, E)
                _lin(rng, sd, f"{p}.mlp.fc2", E, I)
        _ln(rng, sd, "text_model.final_layer_norm")
        _ln(rng, sd, "vision_model.pre_layrnorm")
        _ln(rng, sd, "vision_model.post_layernorm")
        sd["text_projection.weight"] = _w(rng, 32, E)
        sd["visual_projection.weight"] = _w(rng, 32, 64)
        sd["logit_scale"] = torch.tensor(2.6592)
        text = SimpleNamespace(vocab_size=V, hidden_size=E, num_hidden_layers=L, num_attention_heads=H,
                               intermediate_size=I, max_position_embeddings=16, layer_norm_eps=1e-5, eos_token_id=V - 1,
                               hidden_act="quick_gelu")
        vision = SimpleNamespace(hidden_size=64, num_hidden_layers=L, num_attention_heads=H, intermediate_size=I,
                                 image_size=32, patch_size=8, num_channels=3, layer_norm_eps=1e-5,
                                 hidden_act="quick_gelu")
        cfg = dict(text_config=text, vision_config=vision, projection_dim=32)
    else:
        raise ValueError(kind)
    return SimpleNamespace(model_type=kind, **{k: v for k, v in cfg.items() if k != "model_type"}), sd


FAMILIES = ["bloom", "gpt_neox", "gpt_neox_seq", "gptj", "gpt_neo", "bert", "distilbert", "clip"]
CONVERT = {"bloom": "gpt_family", "gpt_neox": "gpt_family", "gpt_neox_seq": "gpt_family", "gptj": "gpt_family",
           "gpt_neo": "gpt_family", "bert": "bert", "distilbert": "bert", "clip": "clip"}


def _both(kind):
    """(HF config, JAX model, JAX params, port model) of ``kind`` in float32."""
    hf_cfg, sd = hf_checkpoint(kind)
    jcfg, params = jpol.convert_hf_state_dict(sd, hf_cfg)
    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
    cfg, state = tpol.convert_hf_state_dict(sd, hf_cfg)
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    policy = tpol.policy_for(hf_cfg.model_type)
    model = policy.build_model(cfg, device="cpu")
    model.load_state_dict(state, strict=True)
    return hf_cfg, cfg, state, jpol.policy_for(hf_cfg.model_type).build_model(jcfg), params, model.eval()


def _inputs(kind):
    if kind == "clip":
        rng = np.random.default_rng(3)
        ids = np.array([[5, 9, 2, V - 1, 1, 3, 0, 4], [7, 7, 1, 2, 3, 4, V - 1, 6]], np.int64)
        return ids, rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    return IDS, None


def _unrolled(params, cfg):
    """A JAX tree's stacked layers (``h``, ``layers`` or ``bert/encoder``) as ``{stack}_{i}``."""
    tree = {k: dict(v) if k == "bert" else v for k, v in jax.tree.map(np.asarray, params).items()}
    node = tree["bert"] if "bert" in tree else tree
    stack = next(k for k in ("h", "layers", "encoder") if k in node)
    layers = node.pop(stack)
    for i in range(cfg.num_hidden_layers):
        node[f"{stack}_{i}"] = jax.tree.map(lambda x: x[i], layers)
    return tree


@pytest.mark.parametrize("kind", FAMILIES)
def test_policy_and_logits_match_jax(kind):
    hf_cfg, cfg, state, jmodel, params, model = _both(kind)
    carry = getattr(convert, f"jax_{CONVERT[kind]}_to_state_dict")
    want_state = carry(jax.tree.map(np.asarray, params), cfg)
    assert state.keys() == want_state.keys()
    for k in want_state:
        assert torch.equal(state[k].float(), want_state[k].float()), k
    if kind != "clip":   # the same tree unrolled ({stack}_{i}) carries to the same state
        assert all(torch.equal(t, want_state[k]) for k, t in carry(_unrolled(params, cfg), cfg).items())
    ids, pixels = _inputs(kind)
    with torch.no_grad():
        if kind == "clip":
            got = model(torch.from_numpy(ids), torch.from_numpy(pixels))
            want = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(ids, jnp.int32), jnp.asarray(pixels))
        else:
            got = (model(torch.from_numpy(ids)), )
            want = (jax.jit(jmodel.apply)({"params": params}, jnp.asarray(ids, jnp.int32)), )
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=LOGIT_TOL * np.abs(w).max(), err_msg=kind)


def test_gpt_neo_window_hides_old_keys():
    """Layer 1 is local with a window of 4: a token 8 positions back moves
    no output of layer 1's attention."""
    _, cfg, _, _, _, model = _both("gpt_neo")
    block = model.h[1]
    assert block.window == 4 and model.h[0].window == 0
    q = torch.randn(1, 16, H, E // H, generator=torch.Generator().manual_seed(1))
    base = tgf.windowed_attention(q, q, q, 4)
    moved = q.clone()
    moved[:, 3] += 1.0
    out = tgf.windowed_attention(q, moved, moved, 4)
    assert torch.equal(out[:, 7:], base[:, 7:]) and not torch.equal(out[:, 3:7], base[:, 3:7])


def test_qwen_and_megatron_translations_equal_jax():
    rng = np.random.default_rng(4)
    # Qwen (v1): the fused c_attn split, gate = w2, up = w1, on the Llama twin
    sd = {"transformer.wte.weight": _w(rng, V, E), "transformer.ln_f.weight": 1.0 + _w(rng, E),
          "lm_head.weight": _w(rng, V, E)}
    for i in range(L):
        p = f"transformer.h.{i}"
        sd.update({f"{p}.ln_1.weight": 1.0 + _w(rng, E), f"{p}.ln_2.weight": 1.0 + _w(rng, E),
                   f"{p}.attn.c_attn.weight": _w(rng, 3 * E, E), f"{p}.attn.c_attn.bias": _w(rng, 3 * E),
                   f"{p}.attn.c_proj.weight": _w(rng, E, E), f"{p}.mlp.w1.weight": _w(rng, I // 2, E),
                   f"{p}.mlp.w2.weight": _w(rng, I // 2, E), f"{p}.mlp.c_proj.weight": _w(rng, E, I // 2)})
    hf_cfg = SimpleNamespace(model_type="qwen", vocab_size=V, hidden_size=E, intermediate_size=I,
                             num_hidden_layers=L, num_attention_heads=H, max_position_embeddings=P,
                             rotary_emb_base=10000.0, layer_norm_epsilon=1e-6)
    _, params = jpol.convert_hf_state_dict(sd, hf_cfg)
    cfg, state = tpol.convert_hf_state_dict(sd, hf_cfg)
    want = convert.jax_llama_to_state_dict(params, cfg)
    assert tpol.policy_for("qwen").paged and state.keys() == want.keys()
    assert all(torch.equal(state[k], want[k]) for k in want)
    # Megatron GPT: both namings; the MoE policy's expert bank
    for enc, attn, embed in (("language_model.encoder.layers", "self_attention",
                              "language_model.embedding.word_embeddings.weight"),
                             ("transformer.layers", "attention", "transformer.word_embeddings.weight")):
        final = ("language_model.encoder" if enc.startswith("language") else "transformer") + ".final_layernorm"
        sd = {embed: _w(rng, V + 32, E), final + ".weight": 1.0 + _w(rng, E), final + ".bias": _w(rng, E)}
        for i in range(L):
            p = f"{enc}.{i}"
            for ln in ("input_layernorm", "post_attention_layernorm"):
                sd.update({f"{p}.{ln}.weight": 1.0 + _w(rng, E), f"{p}.{ln}.bias": _w(rng, E)})
            for name, shape in ((f"{attn}.query_key_value", (3 * E, E)), (f"{attn}.dense", (E, E)),
                                ("mlp.dense_h_to_4h", (I, E)), ("mlp.dense_4h_to_h", (E, I))):
                sd.update({f"{p}.{name}.weight": _w(rng, *shape), f"{p}.{name}.bias": _w(rng, shape[0])})
            for e in range(3):
                q = f"{p}.mlp.deepspeed_moe.experts.deepspeed_experts.{e}"
                sd.update({f"{q}.dense_h_to_4h.weight": _w(rng, I, E), f"{q}.dense_h_to_4h.bias": _w(rng, I),
                           f"{q}.dense_4h_to_h.weight": _w(rng, E, I), f"{q}.dense_4h_to_h.bias": _w(rng, E)})
        hf_cfg = SimpleNamespace(model_type="megatron-gpt", vocab_size=V, hidden_size=E, ffn_hidden_size=I,
                                 num_layers=L, num_attention_heads=H, rotary_percent=0.5)
        jcfg, params = jpol.convert_hf_state_dict(sd, hf_cfg)
        cfg, state = tpol.convert_hf_state_dict(sd, hf_cfg)
        assert not cfg.use_parallel_residual and cfg.rotary_pct == 0.5
        want = convert.jax_gpt_family_to_state_dict(params, cfg)
        assert state.keys() == want.keys() and all(torch.equal(state[k], want[k]) for k in want), enc
        got = tpol.policy_for("megatron-gpt-moe").convert_experts(sd, cfg, 3)
        jwant = jpol.policy_for("megatron-gpt-moe").convert_experts(sd, jcfg, 3)
        assert all(np.array_equal(got[k].numpy(), jwant[k]) for k in jwant)
    with pytest.raises(ValueError, match="learned position"):
        tpol.convert_hf_state_dict({**sd, "transformer.position_embeddings.weight": _w(rng, P, E)}, hf_cfg)


def _save_dir(tmp_path, kind):
    hf_cfg, sd = hf_checkpoint(kind)
    d = tmp_path / kind
    d.mkdir()
    (d / "config.json").write_text(__import__("json").dumps({**vars(hf_cfg)}))
    torch.save(sd, d / "pytorch_model.bin")
    return str(d), hf_cfg, sd


@pytest.mark.parametrize("kind", ["bloom"])
def test_build_hf_engine_serves_the_v1_route_with_jax_tokens(tmp_path, kind):
    """The directory through the port's v1 route (float32) and the JAX v1
    engine over JAX's policy (float32 compute) give the same greedy tokens;
    ``quantization_mode`` raises, ``engine_config`` is ignored."""
    path, hf_cfg, sd = _save_dir(tmp_path, kind)
    eng = build_hf_engine(path, device="cpu")
    assert isinstance(eng, tds.inference.engine.InferenceEngine) and eng.config.dtype == torch.float32
    jcfg, params = jpol.convert_hf_state_dict(sd, hf_cfg)
    jeng = jds.init_inference(model=jpol.policy_for(kind).build_model(dataclasses.replace(jcfg, dtype=jnp.float32)),
                              config={"dtype": "fp32"}, params={"params": params})
    prompt = np.array([[5, 9, 2, 7], [1, 3, 11, 4]], np.int32)
    np.testing.assert_array_equal(eng.generate(prompt, max_new_tokens=6), np.asarray(jeng.generate(prompt, 6)))
    with pytest.raises(NotImplementedError, match="paged"):
        build_hf_engine(path, quantization_mode="wf6af16", device="cpu")


def test_gpt2_trains_three_steps_like_jax():
    """GPT-2 (tiny, float32, AdamW, clipping) through both engines: losses
    and grad norms within 1e-5 relative; parameters all within 2·sum(lr) and
    all but 1e-3 of them within 2e-5 (a key bias has a zero gradient up to
    rounding, which Adam's m/sqrt(v) scales to ±lr on either side, as
    ``test_torch_training._assert_params_close`` explains).  Remat is off
    on both sides: it changes no number, and JAX compiles faster."""
    jcfg = dataclasses.replace(jgpt2.PRESETS["tiny"], dtype=jnp.float32, scan_layers=False, remat=False)
    tcfg = dataclasses.replace(tgpt2.PRESETS["tiny"], dtype=torch.float32, remat=False)
    ds_config = {"train_batch_size": 2, "gradient_clipping": 1.0, "steps_per_print": 0,
                 "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}}}
    model = jgpt2.GPT2LMHeadModel(jcfg)
    variables = {"params": seeded_params(model, jnp.zeros((1, 32), jnp.int32))}
    mesh = create_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    jeng = jds.initialize(model=model, config=JaxConfig(ds_config, dp_world_size=1), mesh=mesh,
                          params=variables["params"])[0]
    want = []
    jeng._maybe_print = want.append
    state = convert.jax_gpt2_to_state_dict(jax.tree.map(np.asarray, variables), tcfg)
    eng = tds.initialize(model=tgpt2.GPT2LMHeadModel(tcfg, device="cpu"), config=ds_config, params=state,
                         device="cpu")[0]
    rng = np.random.default_rng(6)
    got = []
    for _ in range(3):
        ids = rng.integers(0, tcfg.vocab_size, (2, 32)).astype(np.int32)
        jeng.train_batch(batch={"input_ids": ids, "labels": ids})
        got.append((float(eng.train_batch(batch={"input_ids": ids, "labels": ids})), eng.get_global_grad_norm()))
    np.testing.assert_allclose(np.array(got), np.array([(float(m.loss), float(m.grad_norm)) for m in want]),
                               rtol=1e-5)
    jstate = convert.jax_gpt2_to_state_dict(jax.tree.map(np.asarray, jeng.state.params), tcfg)
    diff = np.concatenate([np.abs(t.numpy() - jstate[name].numpy()).ravel()
                           for name, t in eng.module_state_dict().items()])
    assert diff.max() <= 2 * 3 * 1e-3 and (diff > 2e-5).mean() < 1e-3, (diff.max(), (diff > 2e-5).sum())


def test_bert_heads_loss_and_the_transformer_layer_shim_match_jax():
    """``BertForSequenceClassification`` with a padding mask, ``masked_lm_loss``
    with ignored positions, and ``DeepSpeedTransformerLayer`` (pre-LN
    ``BertLayer``) on JAX's seeded params: within LOGIT_TOL of the largest
    output, the loss within 1e-6."""
    from deepspeed_tpu.models import bert as jbert
    from deepspeed_tpu.ops import transformer as jtr
    from deepspeed_tpu_torch.models import bert as tbert
    from deepspeed_tpu_torch.ops import transformer as ttr
    fields = dict(vocab_size=V, hidden_size=E, num_hidden_layers=1, num_attention_heads=H, intermediate_size=I,
                  max_position_embeddings=P)
    jcfg = jbert.BertConfig(**fields, dtype=jnp.float32, scan_layers=False, remat=False)
    tcfg = tbert.BertConfig(**fields, dtype=torch.float32, remat=False)
    ids = IDS[:, :12].repeat(2, axis=0)
    mask = np.ones_like(ids)
    mask[1, 8:] = 0
    jmodel = jbert.BertForSequenceClassification(jcfg, num_labels=3)
    params = seeded_params(jmodel, jnp.asarray(ids, jnp.int32), seed=2)
    model = tbert.BertForSequenceClassification(tcfg, num_labels=3, device="cpu")
    model.load_state_dict(convert.jax_bert_to_state_dict(jax.tree.map(np.asarray, params), tcfg), strict=True)
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, jnp.asarray(ids, jnp.int32), jnp.asarray(mask)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL * np.abs(want).max())

    rng = np.random.default_rng(8)
    logits = rng.normal(size=(2, 12, V)).astype(np.float32)
    labels = np.where(rng.random((2, 12)) < 0.3, rng.integers(0, V, (2, 12)), -100)
    np.testing.assert_allclose(float(tbert.masked_lm_loss(torch.from_numpy(logits), torch.from_numpy(labels))),
                               float(jbert.masked_lm_loss(jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-6)

    tr = dict(hidden_size=E, intermediate_size=I, heads=H)
    jlayer = jtr.DeepSpeedTransformerLayer(jtr.DeepSpeedTransformerConfig(**tr))
    x = rng.normal(size=(2, 12, E)).astype(np.float32)
    lparams = seeded_params(jlayer, jnp.asarray(x), seed=3)
    layer = ttr.DeepSpeedTransformerLayer(ttr.DeepSpeedTransformerConfig(**tr), device="cpu")
    state = convert.jax_bert_to_state_dict({"encoder_0": jax.tree.map(np.asarray, lparams)},
                                           tcfg)
    layer.load_state_dict({k.removeprefix("encoder.0."): v for k, v in state.items()}, strict=True)
    want = np.asarray(jax.jit(jlayer.apply)({"params": lparams}, jnp.asarray(x)))
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL * np.abs(want).max())


def test_replace_module_builds_the_policy_model(tmp_path):
    """``replace_module`` over a checkpoint directory and over an object with
    ``config`` and ``state_dict()`` (as a transformers model): the policy's
    model holding JAX's converted weights; ``replace_transformer_layer``
    raises, as JAX's does."""
    from deepspeed_tpu.module_inject import replace_module as jreplace
    from deepspeed_tpu_torch import module_inject
    path, hf_cfg, sd = _save_dir(tmp_path, "gpt_neox")
    model, state = module_inject.replace_module(path, device="cpu")
    _, jparams = jreplace(SimpleNamespace(config=hf_cfg, state_dict=lambda: sd))
    want = convert.jax_gpt_family_to_state_dict(jparams, model.cfg)
    assert isinstance(model, tgf.GPTNeoXForCausalLM) and state.keys() == want.keys()
    assert all(torch.equal(t, want[k]) for k, t in model.state_dict().items())
    model, _ = module_inject.replace_module(SimpleNamespace(config=vars(hf_cfg), state_dict=lambda: sd),
                                            dtype=torch.float32, device="cpu")
    assert model.cfg.dtype == torch.float32
    with pytest.raises(NotImplementedError, match="replace_module"):
        module_inject.replace_transformer_layer()
