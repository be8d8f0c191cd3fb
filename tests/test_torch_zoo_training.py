"""The training forwards of the dense zoo against the JAX package on the CPU,
in float32: Falcon (parallel with one LayerNorm and with two, sequential,
alibi), OPT (pre-LN, post-LN, ``project_in``/``project_out``), Phi (with and
without ``qk_layernorm``, head dim 80) and Llama with a sliding window
shorter than the sequence.

Seeded JAX params (numpy) go through ``models/convert.py`` into the port's
model, scanned or unrolled alike.  Both models take the same seeded ids: the
logits agree within ``LOGIT_TOL`` of their largest magnitude, and the
gradients of ``causal_lm_loss`` within ``GRAD_RTOL`` relative, plus
``GRAD_RTOL`` of each tensor's largest magnitude and ``GRAD_NOISE`` of the
model's largest gradient for the entries that are rounding noise (the key
projection's bias has a zero gradient up to rounding: it shifts every score
of a row alike) — the two frameworks sum matmuls in other orders.  The port
runs its ``"flash"`` impl, whose plain version (or, for a window, the chunked
path) is what a CPU tensor takes; JAX runs ``"reference"`` (``"chunked"`` for
the window).  Then: tiny Phi trains 2 steps through ``initialize`` /
``train_batch`` with the JAX engine's losses and grad norms; every remat
policy gives the grads of no remat through the engine; PLD leaves these
families ungated, as JAX's engine does; the kernels' shape check takes head
dims 80 and 96 and Falcon-7B's 71:1 (the repeated-KV route) without a card;
the flops profiler counts them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.comm.mesh import MeshSpec, create_mesh
from deepspeed_tpu.models import falcon as jfalcon
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu.models import opt as jopt
from deepspeed_tpu.models import phi as jphi
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models import falcon as tfalcon
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.models import opt as topt
from deepspeed_tpu_torch.models import phi as tphi
from deepspeed_tpu_torch.ops import flash_attention as tfa
from deepspeed_tpu_torch.profiling.flops_profiler.profiler import cost_analysis
from test_torch_gpt_family import one_intra_op_thread, seeded_params  # noqa: F401  (an autouse fixture)

LOGIT_TOL = 1e-5   # of the largest |logit|
GRAD_RTOL = 1e-4
GRAD_NOISE = 1e-6  # of the model's largest |gradient|: about ten float32 ulps of it
B, S, V = 2, 128, 128

FALCON = dict(vocab_size=V, hidden_size=128, num_hidden_layers=2, num_attention_heads=8, num_kv_heads=1,
              max_position_embeddings=256)
# (JAX fields over FALCON, port attention impl, JAX layers scanned)
FALCON_CASES = {
    "parallel-1ln": (dict(), "flash", True),                                        # Falcon-7B: 8:1, one LN
    "parallel-2ln": (dict(new_decoder_architecture=True, num_ln_in_parallel_attn=2, bias=True), "flash", False),
    "sequential": (dict(parallel_attn=False, num_kv_heads=8, tie_word_embeddings=False), "flash", True),
    "alibi": (dict(parallel_attn=False, num_kv_heads=8, alibi=True, bias=True), "reference", False),  # Falcon-RW
}
OPT = dict(vocab_size=V, hidden_size=64, ffn_dim=128, num_hidden_layers=2, num_attention_heads=4,
           max_position_embeddings=256)
OPT_CASES = {
    "pre-ln": (dict(), True),
    "post-ln": (dict(do_layer_norm_before=False, tie_word_embeddings=False), False),
    "project-in-out": (dict(word_embed_proj_dim=32), True),                         # OPT-350M's layout
}
# head dim 80 (Phi-2's), rotary over 32 of it
PHI = dict(vocab_size=V, hidden_size=160, intermediate_size=256, num_hidden_layers=2, num_attention_heads=2,
           num_key_value_heads=2, partial_rotary_factor=0.4, max_position_embeddings=256)


def _ids(seed: int, s: int = S, b: int = B) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, V, (b, s)).astype(np.int32)


def _jax_logits_and_grads(model, params, ids):
    """JAX's logits and the grads of its ``causal_lm_loss`` (one jit)."""

    def loss(p):
        logits = model.apply({"params": p}, jnp.asarray(ids))
        return jl.causal_lm_loss(logits, jnp.asarray(ids)), logits

    (_, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return np.asarray(logits), jax.tree.map(np.asarray, grads)


def _port_logits_and_grads(model, ids):
    t = torch.from_numpy(ids)
    logits = model(t)
    tl.causal_lm_loss(logits, t).backward()
    return logits.detach().numpy(), {n: p.grad.numpy() for n, p in model.named_parameters()}


def _assert_matches(model, jmodel, to_state, cfg, ids, seed=0):
    """The port's model loaded from seeded JAX params: logits and grads as JAX's."""
    params = seeded_params(jmodel, jnp.zeros((1, ids.shape[1]), jnp.int32), seed=seed)
    model.load_state_dict(to_state({"params": params}, cfg), strict=True)
    want_logits, jgrads = _jax_logits_and_grads(jmodel, params, ids)
    got_logits, grads = _port_logits_and_grads(model, ids)
    np.testing.assert_allclose(got_logits, want_logits, rtol=0, atol=LOGIT_TOL * np.abs(want_logits).max())
    want = {k: v.numpy() for k, v in to_state(jgrads, cfg).items()}
    assert want.keys() == grads.keys()
    noise = GRAD_NOISE * max(np.abs(w).max() for w in want.values())
    for name, g in grads.items():
        np.testing.assert_allclose(g, want[name], rtol=GRAD_RTOL, atol=GRAD_RTOL * np.abs(want[name]).max() + noise,
                                   err_msg=name)


@pytest.mark.parametrize("case", list(FALCON_CASES))
def test_falcon_matches_jax(case):
    fields, impl, scanned = FALCON_CASES[case]
    jcfg = jfalcon.FalconConfig(**{**FALCON, **fields}, dtype=jnp.float32, scan_layers=scanned, remat=False)
    tcfg = tfalcon.FalconConfig(**{**FALCON, **fields}, dtype=torch.float32, attention_impl=impl, remat=False)
    model = tfalcon.FalconForCausalLM(tcfg, device="cpu")
    assert model.attention_bias_kind == ("alibi" if tcfg.alibi else None)
    _assert_matches(model, jfalcon.FalconForCausalLM(jcfg), convert.jax_falcon_to_state_dict, tcfg, _ids(1))


def test_falcon_alibi_takes_only_the_reference_attention():
    """As JAX: no kernel takes alibi, so any other impl raises."""
    cfg = tfalcon.FalconConfig(**{**FALCON, **FALCON_CASES["alibi"][0]}, dtype=torch.float32, attention_impl="flash")
    model = tl.init_weights_(tfalcon.FalconForCausalLM(cfg, device="cpu"), torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="alibi falcon requires attention_impl='reference'"):
        model(torch.from_numpy(_ids(2)))


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_opt_matches_jax(case):
    fields, scanned = OPT_CASES[case]
    jcfg = jopt.OPTConfig(**OPT, **fields, dtype=jnp.float32, scan_layers=scanned, remat=False)
    tcfg = topt.OPTConfig(**OPT, **fields, dtype=torch.float32, attention_impl="flash", remat=False)
    _assert_matches(topt.OPTForCausalLM(tcfg, device="cpu"), jopt.OPTForCausalLM(jcfg), convert.jax_opt_to_state_dict,
                    tcfg, _ids(3))


@pytest.mark.parametrize("qk_layernorm", [False, True], ids=["phi-2", "qk-layernorm"])
def test_phi_matches_jax(qk_layernorm):
    jcfg = jphi.PhiConfig(**PHI, qk_layernorm=qk_layernorm, dtype=jnp.float32, scan_layers=qk_layernorm, remat=False)
    tcfg = tphi.PhiConfig(**PHI, qk_layernorm=qk_layernorm, dtype=torch.float32, attention_impl="flash", remat=False)
    assert tcfg.head_dim == 80
    _assert_matches(tphi.PhiForCausalLM(tcfg, device="cpu"), jphi.PhiForCausalLM(jcfg), convert.jax_phi_to_state_dict,
                    tcfg, _ids(4))


def test_windowed_llama_matches_jax_chunked():
    """Mistral's layout: a window of 100 over 256 positions (JAX ``chunked``
    takes one 256-query chunk; the port's flash op sends a window to its
    chunked path, so no kernel would run on the card either)."""
    fields = dict(vocab_size=V, hidden_size=64, intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, rope_theta=1e4, sliding_window=100)
    jcfg = jl.LlamaConfig(**fields, dtype=jnp.float32, attention_impl="chunked", scan_layers=False, remat=False)
    tcfg = tl.LlamaConfig(**fields, dtype=torch.float32, attention_impl="flash", remat=False)
    ids = _ids(5, s=256, b=1)
    _assert_matches(tl.LlamaForCausalLM(tcfg, device="cpu"), jl.LlamaForCausalLM(jcfg), convert.jax_llama_to_state_dict,
                    tcfg, ids)
    # the window bites: the same weights without it give other logits
    model = tl.LlamaForCausalLM(dataclasses.replace(tcfg, sliding_window=0), device="cpu")
    params = seeded_params(jl.LlamaForCausalLM(jcfg), jnp.zeros((1, 256), jnp.int32))
    model.load_state_dict(convert.jax_llama_to_state_dict({"params": params}, tcfg))
    windowed = tl.LlamaForCausalLM(tcfg, device="cpu")
    windowed.load_state_dict(model.state_dict())
    with torch.no_grad():
        t = torch.from_numpy(ids)
        assert not torch.allclose(model(t)[:, 100:], windowed(t)[:, 100:])


# ------------------------------------------------------------------ the engine

DS_CONFIG = {"train_batch_size": 2, "gradient_clipping": 1.0, "steps_per_print": 0,
             "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}}}


def test_phi_trains_two_steps_like_jax():
    """Tiny Phi (head dim 80, float32, AdamW, clipping) through both
    engines: losses and grad norms within 1e-5 relative, the parameters as
    ``test_torch_gpt_family.test_gpt2_trains_three_steps_like_jax`` holds
    them (all within 2·sum(lr), all but 1e-3 within 2e-5).  Remat is off on
    both sides: it changes no number, and JAX compiles faster."""
    jcfg = jphi.PhiConfig(**PHI, dtype=jnp.float32, scan_layers=False, remat=False)
    tcfg = tphi.PhiConfig(**PHI, dtype=torch.float32, remat=False)
    model = jphi.PhiForCausalLM(jcfg)
    params = seeded_params(model, jnp.zeros((1, S), jnp.int32), seed=7)
    mesh = create_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    jeng = jds.initialize(model=model, config=JaxConfig(DS_CONFIG, dp_world_size=1), mesh=mesh, params=params)[0]
    want = []
    jeng._maybe_print = want.append
    state = convert.jax_phi_to_state_dict({"params": params}, tcfg)
    eng = tds.initialize(model=tphi.PhiForCausalLM(tcfg, device="cpu"), config=DS_CONFIG, params=state,
                         device="cpu")[0]
    got = []
    for step in range(2):
        ids = _ids(8 + step)
        jeng.train_batch(batch={"input_ids": ids, "labels": ids})
        got.append((float(eng.train_batch(batch={"input_ids": ids, "labels": ids})), eng.get_global_grad_norm()))
    np.testing.assert_allclose(np.array(got), np.array([(float(m.loss), float(m.grad_norm)) for m in want]),
                               rtol=1e-5)
    jstate = convert.jax_phi_to_state_dict(jax.tree.map(np.asarray, jeng.state.params), tcfg)
    diff = np.concatenate([np.abs(t.numpy() - jstate[name].numpy()).ravel()
                           for name, t in eng.module_state_dict().items()])
    assert diff.max() <= 2 * 2 * 1e-3 and (diff > 2e-5).mean() < 1e-3, (diff.max(), (diff > 2e-5).sum())


TINY_MODELS = {
    "falcon": lambda **kw: tfalcon.FalconForCausalLM(tfalcon.FalconConfig(**FALCON, dtype=torch.float32, **kw),
                                                      device="cpu"),
    "opt": lambda **kw: topt.OPTForCausalLM(topt.OPTConfig(**OPT, dtype=torch.float32, **kw), device="cpu"),
    "phi": lambda **kw: tphi.PhiForCausalLM(tphi.PhiConfig(**PHI, dtype=torch.float32, **kw), device="cpu"),
    "windowed-llama": lambda **kw: tl.LlamaForCausalLM(
        tl.LlamaConfig(vocab_size=V, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
                       num_attention_heads=4, num_key_value_heads=2, sliding_window=48, dtype=torch.float32, **kw),
        device="cpu"),
}


def _one_step(model, extra: dict, seed: int = 0):
    """One ``train_batch`` from seeded weights: the loss and the parameters after it."""
    tl.init_weights_(model, torch.Generator().manual_seed(seed))
    eng = tds.initialize(model=model, config={**DS_CONFIG, **extra}, device="cpu")[0]
    ids = _ids(11)
    loss = float(eng.train_batch(batch={"input_ids": ids, "labels": ids}))
    return eng, loss, {n: t.clone() for n, t in eng.module_state_dict().items()}


@pytest.mark.parametrize("family", list(TINY_MODELS))
def test_every_remat_policy_trains_like_no_remat(family):
    """``activation_checkpointing`` in the config turns each block's remat on
    under its policy (``nothing_saveable``; ``flash_saveable`` with
    ``number_checkpoints``; ``flash_only`` set on the model's config); a
    step equals the step without remat (recompute is deterministic on the
    CPU)."""
    _, want_loss, want = _one_step(TINY_MODELS[family](remat=False), {})
    runs = {"nothing_saveable": ({}, {"activation_checkpointing": {}}),
            "flash_saveable": ({}, {"activation_checkpointing": {"number_checkpoints": 1}}),
            "flash_only": ({"remat_policy": "flash_only"}, {})}
    for policy, (cfg_kw, extra) in runs.items():
        eng, loss, params = _one_step(TINY_MODELS[family](remat=bool(cfg_kw) or not extra, **cfg_kw), extra)
        assert eng.module.cfg.remat and eng.module.cfg.remat_policy == policy
        assert loss == pytest.approx(want_loss, rel=1e-6), policy
        for name, t in params.items():
            torch.testing.assert_close(t, want[name], atol=1e-6, rtol=1e-6, msg=f"{policy} {name}")


@pytest.mark.parametrize("family", ["falcon", "opt", "phi"])
def test_pld_leaves_the_zoo_families_ungated_as_jax(family):
    """JAX's engine gates a model's layers only when the model says
    ``supports_pld`` (``deepspeed_tpu/runtime/engine.py:663-664``), which
    none of these families does, in either package: with PLD on, a step is
    the step without it, bit for bit."""
    jax_models = {"falcon": jfalcon.FalconForCausalLM, "opt": jopt.OPTForCausalLM, "phi": jphi.PhiForCausalLM}
    assert not getattr(jax_models[family], "supports_pld", False)
    _, want_loss, want = _one_step(TINY_MODELS[family](remat=False), {})
    pld = {"progressive_layer_drop": {"enabled": True, "theta": 0.5, "gamma": 0.5}}
    eng, loss, params = _one_step(TINY_MODELS[family](remat=False), pld)
    assert eng.progressive_layer_drop is not None and not getattr(eng.module, "supports_pld", False)
    assert loss == want_loss
    assert all(torch.equal(t, want[name]) for name, t in params.items())


# ------------------------------------------------------------------ the kernels' route


@pytest.mark.parametrize("h,hk,d", [(32, 32, 80), (32, 32, 96), (71, 1, 64), (64, 1, 128)],
                         ids=["phi-2", "phi-3", "falcon-7b", "rep-64"])
def test_kernel_shape_check_takes_the_zoo_shapes(h, hk, d):
    """On a GPU, the flash op hands these shapes to K1/K2a/K2b: the shape
    check (the wrappers' validation, without a launch) accepts head dims 80
    and 96, and beyond 64 query heads a kv head (the kernels' block rows)
    the route repeats K/V to H heads, as JAX's ``_gqa_native_ok`` does for
    Falcon-7B.  Another head dim is still refused."""
    q, kv = (1, 128, h, d), (1, 128, hk, d)
    tfa.check_shapes("flash", q, kv, kv)
    assert tfa.kernel_kv_heads(h, hk) == (h if h // hk > tfa.MAX_REP else hk)
    with pytest.raises(ValueError, match="head dim"):
        tfa.check_shapes("flash", (1, 128, h, 48), (1, 128, hk, 48), (1, 128, hk, 48))


@pytest.mark.parametrize("h,hk,d", [(4, 4, 80), (71, 1, 64)], ids=["d80", "71:1"])
def test_flops_profiler_counts_the_zoo_attention(h, hk, d):
    """The flash formulas count 4·D per visible (query, key) pair and query
    head forward, 14·D backward, whatever D and however many query heads
    share a kv head (the repeated-KV route moves no flops)."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 128, h, d, generator=gen, requires_grad=True)
    k, v = (torch.randn(1, 128, hk, d, generator=gen, requires_grad=True) for _ in range(2))
    pairs = h * 128 * 129 // 2
    assert cost_analysis(tfa.flash_attention, q, k, v)["flops"] == 4 * d * pairs
    assert cost_analysis(lambda: tfa.flash_attention(q, k, v).sum().backward())["flops"] == (4 + 14) * d * pairs
