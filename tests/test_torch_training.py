"""The training step of the PyTorch port (``deepspeed_tpu_torch.initialize`` →
``train_batch``) against the JAX package, on the CPU: the loss and its
hand-written gradient, remat policies, FusedAdam, the LR schedules, the loss
scaler, the config's batch triangle, and a 3-step trajectory of the whole
engine with weights carried across by ``models/convert.py``.  Inputs come
from numpy seeds."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.comm.mesh import MeshSpec, create_mesh
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu.ops.adam import fused_adam as jax_fused_adam
from deepspeed_tpu.runtime import lr_schedules as jlr
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu.runtime.config import DeepSpeedConfigError as JaxConfigError
from deepspeed_tpu.runtime.fp16 import loss_scaler as jls
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.models.convert import jax_llama_to_state_dict
from deepspeed_tpu_torch.ops import flash_attention as tfa
from deepspeed_tpu_torch.ops.adam import FusedAdam
from deepspeed_tpu_torch.runtime import lr_schedules as tlr
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig, DeepSpeedConfigError
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler as tls

# ------------------------------------------------------------------ loss


@pytest.mark.parametrize("masked", [False, True], ids=["mean", "loss-mask"])
def test_causal_lm_loss_value_and_grad_match_jax(masked):
    """float32: the logsumexp and the (softmax − onehot)·w gradient differ
    only in summation order."""
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(2, 9, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, (2, 9)).astype(np.int32)
    mask = (rng.random((2, 9)) > 0.4).astype(np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    want, jgrad = jax.value_and_grad(lambda x: jl.causal_lm_loss(x, jnp.asarray(labels), jm))(jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_()
    got = tl.causal_lm_loss(t, torch.from_numpy(labels), None if mask is None else torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad), atol=1e-7, rtol=1e-5)


def test_causal_lm_loss_grad_keeps_the_logits_dtype():
    logits = torch.randn(2, 4, 16, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0))
    logits.requires_grad_()
    tl.causal_lm_loss(logits, torch.zeros(2, 4, dtype=torch.int64)).backward()
    assert logits.grad.dtype == torch.bfloat16


# ------------------------------------------------------------------ remat

TINY = tl.LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=96, num_hidden_layers=3,
                      num_attention_heads=4, num_key_value_heads=2, rope_theta=1e4, dtype=torch.float32,
                      attention_impl="flash")


def _grads(cfg, ids):
    model = tl.LlamaForCausalLM(cfg, device="cpu")
    tl.init_weights_(model, torch.Generator().manual_seed(0))
    tl.causal_lm_loss(model(ids), ids).backward()
    return {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("policy", ["nothing_saveable", "flash_saveable", "flash_only"])
def test_remat_policies_give_the_grads_of_no_remat(policy, monkeypatch):
    """Recompute is deterministic on the CPU, so the grads agree to rounding.
    Under a policy that saves the flash forward, K1 (here its plain version)
    runs once per layer: the recompute takes its saved (o, lse)."""
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 128, (2, 128)))
    want = _grads(dataclasses.replace(TINY, remat=False), ids)
    calls = []
    plain = tfa.flash_fwd_plain
    monkeypatch.setattr(tfa, "flash_fwd_plain", lambda *a: calls.append(1) or plain(*a))
    got = _grads(dataclasses.replace(TINY, remat=True, remat_policy=policy), ids)
    for name in want:
        torch.testing.assert_close(got[name], want[name], atol=1e-6, rtol=1e-6, msg=name)
    layers = TINY.num_hidden_layers
    assert len(calls) == (2 * layers if policy == "nothing_saveable" else layers)


def test_remat_rejects_unknown_policy_and_multi_device_attention():
    ids = torch.zeros((1, 128), dtype=torch.int64)
    model = tl.LlamaForCausalLM(dataclasses.replace(TINY, remat_policy="dots_saveable"), device="cpu")
    tl.init_weights_(model, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="remat_policy"):
        model(ids)
    for impl in ("ulysses", "fpdt", "ring"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tl.get_attention_impl(impl)
    with pytest.raises(NotImplementedError, match="progressive layer drop"):
        model(ids, pld_scale=torch.ones(3))


@pytest.mark.parametrize("impl", ["reference", "chunked", "flash"])
def test_attention_impls_match_jax(impl):
    """The cache-free forward under each attention impl against JAX's, S 256
    (chunked: one 256-query chunk; flash: the op's plain path)."""
    jcfg = jl.LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
                          num_attention_heads=4, num_key_value_heads=2, rope_theta=1e4, dtype=jnp.float32,
                          attention_impl="chunked" if impl == "flash" else impl, remat=False)
    tcfg = dataclasses.replace(TINY, num_hidden_layers=2, attention_impl=impl)
    ids = np.random.default_rng(2).integers(0, 128, (2, 256)).astype(np.int32)
    variables = jax.jit(jl.LlamaForCausalLM(jcfg).init)(jax.random.PRNGKey(0), jnp.asarray(ids))
    want = jax.jit(jl.LlamaForCausalLM(jcfg).apply)(variables, jnp.asarray(ids))
    model = tl.LlamaForCausalLM(tcfg, device="cpu")
    model.load_state_dict(jax_llama_to_state_dict(jax.tree.map(np.asarray, variables), tcfg))
    with torch.no_grad():
        got = model(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


# ------------------------------------------------------------------ FusedAdam


@pytest.mark.parametrize("adam_w_mode", [True, False], ids=["adamw", "l2"])
def test_fused_adam_matches_jax_over_three_updates(adam_w_mode):
    """float32 state, a schedule for the lr; the update arithmetic is the
    JAX transform's, the bias correction in float32 on both sides."""
    rng = np.random.default_rng(3)
    shapes = [(7, 5), (11, )]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes] for _ in range(3)]

    def sched(step):
        return 1e-2 * min(1.0, float(step) / 2)

    opt = jax_fused_adam(lr=sched, weight_decay=0.1, adam_w_mode=adam_w_mode)
    jp = [jnp.asarray(p) for p in params]
    state = opt.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    topt = FusedAdam(tp, lr=sched, weight_decay=0.1, adam_w_mode=adam_w_mode)
    for g in grads:
        updates, state = opt.update([jnp.asarray(x) for x in g], state, jp)
        jp = [p + u for p, u in zip(jp, updates)]
        for t, x in zip(tp, g):
            t.grad = torch.from_numpy(x)
        topt.step()
    for t, p in zip(tp, jp):
        np.testing.assert_allclose(t.numpy(), np.asarray(p), atol=1e-6, rtol=1e-6)
    assert topt.step_count == 3
    with pytest.raises(ValueError, match="AMSGrad"):
        FusedAdam(tp, amsgrad=True)


def test_fused_adam_skips_on_overflow_without_host_sync():
    """``step(found_inf=True)`` keeps params, moments and the device step."""
    p = torch.ones(4)
    opt = FusedAdam([p], lr=0.1)
    p.grad = torch.full((4, ), 0.5)
    opt.step(found_inf=torch.tensor(False))
    after_one = p.clone()
    p.grad = torch.full((4, ), float("inf"))
    opt.step(found_inf=torch.tensor(True))
    assert torch.equal(p, after_one)
    assert int(opt._device_step) == 1
    assert torch.isfinite(opt.state[p]["exp_avg"]).all()


def test_fused_adam_lr_schedule_reads_the_device_step_after_a_skip():
    """lr(s) = 0.1·s; a step, an overflow-skipped step, a step, from p = 1
    with a constant gradient (each Adam update is then −lr).  JAX evaluates
    the schedule at ``state.step + 1`` and its engine keeps the state on a
    skip (``deepspeed_tpu/runtime/engine.py:824-831``), so the two updates
    take lr(1) and lr(2): p = 1 − 0.1 − 0.2 = 0.7.  The port's device step
    gives the same, with no host sync; a schedule read at the host's step
    count would take lr(3) and end at 0.6."""

    def sched(step):
        return 0.1 * step

    opt = jax_fused_adam(lr=sched)
    jp = [jnp.ones((4, ), jnp.float32)]
    state = opt.init(jp)
    p = torch.ones(4)
    topt = FusedAdam([p], lr=sched)
    for g, skip in ((1.0, False), (float("inf"), True), (1.0, False)):
        updates, new_state = opt.update([jnp.full((4, ), g, jnp.float32)], state, jp)
        if not skip:
            jp, state = [x + u for x, u in zip(jp, updates)], new_state
        p.grad = torch.full((4, ), g)
        topt.step(found_inf=torch.tensor(skip))
    np.testing.assert_allclose(p.numpy(), np.asarray(jp[0]), rtol=1e-6)
    np.testing.assert_allclose(p.numpy(), 0.7, atol=1e-5)   # float32 steps of 0.1 and 0.2 (0.6 with lr(3))
    assert int(topt._device_step) == 2 and topt.step_count == 3


# ------------------------------------------------------------------ LR schedules

SCHEDULES = [
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-3, "lr_range_test_step_size": 5, "lr_range_test_staircase": True}),
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-3, "lr_range_test_step_size": 5, "lr_range_test_step_rate": 2.0}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-2, "cycle_first_step_size": 4, "decay_step_size": 2,
                  "decay_lr_rate": 0.5}),
    ("WarmupLR", {"warmup_min_lr": 0.0, "warmup_max_lr": 1e-3, "warmup_num_steps": 8}),
    ("WarmupLR", {"warmup_min_lr": 1e-5, "warmup_max_lr": 1e-3, "warmup_num_steps": 8, "warmup_type": "linear"}),
    ("WarmupDecayLR", {"total_num_steps": 20, "warmup_max_lr": 1e-3, "warmup_num_steps": 5}),
    ("WarmupCosineLR", {"total_num_steps": 20, "warmup_num_steps": 5, "warmup_min_ratio": 0.1}),
]


@pytest.mark.parametrize("name,params", SCHEDULES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(SCHEDULES)])
def test_lr_schedules_match_jax(name, params):
    """The JAX schedules run in float32, the port's in double for a host
    step: rtol 2e-6 (float32 ``cos`` near the end of the cosine decay is off
    by ~1e-6).  A 0-d int32 tensor step (FusedAdam's device step) is
    evaluated in float32 as JAX evaluates it, and stays a tensor."""
    jfn = jlr.get_lr_schedule(name, params, base_lr=3e-3)
    tfn = tlr.get_lr_schedule(name, params, base_lr=3e-3)
    for step in (0, 1, 2, 3, 4, 5, 7, 8, 9, 12, 19, 20, 25):
        want = float(jfn(step))
        np.testing.assert_allclose(tfn(step), want, rtol=2e-6, atol=1e-12, err_msg=f"step {step}")
        got = tfn(torch.tensor(step, dtype=torch.int32))
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=2e-6, atol=1e-12, err_msg=f"tensor step {step}")
    with pytest.raises(ValueError):
        tlr.get_lr_schedule("Nope", {})


def test_lr_scheduler_shim_surface():
    shim = tlr.LRSchedulerShim(tlr.get_lr_schedule("WarmupLR", {"warmup_num_steps": 4, "warmup_type": "linear"}))
    jshim = jlr.LRSchedulerShim(jlr.get_lr_schedule("WarmupLR", {"warmup_num_steps": 4, "warmup_type": "linear"}))
    for _ in range(3):
        shim.step()
        jshim.step()
        np.testing.assert_allclose(shim.get_last_lr(), jshim.get_last_lr(), rtol=1e-6)
    assert shim.state_dict() == jshim.state_dict()


# ------------------------------------------------------------------ loss scaler


@pytest.mark.parametrize("kw", [dict(init_scale=2**4, scale_window=3, delayed_shift=2),
                                dict(init_scale=8.0, scale_window=2, delayed_shift=1, min_scale=2.0),
                                dict(init_scale=2**4, scale_window=3, delayed_shift=3, consecutive_hysteresis=True)],
                         ids=["hysteresis-2", "floor", "consecutive"])
def test_dynamic_loss_scaler_state_sequence_matches_jax(kw):
    overflows = [False, True, False, False, True, True, False, False, False, True, True, True, False, False]
    js, jstate = jls.DynamicLossScaler(**kw), None
    ts, tstate = tls.DynamicLossScaler(**kw), None
    jstate, tstate = js.init_state(), ts.init_state("cpu")
    for ov in overflows:
        jstate = js.update(jstate, jnp.asarray(ov))
        tstate = ts.update(tstate, torch.tensor(ov))
        assert [float(x) for x in tstate] == [float(x) for x in jstate], ov
    static = tls.StaticLossScaler(4.0)
    st = static.update(static.init_state("cpu"), torch.tensor(True))
    assert float(st.cur_scale) == 4.0 and int(st.iteration) == 1


def test_found_inf_and_create_loss_scaler():
    assert not bool(tls.found_inf_or_nan([torch.ones(3), torch.zeros(2)]))
    assert bool(tls.found_inf_or_nan([torch.ones(3), torch.tensor([0.0, float("nan")])]))
    cfg = DeepSpeedConfig({"train_batch_size": 2, "fp16": {"enabled": True, "initial_scale_power": 5}})
    scaler = tls.create_loss_scaler(cfg.fp16_config, torch.float16)
    assert isinstance(scaler, tls.DynamicLossScaler) and scaler.init_scale == 32.0 and scaler.dynamic
    assert not tls.create_loss_scaler(cfg.fp16_config, torch.bfloat16).dynamic


# ------------------------------------------------------------------ config

TRIANGLES = [
    {"train_batch_size": 32},
    {"train_batch_size": 32, "gradient_accumulation_steps": 4},
    {"train_batch_size": 32, "train_micro_batch_size_per_gpu": 8},
    {"train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 3},
    {"train_micro_batch_size_per_gpu": 4},
    {"train_batch_size": 32, "train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 8},
    {"train_batch_size": 32, "train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 4},
    {"train_batch_size": 30, "train_micro_batch_size_per_gpu": 4},
    {"gradient_accumulation_steps": 4},
    {},
]


@pytest.mark.parametrize("cfg", TRIANGLES, ids=[str(i) for i in range(len(TRIANGLES))])
def test_config_batch_triangle_matches_jax(cfg):
    try:
        j = JaxConfig(dict(cfg), dp_world_size=1)   # the port runs one data-parallel rank
    except JaxConfigError as e:
        with pytest.raises(DeepSpeedConfigError) as got:
            DeepSpeedConfig(dict(cfg))
        assert str(got.value) == str(e)
        return
    t = DeepSpeedConfig(dict(cfg))
    assert (t.train_batch_size, t.train_micro_batch_size_per_gpu, t.gradient_accumulation_steps) == \
        (j.train_batch_size, j.train_micro_batch_size_per_gpu, j.gradient_accumulation_steps)


def test_config_reads_the_training_keys_and_rejects_unported_ones():
    base = {"train_batch_size": 8}
    c = DeepSpeedConfig({**base, "bf16": {"enabled": True}, "zero_optimization": {"stage": 2},
                         "gradient_clipping": 1.0, "gradient_predivide_factor": 2.0, "steps_per_print": 5,
                         "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
                         "scheduler": {"type": "WarmupLR", "params": {}}})
    assert c.precision_dtype == torch.bfloat16 and c.zero_optimization_stage == 2
    assert (c.gradient_clipping, c.gradient_predivide_factor, c.steps_per_print) == (1.0, 2.0, 5)
    assert DeepSpeedConfig({**base, "zero_optimization": {"stage": 1, "overlap_comm": None}}).zero_config.stage == 1
    unported = [{"pipeline": {"stages": 2}}, {"tensor_parallel": {"autotp_size": 2}}, {"sequence_parallel_size": 2},
                {"moe": {"enabled": True}}, {"compression_training": {"weight_quantization": {}}},
                {"progressive_layer_drop": {"enabled": True}},
                {"zero_optimization": {"stage": 2, "offload_optimizer": {"device": "cpu"}}},
                {"zero_optimization": {"stage": 2, "reduce_bucket_size": 10}}, {"flops_profiler": {"enabled": True}}]
    for extra in unported:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            DeepSpeedConfig({**base, **extra})
    with pytest.raises(DeepSpeedConfigError):
        DeepSpeedConfig({**base, "fp16": {"enabled": True}, "bf16": {"enabled": True}})
    with pytest.raises(DeepSpeedConfigError):
        DeepSpeedConfig({**base, "zero_optimization": {"stage": 4}})


# ------------------------------------------------------------------ the engine

JCFG = jl.LlamaConfig(vocab_size=2048, hidden_size=256, intermediate_size=512, num_hidden_layers=4,
                      num_attention_heads=8, num_key_value_heads=4, max_position_embeddings=256, rope_theta=1e4,
                      dtype=jnp.float32)
TCFG = tl.LlamaConfig(vocab_size=2048, hidden_size=256, intermediate_size=512, num_hidden_layers=4,
                      num_attention_heads=8, num_key_value_heads=4, max_position_embeddings=256, rope_theta=1e4,
                      dtype=torch.float32, attention_impl="flash", remat=True, remat_policy="flash_saveable")
SEQ, STEPS = 256, 3
DS_CONFIG = {"train_batch_size": 4, "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
             "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
             "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 1e-3,
                                                          "warmup_num_steps": 10, "warmup_type": "linear"}},
             "zero_optimization": {"stage": 2}, "steps_per_print": 0}


def _batches():
    rng = np.random.default_rng(5)
    out = []
    for _ in range(STEPS):
        ids = rng.integers(0, JCFG.vocab_size, (4, SEQ)).astype(np.int32)
        out.append({"input_ids": ids, "labels": ids})
    return out


def _jax_trajectory(dtype, extra_cfg):
    jcfg = dataclasses.replace(JCFG, dtype=dtype)
    model = jl.LlamaForCausalLM(jcfg)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, SEQ), jnp.int32))
    mesh = create_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    eng, _, _, _ = jds.initialize(model=model, config=JaxConfig({**DS_CONFIG, **extra_cfg}, dp_world_size=1),
                                  mesh=mesh, params=variables["params"])
    metrics = []
    eng._maybe_print = metrics.append
    for b in _batches():
        eng.train_batch(batch=b)
    rows = [(float(m.loss), float(m.grad_norm), float(m.lr)) for m in metrics]
    master = eng.state.master if dtype != jnp.float32 else eng.state.params
    return variables, rows, jax.tree.map(np.asarray, master)


def _assert_params_close(got, want, lrs, tight, share):
    """Adam's m/sqrt(v) normalises every update to about lr whatever the
    gradient's size, so where a gradient is below the two sides' rounding
    difference the two can move a parameter by up to lr in opposite
    directions: all but ``share`` of the entries within ``tight``, every
    entry within 2·sum(lr)."""
    diff = np.abs(got - want)
    assert diff.max() <= 2 * sum(lrs), diff.max()
    assert (diff > tight).mean() < share, ((diff > tight).sum(), diff.size)


def _port_engine(variables, tcfg, extra_cfg):
    state = jax_llama_to_state_dict(jax.tree.map(np.asarray, variables), tcfg)
    model = tl.LlamaForCausalLM(tcfg, device="cpu")
    return tds.initialize(model=model, config={**DS_CONFIG, **extra_cfg}, params=state, device="cpu")[0]


def test_engine_trajectory_matches_jax_f32():
    """3 steps, float32, gas 2, AdamW + WarmupLR + clipping, ZeRO-2 on one
    device: per-step loss, grad norm and lr, and the final params.  The two
    frameworks sum matmuls in other orders (1e-6 relative per product);
    Adam's m/sqrt(v) normalises each update to ~lr whatever the gradient's
    size (see ``_assert_params_close``): all but 1e-4 of the params within
    2e-5 absolute (8.8e-7 of them beyond it on this CPU), losses and norms
    within 1e-5 relative."""
    variables, want, jparams = _jax_trajectory(jnp.float32, {})
    eng = _port_engine(variables, TCFG, {})
    got = []
    for b in _batches():
        loss = eng.train_batch(batch=b)
        got.append((float(loss), eng.get_global_grad_norm(), eng.last_metrics.lr))
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-5)
    assert eng.get_lr() == [pytest.approx(want[-1][2], rel=1e-6)]
    jstate = jax_llama_to_state_dict(jparams, TCFG)
    for name, t in eng.module_state_dict().items():
        _assert_params_close(t.numpy(), jstate[name].numpy(), [r[2] for r in want], 2e-5, 1e-4)


def test_engine_trajectory_matches_jax_bf16():
    """bf16 compute with a float32 master on both sides.  The frameworks
    round the bf16 activations and grads at other points (one bf16 ulp is
    2^-8 relative), so losses agree within 1e-2 relative, grad norms within
    3e-2.  The gradients differ by about one bf16 ulp, so Adam's first,
    sign-like update (lr·g/|g|) takes either sign for the entries whose
    gradient is below that noise: in each tensor all but 1e-2 of the final
    float32 master entries within 3e-4 absolute (at most 4.2e-3 of them
    beyond it on this CPU, in the embedding), every entry within 2·sum(lr)
    (``_assert_params_close``)."""
    extra = {"bf16": {"enabled": True}}
    variables, want, jparams = _jax_trajectory(jnp.bfloat16, extra)
    eng = _port_engine(variables, dataclasses.replace(TCFG, dtype=torch.bfloat16), extra)
    got = []
    for b in _batches():
        loss = eng.train_batch(batch=b)
        got.append((float(loss), eng.get_global_grad_norm(), eng.last_metrics.lr))
    got, want = np.array(got), np.array(want)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-2)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=3e-2)
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=1e-6)
    assert all(p.dtype == torch.bfloat16 for p in eng.module.parameters())
    jstate = jax_llama_to_state_dict(jparams, TCFG)
    masters = dict(zip([n for n, _ in eng.module.named_parameters()], eng.master))
    for name, m in masters.items():
        _assert_params_close(m.numpy(), jstate[name].numpy(), want[:, 2], 3e-4, 1e-2)


def test_forward_backward_step_matches_train_batch():
    """The imperative path over the gas micro-batches equals one
    ``train_batch`` on the whole batch (float32, same weights)."""
    cfg = dataclasses.replace(TCFG, num_hidden_layers=2, vocab_size=256)
    batch = {"input_ids": np.random.default_rng(6).integers(0, 256, (4, 128)).astype(np.int32)}
    batch["labels"] = batch["input_ids"]
    engines = []
    for _ in range(2):
        model = tl.LlamaForCausalLM(cfg, device="cpu")
        tl.init_weights_(model, torch.Generator().manual_seed(0))
        engines.append(tds.initialize(model=model, config=DS_CONFIG, device="cpu")[0])
    fused, imperative = engines
    want = fused.train_batch(batch=batch)
    losses = []
    for i in range(2):
        mb = {k: v[2 * i:2 * i + 2] for k, v in batch.items()}
        losses.append(imperative.backward(imperative.forward(mb)))
        assert imperative.is_gradient_accumulation_boundary() == (i == 1)
    metrics = imperative.step()
    torch.testing.assert_close(metrics.loss, want, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(metrics.loss, torch.stack(losses).mean(), atol=1e-6, rtol=1e-6)
    for (name, a), b in zip(fused.module.named_parameters(), imperative.module.parameters()):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6, msg=name)
    assert imperative.lr_scheduler.state_dict() == {"last_batch_iteration": 0}


def test_initialize_surface():
    model = tl.LlamaForCausalLM(dataclasses.replace(TCFG, num_hidden_layers=1), device="cpu")
    tl.init_weights_(model, torch.Generator().manual_seed(0))
    eng, opt, loader, sched = tds.initialize(model=model, config={"train_batch_size": 2, "bf16": {"enabled": True},
                                                                   "zero_optimization": {"stage": 1}},
                                             device="cpu")
    assert isinstance(opt, FusedAdam) and loader is None and sched is eng.lr_scheduler
    assert eng.train_batch_size() == 2 and eng.gradient_accumulation_steps() == 1
    assert eng.zero_optimization_stage() == 1 and eng.zero_optimization()
    assert eng.loss_scale == 1.0 and eng.skipped_steps == 0 and eng.get_global_grad_norm() is None
    assert len(eng.master) == len(list(model.parameters())) and all(m.dtype == torch.float32 for m in eng.master)
    for bad in ({"zero_optimization": {"stage": 3}}, {"optimizer": {"type": "OneBitAdam"}}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tds.initialize(model=model, config={"train_batch_size": 2, **bad}, device="cpu")
    with pytest.raises(NotImplementedError, match="dataloader"):
        tds.initialize(model=model, config={"train_batch_size": 2}, training_data=[1], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            tds.initialize(model=model, config={"train_batch_size": 2})


def test_fp16_engine_skips_overflow_on_device():
    """fp16 with a dynamic scale of 2^30: the scaled gradients overflow the
    fp16 parameters' range, so the step leaves the master untouched, halves
    the scale (hysteresis 1) and counts a skip."""
    cfg = dataclasses.replace(TCFG, num_hidden_layers=1, vocab_size=64, dtype=torch.float32)
    model = tl.LlamaForCausalLM(cfg, device="cpu")
    tl.init_weights_(model, torch.Generator().manual_seed(0))
    eng = tds.initialize(model=model, config={"train_batch_size": 2, "fp16": {"enabled": True, "hysteresis": 1,
                                                                               "initial_scale_power": 30}},
                         device="cpu")[0]
    ids = np.random.default_rng(7).integers(0, 64, (2, 128)).astype(np.int32)
    before = [m.clone() for m in eng.master]
    eng.train_batch(batch={"input_ids": ids, "labels": ids})
    assert eng.skipped_steps == 1 and eng.loss_scale == 2.0**29
    assert all(torch.equal(a, b) for a, b in zip(before, eng.master))


def test_fp16_engine_lr_after_an_overflow_matches_jax():
    """fp16 with a dynamic scale of 2^19 and hysteresis 1: step 1 overflows
    on both engines (the scale halves to 2^18), steps 2 and 3 do not.  JAX's
    schedule (WarmupLR, linear over 10 steps) reads the optimizer state's
    step, which the skip left at 0, so steps 2 and 3 take lr(1) and lr(2);
    read at the host's step they would take lr(2) and lr(3), and move every
    parameter by about 2e-4 more.  Losses within the f32 test's 1e-5; the
    float32 masters within the f32 test's 2e-5 on all but 1e-2 of the
    entries (on this CPU ~1e-3 lie beyond it: the fp16 gradients of the two
    frameworks differ in the last fp16 bit, and the first Adam update after
    the skip is lr·sign(g), which flips for entries whose gradient is below
    that noise), every entry within 2·sum(lr)."""
    extra = {"fp16": {"enabled": True, "initial_scale_power": 19, "hysteresis": 1}}
    variables, want, jparams = _jax_trajectory(jnp.float16, extra)
    eng = _port_engine(variables, dataclasses.replace(TCFG, dtype=torch.float16), extra)
    losses = [float(eng.train_batch(batch=b)) for b in _batches()]
    assert eng.skipped_steps == 1 and eng.loss_scale == 2.0**18
    assert not np.isfinite(want[0][1]) and np.isfinite([r[1] for r in want[1:]]).all()
    np.testing.assert_allclose(losses, [r[0] for r in want], rtol=1e-5)
    jstate = jax_llama_to_state_dict(jparams, TCFG)
    names = [n for n, _ in eng.module.named_parameters()]
    got = np.concatenate([m.numpy().ravel() for m in eng.master])
    ref = np.concatenate([jstate[n].numpy().ravel() for n in names])
    _assert_params_close(got, ref, [1e-4, 2e-4], 2e-5, 1e-2)
