"""The training features of the PyTorch port beyond the plain step, against
the JAX package on the CPU: LAMB, Lion, Adagrad and SGD (one update against
the JAX transform, the skip on overflow, a 3-step engine trajectory with the
JAX state carried across by ``models/convert.py``), the dataloader and
``initialize(training_data=)``, the ``loss_fn``/``model_inputs_fn`` hooks
(one and three data-parallel ranks), progressive layer drop, the precision
wrappers, the CSV monitor and the synchronized timers.

The model is the tiny Llama of ``tests/unit/simple_model.py`` in float32
(vocab 128, hidden 64, 2 layers, 4/2 heads), batches of 8 rows of 16 tokens
from numpy seeds, and JAX's layers unrolled (``scan_layers=False``): LAMB's
trust ratio is per tensor, and a scanned model stacks each layer's tensors
into one leaf, whose norm spans every layer (the port, like the reference,
takes one ratio per layer's tensor).  This module imports JAX only inside
its tests, so the gloo ranks it spawns start without it.
"""

import dataclasses
import functools
import os
import sys

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.models.convert import jax_llama_to_state_dict, jax_train_state_to_engine
from deepspeed_tpu_torch.ops.adagrad import SGD, Adagrad
from deepspeed_tpu_torch.ops.adam import FusedAdam
from deepspeed_tpu_torch.ops.lamb import FusedLamb
from deepspeed_tpu_torch.ops.lion import FusedLion
from deepspeed_tpu_torch.runtime import progressive_layer_drop as tpld
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader, RepeatingLoader, default_collate

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "unit"))

from test_torch_qgz import run_ranks  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse fixture)

TCFG = tl.LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64, rope_theta=10000.0,
                      dtype=torch.float32, attention_impl="reference")
BATCH, SEQ = 8, 16


def _batch(seed=0, rows=BATCH):
    ids = np.random.default_rng(seed).integers(0, TCFG.vocab_size, (rows, SEQ)).astype(np.int32)
    return {"input_ids": ids, "labels": ids}


def _jax():
    import jax
    import jax.numpy as jnp
    from simple_model import TINY
    return jax, jnp, dataclasses.replace(TINY, dtype=jnp.float32, scan_layers=False)


@functools.lru_cache(maxsize=None)
def _jax_variables():
    """The JAX model and its initial variables (one init for the module)."""
    jax, jnp, jcfg = _jax()
    from deepspeed_tpu.models.llama import LlamaForCausalLM
    model = LlamaForCausalLM(jcfg)
    return model, jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, SEQ), jnp.int32))


def _jax_engine(config, **kw):
    jax, _, _ = _jax()
    import deepspeed_tpu as jds
    from deepspeed_tpu.comm.mesh import MeshSpec, create_mesh
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
    model, variables = _jax_variables()
    mesh = create_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    eng = jds.initialize(model=model, config=JaxConfig(dict(config), dp_world_size=1), mesh=mesh,
                         params=variables["params"], dist_init_required=False, **kw)[0]
    return eng, variables


def _port_engine(variables, config, **kw):
    jax, _, _ = _jax()
    model = tl.LlamaForCausalLM(TCFG, device="cpu")
    state = jax_llama_to_state_dict(jax.tree.map(np.asarray, variables), TCFG)
    return tds.initialize(model=model, config=dict(config), params=state, device="cpu", **kw)


def _assert_params_close(got, want, lrs, tight, share):
    """Sign-like updates (Adam's and Adagrad's first, Lion's every one, a
    LAMB update of a small gradient) move an entry by about lr whatever its
    gradient, so where a gradient is below the two frameworks' rounding
    difference the two can step it by lr either way: all but ``share`` of
    the entries within ``tight``, every entry within 2·sum(lr)."""
    diff = np.abs(got - want)
    assert diff.max() <= 2 * sum(lrs), diff.max()
    assert (diff > tight).mean() <= share, ((diff > tight).sum(), diff.size)


# ------------------------------------------------------------------ optimizers

OPTIMIZERS = {
    "lamb": (FusedLamb, "fused_lamb", dict(lr=1e-2, weight_decay=0.01)),
    "lamb-clip": (FusedLamb, "fused_lamb", dict(lr=1e-2, max_coeff=0.5, min_coeff=0.2, bias_correction=False)),
    "lion": (FusedLion, "fused_lion", dict(lr=1e-3, weight_decay=0.1)),
    "adagrad": (Adagrad, "adagrad", dict(lr=1e-2, weight_decay=0.01)),
    "sgd": (SGD, "sgd", dict(lr=1e-2, weight_decay=0.01)),
    "sgd-momentum": (SGD, "sgd", dict(lr=1e-2, momentum=0.9)),
    "sgd-nesterov": (SGD, "sgd", dict(lr=1e-2, momentum=0.9, nesterov=True)),
}


def _jax_transform(fn_name, kw):
    from deepspeed_tpu.ops import adagrad, lamb, lion
    mods = {"fused_lamb": lamb, "fused_lion": lion, "adagrad": adagrad, "sgd": adagrad}
    return getattr(mods[fn_name], fn_name)(**kw)


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_updates_match_the_jax_transform(name):
    """Two updates on float32 tensors (the second reads the state of the
    first), a schedule as the lr: the port's optimizer against the JAX
    transform, within atol 1e-6.  LAMB also meets a zero tensor (trust 1 by
    ``w_norm == 0``) and a zero gradient (trust 1 by ``u_norm == 0``)."""
    _, jnp, _ = _jax()
    cls, fn_name, kw = OPTIMIZERS[name]
    rng = np.random.default_rng(3)
    shapes = [(7, 5), (11, ), (4, 3)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    params[2][:] = 0.0
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes] for _ in range(2)]
    grads[0][1][:] = 0.0
    base = kw["lr"]

    def sched(step):
        return base * min(1.0, (float(step) + 1) / 2)

    opt = _jax_transform(fn_name, {**kw, "lr": sched})
    jp = [jnp.asarray(p) for p in params]
    state = opt.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    topt = cls(tp, **{**kw, "lr": sched})
    for g in grads:
        updates, state = opt.update([jnp.asarray(x) for x in g], state, jp)
        jp = [p + u for p, u in zip(jp, updates)]
        for t, x in zip(tp, g):
            t.grad = torch.from_numpy(x)
        topt.step()
    for t, p in zip(tp, jp):
        np.testing.assert_allclose(t.numpy(), np.asarray(p), atol=1e-6, rtol=0)
    assert topt.step_count == 2


@pytest.mark.parametrize("cls,kw", [(FusedAdam, {}), (FusedLamb, {"weight_decay": 0.01}), (FusedLion, {}),
                                    (Adagrad, {}), (SGD, {"momentum": 0.9})],
                         ids=["adam", "lamb", "lion", "adagrad", "sgd"])
def test_found_inf_keeps_params_state_and_step(cls, kw):
    """``step(found_inf=True)`` after a clean step leaves the parameters,
    every state tensor and the device step as they were."""
    p = torch.linspace(-1.0, 1.0, 6)
    opt = cls([p], lr=0.1, **kw)
    p.grad = torch.full((6, ), 0.5)
    opt.step(found_inf=torch.tensor(False))
    before = (p.clone(), {k: v.clone() for k, v in opt.state[p].items()}, int(opt._device_step))
    p.grad = torch.full((6, ), float("inf"))
    opt.step(found_inf=torch.tensor(True))
    assert torch.equal(p, before[0])
    assert opt.state[p].keys() == before[1].keys()
    for k, v in opt.state[p].items():
        assert torch.equal(v, before[1][k]), k
    assert int(opt._device_step) == before[2] == 1 and opt.step_count == 2


ENGINE_OPTIMIZERS = {
    "Lamb": {"lr": 1e-2, "weight_decay": 0.01},
    "Lion": {"lr": 1e-3, "weight_decay": 0.01},
    "Adagrad": {"lr": 1e-2},
    "SGD": {"lr": 1e-1, "momentum": 0.9},
}


@pytest.mark.parametrize("opt", list(ENGINE_OPTIMIZERS))
def test_engine_trajectory_with_the_jax_state_carried_across(opt):
    """3 steps (gas 2, clipping 1.0) of each optimizer, float32: the port
    engine from the JAX initial weights against the JAX engine (losses
    within rtol 1e-5), and a second port engine that takes the JAX engine's
    whole state after its first step (``jax_train_state_to_engine``) and
    continues: losses within rtol 1e-5 and every final parameter within 1e-5
    of JAX's (on this CPU the largest difference is 2.4e-7 for LAMB and
    under 2e-6 for the others)."""
    jax, _, _ = _jax()
    config = {"train_batch_size": BATCH, "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
              "optimizer": {"type": opt, "params": ENGINE_OPTIMIZERS[opt]}, "steps_per_print": 0}
    batches = [_batch(s) for s in range(3)]
    jeng, variables = _jax_engine(config)
    want = [float(jeng.train_batch(batch=batches[0]))]
    carried = jax.tree.map(np.asarray, jeng.state)
    want += [float(jeng.train_batch(batch=b)) for b in batches[1:]]
    port = _port_engine(variables, config)[0]
    got = [float(port.train_batch(batch=b)) for b in batches]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    cont = jax_train_state_to_engine(carried, _port_engine(variables, config)[0], TCFG)
    assert cont.global_steps == 1 and cont.optimizer.step_count == (0 if opt == "SGD" else 1)   # JAX's SGD has no step
    got = [float(cont.train_batch(batch=b)) for b in batches[1:]]
    np.testing.assert_allclose(got, want[1:], rtol=1e-5)
    jstate = jax_llama_to_state_dict(jax.tree.map(np.asarray, jeng.state.params), TCFG)
    for name, t in cont.module_state_dict().items():
        np.testing.assert_allclose(t.numpy(), jstate[name].numpy(), atol=1e-5, rtol=0, err_msg=name)


def test_engine_builds_every_jax_optimizer_name():
    """The JAX engine's names build the port's classes; the 1-bit family
    raises naming its ROADMAP item; an unknown name raises as in JAX."""
    model = tl.LlamaForCausalLM(TCFG, device="cpu")
    tl.init_weights_(model, torch.Generator().manual_seed(0))
    want = {"Adam": FusedAdam, "AdamW": FusedAdam, "FusedAdam": FusedAdam, "CPUAdam": FusedAdam,
            "Lamb": FusedLamb, "FusedLamb": FusedLamb, "Lion": FusedLion, "Adagrad": Adagrad, "SGD": SGD}
    for name, cls in want.items():
        opt = tds.initialize(model=model, config={"train_batch_size": 2, "optimizer": {"type": name}},
                             device="cpu")[1]
        assert type(opt) is cls, name
    for name in ("OneBitAdam", "ZeroOneAdam", "OneBitLamb"):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 7"):
            tds.initialize(model=model, config={"train_batch_size": 2, "optimizer": {"type": name}}, device="cpu")
    with pytest.raises(ValueError, match="Unknown optimizer"):
        tds.initialize(model=model, config={"train_batch_size": 2, "optimizer": {"type": "Nope"}}, device="cpu")


# ------------------------------------------------------------------ dataloader


def _dataset(n, seed=4):
    ids = np.random.default_rng(seed).integers(0, TCFG.vocab_size, (n, SEQ)).astype(np.int32)
    return [{"input_ids": r, "labels": r} for r in ids]


@pytest.mark.parametrize("shuffle,drop_last", [(False, True), (True, True), (True, False)])
def test_dataloader_yields_jax_batches_in_jax_order(shuffle, drop_last):
    """Two epochs of 13 samples in batches of 4: the same batches in the
    same order as the JAX loader (``default_rng(seed + epoch)``), the same
    ``len``, and a short tail only without ``drop_last``."""
    from deepspeed_tpu.runtime.dataloader import DeepSpeedDataLoader as JaxLoader
    data = _dataset(13)
    jl_, tl_ = (cls(data, batch_size=4, shuffle=shuffle, drop_last=drop_last, seed=7)
                for cls in (JaxLoader, DeepSpeedDataLoader))
    assert len(tl_) == len(jl_) == (3 if drop_last else 4)
    for _ in range(2):
        want, got = list(jl_), list(tl_)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.keys() == w.keys() and all(np.array_equal(g[k], w[k]) for k in w)
    rep = RepeatingLoader(DeepSpeedDataLoader(data, batch_size=4))
    firsts = [next(rep)["input_ids"][0] for _ in range(4)]
    assert np.array_equal(firsts[3], data[0]["input_ids"]) and len(rep) == 3
    pairs = default_collate([(np.ones(2), np.zeros(3)), (np.ones(2), np.zeros(3))])
    assert isinstance(pairs, tuple) and pairs[0].shape == (2, 2) and pairs[1].shape == (2, 3)


def test_training_data_trajectory_matches_jax():
    """``initialize(training_data=)`` at gas 2: the loader yields global
    micro-batches of ``train_batch_size // gas`` rows; 3 steps through
    ``train_batch(data_iter=iter(RepeatingLoader(loader)))`` give JAX's
    losses (rtol 1e-5), and the loader's batches are JAX's."""
    import deepspeed_tpu as jds
    jax, _, _ = _jax()
    from deepspeed_tpu.comm.mesh import MeshSpec, create_mesh
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
    data = _dataset(40)
    config = {"train_batch_size": BATCH, "gradient_accumulation_steps": 2,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}, "steps_per_print": 0}
    model, variables = _jax_variables()
    mesh = create_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    jeng, _, jloader, _ = jds.initialize(model=model, config=JaxConfig(dict(config), dp_world_size=1), mesh=mesh,
                                         params=variables["params"], training_data=data, dist_init_required=False)
    eng, _, loader, _ = _port_engine(variables, config, training_data=data)
    assert loader.batch_size == jloader.batch_size == BATCH // 2 and len(loader) == len(jloader) == 10
    jit, it = iter(RepeatingLoader(jloader)), iter(RepeatingLoader(loader))
    want = [float(jeng.train_batch(data_iter=jit)) for _ in range(3)]
    got = [float(eng.train_batch(data_iter=it)) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert np.array_equal(next(it)["input_ids"], next(jit)["input_ids"])


# ------------------------------------------------------------------ hooks


def _jax_hooks():
    _, jnp, _ = _jax()

    def model_inputs_fn(batch):
        return (batch["tokens"], ), {}

    def loss_fn(logits, batch):
        # a per-row mean of a non-linear per-row loss: the squared logsumexp
        # of each row's last position, weighted
        lse = jnp.log(jnp.sum(jnp.exp(logits[:, -1, :].astype(jnp.float32)), axis=-1))
        return jnp.mean(batch["weight"] * lse**2) / 100.0

    return model_inputs_fn, loss_fn


def _port_model_inputs(batch):
    return (batch["tokens"], ), {}


def _port_loss(logits, batch):
    lse = torch.logsumexp(logits[:, -1, :].float(), dim=-1)
    return torch.mean(batch["weight"] * lse**2) / 100.0


def _hook_batches():
    out = []
    for s in range(3):
        rng = np.random.default_rng(20 + s)
        out.append({"tokens": rng.integers(0, TCFG.vocab_size, (6, SEQ)).astype(np.int32),
                    "weight": rng.uniform(0.5, 2.0, (6, )).astype(np.float32)})
    return out


HOOK_CONFIG = {"train_batch_size": 6, "optimizer": {"type": "AdamW", "params": {"lr": 1e-2}}, "steps_per_print": 0}


@pytest.fixture(scope="module")
def jax_hook_run():
    """The JAX engine with the custom hooks over ``_hook_batches()``: its
    initial variables, per-step losses, its loss on the first batch after
    the steps, and its final parameters."""
    jax, _, _ = _jax()
    mif, lf = _jax_hooks()
    jeng, variables = _jax_engine(HOOK_CONFIG, loss_fn=lf, model_inputs_fn=mif)
    batches = _hook_batches()
    losses = [float(jeng.train_batch(batch=b)) for b in batches]
    return {"variables": variables, "losses": losses, "eval": float(jeng.eval_batch(batch=batches[0])),
            "params": jax_llama_to_state_dict(jax.tree.map(np.asarray, jeng.state.params), TCFG)}


def test_custom_loss_and_model_inputs_match_jax(jax_hook_run):
    """A custom ``model_inputs_fn`` (a ``tokens`` key) and ``loss_fn`` (a
    weighted per-row mean of each row's squared last-position logsumexp),
    written once in jnp and once in torch: 3 steps give JAX's losses (rtol
    1e-5); ``eval_batch`` gives the loss without a step."""
    eng = _port_engine(jax_hook_run["variables"], HOOK_CONFIG, loss_fn=_port_loss,
                       model_inputs_fn=_port_model_inputs)[0]
    batches = _hook_batches()
    got = [float(eng.train_batch(batch=b)) for b in batches]
    np.testing.assert_allclose(got, jax_hook_run["losses"], rtol=1e-5)
    np.testing.assert_allclose(float(eng.eval_batch(batch=batches[0])), jax_hook_run["eval"], rtol=1e-5)
    assert eng.global_steps == 3


def _hook_rank(rank, state, batches):
    model = tl.LlamaForCausalLM(TCFG, device="cpu")
    eng = tds.initialize(model=model, config=dict(HOOK_CONFIG), params=state, device="cpu",
                         loss_fn=_port_loss, model_inputs_fn=_port_model_inputs)[0]
    losses = [float(eng.train_batch(batch=b)) for b in batches]
    return {"losses": losses, "params": {k: v.numpy() for k, v in eng.module_state_dict().items()}}


def test_custom_loss_at_world_3_matches_jax_over_the_global_batch(tmp_path, jax_hook_run):
    """Three gloo ranks, two of the six rows each: the custom loss is
    evaluated over the gathered micro-batch, so each step's loss is JAX's
    over the global batch on one device (rtol 1e-5; a mean of the per-rank
    losses would differ, since each rank's rows carry other weights) and the
    ranks end with identical parameters close to JAX's (all but 1e-3 within
    1e-5)."""
    jax, _, _ = _jax()
    state = jax_llama_to_state_dict(jax.tree.map(np.asarray, jax_hook_run["variables"]), TCFG)
    ranks = run_ranks(str(tmp_path), _hook_rank, state, _hook_batches(), world=3)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], jax_hook_run["losses"], rtol=1e-5)
        for k, v in r["params"].items():
            assert np.array_equal(v, ranks[0]["params"][k]), k
    for k, v in ranks[0]["params"].items():
        _assert_params_close(v, jax_hook_run["params"][k].numpy(), [1e-2] * 3, 1e-5, 1e-3)


# ------------------------------------------------------------------ PLD


def test_pld_schedule_and_keep_probabilities_match_jax():
    """The host schedule (``update_state``) equals JAX's exactly (the same
    double arithmetic); the float32 theta of the step within one float32
    ulp of the JAX step's jitted value; the keep probabilities' 1/keep_p
    equal JAX's ``pld_layer_mask`` inverse for the same theta bit for bit."""
    jax, jnp, _ = _jax()
    from deepspeed_tpu.runtime.progressive_layer_drop import ProgressiveLayerDrop as JPLD
    from deepspeed_tpu.runtime.progressive_layer_drop import pld_layer_mask as jmask
    j, t = JPLD(theta=0.5, gamma=0.001), tpld.ProgressiveLayerDrop(theta=0.5, gamma=0.001)
    steps = np.arange(0, 5000, 37)
    assert [j.update_state(int(s)) for s in steps] == [t.update_state(int(s)) for s in steps]
    want = np.asarray(jax.jit(lambda s: (1.0 - 0.5) * jnp.exp(-0.001 * s.astype(jnp.float32)) + 0.5)(
        jnp.asarray(steps, jnp.int32)))
    got = np.array([float(t.step_theta(int(s))) for s in steps], np.float32)
    assert np.all(np.abs(got - want) <= np.spacing(want)), np.abs(got - want).max()
    for theta in (1.0, 0.73, 0.3):
        _, jinv = jmask(jax.random.PRNGKey(0), 12, jnp.float32(theta))
        assert np.array_equal(1.0 / tpld.pld_keep_prob(12, np.float32(theta)).numpy(), np.asarray(jinv))


def test_pld_keep_rates_follow_keep_p():
    """Over 2000 steps at theta 0.3, each layer keeps at its probability
    (within 4.5 binomial standard deviations); theta 1 keeps every layer;
    a step's mask is a function of the step alone."""
    layers, n = 8, 2000
    keep_p = tpld.pld_keep_prob(layers, 0.3).numpy()
    masks = np.stack([tpld.pld_layer_mask(tpld.pld_generator(s), layers, 0.3)[0].numpy() for s in range(n)])
    sd = np.sqrt(keep_p * (1 - keep_p) / n)
    assert np.all(np.abs(masks.mean(0) - keep_p) <= 4.5 * sd), (masks.mean(0), keep_p)
    assert masks.mean(0)[0] > masks.mean(0)[-1]
    assert tpld.pld_layer_mask(tpld.pld_generator(5), layers, 1.0)[0].eq(1).all()
    assert torch.equal(tpld.pld_layer_mask(tpld.pld_generator(9), layers, 0.3)[0],
                       tpld.pld_layer_mask(tpld.pld_generator(9), layers, 0.3)[0])


@pytest.mark.parametrize("scale", [[1.0, 1.0], [0.0, 0.0], [1.0 / 0.75, 0.0]], ids=["ones", "zeros", "mixed"])
def test_model_under_pld_scale_matches_jax(scale):
    """The logits under a given ``pld_scale`` against JAX's (JAX's
    ``test_pld_actually_drops_layers``), float32, within 1e-5, with and
    without remat (under remat the gate reaches each block through
    ``checkpoint``, and the gradients equal those without remat to 1e-6);
    ones leave the model as it is, any zero changes it."""
    jax, jnp, jcfg = _jax()
    model, variables = _jax_variables()
    ids = np.random.default_rng(8).integers(0, 128, (2, SEQ)).astype(np.int32)
    want = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(ids), pld_scale=jnp.asarray(scale, jnp.float32)))
    state = jax_llama_to_state_dict(jax.tree.map(np.asarray, variables), TCFG)
    grads = []
    for remat in (False, True):
        port = tl.LlamaForCausalLM(dataclasses.replace(TCFG, remat=remat), device="cpu")
        port.load_state_dict(state)
        got = port(torch.from_numpy(ids), pld_scale=torch.tensor(scale))
        np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=1e-5)
        got.square().mean().backward()
        grads.append({n: p.grad for n, p in port.named_parameters()})
        full = port(torch.from_numpy(ids))
        if scale == [1.0, 1.0]:
            assert torch.equal(got, full)
        else:
            assert (got - full).abs().max() > 1e-3
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, atol=1e-6, rtol=1e-6, msg=name)
    with pytest.raises(ValueError, match="pld_scale"):
        port(torch.from_numpy(ids), pld_scale=torch.ones(3))


def test_engine_draws_the_pld_mask_of_each_step():
    """With ``progressive_layer_drop`` on, step n (n steps taken) runs the
    model under ``pld_scale_for_step(pld, L, n)``, theta follows JAX's host
    schedule, and ``eval_batch`` runs without the gate."""
    from deepspeed_tpu.runtime.progressive_layer_drop import ProgressiveLayerDrop as JPLD
    model = tl.LlamaForCausalLM(TCFG, device="cpu")
    tl.init_weights_(model, torch.Generator().manual_seed(0))
    eng = tds.initialize(model=model, config={"train_batch_size": BATCH, "steps_per_print": 0,
                                              "progressive_layer_drop": {"enabled": True, "theta": 0.5,
                                                                         "gamma": 0.1}}, device="cpu")[0]
    seen = []
    forward = eng.module.forward
    eng.module.forward = lambda *a, pld_scale=None, **k: seen.append(pld_scale) or forward(*a, pld_scale=pld_scale,
                                                                                           **k)
    jpld = JPLD(theta=0.5, gamma=0.1)
    for step in range(3):
        eng.train_batch(batch=_batch(step))
        assert torch.equal(seen[-1], tpld.pld_scale_for_step(eng.progressive_layer_drop, 2, step))
        assert eng.progressive_layer_drop.get_theta() == jpld.update_state(step + 1)
    eng.eval_batch(batch=_batch(0))
    assert seen[-1] is None


# ------------------------------------------------------------------ precision wrappers


def test_fp16_optimizer_standalone_matches_jax():
    """JAX's ``test_fp16_optimizer_standalone``: pre-scaled gradients move
    the fp16 parameters downhill (to JAX's values), an overflow skips the
    update, counts a skip and halves the scale (hysteresis 1)."""
    jax, jnp, _ = _jax()
    from deepspeed_tpu.ops.adam import fused_adam
    from deepspeed_tpu.runtime.config import FP16Config as JFP16Config
    from deepspeed_tpu.runtime.fp16.fused_optimizer import FP16_Optimizer as JFP16
    from deepspeed_tpu_torch.runtime.config import FP16Config
    from deepspeed_tpu_torch.runtime.fp16.fused_optimizer import FP16_Optimizer
    params = {"w": jnp.ones((4, ), jnp.float16)}
    jopt = JFP16(fused_adam(lr=0.1), compute_dtype=jnp.float16,
                 fp16_config=JFP16Config(enabled=True, initial_scale_power=8, hysteresis=1))
    state = jopt.init(params)
    deltas, state = jopt.update({"w": jnp.full((4, ), 1.0, jnp.float16) * state.scaler.cur_scale}, state, params)
    jw = params["w"] + deltas["w"]
    w = torch.ones(4, dtype=torch.float16)
    opt = FP16_Optimizer([w], lambda m: FusedAdam(m, lr=0.1), compute_dtype=torch.float16,
                         fp16_config=FP16Config(enabled=True, initial_scale_power=8, hysteresis=1))
    w.grad = torch.full((4, ), 1.0, dtype=torch.float16) * opt.scaler_state.cur_scale.half()
    opt.step()
    assert float(w[0]) < 1.0 and int(opt.skipped) == 0
    assert np.array_equal(w.numpy(), np.asarray(jw))
    scale = opt.loss_scale
    w.grad = torch.full((4, ), float("inf"), dtype=torch.float16)
    after = w.clone()
    opt.step()
    assert torch.equal(w, after) and int(opt.skipped) == 1 and opt.loss_scale == scale / 2


def test_bf16_optimizer_standalone_matches_jax():
    """JAX's ``test_bf16_optimizer_standalone``: a float32 master, the bf16
    parameters moved downhill to JAX's values; with ``clip_grad`` the
    gradients are clipped by the global norm first."""
    _, jnp, _ = _jax()
    from deepspeed_tpu.ops.adam import fused_adam
    from deepspeed_tpu.runtime.bf16_optimizer import BF16_Optimizer as JBF16
    from deepspeed_tpu_torch.runtime.bf16_optimizer import BF16_Optimizer
    for clip in (0.0, 0.5):
        params = {"w": jnp.asarray([1.0, -2.0, 0.5, 3.0], jnp.bfloat16)}
        jopt = JBF16(fused_adam(lr=0.1), clip_grad=clip)
        state = jopt.init(params)
        assert state.master["w"].dtype == jnp.float32
        grads = {"w": jnp.asarray([1.0, 2.0, -3.0, 0.25], jnp.bfloat16)}
        deltas, state = jopt.update(grads, state, params)
        w = torch.tensor([1.0, -2.0, 0.5, 3.0], dtype=torch.bfloat16)
        opt = BF16_Optimizer([w], lambda m: FusedAdam(m, lr=0.1), clip_grad=clip)
        assert opt.master[0].dtype == torch.float32
        w.grad = torch.tensor([1.0, 2.0, -3.0, 0.25], dtype=torch.bfloat16)
        opt.step()
        assert np.array_equal(w.float().numpy(), np.asarray(params["w"] + deltas["w"], np.float32))
        np.testing.assert_allclose(opt.master[0].numpy(), np.asarray(state.master["w"]), atol=1e-7)


# ------------------------------------------------------------------ monitor and timers


def test_csv_monitor_writes_jax_rows(tmp_path):
    """The port's and JAX's ``MonitorMaster`` over the same events write the
    same files, byte for byte; the engines' 2 steps write the same files
    with the same steps and JAX's losses (rtol 1e-5)."""
    import csv
    from deepspeed_tpu.monitor.monitor import MonitorMaster as JMonitor
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
    from deepspeed_tpu_torch.monitor import MonitorMaster
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

    def cfg(where):
        return {"train_batch_size": BATCH, "steps_per_print": 0,
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
                "csv_monitor": {"enabled": True, "output_path": str(tmp_path / where), "job_name": "job"}}

    events = [("Train/Samples/train_loss", 1.25, 8), ("resilience/ckpt_published", 1.0, 3),
              ("Train/Samples/train_loss", 0.5, 16)]
    for cls, conf, where in ((JMonitor, JaxConfig, "jax"), (MonitorMaster, DeepSpeedConfig, "port")):
        m = cls((conf(cfg(where), dp_world_size=1) if cls is JMonitor else conf(cfg(where))).monitor_config)
        assert m.enabled
        m.write_events(events)
    files = sorted(os.listdir(tmp_path / "jax" / "job"))
    assert files == sorted(os.listdir(tmp_path / "port" / "job")) == ["Train_Samples_train_loss.csv",
                                                                        "resilience_ckpt_published.csv"]
    for f in files:
        assert (tmp_path / "jax" / "job" / f).read_bytes() == (tmp_path / "port" / "job" / f).read_bytes()

    jeng, variables = _jax_engine(cfg("jax_engine"))
    eng = _port_engine(variables, cfg("port_engine"))[0]
    for b in (_batch(0), _batch(1)):
        jeng.train_batch(batch=b)
        eng.train_batch(batch=b)
    from deepspeed_tpu.resilience import events as jevents
    from deepspeed_tpu_torch.resilience import events as tevents
    jevents.attach_monitor(None)
    tevents.attach_monitor(None)
    names = sorted(os.listdir(tmp_path / "jax_engine" / "job"))
    assert names == sorted(os.listdir(tmp_path / "port_engine" / "job"))
    for f in names:
        rows = [list(csv.reader(open(tmp_path / d / "job" / f))) for d in ("jax_engine", "port_engine")]
        assert rows[0][0] == rows[1][0] and [r[0] for r in rows[0]] == [r[0] for r in rows[1]]
        np.testing.assert_allclose([float(r[1]) for r in rows[1][1:]], [float(r[1]) for r in rows[0][1:]],
                                   rtol=1e-5)


def test_wall_clock_breakdown_uses_the_synchronized_timers():
    """``wall_clock_breakdown`` builds ``SynchronizedWallClockTimer``: one
    ``train_batch`` record per step, logged at ``steps_per_print``; without
    it the timers are ``NoopTimer``s."""
    from deepspeed_tpu_torch.utils.timer import NoopTimer, SynchronizedWallClockTimer, TRAIN_BATCH_TIMER
    model = tl.LlamaForCausalLM(TCFG, device="cpu")
    tl.init_weights_(model, torch.Generator().manual_seed(0))
    eng = tds.initialize(model=model, config={"train_batch_size": BATCH, "wall_clock_breakdown": True,
                                              "steps_per_print": 2}, device="cpu")[0]
    assert isinstance(eng.timers, SynchronizedWallClockTimer)
    logged = []
    eng.timers.log = lambda names, **kw: logged.append((eng.global_steps, list(names)))
    for s in range(3):
        eng.train_batch(batch=_batch(s))
    timer = eng.timers(TRAIN_BATCH_TIMER)
    assert len(timer.elapsed_records) == 3 and timer.mean() > 0
    assert logged == [(2, [TRAIN_BATCH_TIMER])]
    plain = tds.initialize(model=model, config={"train_batch_size": BATCH}, device="cpu")[0]
    assert isinstance(plain.timers, NoopTimer) and plain.timers(TRAIN_BATCH_TIMER).elapsed() == 0.0
