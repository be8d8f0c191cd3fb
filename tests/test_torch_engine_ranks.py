"""The training engine's user-facing losses at three data-parallel ranks, and
its step hooks, against the JAX package on the CPU.

  * ``eval_batch``, ``forward``, the loss ``backward`` returns (of a
    ``forward`` loss and of a fresh forward of a batch) and ``step()``'s
    loss, at W = 3 gloo ranks given the global micro-batch: each equals the
    JAX engine's loss of that micro-batch on one device (the global mean
    does not depend on the mesh), rtol 1e-5, with no ``loss_mask`` and with
    one that hides 3/4 of rank 1's tokens.  ``step()``'s update on each rank
    equals the one-rank port's (params within 1e-6).  One spawn of the three
    ranks serves every case.
  * ``train_batch`` probes the ``engine.step`` chaos site: a plan armed at
    hit 2 fires at the second step in both packages;
  * ``set_telemetry``: one ``engine/step`` span a step, with
    ``engine/fwd_bwd`` and ``engine/optim`` children; JAX's root span has
    the same name and ``global_step`` attribute.

The model is the tiny f32 Llama of ``tests/test_torch_training_features.py``
(vocab 128, hidden 64, 2 layers), six rows of 16 tokens.
"""

import threading

import numpy as np
import pytest

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.resilience import fault_injection as tfi
from deepspeed_tpu_torch.telemetry.trace import Tracer

from test_torch_qgz import run_ranks
from test_torch_training_features import SEQ, TCFG, _assert_params_close, _jax

ROWS = 6
CONFIG = {"train_batch_size": ROWS, "optimizer": {"type": "AdamW", "params": {"lr": 1e-2}}, "steps_per_print": 0}
CONFIG_GAS2 = dict(CONFIG, gradient_accumulation_steps=2)
MASKS = ("none", "uneven")


def _batch(mask: str, seed: int = 5):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, TCFG.vocab_size, (ROWS, SEQ)).astype(np.int32)
    batch = {"input_ids": ids, "labels": ids}
    if mask == "uneven":   # rank 1's rows (2, 3) keep a quarter of their tokens
        m = np.ones((ROWS, SEQ), np.float32)
        m[2:4, SEQ // 4:] = 0.0
        batch["loss_mask"] = m
    return batch


def _variables():
    """JAX Llama variables of the tiny config, every leaf N(0, 0.05²) from a
    numpy seed (norm scales 1): shapes by ``eval_shape``, no compile."""
    jax, jnp, jcfg = _jax()
    from deepspeed_tpu.models.llama import LlamaForCausalLM
    shapes = jax.eval_shape(LlamaForCausalLM(jcfg).init, jax.random.PRNGKey(0), jnp.zeros((1, SEQ), jnp.int32))
    rng = np.random.default_rng(11)

    def leaf(path, s):
        if "norm" in jax.tree_util.keystr(path):
            return np.ones(s.shape, np.float32)
        return (0.05 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def variables():
    return _variables()


@pytest.fixture(scope="module")
def state(variables):
    jax, _, _ = _jax()
    from deepspeed_tpu_torch.models.convert import jax_llama_to_state_dict
    return jax_llama_to_state_dict(jax.tree.map(np.asarray, variables), TCFG)


@pytest.fixture(scope="module")
def jax_engine(variables):
    """One JAX engine on one device for the module (its steps are counted
    relative to where a test finds it)."""
    jax, _, _ = _jax()
    import deepspeed_tpu as jds
    from deepspeed_tpu.comm.mesh import MeshSpec, create_mesh
    from deepspeed_tpu.models.llama import LlamaForCausalLM
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
    _, _, jcfg = _jax()
    mesh = create_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    return jds.initialize(model=LlamaForCausalLM(jcfg), config=JaxConfig(dict(CONFIG), dp_world_size=1), mesh=mesh,
                          params=variables["params"], dist_init_required=False)[0]


def _port_engine(state, config):
    return tds.initialize(model=tl.LlamaForCausalLM(TCFG, device="cpu"), config=dict(config), params=state,
                          device="cpu")[0]


def _losses(eng, batch):
    """Every loss a user reads on the imperative path, and the update."""
    out = {"eval": float(eng.eval_batch(batch=batch))}
    loss = eng.forward(batch)
    out["forward"] = float(loss.detach())
    out["backward"] = float(eng.backward(loss))
    out["backward_fresh"] = float(eng.backward(batch=batch))
    out["step"] = float(eng.step().loss)
    out["params"] = {k: v.numpy().copy() for k, v in eng.module_state_dict().items()}
    return out


def _rank(rank, state, batches):
    return {mask: _losses(_port_engine(state, CONFIG_GAS2), batch) for mask, batch in batches.items()}


@pytest.fixture(scope="module")
def w3_runs(tmp_path_factory, state, jax_engine):
    """The JAX engine's losses of each batch, the one-rank port's imperative
    run, and the three ranks' runs (one spawn, run while the rest compute)."""
    batches = {m: _batch(m) for m in MASKS}
    ranks = {}

    def spawn():
        try:
            ranks["out"] = run_ranks(str(tmp_path_factory.mktemp("w3")), _rank, state, batches, world=3)
        except BaseException as e:
            ranks["error"] = e

    thread = threading.Thread(target=spawn)
    thread.start()
    try:
        jax_losses = {mask: {"eval": float(jax_engine.eval_batch(batch=batch)),
                             "backward": float(jax_engine.backward(batch=batch))}
                      for mask, batch in batches.items()}
        jax_engine.zero_grad()
        one_rank = {mask: _losses(_port_engine(state, CONFIG_GAS2), batch) for mask, batch in batches.items()}
    finally:
        thread.join()
    if "error" in ranks:
        raise ranks["error"]
    return jax_losses, one_rank, ranks["out"]


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("what", ["eval", "forward", "backward", "backward_fresh", "step"])
def test_world_3_losses_are_the_global_micro_batch_mean(w3_runs, mask, what):
    """At W = 3 each loss a user reads is JAX's over the global micro-batch
    (on ``d03e953`` they read a third of it, and with the mask each rank's
    own share)."""
    jax_losses, one_rank, ranks = w3_runs
    want = jax_losses[mask]["backward" if what.startswith("backward") else "eval"]
    np.testing.assert_allclose(one_rank[mask][what], want, rtol=1e-5)
    for r in ranks:
        np.testing.assert_allclose(r[mask][what], want, rtol=1e-5)


@pytest.mark.parametrize("mask", MASKS)
def test_world_3_imperative_step_matches_one_rank(w3_runs, mask):
    """forward + backward, backward(batch=) and ``step()`` at gas 2: the
    summed gradient gives the one-rank update on every rank (AdamW's first
    step moves an entry by about lr whatever its gradient: all but 1e-3 of
    the entries within 1e-6, all within 2·lr)."""
    _, one_rank, ranks = w3_runs
    for r in ranks:
        for k, v in r[mask]["params"].items():
            _assert_params_close(v, one_rank[mask]["params"][k], [1e-2], 1e-6, 1e-3)


def test_engine_step_fault_site_fires_at_the_same_step_as_jax(state, jax_engine):
    """A plan arming ``engine.step`` at hit 2 raises at the second
    ``train_batch`` in both packages, and the steps around it ran."""
    from deepspeed_tpu.resilience import fault_injection as jfi
    eng = _port_engine(state, CONFIG)
    plan = {"sites": [{"site": "engine.step", "kind": "os_error", "at": 2}]}
    fired, ran = {}, {}
    for name, fi, e in (("jax", jfi, jax_engine), ("port", tfi, eng)):
        start = e.global_steps
        fi.configure_fault_injection(plan)
        try:
            for call in range(1, 4):
                try:
                    e.train_batch(batch=_batch("none", seed=call))
                except fi.InjectedTransientError:
                    fired[name] = (call, e.global_steps - start)
        finally:
            fi.configure_fault_injection(None)
        ran[name] = e.global_steps - start
    assert fired["port"] == fired["jax"] == (2, 1)
    assert ran["port"] == ran["jax"] == 2


def test_set_telemetry_emits_the_step_span_and_its_children(state, jax_engine):
    """One ``engine/step`` root a ``train_batch`` with ``engine/fwd_bwd``
    then ``engine/optim`` under it; ``set_telemetry()`` detaches."""
    eng = _port_engine(state, CONFIG)
    tracer = Tracer()
    eng.set_telemetry(tracer=tracer)
    for s in range(2):
        eng.train_batch(batch=_batch("none", seed=s))
    roots = [s for s in tracer.spans if s.name == "engine/step"]
    assert [r.attrs for r in roots] == [{"global_step": 0}, {"global_step": 1}]
    for r in roots:
        kids = sorted((s for s in tracer.spans if s.parent_id == r.span_id), key=lambda s: s.start_ts)
        assert [k.name for k in kids] == ["engine/fwd_bwd", "engine/optim"]
        assert all(k.trace_id == r.trace_id and r.start_ts <= k.start_ts <= k.end_ts <= r.end_ts for k in kids)
    eng.set_telemetry()
    eng.train_batch(batch=_batch("none", seed=3))
    assert len(tracer.spans) == 6
    from deepspeed_tpu.telemetry.trace import Tracer as JaxTracer
    jtracer = JaxTracer()
    jax_engine.set_telemetry(tracer=jtracer)
    step = jax_engine.global_steps
    jax_engine.train_batch(batch=_batch("none"))
    jax_engine.set_telemetry()
    assert [s.attrs for s in jtracer.spans if s.name == "engine/step"] == [{"global_step": step}]
