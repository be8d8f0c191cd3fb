"""Crash-safe checkpoints of the PyTorch port (``checkpoint/engine.py``,
``runtime/checkpoint_engine.py``, ``checkpoint/zero_to_fp32.py``) on the CPU.

The scenarios of the JAX package's ``tests/unit/resilience/test_chaos_recovery.py``
written for the port: a victim engine trains ``TOTAL_STEPS`` uninterrupted
(its losses are the baseline: a failed save never touches training state),
writes a clean ``good`` checkpoint after step ``GOOD_AT`` and a faulted or
later vandalised ``bad`` one after step ``BAD_AT`` into a directory per
scenario; one resumer engine (diverged first, so only a real restore can
explain equality) loads each directory and continues.  Every resumed
trajectory equals the uninterrupted one **bit for bit**: the state file
holds every tensor the step reads (parameters, float32 master, moments, the
optimizer's step, the scaler, the skip count) and the CPU's arithmetic is
deterministic.  The victim trains bf16 with a float32 master and AdamW.

Also: the async save copies the state before it returns (a step right after
the save does not leak into it), ``load_optimizer_states=False`` and
``load_module_only``, ``meta.json``'s keys against a JAX save's, a resume
with progressive layer drop on, a JAX run continued by the port against JAX
continuing, and the float32 consolidation.
"""

import dataclasses
import json
import os
import shutil
import sys
import threading

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.checkpoint import engine as ckpt
from deepspeed_tpu_torch.checkpoint.zero_to_fp32 import (convert_zero_checkpoint_to_fp32_state_dict,
                                                         get_fp32_state_dict_from_zero_checkpoint,
                                                         load_state_dict_from_zero_checkpoint, main)
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.resilience import events
from deepspeed_tpu_torch.resilience.fault_injection import InjectedCrash, configure_fault_injection
from deepspeed_tpu_torch.runtime import checkpoint_engine as ce
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse fixture)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "unit"))

TCFG = tl.LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64, rope_theta=10000.0,
                      dtype=torch.bfloat16, attention_impl="reference")
CONFIG = {"train_batch_size": 8, "steps_per_print": 0, "gradient_clipping": 1.0, "bf16": {"enabled": True},
          "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
          "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 4, "warmup_type": "linear"}}}
TOTAL_STEPS = 6
GOOD_AT = 2   # clean checkpoint after this step
BAD_AT = 4    # faulted save attempt after this step
CRASH_SITES = [("ckpt.state_save", "crash"), ("ckpt.meta_write", "torn_write"),
               ("ckpt.manifest_write", "torn_write"), ("ckpt.latest_publish", "torn_write")]
POST_HOC = ["corrupt_latest", "corrupt_state", "deleted_tag", "no_valid"]


def _batch(seed=0):
    ids = np.random.default_rng(seed).integers(0, TCFG.vocab_size, (8, 16)).astype(np.int32)
    return {"input_ids": ids, "labels": ids}


def _engine(config=None, seed=0, cfg=TCFG):
    model = tl.LlamaForCausalLM(cfg, device="cpu")
    tl.init_weights_(model, torch.Generator().manual_seed(seed))
    return tds.initialize(model=model, config=dict(config or CONFIG), device="cpu")[0]


def _state(engine):
    """Every tensor of the engine's state, copied."""
    return {"params": {k: v.clone() for k, v in engine.module.state_dict().items()},
            "master": [m.clone() for m in engine.master],
            "moments": {(i, k): v.clone() for i, p in enumerate(engine.optimizer.param_groups[0]["params"])
                        for k, v in engine.optimizer.state[p].items()},
            "scaler": [t.clone() for t in engine.scaler_state], "skipped": engine.skipped.clone(),
            "steps": (engine.global_steps, engine.optimizer.step_count)}


def _on_cpu(state):
    """A ``_state`` with every tensor moved to the CPU."""
    return {"params": {k: v.cpu() for k, v in state["params"].items()},
            "master": [m.cpu() for m in state["master"]],
            "moments": {k: v.cpu() for k, v in state["moments"].items()},
            "scaler": [t.cpu() for t in state["scaler"]], "skipped": state["skipped"].cpu(), "steps": state["steps"]}


def _assert_state_equal(a, b):
    assert a["steps"] == b["steps"]
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    assert all(torch.equal(x, y) for x, y in zip(a["master"], b["master"]))
    assert a["moments"].keys() == b["moments"].keys()
    assert all(torch.equal(a["moments"][k], b["moments"][k]) for k in a["moments"])
    assert all(torch.equal(x, y) for x, y in zip(a["scaler"], b["scaler"]))
    assert torch.equal(a["skipped"], b["skipped"])


@pytest.fixture(autouse=True)
def _disarm():
    yield
    configure_fault_injection(None)


@pytest.fixture(scope="module")
def chaos(tmp_path_factory):
    batch = _batch()
    dirs = {key: str(tmp_path_factory.mktemp(key.replace(".", "_"))) for key, _ in CRASH_SITES}
    dirs.update({key: str(tmp_path_factory.mktemp(key)) for key in POST_HOC})
    engine = _engine()
    losses, crash_errors = [], {}
    for step in range(TOTAL_STEPS):
        losses.append(float(engine.train_batch(batch=batch)))
        if step + 1 == GOOD_AT:
            for d in dirs.values():
                engine.save_checkpoint(d, tag="good")
        if step + 1 == BAD_AT:
            for site, kind in CRASH_SITES:
                configure_fault_injection({"sites": [{"site": site, "kind": kind, "at": 1}]})
                try:
                    engine.save_checkpoint(dirs[site], tag="bad")
                    crash_errors[site] = None
                except Exception as e:  # the injected kill
                    crash_errors[site] = e
                finally:
                    configure_fault_injection(None)
            for key in POST_HOC:
                engine.save_checkpoint(dirs[key], tag="bad")
    final = {k: v.clone() for k, v in engine.module.state_dict().items()}
    return {"dirs": dirs, "losses": losses, "batch": batch, "crash_errors": crash_errors, "final": final}


@pytest.fixture(scope="module")
def resumer(chaos):
    engine = _engine(seed=1)
    engine.train_batch(batch=_batch(seed=99))
    return engine


def _resume_and_check(resumer, chaos, ckpt_dir, expect_step, expect_tag):
    path, _ = resumer.load_checkpoint(ckpt_dir)
    assert path is not None and os.path.basename(path) == expect_tag
    assert resumer.global_steps == expect_step
    resumed = [float(resumer.train_batch(batch=chaos["batch"])) for _ in range(TOTAL_STEPS - expect_step)]
    assert resumed == chaos["losses"][expect_step:]
    for k, v in resumer.module.state_dict().items():
        assert torch.equal(v, chaos["final"][k]), k


@pytest.mark.parametrize("site,kind", CRASH_SITES)
def test_kill_during_save_resumes_identical_trajectory(site, kind, chaos, resumer):
    """A kill at any save-path site leaves ``latest`` at the intact 'good'
    checkpoint; the resume reproduces the uninterrupted run bit for bit."""
    err = chaos["crash_errors"][site]
    assert isinstance(err, (InjectedCrash, OSError)), err
    assert open(os.path.join(chaos["dirs"][site], "latest")).read().strip() == "good"
    _resume_and_check(resumer, chaos, chaos["dirs"][site], expect_step=GOOD_AT, expect_tag="good")


def test_corrupt_published_state_auto_falls_back(chaos, resumer):
    """``latest`` → 'bad', whose state file rotted after publication: the
    manifest check rejects it and the loader falls back to 'good'."""
    d = chaos["dirs"]["corrupt_state"]
    victim = os.path.join(d, "bad", "state", ce.STATE_FILE)
    raw = bytearray(open(victim, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(victim, "rb+").write(raw)
    events.clear()
    _resume_and_check(resumer, chaos, d, expect_step=GOOD_AT, expect_tag="good")
    assert events.recent("resilience/ckpt_fallback") and events.recent("resilience/ckpt_invalid_tag")


def test_corrupt_latest_pointer_falls_back_to_newest_valid(chaos, resumer):
    """``latest`` holds garbage: the newest valid tag ('bad', step 4) loads."""
    d = chaos["dirs"]["corrupt_latest"]
    open(os.path.join(d, "latest"), "w").write("no_such_tag")
    _resume_and_check(resumer, chaos, d, expect_step=BAD_AT, expect_tag="bad")


def test_latest_pointing_at_deleted_tag_falls_back(chaos, resumer):
    d = chaos["dirs"]["deleted_tag"]
    shutil.rmtree(os.path.join(d, "bad"), ignore_errors=True)
    _resume_and_check(resumer, chaos, d, expect_step=GOOD_AT, expect_tag="good")


def test_no_valid_checkpoint_raises_clear_error(chaos, resumer):
    d = chaos["dirs"]["no_valid"]
    shutil.rmtree(os.path.join(d, "good"))
    os.unlink(os.path.join(d, "bad", "meta.json"))
    with pytest.raises(FileNotFoundError, match="no valid fallback"):
        resumer.load_checkpoint(d)


def test_explicit_tag_is_never_silently_substituted(chaos, resumer):
    d = chaos["dirs"]["deleted_tag"]
    shutil.rmtree(os.path.join(d, "bad"), ignore_errors=True)
    with pytest.raises(FileNotFoundError, match="not loadable"):
        resumer.load_checkpoint(d, tag="bad")


def test_transient_write_errors_are_absorbed_by_retry(resumer, tmp_path):
    """An os_error (unlike a kill) is retried: the save publishes a valid
    checkpoint and leaves a ``resilience/retry`` event."""
    events.clear()
    configure_fault_injection({"sites": [{"site": "ckpt.meta_write", "kind": "os_error", "at": 1}]})
    assert resumer.save_checkpoint(str(tmp_path), tag="t") is True
    configure_fault_injection(None)
    ok, why = ckpt.checkpoint_tag_valid(str(tmp_path), "t")
    assert ok, why
    assert events.recent("resilience/retry") and events.recent("resilience/ckpt_published")


def test_keep_last_k_retention(resumer, tmp_path):
    """``checkpoint.keep_last_n`` prunes the oldest tags after a publish;
    ``latest`` names a surviving, valid tag."""
    cc = resumer._config.checkpoint_config
    cc.keep_last_n = 2
    events.clear()
    try:
        for i in range(4):
            resumer.save_checkpoint(str(tmp_path), tag=f"t{i}")
    finally:
        cc.keep_last_n = None
    tags = sorted(d for d in os.listdir(tmp_path) if os.path.isdir(os.path.join(tmp_path, d)))
    assert tags == ["t2", "t3"]
    assert open(os.path.join(tmp_path, "latest")).read().strip() == "t3"
    assert len(events.recent("resilience/ckpt_retention_delete")) == 2


# ------------------------------------------------------------------ async save


def test_async_save_copies_the_state_before_it_returns(tmp_path, monkeypatch):
    """``AsyncCheckpointEngine.save`` with the writer held back: a training
    step runs before the write, and the file still holds the state at the
    save (the step updated the live tensors in place).  Through the engine
    (``nebula``), a save then a step then a load restores the state at the
    save."""
    engine = _engine()
    engine.train_batch(batch=_batch(0))
    at_save = _state(engine)
    release, write = threading.Event(), ce._write
    monkeypatch.setattr(ce, "_write", lambda *a: release.wait(30) and write(*a))
    writer = ce.AsyncCheckpointEngine()
    writer.save(ckpt.engine_state(engine), str(tmp_path / "held" / "state"))
    engine.train_batch(batch=_batch(1))
    assert not torch.equal(engine.master[0], at_save["master"][0])
    release.set()
    writer.commit("held")
    restored = writer.load(str(tmp_path / "held" / "state"), map_location="cpu")
    fresh = _engine(seed=1)
    ckpt.restore_engine_state(fresh, restored)
    fresh.global_steps = restored["step"]
    _assert_state_equal(_state(fresh), at_save)
    monkeypatch.undo()

    config = {**CONFIG, "nebula": {"enabled": True}}
    engine = _engine(config)
    engine.train_batch(batch=_batch(0))
    at_save = _state(engine)
    engine.save_checkpoint(str(tmp_path / "nebula"), tag="async1")
    assert isinstance(ce.make_checkpoint_engine("nebula"), ce.AsyncCheckpointEngine)
    engine.train_batch(batch=_batch(1))
    fresh = _engine(config, seed=1)
    fresh.load_checkpoint(str(tmp_path / "nebula"))
    _assert_state_equal(_state(fresh), at_save)


def test_load_optimizer_states_false_and_load_module_only(tmp_path):
    """Both restore the parameters, the master, the scaler and the step
    count and keep the optimizer's own state (JAX keeps ``opt_state``)."""
    engine = _engine()
    for s in range(2):
        engine.train_batch(batch=_batch(s))
    engine.save_checkpoint(str(tmp_path), tag="t", client_state={"epoch": 3})
    saved = _state(engine)
    for kw in ({"load_optimizer_states": False}, {"load_module_only": True}):
        other = _engine(seed=1)
        other.train_batch(batch=_batch(7))
        own = _state(other)
        path, client = other.load_checkpoint(str(tmp_path), **kw)
        assert client == {"epoch": 3} and os.path.basename(path) == "t"
        got = _state(other)
        assert all(torch.equal(got["params"][k], saved["params"][k]) for k in saved["params"])
        assert all(torch.equal(x, y) for x, y in zip(got["master"], saved["master"]))
        assert all(torch.equal(got["moments"][k], own["moments"][k]) for k in own["moments"])
        assert other.global_steps == 2 and other.optimizer.step_count == 1


def test_meta_keys_and_client_state_match_a_jax_save(tmp_path):
    """``meta.json`` has the JAX save's keys, ``client_state`` round-trips,
    the tag layout is JAX's (``state``, ``meta.json``, ``manifest.json``,
    ``latest``), and an engine with no checkpoint directory restores nothing."""
    import dataclasses as dc

    import jax
    import jax.numpy as jnp

    import deepspeed_tpu as jds
    from deepspeed_tpu.comm.mesh import MeshSpec, create_mesh
    from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
    from simple_model import TINY
    mesh = create_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    jconf = {"train_batch_size": 8, "steps_per_print": 0, "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}
    jeng = jds.initialize(model=JaxLlama(dc.replace(TINY, dtype=jnp.float32)),
                          config=JaxConfig(jconf, dp_world_size=1), mesh=mesh, dist_init_required=False)[0]
    jeng.train_batch(batch=_batch(0))
    jeng.save_checkpoint(str(tmp_path / "jax"), tag="t", client_state={"epoch": 2, "note": "x"})
    engine = _engine()
    engine.train_batch(batch=_batch(0))
    engine.save_checkpoint(str(tmp_path / "port"), tag="t", client_state={"epoch": 2, "note": "x"})
    jmeta, meta = (json.load(open(tmp_path / d / "t" / "meta.json")) for d in ("jax", "port"))
    assert sorted(meta) == sorted(jmeta) and meta["client_state"] == jmeta["client_state"]
    assert {k: meta[k] for k in ("tag", "global_steps", "global_samples", "zero_stage")} == \
        {k: jmeta[k] for k in ("tag", "global_steps", "global_samples", "zero_stage")}
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == ["latest", "t"]
    assert sorted(os.listdir(tmp_path / "port" / "t")) == sorted(os.listdir(tmp_path / "jax" / "t"))
    assert engine.load_checkpoint(str(tmp_path / "nothing_here")) == (None, {})


def test_resume_with_pld_on_is_exact(tmp_path):
    """Progressive layer drop on: a resume from step 2 continues the
    uninterrupted run bit for bit (the mask is a function of the step)."""
    config = {**CONFIG, "progressive_layer_drop": {"enabled": True, "theta": 0.5, "gamma": 0.3}}
    engine = _engine(config)
    losses = []
    for s in range(4):
        losses.append(float(engine.train_batch(batch=_batch(s))))
        if s == 1:
            engine.save_checkpoint(str(tmp_path), tag="pld")
    other = _engine(config, seed=1)
    other.load_checkpoint(str(tmp_path))
    assert other.progressive_layer_drop.get_theta() == engine.progressive_layer_drop.update_state(2)
    assert [float(other.train_batch(batch=_batch(s))) for s in (2, 3)] == losses[2:]


def test_jax_run_continued_by_the_port_matches_jax_continuing():
    """A JAX engine (float32, AdamW) takes 2 steps; its whole state carried
    into a port engine (``jax_train_state_to_engine``), both take 2 more:
    losses within rtol 1e-5, parameters within 1e-5."""
    import jax
    import jax.numpy as jnp

    import deepspeed_tpu as jds
    from deepspeed_tpu.comm.mesh import MeshSpec, create_mesh
    from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
    from deepspeed_tpu_torch.models.convert import jax_llama_to_state_dict, jax_train_state_to_engine
    from simple_model import TINY
    conf = {"train_batch_size": 8, "steps_per_print": 0, "gradient_clipping": 1.0,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}
    jcfg = dataclasses.replace(TINY, dtype=jnp.float32)
    mesh = create_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    jeng = jds.initialize(model=JaxLlama(jcfg), config=JaxConfig(dict(conf), dp_world_size=1), mesh=mesh,
                          dist_init_required=False)[0]
    for s in range(2):
        jeng.train_batch(batch=_batch(s))
    carried = jax.tree.map(np.asarray, jeng.state)
    want = [float(jeng.train_batch(batch=_batch(s))) for s in (2, 3)]
    tcfg = dataclasses.replace(TCFG, dtype=torch.float32)
    port = jax_train_state_to_engine(carried, _engine(conf, cfg=tcfg), tcfg)
    assert port.global_steps == 2 and port.optimizer.step_count == 2
    got = [float(port.train_batch(batch=_batch(s))) for s in (2, 3)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    jstate = jax_llama_to_state_dict(jax.tree.map(np.asarray, jeng.state.params), tcfg)
    for name, t in port.module_state_dict().items():
        np.testing.assert_allclose(t.numpy(), jstate[name].numpy(), atol=1e-5, rtol=0, err_msg=name)


def test_zero_to_fp32_returns_the_float32_master(tmp_path):
    """The consolidated state dict is the engine's float32 master by name;
    the ``.pt`` and ``.npz`` outputs and the CLI hold it; loading it into a
    fresh engine gives the saved master and the bf16 parameters."""
    engine = _engine()
    engine.train_batch(batch=_batch(0))
    engine.save_checkpoint(str(tmp_path / "ck"))
    sd = get_fp32_state_dict_from_zero_checkpoint(str(tmp_path / "ck"))
    master = dict(zip(engine.param_names, engine.master))
    assert sd.keys() == master.keys()
    assert all(v.dtype == torch.float32 and torch.equal(v, master[k]) for k, v in sd.items())
    pt = convert_zero_checkpoint_to_fp32_state_dict(str(tmp_path / "ck"), str(tmp_path / "out.pt"))
    assert all(torch.equal(v, sd[k]) for k, v in torch.load(pt, weights_only=True).items())
    main([str(tmp_path / "ck"), str(tmp_path / "out"), "--tag", "global_step1"])
    with np.load(tmp_path / "out.npz") as z:
        assert all(np.array_equal(z[k], sd[k].numpy()) for k in sd)
    fresh = load_state_dict_from_zero_checkpoint(_engine(seed=1), str(tmp_path / "ck"))
    assert all(torch.equal(m, master[n]) for n, m in zip(fresh.param_names, fresh.master))
    assert all(torch.equal(p, engine.module.state_dict()[k]) for k, p in fresh.module.state_dict().items())


def test_checkpoint_config_and_engine_selection():
    """``checkpoint`` block: the engine kind, retention, checksum opt-out;
    ``load_universal`` (stored by JAX, never read) raises naming
    ``load_universal_checkpoint``; ``orbax`` (JAX's
    default name) and ``torch`` are the synchronous engine."""
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig, DeepSpeedConfigError
    c = DeepSpeedConfig({"train_batch_size": 2, "checkpoint": {"checkpoint_engine": "async", "keep_last_n": "3",
                                                               "verify_checksums_on_load": False}})
    cc = c.checkpoint_config
    assert (cc.checkpoint_engine, cc.keep_last_n, cc.verify_checksums_on_load) == ("async", 3, False)
    with pytest.raises(NotImplementedError, match="load_universal_checkpoint"):
        DeepSpeedConfig({"train_batch_size": 2, "checkpoint": {"load_universal": True}})
    with pytest.raises(DeepSpeedConfigError):
        DeepSpeedConfig({"train_batch_size": 2, "checkpoint": {"tag_validation": "sometimes"}})
    for name in ("orbax", "torch", None):
        assert type(ce.make_checkpoint_engine(name)) is ce.CheckpointEngine
    assert ce.make_checkpoint_engine("async") is ce.make_checkpoint_engine("nebula")
    ce.wait_for_pending_saves()


@pytest.mark.cuda
def test_checkpoint_moves_between_the_card_and_the_cpu(tmp_path):
    """A checkpoint saved by an engine on the card loads into an engine on
    the CPU and one saved on the CPU into an engine on the card: each
    tensor lands on the loading engine's device, bit for bit, and the
    optimizer keeps working on the engine's own master."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    model = tl.LlamaForCausalLM(TCFG, device="cuda")
    tl.init_weights_(model, torch.Generator(device="cuda").manual_seed(0))
    gpu = tds.initialize(model=model, config=dict(CONFIG), device="cuda")[0]
    for s in range(2):
        gpu.train_batch(batch=_batch(s))
    gpu.save_checkpoint(str(tmp_path / "from_gpu"))
    cpu = _engine(seed=1)
    cpu.load_checkpoint(str(tmp_path / "from_gpu"))
    _assert_state_equal(_state(cpu), _on_cpu(_state(gpu)))
    assert all(t.device.type == "cpu" for t in cpu.optimizer.state[cpu.master[0]].values())
    cpu.train_batch(batch=_batch(2))
    cpu.save_checkpoint(str(tmp_path / "from_cpu"))
    gpu.load_checkpoint(str(tmp_path / "from_cpu"))
    assert all(m.device.type == "cuda" for m in gpu.master)
    assert all(t.device.type == "cuda" for t in gpu.optimizer.state[gpu.master[0]].values())
    _assert_state_equal(_on_cpu(_state(gpu)), _state(cpu))
    assert np.isfinite(float(gpu.train_batch(batch=_batch(3))))
