"""The training engine's hooks of ROADMAP item 10 on the CPU: the flops
profiler, activation checkpointing and the config keys.

  * ``cost_analysis`` counts 2·M·N·K for a matmul; ``get_model_profile`` the
    MLP of the JAX test (``tests/unit/profiling/test_flops_profiler.py:40``):
    its parameters exactly, its flops within 25% of 2·B·(16·64 + 64·32);
  * a tiny Llama step through the flash op (whose plain version the CPU
    runs) is counted within 10% of ``bench.py``'s 6·N + 12·L·E·S a token,
    and the flash forward and backward formulas count 4·D and 14·D a
    visible pair; the block-sparse ops count their layout's pairs;
  * the engine profiles the step at ``profile_step``: flops, params and
    duration, the printout, and the gauges of ``set_telemetry``'s registry;
  * ``checkpointing.checkpoint`` and the ``activation_checkpointing`` key
    give the gradients of no checkpointing (bit for bit, float32), the
    policy follows JAX's ``_policy_from_config``, ``RNGStatesTracker``
    forks deterministically (on the card unless asked for another device,
    as ``model_parallel_rng_key``), ``partition_activations`` at world > 1
    without a tensor axis is JAX's no-op, ``cpu_checkpointing`` raises
    naming its item;
  * ``comms_logger`` turns the CommsLogger on; the keys still rejected name
    their items (``hybrid_engine`` 5.4, ``eigenvalue`` 7, ``elasticity``
    and ``data_efficiency`` 8).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch
from torch import nn

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.ops.flash_attention import flash_attention
from deepspeed_tpu_torch.ops.sparse_attention.kernel import SparseLayout, sparse_attention_kernel
from deepspeed_tpu_torch.profiling.flops_profiler import cost_analysis, flops_to_string, get_model_profile
from deepspeed_tpu_torch.profiling.flops_profiler.profiler import causal_pairs
from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.telemetry.metrics import MetricsRegistry
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse fixture)

CFG = tl.LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                     num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=256, rope_theta=1e4,
                     dtype=torch.float32, remat=False)


def test_matmul_and_mlp_counts():
    assert cost_analysis(lambda x, y: x @ y, torch.ones(128, 256), torch.ones(256, 512))["flops"] == 2 * 128 * 256 * 512
    mlp = nn.Sequential(nn.Linear(16, 64), nn.ReLU(), nn.Linear(64, 32))
    flops, macs, params = get_model_profile(mlp, args=(torch.ones(8, 16), ), print_profile=False, as_string=False)
    assert params == (16 * 64 + 64) + (64 * 32 + 32) and macs == flops // 2
    assert abs(flops - 2 * 8 * (16 * 64 + 64 * 32)) / (2 * 8 * (16 * 64 + 64 * 32)) < 0.25
    assert "FLOPS" in get_model_profile(mlp, args=(torch.ones(4, 16), ), print_profile=False)[0]
    assert flops_to_string(2.0e9) == "2.00 GFLOPS"


def test_attention_op_formulas():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 128, 4, 64, generator=g, requires_grad=True) for _ in range(3))
    pairs = 2 * 4 * causal_pairs(128, 128)
    assert cost_analysis(flash_attention, q, k, v)["flops"] == 4 * 64 * pairs
    assert cost_analysis(lambda: flash_attention(q, k, v).sum().backward())["flops"] == (4 + 14) * 64 * pairs
    layout = np.zeros((4, 4, 4), bool)
    layout[:, np.arange(4), np.arange(4)] = True
    layout[:, 3, 0] = True
    qs = torch.randn(2, 4, 64, 32, generator=g)
    got = cost_analysis(sparse_attention_kernel, qs, qs, qs, SparseLayout(layout, 16), 16, causal=True)["flops"]
    assert got == 4 * 32 * 2 * 4 * (5 * 16 * 16 - 4 * 16 * 15 // 2)


def test_llama_step_within_ten_percent_of_the_bench_formula():
    """6·N + 12·L·E·S a token against the counted step (forward and
    backward, S 128 through the flash op's plain version)."""
    model = tl.init_weights_(tl.LlamaForCausalLM(CFG, device="cpu"), torch.Generator().manual_seed(0))
    eng = tds.initialize(model=model, config={"train_batch_size": 2, "flops_profiler": {"enabled": True,
                                                                                           "profile_step": 0}},
                         device="cpu")[0]
    ids = np.random.default_rng(0).integers(0, 256, (2, 128)).astype(np.int64)
    eng.train_batch(batch={"input_ids": ids, "labels": ids})
    n = sum(p.numel() for p in eng.params)
    want = ids.size * (6 * n + 12 * CFG.num_hidden_layers * CFG.hidden_size * 128)
    assert abs(eng.flops_profiler.get_total_flops() - want) / want < 0.10


def test_engine_profiles_its_step_and_publishes_gauges(capsys):
    model = tl.init_weights_(tl.LlamaForCausalLM(CFG, device="cpu"), torch.Generator().manual_seed(0))
    eng = tds.initialize(model=model, config={"train_batch_size": 2, "flops_profiler": {"enabled": True}},
                         device="cpu")[0]
    registry = MetricsRegistry()
    eng.set_telemetry(metrics=registry)
    ids = np.random.default_rng(1).integers(0, 256, (2, 16)).astype(np.int64)
    for _ in range(3):
        eng.train_batch(batch={"input_ids": ids, "labels": ids})
    prof = eng.flops_profiler
    assert prof.get_total_flops() > 0 and prof.get_total_params() == sum(p.numel() for p in eng.params)
    assert prof.get_total_duration() > 0 and not prof.started
    out = capsys.readouterr().out
    assert "Flops Profiler" in out and "Profile Summary at step 1:" in out
    assert registry.gauge("profiler/flops_per_step").value == prof.get_total_flops()
    assert registry.gauge("profiler/params").value == prof.get_total_params()


def test_checkpointing_gives_the_gradients_of_no_checkpointing():
    block = nn.Sequential(nn.Linear(32, 64), nn.GELU(), nn.Linear(64, 32))
    x = torch.randn(4, 32, generator=torch.Generator().manual_seed(2), requires_grad=True)
    want = torch.autograd.grad(block(x).square().sum(), [x, *block.parameters()])
    for num_checkpoints in (None, 2):
        checkpointing.configure(num_checkpoints=num_checkpoints)
        for fn in (lambda: checkpointing.checkpoint(block, x), lambda: checkpointing.checkpoint_wrapper(block)(x),
                   lambda: checkpointing.non_reentrant_checkpoint(block, x)):
            got = torch.autograd.grad(fn().square().sum(), [x, *block.parameters()])
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    checkpointing.reset()
    assert checkpointing.checkpoint_name(x) is x and not checkpointing.is_configured()


def test_activation_checkpointing_key_maps_onto_the_remat_policy():
    """JAX ``_policy_from_config``: nothing saved by default, the matmul
    outputs with ``number_checkpoints``; the engine's losses and gradients
    equal a model without remat."""
    c = DeepSpeedConfig({"train_batch_size": 2, "activation_checkpointing": {"number_checkpoints": 4}})
    assert checkpointing.policy_from_config(c.activation_checkpointing_config) == "flash_saveable"
    assert checkpointing.policy_from_config(None) == "nothing_saveable"
    ids = np.random.default_rng(3).integers(0, 256, (2, 128)).astype(np.int64)
    grads = []
    for extra in ({}, {"activation_checkpointing": {"number_checkpoints": 4}},
                  {"activation_checkpointing": {"partition_activations": True}}):
        model = tl.init_weights_(tl.LlamaForCausalLM(CFG, device="cpu"), torch.Generator().manual_seed(0))
        eng = tds.initialize(model=model, config={"train_batch_size": 2, **extra}, device="cpu")[0]
        loss = eng.forward({"input_ids": ids, "labels": ids})
        grads.append([loss.detach()] + list(torch.autograd.grad(loss, eng.params)))
        if extra:
            policy = "flash_saveable" if "number_checkpoints" in extra["activation_checkpointing"] else \
                "nothing_saveable"
            assert eng.module.cfg.remat and eng.module.cfg.remat_policy == policy
    for other in grads[1:]:
        assert all(torch.allclose(a, b, rtol=1e-6, atol=1e-7) for a, b in zip(other, grads[0]))
    with pytest.raises(NotImplementedError, match="item 8"):
        DeepSpeedConfig({"train_batch_size": 2, "activation_checkpointing": {"cpu_checkpointing": True}})


def test_partition_activations_at_world_above_one_raises(monkeypatch):
    """At world > 1 without a tensor axis ``partition_activations`` is JAX's
    no-op: ``configure`` no longer raises (the activation partitions over
    tensor ranks are ported, ``tests/test_torch_zoo_tensor_parallel.py``),
    and ``checkpoint`` gives the function's value and gradients exactly."""
    monkeypatch.setattr(comm, "get_world_size", lambda *a, **k: 2)
    checkpointing.configure(partition_activations=True)
    try:
        w = torch.randn(8, 4, generator=torch.Generator().manual_seed(1), requires_grad=True)
        x = torch.randn(3, 8, generator=torch.Generator().manual_seed(2))
        fn = lambda w, x: torch.tanh(x @ w).square().sum()
        want, (want_g, ) = fn(w, x), torch.autograd.grad(fn(w, x), [w])
        got = checkpointing.checkpoint(fn, w, x)
        assert torch.equal(got, want) and torch.equal(torch.autograd.grad(got, [w])[0], want_g)
    finally:
        checkpointing.reset()


def test_rng_tracker_forks_deterministically():
    tracker = checkpointing.model_parallel_cuda_manual_seed(7)
    states = tracker.get_states()
    a = [torch.rand(3, generator=tracker.fork(device="cpu")) for _ in range(2)]
    assert not torch.equal(a[0], a[1])
    tracker.set_states(states)
    assert all(torch.equal(x, torch.rand(3, generator=tracker.fork(device="cpu"))) for x in a)
    with pytest.raises(Exception, match="already exists"):
        tracker.add("data-parallel-rng", 1)


def test_rng_tracker_fork_and_model_parallel_rng_key_default_to_the_card():
    """An entry point makes its generator on the card unless the caller
    names another device: without one, ``fork()`` and
    ``model_parallel_rng_key`` raise rather than hand back a CPU generator."""
    tracker = checkpointing.model_parallel_cuda_manual_seed(7)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tracker.fork()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        checkpointing.model_parallel_rng_key(3)
    assert tracker.fork(device="cpu").device.type == "cpu"


def test_model_parallel_rng_key_without_a_tensor_axis_is_the_seed_s_stream():
    """Outside a tensor axis of more than one rank, JAX's key is
    ``PRNGKey(seed)``: the port's is ``seed``'s own generator."""
    got = torch.rand(4, generator=checkpointing.model_parallel_rng_key(11, device="cpu"))
    assert torch.equal(got, torch.rand(4, generator=torch.Generator().manual_seed(11)))


def test_comms_logger_key_and_the_items_of_the_rejected_keys(monkeypatch):
    monkeypatch.setattr(comm, "_COMMS_LOGGER", None)
    model = tl.init_weights_(tl.LlamaForCausalLM(CFG, device="cpu"), torch.Generator().manual_seed(0))
    tds.initialize(model=model, config={"train_batch_size": 2, "comms_logger": {"enabled": True, "verbose": True,
                                                                                "prof_ops": ["all_reduce"]}},
                   device="cpu")
    logger = comm.comms_logger()
    assert logger is not None and logger.verbose and logger.prof_ops == ["all_reduce"]
    for key, item in (("hybrid_engine", "item 5.4"), ("eigenvalue", "item 7"), ("elasticity", "item 8"),
                      ("data_efficiency", "item 8")):
        with pytest.raises(NotImplementedError, match=item):
            DeepSpeedConfig({"train_batch_size": 2, key: {"enabled": True, "x": 1}})
    assert math.isclose(DeepSpeedConfig({"train_batch_size": 2, "flops_profiler": {"enabled": True,
                                                                                    "recompute_fwd_factor": 0.5}})
                        .flops_profiler_config.recompute_fwd_factor, 0.5)
