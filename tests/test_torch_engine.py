"""The serving slice as a whole: the PyTorch port's ``build_engine`` on
weights converted from the JAX package gives the SAME greedy token streams
and the same page accounting as the JAX ``InferenceEngineV2``, on the CPU
in float32, driven through the same calls (``put`` / ``step`` /
``preempt`` / ``flush`` / ``generate``).  Engine and model settings are
those of ``tests/unit/inference/test_inference_v2.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JaxEngineConfig
from deepspeed_tpu.inference.v2 import build_engine as jax_build_engine
from deepspeed_tpu.inference.v2.scheduler import SchedulerConfig as JaxSchedulerConfig
from deepspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu.models.llama_cache import PagedKVConfig as JaxPagedKVConfig
from deepspeed_tpu_torch.inference.v2 import (PagedKVConfig, RaggedInferenceEngineConfig, SchedulerConfig,
                                              build_engine)
from deepspeed_tpu_torch.models.convert import jax_llama_to_state_dict
from deepspeed_tpu_torch.models.llama import LlamaConfig

JCFG = JaxLlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128, rope_theta=1e4,
                      dtype=jnp.float32, scan_layers=True, remat=False)
TCFG = LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                   num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128, rope_theta=1e4,
                   dtype=torch.float32, attention_impl="flash")
KV = dict(num_pages=64, page_size=8, max_pages_per_seq=8)
SCHED = dict(token_budget=64, max_seqs=8, prefill_chunk=8, decode_bucket=4)


@pytest.fixture(scope="module")
def weights():
    variables = jax.jit(JaxLlama(JCFG).init)(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return variables, jax_llama_to_state_dict(jax.tree.map(np.asarray, variables), TCFG)


def _engines(weights, **overrides):
    """The JAX engine (attention_impl="reference") and the port's engine
    (device="cpu"; its K3 op takes the plain version on a CPU tensor) with
    the same settings."""
    variables, state = weights
    jax_eng = jax_build_engine(JCFG, variables, JaxEngineConfig(
        kv=JaxPagedKVConfig(**KV), scheduler=JaxSchedulerConfig(**SCHED), kv_dtype=jnp.float32, **overrides))
    port_eng = build_engine(TCFG, state, RaggedInferenceEngineConfig(
        kv=PagedKVConfig(**KV), scheduler=SchedulerConfig(**SCHED), kv_dtype=torch.float32, **overrides),
                            device="cpu")
    return jax_eng, port_eng


PROMPTS = [[5, 9, 2, 7, 1], [3, 3, 8]]
LONG = [int(t) for t in np.random.default_rng(0).integers(1, 100, size=21)]   # 3 prefill chunks of 8


def _run_until_done(eng, uids, limit=64):
    for _ in range(limit):
        if all(eng.state.seqs[u].done for u in uids):
            return
        eng.step()
    raise AssertionError("engine made no progress")


def _generate(eng, prompts=PROMPTS, n=8):
    return eng.generate(prompts, max_new_tokens=n)


def _join_mid_flight(eng):
    """A sequence admitted while another decodes (continuous batching)."""
    eng.put([100], [[5, 9, 2, 7, 1]], max_new_tokens=7)
    eng.step()
    eng.step()
    eng.put([200], [[11, 4, 6, 2]], max_new_tokens=7)
    _run_until_done(eng, [100, 200])
    out = [list(eng.state.seqs[u].generated) for u in (100, 200)]
    for u in (100, 200):
        eng.flush(u)
    return out


def _preempt_and_requeue(eng):
    """Evict a decoding sequence under (simulated) pressure, then re-put its
    whole history with the remaining budget; its full pages come back from
    the prefix cache when it is on."""
    eng.put([1], [LONG], max_new_tokens=20)
    eng.put([2], [[3, 3, 8]], max_new_tokens=20)
    for _ in range(4):       # 3 prefill chunks of LONG, then one fused decode rung
        eng.step()
    seq = eng.preempt(1)
    done = list(seq.generated)
    assert 0 < len(done) < 20
    eng.put([1], [list(seq.tokens)], max_new_tokens=20 - len(done))
    _run_until_done(eng, [1, 2])
    out = [done + list(eng.state.seqs[1].generated), list(eng.state.seqs[2].generated)]
    eng.flush(1)
    eng.flush(2)
    return out


def _shared_prefix(eng):
    """Prompts sharing a 3-page prefix, admitted one after another: later
    ones attach the first one's pages."""
    prefix = list(range(1, 25))
    out = []
    for i in range(3):
        eng.put([300 + i], [prefix + [30 + i]], max_new_tokens=4)
        _run_until_done(eng, [300 + i])
        out.append(list(eng.state.seqs[300 + i].generated))
    for i in range(3):
        eng.flush(300 + i)
    return out


SCENARIOS = {
    "prefix-cache-on": ({}, _generate),
    "prefix-cache-off": ({"enable_prefix_cache": False}, _generate),
    "splitfuse-long-prompt": ({}, lambda eng: _generate(eng, [LONG, [7, 7]], n=6)),
    "decode-k1": ({"decode_steps_per_dispatch": 1}, _generate),
    "decode-k8-overshoot": ({"decode_steps_per_dispatch": 8}, lambda eng: _generate(eng, n=6)),
    "join-mid-flight": ({}, _join_mid_flight),
    "preempt-requeue": ({}, _preempt_and_requeue),
    "preempt-requeue-cache-off": ({"enable_prefix_cache": False}, _preempt_and_requeue),
    "shared-prefix": ({}, _shared_prefix),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_greedy_streams_identical_to_jax(weights, name):
    overrides, drive = SCENARIOS[name]
    streams, accounting = [], []
    for eng in _engines(weights, **overrides):
        free0 = eng.kv.allocator.free_pages
        streams.append(drive(eng))
        assert not eng.state.seqs, "every sequence was flushed"
        pc = eng.kv.prefix_cache
        cached = pc.cached_pages if pc is not None else 0
        # every page is free again or held (refcount 1) by the prefix cache
        assert eng.kv.allocator.free_pages + cached == free0
        accounting.append((eng.kv.allocator.free_pages, cached))
    assert streams[0] == streams[1], streams
    assert accounting[0] == accounting[1]
    assert all(len(s) > 0 for s in streams[1])


def test_eos_stops_both_engines(weights):
    jax_eng, _ = _engines(weights)
    ref = _generate(jax_eng, [[5, 9, 2, 7, 1]], n=8)[0]
    eos = ref[2]
    streams = [_generate(eng, [[5, 9, 2, 7, 1]], n=8) for eng in _engines(weights, eos_token_id=eos)]
    assert streams[0] == streams[1] == [ref[:3]], (streams, ref)


def test_port_engine_counts_forwards_and_rejects_unported_options(weights):
    _, state = weights
    eng = build_engine(TCFG, state, RaggedInferenceEngineConfig(kv=PagedKVConfig(**KV), kv_dtype=torch.float32,
                                                                 decode_steps_per_dispatch=4), device="cpu")
    eng.generate([[1, 2, 3]], max_new_tokens=5)     # 1 prefill step + 1 fused rung of 4 rounds
    assert eng.forward_calls == 5
    # speculative decoding is ported (tests/test_torch_spec_decode.py);
    # tensor-parallel serving is not
    with pytest.raises(NotImplementedError):
        build_engine(TCFG, state, RaggedInferenceEngineConfig(tensor_parallel=2), device="cpu")
    # KV staging is ported (tests/test_torch_serving_kv_migration.py): it
    # stages a real page and refuses the reserved null page
    assert eng.kv.export_pages(eng.cache, [1]).shape == (TCFG.num_hidden_layers, 1, KV["page_size"], 2,
                                                          TCFG.num_key_value_heads, TCFG.head_dim)
    with pytest.raises(ValueError, match="out of range"):
        eng.kv.export_pages(eng.cache, [0])


def test_configs_mirror_jax_fields():
    """Scheduling settings carry over by name (dtype fields become torch dtypes)."""
    jax_fields = {f.name for f in dataclasses.fields(JaxEngineConfig)}
    port_fields = {f.name for f in dataclasses.fields(RaggedInferenceEngineConfig)}
    assert port_fields <= jax_fields
    assert {f.name for f in dataclasses.fields(SchedulerConfig)} == \
        {f.name for f in dataclasses.fields(JaxSchedulerConfig)}
