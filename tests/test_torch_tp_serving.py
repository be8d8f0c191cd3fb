"""Tensor-parallel serving of the Llama family (``inference/v2/engine_v2.py``
over ``tensor_parallel`` ranks, ``models/llama_cache.py``'s sharded twin,
``compile_aot_serving``), the vocab-parallel loss and embedding
(``module_inject/layers.py``, ``models/llama.py``) and Domino
(``runtime/domino``), against the JAX package on the CPU.

  * The scenarios of JAX's ``tests/unit/inference/test_tp_serving.py`` at
    tensor 2 and tensor 3 (gloo ranks: one spawn of 3, then ranks 0-1
    re-form a 2-rank group; run while JAX computes): greedy tokens equal to
    JAX's single-device engine, JAX's TP engine at the same degree, and the
    port's one-rank engine, on every rank; the fused decode rung; a join
    mid-flight; ``tensor_parallel=`` building the group (tensor 3) and an
    explicit mesh (tensor 2); a degree that does not divide the kv heads
    raises, as JAX's.  Float32 (vocab 96, hidden 48, 12:6 heads), so the
    streams are equal token for token.
  * ``compile_aot_serving``: ``n_params`` equals JAX's, and a rank's
    parameter and arena bytes equal the sum of JAX's ``shard_shape`` over
    the same leaves, at the tiny size (tensor 2 and 3) and for Llama-3-8B at
    tensor 8 (``jax.eval_shape``: nothing compiled or allocated).
  * Domino at tensor 2: µ-batch chunks equal one chunk (within 1e-6) and
    JAX's ``DominoTransformer`` on the same weights (float32, within 1e-5
    of the output's largest magnitude).
  * The vocab-parallel loss (with and without a ``loss_mask``) and
    embedding, forward and backward, at tensor 2 against the one-rank ones
    (rtol 1e-6, gradients within 1e-7 absolute).
  * What is not ported at tensor > 1 raises naming ROADMAP item 6.2:
    int8 weights (JAX's message), speculative decoding, BERT in the v1
    engine.

JAX is imported only inside the tests, so the ranks start without it.
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.comm.mesh import MESH_AXES, Mesh
from deepspeed_tpu_torch.inference.v2 import (PagedKVConfig, RaggedInferenceEngineConfig, SchedulerConfig, build_engine,
                                              compile_aot_serving)
from deepspeed_tpu_torch.models import llama as tl

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "unit"))

from test_torch_qgz import run_ranks  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: F401,E402 (autouse fixture)

SHAPE = dict(vocab_size=96, hidden_size=48, intermediate_size=96, num_hidden_layers=2, num_attention_heads=12,
             num_key_value_heads=6, max_position_embeddings=128, rope_theta=1e4)
CFG = tl.LlamaConfig(**SHAPE, dtype=torch.float32, attention_impl="flash")
KV = dict(num_pages=64, page_size=8, max_pages_per_seq=8)
SCHED = dict(token_budget=64, max_seqs=8, prefill_chunk=8, decode_bucket=4)
PROMPTS = [[5, 9, 2, 7, 1], [3, 3, 8], [11, 4, 4, 4, 9, 2]]
DOMINO = dict(num_layers=2, hidden_size=48, num_attention_heads=12, ffn_hidden_size=96)


def _econf(**overrides):
    return RaggedInferenceEngineConfig(kv=PagedKVConfig(**KV), scheduler=SchedulerConfig(**SCHED),
                                       kv_dtype=torch.float32, **overrides)


def _mesh(tensor: int, data: int = 1) -> Mesh:
    return Mesh({**dict.fromkeys(MESH_AXES, 1), "data": data, "tensor": tensor})


# ------------------------------------------------------------------ scenarios (both packages)

def _generate(eng):
    return eng.generate(PROMPTS, max_new_tokens=6)


def _fused(eng):
    return eng.generate(PROMPTS, max_new_tokens=8)


def _join(eng):
    """A sequence admitted while another decodes (JAX ``test_tp2_continuous_batching_join_mid_flight``)."""
    eng.put([0], [PROMPTS[0]], max_new_tokens=6)
    for _ in range(3):
        eng.step()
    eng.put([1], [PROMPTS[1]], max_new_tokens=6)
    while not all(s.done for s in eng.state.seqs.values()):
        eng.step()
    return [list(eng.state.seqs[u].generated) for u in (0, 1)]


#: name → (engine config overrides, drive)
SCENARIOS = {"generate": ({}, _generate), "fused-k4": ({"decode_steps_per_dispatch": 4}, _fused),
             "join-mid-flight": ({}, _join)}


# ------------------------------------------------------------------ the ranks

def _serve(state, tp, mesh):
    from deepspeed_tpu_torch.comm import comm
    out = {}
    for name, (over, drive) in SCENARIOS.items():
        comm.tensor_parallel_kinds.clear()
        eng = build_engine(CFG, state, _econf(**over, tensor_parallel=1 if mesh else tp), device="cpu",
                           mesh=_mesh(tp) if mesh else None)
        out[name] = {"tokens": drive(eng), "forwards": eng.forward_calls,
                     "kinds": dict(comm.tensor_parallel_kinds), "arena": tuple(eng.cache[0].shape),
                     "q_rows": tuple(eng.model.layers[0].self_attn.q_proj.weight.shape)}
    return out


def _loss_and_embed(rank, inputs):
    """The vocab-parallel loss and embedding at tensor 2 on this rank, and
    the one-rank ones on the same inputs."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.module_inject.layers import TensorParallel, vocab_parallel_embed
    from deepspeed_tpu_torch.utils import groups
    logits, labels, mask, ids, table = (torch.from_numpy(a) for a in inputs)
    tp = TensorParallel(2, groups.get_tensor_model_parallel_rank(), groups.get_tensor_model_parallel_group())
    v = logits.shape[-1] // 2
    out = {}
    for name, m in (("plain", None), ("masked", mask)):
        whole = logits.clone().requires_grad_(True)
        want = tl.causal_lm_loss(whole, labels, m)
        want.backward()
        mine = logits[..., tp.rank * v:(tp.rank + 1) * v].clone().requires_grad_(True)
        got = tl.causal_lm_loss(mine, labels, m, tp=tp)
        got.backward()
        out[name] = {"loss": (float(got), float(want)),
                     "grad": (mine.grad.numpy(), whole.grad[..., tp.rank * v:(tp.rank + 1) * v].numpy())}
    rows = table.shape[0] // 2
    whole = table.clone().requires_grad_(True)
    w = torch.arange(ids.numel() * table.shape[1], dtype=torch.float32).reshape(ids.shape + (table.shape[1], ))
    (F.embedding(ids, whole) * w).sum().backward()
    mine = table[tp.rank * rows:(tp.rank + 1) * rows].clone().requires_grad_(True)
    emb = vocab_parallel_embed(ids, mine, tp)
    (emb * w).sum().backward()
    out["embed"] = {"out": (emb.detach().numpy(), F.embedding(ids, table).numpy()),
                    "grad": (mine.grad.numpy(), whole.grad[tp.rank * rows:(tp.rank + 1) * rows].numpy())}
    return out


def _domino(rank, params, x):
    from deepspeed_tpu_torch.module_inject.layers import TensorParallel
    from deepspeed_tpu_torch.runtime.domino import DominoTransformer
    from deepspeed_tpu_torch.utils import groups
    tp = TensorParallel(2, groups.get_tensor_model_parallel_rank(), groups.get_tensor_model_parallel_group())
    out = {}
    for mb in (1, 2):
        model = DominoTransformer(**DOMINO, micro_batches=mb, tp=tp).load_jax_params(params)
        out[mb] = model(torch.from_numpy(x)).detach().numpy()
    return out


def _seeded_state(tensor_parallel: int = 1):
    """A seeded twin's state dict: whole, or this rank's slices of the same
    draws (``init_weights_`` over a model built with ``tensor_parallel``)."""
    from deepspeed_tpu_torch.models.llama_cache import LlamaForCausalLMWithCache
    model = LlamaForCausalLMWithCache(CFG, page_size=KV["page_size"], device="cpu", tensor_parallel=tensor_parallel)
    return tl.init_weights_(model, torch.Generator().manual_seed(5)).state_dict()


def _raises(state):
    from deepspeed_tpu_torch.inference.quantization import quantize_inference_params
    from deepspeed_tpu_torch.inference.v2 import SpecConfig
    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch.models.bert import BertConfig, BertForMaskedLM
    raised = {}
    bert = BertConfig(vocab_size=96, hidden_size=48, num_hidden_layers=1, num_attention_heads=4, intermediate_size=96,
                      max_position_embeddings=64, dtype=torch.float32)
    calls = {"int8": lambda: build_engine(CFG, quantize_inference_params(state, cfg=CFG), _econf(tensor_parallel=2),
                                          device="cpu"),
             "spec": lambda: build_engine(CFG, state, _econf(tensor_parallel=2, spec=SpecConfig(max_draft=2)),
                                          device="cpu"),
             "v1-bert": lambda: tds.init_inference(model=BertForMaskedLM(bert, device="cpu"),
                                                   config={"tensor_parallel": {"tp_size": 2}}, device="cpu")}
    for name, call in calls.items():
        try:
            call()
            raised[name] = None
        except NotImplementedError as e:
            raised[name] = str(e)
    return raised


def _rank(rank, state, init2, loss_inputs, domino):
    from deepspeed_tpu_torch.comm import comm
    out = {3: _serve(state, 3, mesh=False)}
    comm.barrier()
    torch.distributed.destroy_process_group()
    if rank == 2:
        return out
    comm.init_distributed(dist_backend="gloo", init_method=init2, rank=rank, world_size=2, verbose=False)
    out[2] = _serve(state, 2, mesh=True)
    out["seeded"] = _generate(build_engine(CFG, _seeded_state(2), _econf(tensor_parallel=2), device="cpu"))
    out["raised"] = _raises(state)
    out["loss"] = _loss_and_embed(rank, loss_inputs)
    out["domino"] = _domino(rank, *domino)
    return out


# ------------------------------------------------------------------ JAX side

def _jax_cfg():
    import jax.numpy as jnp
    from deepspeed_tpu.models.llama import LlamaConfig
    return LlamaConfig(**SHAPE, dtype=jnp.float32, scan_layers=True, remat=False)


def _jax_engine(variables, mesh=None, **overrides):
    import jax.numpy as jnp
    from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JaxEngineConfig
    from deepspeed_tpu.inference.v2 import build_engine as jax_build_engine
    from deepspeed_tpu.inference.v2.scheduler import SchedulerConfig as JaxSchedulerConfig
    from deepspeed_tpu.models.llama_cache import PagedKVConfig as JaxPagedKVConfig
    return jax_build_engine(_jax_cfg(), variables, JaxEngineConfig(kv=JaxPagedKVConfig(**KV),
                                                                   scheduler=JaxSchedulerConfig(**SCHED),
                                                                   kv_dtype=jnp.float32, **overrides), mesh=mesh)


def _jax_tp_mesh(tp: int):
    import jax
    from deepspeed_tpu.comm.mesh import MeshSpec, create_mesh
    return create_mesh(MeshSpec(data=1, tensor=tp), devices=jax.devices()[:tp])


def _jax_streams(variables):
    """JAX's streams: every scenario on one device, and generate at tensor 2 and 3."""
    out = {"single": {name: drive(_jax_engine(variables, **over)) for name, (over, drive) in SCENARIOS.items()}}
    for tp in (2, 3):
        out[tp] = _generate(_jax_engine(variables, mesh=_jax_tp_mesh(tp)))
    return out


def _domino_inputs():
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.runtime.domino import DominoTransformer as JaxDomino
    x = np.random.default_rng(4).standard_normal((4, 8, DOMINO["hidden_size"])).astype(np.float32)
    model = JaxDomino(**DOMINO, micro_batches=2, dtype=jnp.float32)
    from flax import linen as nn
    params = nn.meta.unbox(model.init(jax.random.PRNGKey(3), jnp.asarray(x)))["params"]
    want = np.asarray(jax.jit(lambda p, v: model.apply({"params": p}, v))(params, jnp.asarray(x)))
    return jax.tree.map(np.asarray, params), x, want


@pytest.fixture(scope="module")
def seeded():
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from deepspeed_tpu_torch.models.convert import jax_llama_to_state_dict
    variables = jax.jit(JaxLlama(_jax_cfg()).init)(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    state = {k: v.numpy() for k, v in jax_llama_to_state_dict(jax.tree.map(np.asarray, variables), CFG).items()}
    return variables, state


@pytest.fixture(scope="module")
def runs(tmp_path_factory, seeded):
    variables, state = seeded
    rng = np.random.default_rng(6)
    loss_inputs = (rng.standard_normal((2, 5, 96)).astype(np.float32), rng.integers(0, 96, (2, 5)),
                   (rng.random((2, 5)) > 0.3).astype(np.float32), rng.integers(0, 96, (3, 4)),
                   rng.standard_normal((96, 8)).astype(np.float32))
    domino = _domino_inputs()
    spawn_dir = tmp_path_factory.mktemp("tp_serving")
    ranks = {}

    def spawn():
        try:
            ranks["out"] = run_ranks(str(spawn_dir), _rank, state, f"file://{spawn_dir}/rendezvous2", loss_inputs,
                                     domino[:2], world=3)
        except BaseException as e:
            ranks["error"] = e

    thread = threading.Thread(target=spawn)
    thread.start()
    try:
        jax_streams = _jax_streams(variables)
        one = {name: drive(build_engine(CFG, state, _econf(**over), device="cpu"))
               for name, (over, drive) in SCENARIOS.items()}
        one["seeded"] = _generate(build_engine(CFG, _seeded_state(), _econf(), device="cpu"))
    finally:
        thread.join()
    if "error" in ranks:
        raise ranks["error"]
    return {"ranks": ranks["out"], "jax": jax_streams, "one": one, "domino": domino}


# ------------------------------------------------------------------ serving

@pytest.mark.parametrize("tp", [2, 3])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_tp_greedy_streams_equal_jax_and_one_rank(name, tp, runs):
    """Every rank's greedy tokens equal the JAX single-device engine's and
    the port's one-rank engine's (and JAX's TP engine's where it ran the
    scenario); each rank holds 1/tp of the q rows and of the arena's kv
    heads, and a forward runs 2 all-reduces a layer, the embedding's and
    the logits gather."""
    ranks = [r[tp][name] for r in runs["ranks"][:tp]]
    want = runs["jax"]["single"][name]
    assert runs["one"][name] == want
    if name == "generate":
        assert runs["jax"][tp] == want
    for r in ranks:
        assert r["tokens"] == want, (r["tokens"], want)
        assert r["arena"][3] == SHAPE["num_key_value_heads"] // tp
        assert r["q_rows"] == (SHAPE["hidden_size"] // tp, SHAPE["hidden_size"])
        forwards = r["forwards"]
        assert r["kinds"] == {("embed", "forward"): forwards, ("o_proj", "forward"): 2 * forwards,
                              ("down_proj", "forward"): 2 * forwards, ("logits", "forward"): forwards}


def test_ranks_seeded_with_their_slices_serve_as_one_rank(runs):
    """Ranks that build their slices from the seeded generator (each tensor
    drawn whole, the rank's slice kept; a rank's coordinate from its process
    group rank) serve the one-rank engine's tokens of the same seed."""
    for r in runs["ranks"][:2]:
        assert r["seeded"] == runs["one"]["seeded"]


def test_degree_that_does_not_divide_the_kv_heads_raises(seeded):
    """Tensor 4 over 6 kv heads raises, in both packages (JAX ``test_tp4_greedy_parity_flash_kernel``)."""
    variables, state = seeded
    with pytest.raises(ValueError, match="must divide"):
        build_engine(CFG, state, _econf(tensor_parallel=4), device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        build_engine(CFG, state, _econf(), device="cpu", mesh=_mesh(4))
    with pytest.raises(ValueError, match="must divide"):
        _jax_engine(variables, mesh=_jax_tp_mesh(4))
    with pytest.raises(ValueError, match="no 'tensor' axis"):
        build_engine(CFG, state, _econf(), device="cpu", mesh=_mesh(1, data=2))


def test_unported_raise_naming_item_6_2(runs):
    raised = runs["ranks"][0]["raised"]
    for name, msg in raised.items():
        assert msg is not None and "item 6.2" in msg, (name, msg)
    assert "weight-only-quantized" in raised["int8"]


# ------------------------------------------------------------------ the budget

def _jax_shard_bytes(cfg, tp: int, kv_dtype, page_size=KV["page_size"]):
    """JAX's serving shardings at tensor ``tp`` (``_serving_shardings``): the
    parameter count, and a device's parameter and arena bytes from each
    leaf's ``shard_shape``."""
    import jax
    from deepspeed_tpu.inference.v2.engine_v2 import _serving_shardings
    from deepspeed_tpu.inference.v2.engine_v2 import build_cache_model as jax_build_cache_model
    from deepspeed_tpu.models.llama_cache import PagedKVConfig as JaxPagedKVConfig
    from flax import linen as nn
    kvcfg = JaxPagedKVConfig(**KV)
    abs_vars, cache_abs, param_sh, cache_sh, _ = _serving_shardings(jax_build_cache_model(cfg, page_size), cfg, kvcfg,
                                                                    kv_dtype, _jax_tp_mesh(tp))
    leaves = jax.tree.leaves(nn.meta.unbox(abs_vars))
    shardings = jax.tree.leaves(param_sh)
    param_bytes = sum(int(np.prod(sh.shard_shape(l.shape))) * l.dtype.itemsize for l, sh in zip(leaves, shardings))
    arena = int(np.prod(cache_sh.shard_shape(cache_abs.shape))) * cache_abs.dtype.itemsize
    return sum(int(np.prod(l.shape)) for l in leaves), param_bytes, arena


@pytest.mark.parametrize("tp", [2, 3])
def test_aot_budget_equals_jax_shard_shapes_tiny(tp):
    """At the tiny size: ``n_params`` equals JAX's ``compile_aot_serving``'s
    (tensor 2) and its leaves' count; a rank's parameter and arena bytes
    equal the sum of JAX's shard shapes; the batch arrays are the step's
    four int32 arrays."""
    import jax.numpy as jnp
    budget, n_params = compile_aot_serving(CFG, _mesh(tp), _econf(), batch=4, chunk=1)
    n, param_bytes, arena = _jax_shard_bytes(_jax_cfg(), tp, jnp.float32)
    assert (n_params, budget.param_bytes, budget.arena_bytes) == (n, param_bytes, arena)
    assert budget.batch_bytes == 4 * (4 + 4 + 4 * KV["max_pages_per_seq"] + 4)
    assert budget.argument_size_in_bytes == budget.param_bytes + budget.arena_bytes + budget.batch_bytes
    if tp == 2:
        from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JaxEngineConfig
        from deepspeed_tpu.inference.v2 import compile_aot_serving as jax_compile_aot_serving
        from deepspeed_tpu.models.llama_cache import PagedKVConfig as JaxPagedKVConfig
        _, jax_n = jax_compile_aot_serving(_jax_cfg(), _jax_tp_mesh(2),
                                           JaxEngineConfig(kv=JaxPagedKVConfig(**KV), kv_dtype=jnp.float32),
                                           batch=4, chunk=1)
        assert n_params == jax_n


def test_aot_budget_llama3_8b_at_tensor_8():
    """Llama-3-8B at tensor 8, reckoned without a card or an allocation:
    the port's rank bytes equal the sum of JAX's shard shapes (parameters
    in float32, the arena in bf16)."""
    import jax.numpy as jnp
    from deepspeed_tpu.models.llama import PRESETS as JAX_PRESETS
    cfg = tl.PRESETS["llama3-8b"]
    econf = RaggedInferenceEngineConfig(kv=PagedKVConfig(**KV))
    budget, n_params = compile_aot_serving(cfg, _mesh(8), econf, batch=8, chunk=1)
    n, param_bytes, arena = _jax_shard_bytes(JAX_PRESETS["llama3-8b"], 8, jnp.bfloat16)
    assert (n_params, budget.param_bytes, budget.arena_bytes) == (n, param_bytes, arena)
    assert n_params == 8_030_261_248


def test_k3_split_choice_at_a_rank_s_heads():
    """K3 picks its decode split from the heads it is given: Llama-3-8B's
    8 decode rows at a rank's 16:4 heads make 32 row tiles, which grow to
    the key cap of 8 splits (7 at the whole model's 32:8, 64 tiles); the
    split route's plain partials and merge at 16:4 equal the plain
    attention (float32, within 1e-5)."""
    from deepspeed_tpu_torch.models.llama_cache import paged_attention
    from deepspeed_tpu_torch.ops import paged_attention as op
    cap = 128 * 16
    assert op.choose_n_split(8, 1, 16, 4, 128, cap) == 8
    assert op.choose_n_split(8, 1, 32, 8, 128, cap) == 7
    rng = np.random.default_rng(8)
    b, h, n_kv, d, page, max_pages = 8, 16, 4, 16, 16, 32
    q = torch.from_numpy(rng.standard_normal((b, 1, h, d)).astype(np.float32))
    pages = torch.from_numpy(rng.standard_normal((1 + b * max_pages, page, 2, n_kv, d)).astype(np.float32))
    table = torch.arange(1, 1 + b * max_pages, dtype=torch.int32).reshape(b, max_pages)
    start = torch.from_numpy(rng.integers(1, max_pages * page - 1, b).astype(np.int32))
    lens = torch.ones(b, dtype=torch.int32)
    n = op.choose_n_split(b, 1, h, n_kv, d, max_pages * page)
    m, l, o = op.paged_attention_partials_plain(q, pages, table, start, lens, page, n)
    got = op.merge_partials_plain(m, l, o, lens)
    want = paged_attention(q, pages, table, start, lens, page)
    assert n > 1
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ layers

def test_domino_chunks_equal_one_chunk_and_jax(runs):
    want = runs["domino"][2]
    scale = float(np.abs(want).max())
    for r in runs["ranks"][:2]:
        got = r["domino"]
        np.testing.assert_allclose(got[2], got[1], rtol=0, atol=1e-6 * scale)
        np.testing.assert_allclose(got[2], want, rtol=0, atol=1e-5 * scale)


def test_domino_one_rank_equals_jax(runs):
    """At tensor 1 the same weights (whole) give JAX's output."""
    from deepspeed_tpu_torch.runtime.domino import DominoTransformer
    params, x, want = runs["domino"]
    got = DominoTransformer(**DOMINO, micro_batches=2).load_jax_params(params)(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("which", ["plain", "masked", "embed"])
def test_vocab_parallel_loss_and_embedding_equal_one_rank(which, runs):
    for r in runs["ranks"][:2]:
        res = r["loss"][which]
        if which == "embed":
            np.testing.assert_array_equal(*res["out"])
        else:
            np.testing.assert_allclose(*res["loss"], rtol=1e-6)
        np.testing.assert_allclose(*res["grad"], rtol=1e-6, atol=1e-7)
