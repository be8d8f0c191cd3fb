"""MoE and q/k/v biases at tensor > 1 (``moe/{experts,layer,sharded_moe,
mappings}.py``, ``models/{mixtral,qwen2_moe,mixtral_cache,cache_zoo}.py``,
``module_inject/{layers,tp_rules}.py``, ``models/convert.py``, the engine
and ``runtime/zero`` with banks held over ``(expert, tensor)``, the v2
engine's tensor-parallel serving), against the JAX package on the CPU, on
the same numpy-seeded float32 weights and inputs.

  * **Layouts** (no spawn): tiny Mixtral at ``MeshSpec(data=3, tensor=2)``
    (4 experts) and ``MeshSpec(expert=3, tensor=2)`` (6 experts), tiny
    Qwen2-MoE with q/k/v biases at ``data=3, tensor=2``, stages 0-3: every
    leaf's spec and every rank's slice equal JAX's shardings (its
    ``tp_rules`` and ``runtime/zero/partition`` functions, which its engine's
    ``_materialize_state`` applies to the abstract tree); a slice's partition
    within the ranks that share its held coordinates cuts the same slices.
    A q/k/v bias is the one difference: JAX keeps its leaf whole, the port
    holds its heads' slice (``tensor`` on the heads dim).
  * **Training** (one spawn of 6 gloo ranks, run while JAX computes): the
    three cases at stages 0 and 3, 3 AdamW steps with clipping, against the
    JAX engine at the same ``MeshSpec``: losses and the eval loss within
    rtol 1e-5 and equal on every rank; parameters within 2e-5 on all but
    1e-3 of the entries and within 6·lr everywhere (Adam moves an entry by
    about lr whatever its gradient); the replicated tensors (router, norms)
    bit-identical over each tensor group.  The first MoE layer on each
    rank's rows at ``data=3, tensor=2`` and ``expert=3, tensor=2``: output
    within 1e-5 of its largest magnitude, ``l_aux`` within rtol 1e-5 and
    ``exp_counts`` exact against JAX's layer under the same mesh.
  * **Checkpoints**: saved at expert 3 × tensor 2, stage 3, loaded by one
    rank: whole tensors identical; universal atoms with JAX's names and
    shapes.
  * **The layer case of JAX** ``tests/unit/moe/test_moe.py:95-135`` on 4
    ranks at ``expert=2, tensor=2`` against the single-device layer:
    output within atol = rtol = 2e-5, ``l_aux`` within rtol 0.2 (the groups
    differ), gradients within atol 3e-5 and rtol 2e-4.
  * ``drop_tokens``/``gather_tokens`` at tensor 2, forward and backward.
  * **Serving**: the Mixtral and Qwen2-MoE twins at tensor 2 and 3 (ranks
    0-2, then 0-1, re-formed) emit JAX's greedy tokens from
    ``build_engine(..., mesh=create_mesh(MeshSpec(data=1, tensor=N)))`` on
    every rank, with one o_proj and one MoE all-reduce a layer.
  * ``compile_aot_serving``: Mixtral-8x7B's rank bytes at tensor 8 equal the
    sum of JAX's ``shard_shape``s; the tiny twins' at tensor 2 too, less the
    q/k/v biases' slices JAX keeps whole.
  * The chip phases' reckonings, and what stays out of scope raising naming
    ROADMAP item 6.2.

JAX is imported only inside the tests, so the ranks start without it.
"""

import dataclasses
import os
import sys
import threading

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.comm.mesh import MESH_AXES, Mesh
from deepspeed_tpu_torch.inference.v2 import (PagedKVConfig, RaggedInferenceEngineConfig, SchedulerConfig, build_engine,
                                              compile_aot_serving)
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models import mixtral as tmix
from deepspeed_tpu_torch.models import qwen2_moe as tqwen
from deepspeed_tpu_torch.models.convert import jax_leaves
from deepspeed_tpu_torch.module_inject.tp_rules import param_shardings
from deepspeed_tpu_torch.runtime.zero import grad_shardings, master_and_optstate_shardings

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "unit"))

from test_torch_qgz import run_ranks  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: F401,E402 (autouse fixture)

ROWS, SEQ, STEPS, LR, CLIP = 12, 16, 3, 1e-2, 0.5
#: the tiny Mixtral preset with a vocab and a width that stage 3 can shard (over tensor × data and data)
MIXTRAL = dict(vars(tmix.PRESETS["tiny"]), vocab_size=96, hidden_size=48)
QWEN = dict(vocab_size=96, hidden_size=48, intermediate_size=96, moe_intermediate_size=48,
            shared_expert_intermediate_size=96, num_hidden_layers=2, num_attention_heads=6, num_key_value_heads=6,
            num_experts=4, num_experts_per_tok=2, max_position_embeddings=128, qkv_bias=True)
#: the serving Mixtral: 6:6 heads and an expert width that 2 and 3 divide
MIXTRAL_SERVE = dict(MIXTRAL, intermediate_size=96, num_attention_heads=6, num_key_value_heads=6,
                     max_position_embeddings=128)
MODEL_FIELDS = ("dtype", "param_dtype", "attention_impl", "remat", "remat_policy")
#: case → (family, experts, data, expert, tensor)
CASES = {"mix-d3t2": ("mixtral", 4, 3, 1, 2), "mix-e3t2": ("mixtral", 6, 1, 3, 2), "qwen-d3t2": ("qwen", 4, 3, 1, 2)}
STAGES = (0, 3)
KV = dict(num_pages=64, page_size=8, max_pages_per_seq=8)
SCHED = dict(token_budget=64, max_seqs=8, prefill_chunk=8, decode_bucket=4)
PROMPTS = [[5, 9, 2, 7, 1], [3, 3, 8], [11, 4, 4, 4, 9, 2]]
NEW = 6
#: the layer of JAX ``test_tp_ep_mesh_matches_single_device``
LAYER = dict(hidden_size=32, num_experts=4, intermediate_size=64, k=2, capacity_factor=4.0)


def _fields(fields):
    return {k: v for k, v in fields.items() if k not in MODEL_FIELDS}


def _cfg(case: str):
    family, experts = CASES[case][:2]
    if family == "mixtral":
        return tmix.MixtralConfig(**dict(_fields(MIXTRAL), num_local_experts=experts), dtype=torch.float32,
                                  attention_impl="reference")
    return tqwen.Qwen2MoeConfig(**_fields(QWEN), dtype=torch.float32, attention_impl="reference")


def _serve_cfg(family: str):
    if family == "mixtral":
        return tmix.MixtralConfig(**_fields(MIXTRAL_SERVE), dtype=torch.float32, attention_impl="flash")
    return tqwen.Qwen2MoeConfig(**_fields(QWEN), dtype=torch.float32, attention_impl="flash")


def _mesh(data: int = 1, expert: int = 1, tensor: int = 1) -> Mesh:
    return Mesh({**dict.fromkeys(MESH_AXES, 1), "data": data, "expert": expert, "tensor": tensor})


def _case_mesh(case: str) -> Mesh:
    return _mesh(*CASES[case][2:])


def _batch(seed: int, rows: int = ROWS):
    ids = np.random.default_rng(seed).integers(0, 96, (rows, SEQ)).astype(np.int32)
    return {"input_ids": ids, "labels": ids}


def _config(case: str, stage: int):
    family, _, _, expert, tensor = CASES[case]
    c = {"train_batch_size": ROWS, "steps_per_print": 0, "gradient_clipping": CLIP,
         "optimizer": {"type": "AdamW", "params": {"lr": LR, "weight_decay": 0.01}},
         "zero_optimization": {"stage": stage}, "tensor_parallel": {"autotp_size": tensor}}
    if family == "mixtral":
        c["moe"] = {"enabled": True, "expert_parallel_size": expert}
    return c


def _np(sd):
    return {k: v.detach().float().numpy().copy() for k, v in sd.items()}


def _assert_params_close(got, want):
    far = total = 0
    for k, w in want.items():
        diff = np.abs(np.asarray(got[k], np.float32) - np.asarray(w, np.float32))
        assert diff.max() <= 6 * LR, (k, diff.max())
        far += int((diff > 2e-5).sum())
        total += diff.size
    assert far <= 1e-3 * total, (far, total)


def _port_engine(case, state, stage, one_rank: bool = False):
    cfg = _cfg(case)
    config = _config(case, stage)
    if one_rank:
        config = {**config, "tensor_parallel": {"autotp_size": 1}, "moe": {"enabled": True}}
    if CASES[case][0] == "mixtral":
        return tds.initialize(model=tmix.MixtralForCausalLM(cfg, device="cpu"), params=state, device="cpu",
                              config=config, loss_fn=tmix.make_mixtral_loss_fn(cfg))[0]
    return tds.initialize(model=tqwen.Qwen2MoeForCausalLM(cfg, device="cpu"), params=state, device="cpu",
                          config=config)[0]


# ------------------------------------------------------------------ the ranks

def _train(case, state, stage, ckpt_dir=None):
    eng = _port_engine(case, state, stage)
    losses = [float(eng.train_batch(batch=_batch(s))) for s in range(STEPS)]
    out = {"losses": losses, "eval": float(eng.eval_batch(batch=_batch(STEPS))),
           "params": _np(eng.module_state_dict()), "bytes": eng.state_bytes(),
           "local": _np(eng.module.state_dict()) if stage < 3 else None}
    if ckpt_dir is not None:
        eng.save_checkpoint(ckpt_dir, tag="moe_tp")
        out["saved"] = _np(eng.module_state_dict())
    return out


def _reused_loss_fn(state):
    """The eval losses of one ``make_mixtral_loss_fn`` function handed to a
    tensor-2 engine, then to a tensor-1 one, then to a tensor-2 one again,
    and of a fresh function in a tensor-1 engine."""
    cfg = _cfg("mix-d3t2")
    reused = tmix.make_mixtral_loss_fn(cfg)

    def eval_loss(tensor, loss_fn):
        config = {**_config("mix-d3t2", 0), "tensor_parallel": {"autotp_size": tensor}}
        eng = tds.initialize(model=tmix.MixtralForCausalLM(cfg, device="cpu"), params=state, device="cpu",
                             config=config, loss_fn=loss_fn)[0]
        return float(eng.eval_batch(batch=_batch(STEPS)))

    return {"reused": [eval_loss(t, reused) for t in (2, 1, 2)],
            "fresh_t1": eval_loss(1, tmix.make_mixtral_loss_fn(cfg))}


def _layer_on_rows(case, weights, x):
    """The first MoE layer (whole ``weights``) cut to this rank's experts and
    tensor slice in the groups of the last engine's mesh, on this rank's
    rows of ``x``: (out, l_aux, exp_counts)."""
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.comm.mesh import set_global_mesh
    from deepspeed_tpu_torch.module_inject.layers import TensorParallel, cut_bank_
    from deepspeed_tpu_torch.utils import groups
    _, _, data, expert, tensor = CASES[case]
    set_global_mesh(_case_mesh(case))
    layer = tmix.moe_layer(_cfg(case), "cpu")
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    tp = TensorParallel(tensor, groups.get_tensor_model_parallel_rank(), groups.get_tensor_model_parallel_group())
    layer.experts.shard_(expert, groups.get_expert_parallel_rank())
    cut_bank_(layer.experts, tp)
    layer.set_expert_parallel(groups.get_expert_parallel_group() if expert > 1 else None, data * expert,
                              groups.get_data_parallel_group())
    rows = x.shape[0] // (data * expert)
    d = comm.get_rank() // tensor
    with torch.no_grad():
        o, l_aux, counts = layer(torch.from_numpy(x[d * rows:(d + 1) * rows]))
    return {"out": o.numpy(), "l_aux": float(l_aux), "counts": counts.numpy()}


def _layer_case(inputs):
    """JAX's layer case at expert 2 × tensor 2 (W = 4): this rank's output
    rows, its group's ``l_aux``, and the whole gradients of ``mean(out²)``
    over the global batch."""
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.comm.mesh import set_global_mesh
    from deepspeed_tpu_torch.module_inject.layers import TensorParallel, cut_bank_, gather_dim
    from deepspeed_tpu_torch.moe.layer import MoE
    from deepspeed_tpu_torch.utils import groups
    x, weights = inputs
    mesh = _mesh(expert=2, tensor=2)
    set_global_mesh(mesh)
    groups.create_expert_groups()
    groups.create_tensor_groups()
    layer = MoE(**LAYER, dtype=torch.float32, device="cpu")
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    tp = TensorParallel(2, groups.get_tensor_model_parallel_rank(), groups.get_tensor_model_parallel_group())
    e = groups.get_expert_parallel_rank()
    layer.experts.shard_(2, e)
    cut_bank_(layer.experts, tp)
    dp_group = groups.get_data_parallel_group()
    layer.set_expert_parallel(groups.get_expert_parallel_group(), 2, dp_group)
    rows = x.shape[0] // 2
    xs = torch.from_numpy(x[e * rows:(e + 1) * rows])
    out, l_aux, _ = layer(xs)
    ((out ** 2).sum() / x.size).backward()
    grads = {"gate.weight": layer.gate.weight.grad.clone()}
    comm.all_reduce(grads["gate.weight"], comm.ReduceOp.SUM, group=dp_group)
    for n, dim in layer.experts.TP_DIMS.items():
        g = gather_dim(getattr(layer.experts, n).grad, tp, dim)
        grads[f"experts.{n}"] = gather_dim(g, TensorParallel(2, e, groups.get_expert_parallel_group()), 0)
    assert isinstance(layer, MoE)
    return {"out": out.detach().numpy(), "l_aux": float(l_aux), "grads": {k: v.numpy() for k, v in grads.items()}}


def _mappings(rank):
    """drop/gather over a 2-rank tensor group: forward values and the
    gradients of a weighted sum through each."""
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.module_inject.layers import TensorParallel
    from deepspeed_tpu_torch.moe import mappings
    tp = TensorParallel(2, rank, None)
    x = torch.arange(2 * 6 * 3, dtype=torch.float32).reshape(2, 6, 3)
    w = torch.linspace(-1.0, 1.0, x.numel()).reshape(x.shape)
    xd = x.clone().requires_grad_(True)
    dropped = mappings.drop_tokens(xd, 1, tp)
    (dropped * w[:, rank * 3:(rank + 1) * 3]).sum().backward()
    piece = x[:, rank * 3:(rank + 1) * 3].clone().requires_grad_(True)
    gathered = mappings.gather_tokens(piece, 1, tp)
    (gathered * w).sum().backward()
    round_trip = mappings.gather_tokens(mappings.drop_tokens(x, 1, tp), 1, tp)
    return {"dropped": dropped.detach().numpy(), "drop_grad": xd.grad.numpy(), "gathered": gathered.detach().numpy(),
            "gather_grad": piece.grad.numpy(), "round": round_trip.numpy(),
            "identity": mappings.drop_tokens(x, 1) is x and mappings.gather_tokens(x, 1) is x,
            "kinds": dict(comm.tensor_parallel_kinds)}


def _econf(tp: int = 1):
    return RaggedInferenceEngineConfig(kv=PagedKVConfig(**KV), scheduler=SchedulerConfig(**SCHED),
                                       kv_dtype=torch.float32, tensor_parallel=tp)


def _serve(states, tp):
    from deepspeed_tpu_torch.comm import comm
    out = {}
    for family in ("mixtral", "qwen"):
        comm.tensor_parallel_kinds.clear()
        eng = build_engine(_serve_cfg(family), states[family], _econf(tp), device="cpu")
        out[family] = {"tokens": eng.generate(PROMPTS, max_new_tokens=NEW), "forwards": eng.forward_calls,
                       "kinds": dict(comm.tensor_parallel_kinds)}
    return out


def _raises():
    """What stays out of scope at tensor 2 on the 2-rank group: training a
    v1 family (GPT-2), the v1 engine's tensor_parallel for BERT."""
    from deepspeed_tpu_torch.models.bert import BertConfig, BertForMaskedLM
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel
    gcfg = GPT2Config(vocab_size=96, hidden_size=48, num_hidden_layers=1, num_attention_heads=4, n_positions=64,
                      dtype=torch.float32)
    bert = BertConfig(vocab_size=96, hidden_size=48, num_hidden_layers=1, num_attention_heads=4, intermediate_size=96,
                      max_position_embeddings=64, dtype=torch.float32)
    calls = {"gpt2-train": lambda: tds.initialize(model=GPT2LMHeadModel(gcfg, device="cpu"), device="cpu",
                                                  config={"train_batch_size": 2,
                                                          "tensor_parallel": {"autotp_size": 2}}),
             "v1-bert": lambda: tds.init_inference(model=BertForMaskedLM(bert, device="cpu"),
                                                   config={"tensor_parallel": {"tp_size": 2}}, device="cpu")}
    raised = {}
    for name, call in calls.items():
        try:
            call()
            raised[name] = None
        except NotImplementedError as e:
            raised[name] = str(e)
    return raised


def _rank(rank, states, layer_inputs, case_inputs, ckpt_dir, inits):
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.utils import groups
    out = {"train": {}}
    for case in CASES:
        for stage in STAGES:
            save = ckpt_dir if (case, stage) == ("mix-e3t2", 3) else None
            out["train"][(case, stage)] = _train(case, states[case], stage, save)
        if case.startswith("mix"):
            x, weights = case_inputs[case]
            out.setdefault("layer", {})[case] = _layer_on_rows(case, weights, x)
            out.setdefault("groups", {})[case] = {
                "ep": comm.get_all_ranks_from_group(groups.get_expert_parallel_group()),
                "ed": comm.get_all_ranks_from_group(groups.get_expert_data_parallel_group()),
                "tp": comm.get_all_ranks_from_group(groups.get_tensor_model_parallel_group()),
                "dp": comm.get_all_ranks_from_group(groups.get_data_parallel_group())}
    out["reused_loss"] = _reused_loss_fn(states["mix-d3t2"])
    for world, init in zip((4, 3, 2), inits):
        comm.barrier()
        torch.distributed.destroy_process_group()
        if rank >= world:
            return out
        comm.init_distributed(dist_backend="gloo", init_method=init, rank=rank, world_size=world, verbose=False)
        if world == 4:
            out["layer_case"] = _layer_case(layer_inputs)
        else:
            out[world] = _serve(states["serve"], world)
    comm.tensor_parallel_kinds.clear()
    out["mappings"] = _mappings(rank)
    out["raised"] = _raises()
    return out


# ------------------------------------------------------------------ JAX side

def _jax_cfg(case_or_family: str, serve: bool = False):
    import jax.numpy as jnp
    from deepspeed_tpu.models import mixtral as jmix
    from deepspeed_tpu.models import qwen2_moe as jqwen
    if serve:
        if case_or_family == "mixtral":
            return jmix.MixtralConfig(**_fields(MIXTRAL_SERVE), dtype=jnp.float32, remat=False)
        return jqwen.Qwen2MoeConfig(**_fields(QWEN), dtype=jnp.float32, remat=False)
    family, experts = CASES[case_or_family][:2]
    if family == "mixtral":
        return jmix.MixtralConfig(**dict(_fields(MIXTRAL), num_local_experts=experts), dtype=jnp.float32,
                                  scan_layers=False, remat=False, attention_impl="reference")
    return jqwen.Qwen2MoeConfig(**_fields(QWEN), dtype=jnp.float32, scan_layers=False, remat=False,
                                attention_impl="reference")


def _jax_model(case):
    from deepspeed_tpu.models import mixtral as jmix
    from deepspeed_tpu.models import qwen2_moe as jqwen
    cfg = _jax_cfg(case)
    return jmix.MixtralForCausalLM(cfg) if CASES[case][0] == "mixtral" else jqwen.Qwen2MoeForCausalLM(cfg)


def _jax_mesh(data=1, expert=1, tensor=1):
    import jax
    from deepspeed_tpu.comm.mesh import MeshSpec, create_mesh
    return create_mesh(MeshSpec(data=data, expert=expert, tensor=tensor), devices=jax.devices()[:data * expert * tensor])


def _to_state(case_or_family, params):
    family = CASES[case_or_family][0] if case_or_family in CASES else case_or_family
    fn = convert.jax_mixtral_to_state_dict if family == "mixtral" else convert.jax_qwen2_moe_to_state_dict
    cfg = _cfg(case_or_family) if case_or_family in CASES else _serve_cfg(family)
    return {k: v.numpy() for k, v in fn(params, cfg).items()}


def _seeded_train(case, seed):
    import jax.numpy as jnp
    from test_torch_gpt_family import seeded_params
    params = seeded_params(_jax_model(case), jnp.zeros((1, SEQ), jnp.int32), seed=seed)
    import jax
    return params, _to_state(case, jax.tree.map(np.asarray, params))


def _seeded_twin(family, seed):
    """A JAX twin's variables (scanned layers), every leaf from numpy: norm
    scales 1 + N(0, 0.1²), the rest N(0, 0.3²)."""
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.inference.v2.engine_v2 import build_cache_model as jax_build_cache_model
    from deepspeed_tpu.models import llama_cache as jlc
    from flax.linen import meta
    cfg = _jax_cfg(family, serve=True)
    cache = jlc.init_kv_cache(cfg, jlc.PagedKVConfig(**KV), dtype=jnp.float32)
    shapes = jax.eval_shape(jax_build_cache_model(cfg, KV["page_size"]).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 1), jnp.int32), jnp.zeros((1, ), jnp.int32),
                            jnp.zeros((1, KV["max_pages_per_seq"]), jnp.int32), cache, jnp.ones((1, ), jnp.int32))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        if "norm" in name and name.endswith("weight"):
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (0.3 * rng.standard_normal(s.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(leaf, meta.unbox(shapes))
    return variables, _to_state(family, variables)


def _jax_engine(case, params=None, stage=0):
    import deepspeed_tpu as jds
    from deepspeed_tpu.models import mixtral as jmix
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
    family, _, data, expert, tensor = CASES[case]
    jcfg = _jax_cfg(case)
    kw = {"loss_fn": jmix.make_mixtral_loss_fn(jcfg)} if family == "mixtral" else {}
    return jds.initialize(model=_jax_model(case), config=JaxConfig(_config(case, stage), dp_world_size=data * expert),
                          mesh=_jax_mesh(data, expert, tensor), params=params, dist_init_required=False, **kw)[0]


def _jax_run(case, params):
    import jax
    eng = _jax_engine(case, params)
    losses = [float(eng.train_batch(batch=_batch(s))) for s in range(STEPS)]
    return {"losses": losses, "eval": float(eng.eval_batch(batch=_batch(STEPS))),
            "params": _np_dict(_to_state(case, jax.tree.map(np.asarray, eng.state.params)))}


def _np_dict(state):
    return {k: np.asarray(v, np.float32) for k, v in state.items()}


def _jax_moe_layer(case, params, x):
    """JAX's first MoE layer of ``params`` on ``x`` under the case's mesh:
    (out, l_aux, exp_counts)."""
    import jax
    from deepspeed_tpu.comm.mesh import set_global_mesh
    from deepspeed_tpu.moe.layer import MoE as JMoE
    from flax import linen as nn
    from jax.sharding import NamedSharding, PartitionSpec as P
    jcfg = _jax_cfg(case)
    layer = JMoE(hidden_size=jcfg.hidden_size, num_experts=jcfg.num_local_experts,
                 intermediate_size=jcfg.intermediate_size, k=jcfg.num_experts_per_tok,
                 capacity_factor=jcfg.capacity_factor, eval_capacity_factor=jcfg.eval_capacity_factor,
                 min_capacity=jcfg.min_capacity, dtype=jcfg.dtype, param_dtype=jcfg.param_dtype)
    mesh = _jax_mesh(*CASES[case][2:])
    set_global_mesh(mesh)
    xs = jax.device_put(x, NamedSharding(mesh, P(("data", "expert"), None, None)))
    weights = nn.meta.unbox(params["layers_0"]["block_sparse_moe"])
    out, l_aux, counts = jax.jit(lambda p, v: layer.apply({"params": p}, v))(weights, xs)
    return np.asarray(out), float(l_aux), np.asarray(counts)


def _jax_layer_port(tree):
    return {"gate.weight": np.asarray(tree["gate"]["kernel"]).T.copy(),
            **{f"experts.{n}": np.asarray(tree["experts"][n]) for n in ("w_gate", "w_up", "w_down")}}


def _jax_layer_case_inputs():
    """JAX's layer case: its layer, input and params (flax's, and by port name)."""
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.moe.layer import MoE as JMoE
    from flax import linen as nn
    layer = JMoE(**LAYER, dtype=jnp.float32)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (4, 8, 32), jnp.float32))
    params = nn.meta.unbox(jax.jit(layer.init)(jax.random.PRNGKey(0), x))
    return layer, x, params, _jax_layer_port(jax.tree.map(np.asarray, params["params"]))


def _jax_layer_case_gold(layer, x, params):
    """The layer case on one device: the output, ``l_aux`` and the
    gradients of ``mean(out²)`` (port names)."""
    import jax
    from deepspeed_tpu.comm.mesh import MeshSpec, create_mesh, set_global_mesh
    set_global_mesh(create_mesh(MeshSpec(), devices=jax.devices()[:1]))
    gold, gold_aux, _ = jax.jit(lambda p, v: layer.apply(p, v))(params, x)
    grads = jax.jit(jax.grad(lambda p, v: (layer.apply(p, v)[0] ** 2).mean()))(params, x)["params"]
    return np.asarray(gold), float(gold_aux), _jax_layer_port(grads)


def _jax_serving_tokens(variables):
    """JAX's greedy tokens of each twin at tensor 2 and 3."""
    import jax.numpy as jnp
    from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JaxEngineConfig
    from deepspeed_tpu.inference.v2 import build_engine as jax_build_engine
    from deepspeed_tpu.inference.v2.scheduler import SchedulerConfig as JaxSchedulerConfig
    from deepspeed_tpu.models.llama_cache import PagedKVConfig as JaxPagedKVConfig
    from deepspeed_tpu.comm.mesh import set_global_mesh
    out = {}
    for family, v in variables.items():
        for tp in (2, 3):
            mesh = _jax_mesh(tensor=tp)
            set_global_mesh(mesh)   # the MoE layer's token mappings read the global mesh
            eng = jax_build_engine(_jax_cfg(family, serve=True), v,
                                   JaxEngineConfig(kv=JaxPagedKVConfig(**KV), scheduler=JaxSchedulerConfig(**SCHED),
                                                   kv_dtype=jnp.float32), mesh=mesh)
            out[(family, tp)] = eng.generate(PROMPTS, max_new_tokens=NEW)
    return out


@pytest.fixture(scope="module")
def seeded():
    train = {case: _seeded_train(case, seed=11 + i) for i, case in enumerate(CASES)}
    twins = {family: _seeded_twin(family, seed=21 + i) for i, family in enumerate(("mixtral", "qwen"))}
    return train, twins


@pytest.fixture(scope="module")
def runs(tmp_path_factory, seeded):
    """The ranks' results and JAX's (the spawn runs while JAX computes)."""
    train, twins = seeded
    states = {case: s for case, (_, s) in train.items()}
    states["serve"] = {family: s for family, (_, s) in twins.items()}
    rng = np.random.default_rng(5)
    case_inputs = {}
    for case in ("mix-d3t2", "mix-e3t2"):
        weights = {k.split("block_sparse_moe.")[1]: v for k, v in states[case].items()
                   if k.startswith("layers.0.block_sparse_moe.")}
        case_inputs[case] = (rng.standard_normal((ROWS, SEQ, MIXTRAL["hidden_size"])).astype(np.float32), weights)
    layer, x, params, weights = _jax_layer_case_inputs()
    ckpt_dir = str(tmp_path_factory.mktemp("moe_tp_ckpt"))
    spawn_dir = tmp_path_factory.mktemp("moe_tp_ranks")
    inits = [f"file://{spawn_dir}/rendezvous{w}" for w in (4, 3, 2)]
    ranks = {}

    def spawn():
        try:
            ranks["out"] = run_ranks(str(spawn_dir), _rank, states, (x, weights), case_inputs, ckpt_dir, inits,
                                     world=6)
        except BaseException as e:
            ranks["error"] = e

    thread = threading.Thread(target=spawn)
    thread.start()
    try:
        jax_layer = (x, ) + _jax_layer_case_gold(layer, x, params)
        jax_runs = {case: _jax_run(case, p) for case, (p, _) in train.items()}
        jax_layers = {case: _jax_moe_layer(case, train[case][0], case_inputs[case][0]) for case in case_inputs}
        jax_tokens = _jax_serving_tokens({family: v for family, (v, _) in twins.items()})
        one = {family: build_engine(_serve_cfg(family), states["serve"][family], _econf(), device="cpu").generate(
            PROMPTS, max_new_tokens=NEW) for family in ("mixtral", "qwen")}
    finally:
        thread.join()
    if "error" in ranks:
        raise ranks["error"]
    return {"ranks": ranks["out"], "jax": jax_runs, "jax_layers": jax_layers, "jax_layer_case": jax_layer,
            "jax_tokens": jax_tokens, "one": one, "ckpt": ckpt_dir, "states": states}


# ------------------------------------------------------------------ layouts

def _jax_layouts(case, stage):
    """JAX's shardings of every leaf at the case's mesh (its ``tp_rules``
    and ZeRO partition functions over the abstract boxed tree), by path."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn
    from deepspeed_tpu.module_inject.tp_rules import param_shardings as jparam
    from deepspeed_tpu.runtime.zero.partition import grad_shardings as jgrad
    from deepspeed_tpu.runtime.zero.partition import master_and_optstate_shardings as jmaster
    mesh = _jax_mesh(*CASES[case][2:])
    boxed = jax.eval_shape(_jax_model(case).init, jax.random.PRNGKey(0), jnp.zeros((1, SEQ), jnp.int32))
    params = jparam(boxed, mesh, stage)["params"]
    shapes = nn.meta.unbox(boxed)["params"]
    trees = {"param": params, "state": jmaster(params, shapes, mesh, stage), "grad": jgrad(params, shapes, mesh, stage)}

    def by_path(tree):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        return {"/".join(str(getattr(k, "key", k)) for k in path): sh for path, sh in flat}

    return {kind: by_path(t) for kind, t in trees.items()}, list(mesh.devices.flat)


def _spec(entries, ndim):
    out = []
    for e in tuple(entries) + (None, ) * (ndim - len(tuple(entries))):
        out.append(() if e is None else (e, ) if isinstance(e, str) else tuple(e))
    return tuple(out)


def _tp_model(case):
    family, _, _, expert, tensor = CASES[case]
    if family == "mixtral":
        return tmix.MixtralForCausalLM(_cfg(case), device="meta", expert_parallel_size=expert, tensor_parallel=tensor)
    return tqwen.Qwen2MoeForCausalLM(_cfg(case), device="meta", tensor_parallel=tensor)


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_layouts_equal_the_jax_shardings(case, stage):
    """Every leaf's spec and every rank's slice equal JAX's (parameter,
    master and moments, gradient); the partition of a rank's slice within
    the ranks that share its held coordinates cuts the same slices from it.
    A q/k/v bias: JAX keeps the leaf whole over ``tensor``, the port's spec
    adds ``tensor`` on its heads dim and the rank holds its heads."""
    jax_sh, devices = _jax_layouts(case, stage)
    mesh = _case_mesh(case)
    leaves = jax_leaves(_tp_model(case))
    params = param_shardings(leaves, mesh, stage)
    ours = {"param": params, "state": master_and_optstate_shardings(params, mesh, stage),
            "grad": grad_shardings(params, mesh, stage)}
    names = {leaf.path: name for name, leaf in leaves.items()}
    rng = np.random.default_rng(3)
    held = {"tensor": 0, "expert": 0, "bias": 0}
    for kind, tree in jax_sh.items():
        assert set(names[p] for p in tree) == set(ours[kind])
        for path, sh in tree.items():
            part = ours[kind][names[path]]
            want_spec = _spec(sh.spec, len(part.jax_shape))
            value = rng.standard_normal(part.jax_shape).astype(np.float32)
            index = sh.devices_indices_map(part.jax_shape)
            if path.endswith("/bias"):
                assert all("tensor" not in e for e in want_spec)
                assert part.spec[0] == ("tensor", ) and part.held == ("tensor", ), (path, part.spec)
                held["bias"] += 1
                continue
            assert part.spec == want_spec, (kind, path, sh.spec, part.spec)
            inner = part.within_held()
            for r in range(len(devices)):
                want = value[index[devices[r]]]
                np.testing.assert_array_equal(part.local(torch.from_numpy(value), r).numpy(), want)
                at = mesh.coords(r)
                mine = torch.from_numpy(value)
                for d, axes in enumerate(part.spec):
                    for a in ("expert", "tensor"):
                        if a in axes and a in part.held:
                            n = part.jax_shape[d] // mesh.shape[a]
                            mine = mine.narrow(d, at[a] * n, n)
                group_rank = at["data"] if "expert" in part.held else at["data"] * mesh.shape["expert"] + at["expert"]
                np.testing.assert_array_equal(inner.local(mine, group_rank).numpy(), want)
            held["tensor"] += "tensor" in part.held
            held["expert"] += "expert" in part.held
    assert held["tensor"] > 0 and (held["expert"] > 0) == (mesh.shape["expert"] > 1)
    assert (held["bias"] > 0) == (CASES[case][0] == "qwen")


# ------------------------------------------------------------------ training

@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("case", list(CASES))
def test_trajectory_equals_jax(case, stage, runs):
    """Losses (train and eval) within rtol 1e-5 of the JAX engine's at the
    same mesh, the same on every rank; the parameters as JAX's."""
    ranks = [r["train"][(case, stage)] for r in runs["ranks"]]
    want = runs["jax"][case]
    np.testing.assert_allclose(ranks[0]["losses"], want["losses"], rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["eval"], want["eval"], rtol=1e-5)
    assert all(r["losses"] == ranks[0]["losses"] and r["eval"] == ranks[0]["eval"] for r in ranks)
    _assert_params_close(ranks[0]["params"], want["params"])
    for r in ranks[1:]:
        for k, v in ranks[0]["params"].items():
            np.testing.assert_array_equal(r["params"][k], v)


def test_one_loss_fn_serves_engines_of_either_tensor_degree(runs):
    """A Mixtral loss function keeps no engine's state: handed to a tensor-2
    engine, then a tensor-1 and a tensor-2 one at the same weights, it gives
    the tensor-1 engine a fresh function's loss and the second tensor-2
    engine the first one's, exactly, on every rank."""
    for r in runs["ranks"]:
        t2, t1, again = r["reused_loss"]["reused"]
        assert (t1, again) == (r["reused_loss"]["fresh_t1"], t2)


@pytest.mark.parametrize("case", list(CASES))
def test_replicated_tensors_are_bit_identical_over_a_tensor_group(case, runs):
    """The router(s), the norms and the row-parallel biases a rank holds
    whole are bit-identical on the ranks of its tensor group (their
    gradients are equal there without a reduce); a cut tensor is its
    coordinates' slice of the whole."""
    from deepspeed_tpu_torch.module_inject.layers import tp_dims
    cut = tp_dims(_tp_model(case))
    mesh = _case_mesh(case)
    ranks = runs["ranks"]
    for r, res in enumerate(ranks):
        got = res["train"][(case, 0)]
        at = mesh.coords(r)
        for k, local in got["local"].items():
            whole = got["params"][k]
            if k in cut:
                n = whole.shape[cut[k]] // 2
                whole = np.take(whole, range(at["tensor"] * n, (at["tensor"] + 1) * n), axis=cut[k])
            if ".experts." in k and mesh.shape["expert"] > 1:
                n = whole.shape[0] // mesh.shape["expert"]
                whole = whole[at["expert"] * n:(at["expert"] + 1) * n]
            np.testing.assert_array_equal(local, whole, err_msg=f"{k} on rank {r}")
            if k not in cut and r % 2:
                np.testing.assert_array_equal(local, ranks[r - 1]["train"][(case, 0)]["local"][k])


@pytest.mark.parametrize("case", ["mix-d3t2", "mix-e3t2"])
def test_moe_layer_l_aux_and_counts_equal_jax(case, runs):
    """The first MoE layer on each rank's rows: its group's output within
    1e-5 of its largest magnitude of JAX's rows, ``l_aux`` (the mean over
    the ranks' groups) within rtol 1e-5, ``exp_counts`` summed over the
    data-parallel ranks (not over ``tensor``) equal to JAX's."""
    out, l_aux, counts = runs["jax_layers"][case]
    _, _, data, expert, tensor = CASES[case]
    rows = ROWS // (data * expert)
    got = [r["layer"][case] for r in runs["ranks"]]
    for r, g in enumerate(got):
        d = r // tensor
        want = out[d * rows:(d + 1) * rows]
        np.testing.assert_allclose(g["out"], want, rtol=0, atol=1e-5 * np.abs(out).max())
        np.testing.assert_array_equal(g["counts"], counts)
    np.testing.assert_allclose(np.mean([g["l_aux"] for g in got]), l_aux, rtol=1e-5)


def test_groups_at_expert_3_tensor_2(runs):
    """With tensor fastest, an expert group's ranks are 2 apart, an
    expert-data group is the rank alone (data 1), a tensor group 2
    consecutive ranks; at data 3 × tensor 2 the data-parallel group is the
    3 ranks of one tensor coordinate."""
    for r, res in enumerate(runs["ranks"]):
        g = res["groups"]["mix-e3t2"]
        assert g["ep"] == [r % 2, r % 2 + 2, r % 2 + 4] and g["ed"] == [r] and g["tp"] == [r - r % 2, r - r % 2 + 1]
        assert res["groups"]["mix-d3t2"]["dp"] == [r % 2, r % 2 + 2, r % 2 + 4]


def test_state_bytes_at_expert_3_tensor_2(runs):
    """A rank's state bytes: each tensor's slice within its held
    coordinates, partitioned from stage 1 (float32: no master)."""
    leaves = jax_leaves(_tp_model("mix-e3t2"))
    mesh = _case_mesh("mix-e3t2")
    for stage in STAGES:
        params = param_shardings(leaves, mesh, stage)
        state = master_and_optstate_shardings(params, mesh, stage)
        per = lambda parts: sum(p.within_held().local_numel * 4 for p in parts.values())
        want = {"params": per(params), "master": 0, "moments": 2 * per(state)}
        assert all(r["train"][("mix-e3t2", stage)]["bytes"] == want for r in runs["ranks"])


def test_checkpoint_at_expert_3_tensor_2_loads_at_one_rank(runs, tmp_path):
    """The stage-3 checkpoint of expert 3 × tensor 2 holds whole tensors: a
    one-rank engine loads the same whole state; its universal atoms carry
    JAX's names and shapes."""
    eng = _port_engine("mix-e3t2", runs["states"]["mix-e3t2"], 0, one_rank=True)
    eng.load_checkpoint(runs["ckpt"], tag="moe_tp")
    got = _np(eng.module_state_dict())
    saved = runs["ranks"][0]["train"][("mix-e3t2", 3)]["saved"]
    assert set(got) == set(saved)
    for k, v in saved.items():
        np.testing.assert_array_equal(got[k], v)
    from deepspeed_tpu_torch.checkpoint import convert_to_universal, load_universal_atoms
    from deepspeed_tpu_torch.checkpoint.ds_to_universal import canonicalize_param_name
    atoms = load_universal_atoms(convert_to_universal(runs["ckpt"], str(tmp_path / "uni"), tag="moe_tp"))
    for lf in jax_leaves(tmix.MixtralForCausalLM(_cfg("mix-e3t2"), device="meta")).values():
        assert tuple(np.shape(atoms[canonicalize_param_name(lf.path.replace("/", "."))]["fp32"])) == lf.shape


# ------------------------------------------------------------------ the layer and the mappings

def test_layer_case_of_jax_at_expert_2_tensor_2(runs):
    """JAX ``test_tp_ep_mesh_matches_single_device`` at expert 2 × tensor 2:
    the output rows within atol = rtol = 2e-5 of the single-device layer's,
    ``l_aux`` within rtol 0.2, the gradients of ``mean(out²)`` within atol
    3e-5 and rtol 2e-4."""
    x, gold, gold_aux, grads = runs["jax_layer_case"]
    got = [r["layer_case"] for r in runs["ranks"][:4]]
    rows = x.shape[0] // 2
    for r, g in enumerate(got):
        e = r // 2
        np.testing.assert_allclose(g["out"], gold[e * rows:(e + 1) * rows], atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(g["l_aux"], gold_aux, rtol=0.2)
        for k, w in grads.items():
            np.testing.assert_allclose(g["grads"][k], w, atol=3e-5, rtol=2e-4, err_msg=k)


def test_drop_and_gather_tokens_over_the_tensor_group(runs):
    """drop keeps the rank's token slice and its backward all-gathers;
    gather all-gathers the slices and its backward keeps the rank's slice;
    ``gather(drop(x)) == x`` on every rank; degree 1 is the identity."""
    x = np.arange(2 * 6 * 3, dtype=np.float32).reshape(2, 6, 3)
    w = np.linspace(-1.0, 1.0, x.size, dtype=np.float32).reshape(x.shape)
    for r, res in enumerate(runs["ranks"][:2]):
        m = res["mappings"]
        mine = slice(r * 3, (r + 1) * 3)
        np.testing.assert_array_equal(m["dropped"], x[:, mine])
        np.testing.assert_allclose(m["drop_grad"], np.concatenate([w[:, 0:3], w[:, 3:6]], axis=1), rtol=1e-6)
        np.testing.assert_array_equal(m["gathered"], x)
        np.testing.assert_allclose(m["gather_grad"], w[:, mine], rtol=1e-6)
        np.testing.assert_array_equal(m["round"], x)
        assert m["identity"]
        assert m["kinds"] == {("drop_tokens", "backward"): 1, ("gather_tokens", "forward"): 2}


def test_token_mappings_need_a_dividing_degree():
    """A degree that does not divide the token dim raises, in the forward."""
    from deepspeed_tpu_torch.module_inject.layers import TensorParallel
    from deepspeed_tpu_torch.moe import mappings
    with pytest.raises(ValueError, match="does not divide"):
        mappings.drop_tokens(torch.zeros(2, 5, 3), 1, TensorParallel(2, 0))


# ------------------------------------------------------------------ serving

@pytest.mark.parametrize("tp", [2, 3])
@pytest.mark.parametrize("family", ["mixtral", "qwen"])
def test_tp_serving_equals_jax(family, tp, runs):
    """Every rank's greedy tokens equal JAX's TP engine's at the same degree
    and the port's one-rank engine's; a forward runs the embedding's
    all-reduce, one o_proj and one MoE all-reduce a layer, and the logits
    gather."""
    want = runs["jax_tokens"][(family, tp)]
    assert runs["one"][family] == want
    for r in runs["ranks"][:tp]:
        got = r[tp][family]
        assert got["tokens"] == want, (got["tokens"], want)
        n = got["forwards"]
        assert got["kinds"] == {("embed", "forward"): n, ("o_proj", "forward"): 2 * n, ("moe", "forward"): 2 * n,
                                ("logits", "forward"): n}


def _jax_shard_bytes(cfg, tp: int, kv_dtype):
    """JAX's serving shardings at tensor ``tp``: the parameter count, a
    device's parameter and arena bytes from each leaf's ``shard_shape``,
    and the bytes of the q/k/v bias leaves it keeps whole."""
    import jax
    from deepspeed_tpu.inference.v2.engine_v2 import _serving_shardings
    from deepspeed_tpu.inference.v2.engine_v2 import build_cache_model as jax_build_cache_model
    from deepspeed_tpu.models.llama_cache import PagedKVConfig as JaxPagedKVConfig
    from flax import linen as nn
    abs_vars, cache_abs, param_sh, cache_sh, _ = _serving_shardings(jax_build_cache_model(cfg, KV["page_size"]), cfg,
                                                                    JaxPagedKVConfig(**KV), kv_dtype,
                                                                    _jax_mesh(tensor=tp))
    flat, _ = jax.tree_util.tree_flatten_with_path(nn.meta.unbox(abs_vars))
    shardings = jax.tree.leaves(param_sh)
    param_bytes = bias_bytes = 0
    for (path, leaf), sh in zip(flat, shardings):
        n = int(np.prod(sh.shard_shape(leaf.shape))) * leaf.dtype.itemsize
        param_bytes += n
        bias_bytes += n if str(getattr(path[-1], "key", "")) == "bias" else 0
    arena = int(np.prod(cache_sh.shard_shape(cache_abs.shape))) * cache_abs.dtype.itemsize
    return sum(int(np.prod(leaf.shape)) for _, leaf in flat), param_bytes, arena, bias_bytes


@pytest.mark.parametrize("family", ["mixtral", "qwen"])
def test_aot_budget_tiny_at_tensor_2(family):
    """A rank's bytes at tensor 2 equal the sum of JAX's shard shapes, less
    half of the q/k/v biases, which JAX keeps whole and the port cuts."""
    import jax.numpy as jnp
    budget, n_params = compile_aot_serving(_serve_cfg(family), _mesh(tensor=2), _econf(), batch=4, chunk=1)
    n, param_bytes, arena, bias = _jax_shard_bytes(_jax_cfg(family, serve=True), 2, jnp.float32)
    assert (n_params, budget.param_bytes, budget.arena_bytes) == (n, param_bytes - bias // 2, arena)
    assert (bias > 0) == (family == "qwen")


def test_aot_budget_mixtral_8x7b_at_tensor_8():
    """Mixtral-8x7B at tensor 8, reckoned without a card or an allocation:
    the rank's bytes equal the sum of JAX's shard shapes (parameters in
    float32, each expert's FFN cut 8 ways; the arena in bf16)."""
    import jax.numpy as jnp
    from deepspeed_tpu.models.mixtral import PRESETS as JAX_PRESETS
    econf = RaggedInferenceEngineConfig(kv=PagedKVConfig(**KV))
    budget, n_params = compile_aot_serving(tmix.PRESETS["mixtral-8x7b"], _mesh(tensor=8), econf, batch=8, chunk=1)
    n, param_bytes, arena, bias = _jax_shard_bytes(JAX_PRESETS["mixtral-8x7b"], 8, jnp.bfloat16)
    assert (n_params, budget.param_bytes, budget.arena_bytes, bias) == (n, param_bytes, arena, 0)
    assert n_params == 46_702_792_704


# ------------------------------------------------------------------ the surface

def test_rank_parameter_counts_of_the_chip_configs():
    """The reckonings ``chip_smoke.py`` holds its ranks to (meta tensors:
    nothing allocated): a tensor-2 rank of the Qwen1.5-MoE-A2.7B twin holds
    7,159,441,408 of 14,315,784,192 parameters (norms, routers and
    shared-expert gates whole, the rest halved); a rank of Mixtral-8x7B's
    widths at one layer over expert 2 × tensor 2 holds 504,410,112 of
    1,713,418,240 (4 experts at half their width, attention and vocab
    halved)."""
    from deepspeed_tpu_torch.models.cache_zoo import build_cache_model
    count = lambda m: sum(p.numel() for p in m.parameters())
    qwen = tqwen.Qwen2MoeConfig(vocab_size=151936, hidden_size=2048, intermediate_size=5632,
                                moe_intermediate_size=1408, shared_expert_intermediate_size=5632,
                                num_hidden_layers=24, num_attention_heads=16, num_key_value_heads=16, num_experts=60,
                                num_experts_per_tok=4, max_position_embeddings=8192)
    assert count(build_cache_model(qwen, 16, device="meta", tensor_parallel=2)) == 7_159_441_408
    assert count(build_cache_model(qwen, 16, device="meta")) == 14_315_784_192
    mix = dataclasses.replace(tmix.PRESETS["mixtral-8x7b"], num_hidden_layers=1)
    assert count(tmix.MixtralForCausalLM(mix, device="meta", expert_parallel_size=2, tensor_parallel=2)) == 504_410_112
    assert count(tmix.MixtralForCausalLM(mix, device="meta")) == 1_713_418_240


def test_out_of_scope_raises_naming_item_6_2(runs):
    for name, msg in runs["ranks"][0]["raised"].items():
        assert msg is not None and "item 6.2" in msg, (name, msg)


@pytest.mark.parametrize("rank", [0, 1])
def test_seeded_init_keeps_the_whole_model_s_slices(rank):
    """A tensor-parallel MoE model seeded by ``init_weights_`` holds exactly
    its rank's slices of the one-rank model of the same seed (banks, shared
    experts and biases drawn whole, the slice kept)."""
    from deepspeed_tpu_torch.models import llama as tl
    from deepspeed_tpu_torch.module_inject.layers import TensorParallel, set_tensor_parallel_, slice_state, tp_dims
    for whole_model, cut_model in ((tmix.MixtralForCausalLM(_cfg("mix-d3t2"), device="cpu"),
                                    tmix.MixtralForCausalLM(_cfg("mix-d3t2"), device="cpu", tensor_parallel=2)),
                                   (tqwen.Qwen2MoeForCausalLM(_cfg("qwen-d3t2"), device="cpu"),
                                    tqwen.Qwen2MoeForCausalLM(_cfg("qwen-d3t2"), device="cpu", tensor_parallel=2))):
        whole = tl.init_weights_(whole_model, torch.Generator().manual_seed(4)).state_dict()
        tp = TensorParallel(2, rank)
        mine = tl.init_weights_(set_tensor_parallel_(cut_model, tp), torch.Generator().manual_seed(4)).state_dict()
        want = slice_state(whole, tp_dims(cut_model), tp)
        assert set(mine) == set(want)
        for k, v in want.items():
            torch.testing.assert_close(mine[k], v, rtol=0, atol=0)
