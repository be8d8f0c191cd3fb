"""ZeRO stages 1-3 over several data-parallel ranks (``runtime/zero/``,
``utils/{groups,tensor_fragment}.py``, ``runtime/sparse_tensor.py`` and the
checkpoints of a partitioned engine), against the JAX package on the CPU.

  * **Layouts**: for stages 1-3, each port tensor's sharded dim and rank r's
    slice, for the parameter, the master and moments, and the gradient,
    equal what the JAX engine's ``param_shardings``,
    ``master_and_optstate_shardings`` and ``grad_shardings`` give (built
    abstractly, no compile): W = 3 on a config every one of whose tensors
    has a dim 3 divides (vocab 96, hidden 48, intermediate 96), W = 2 on
    ``tests/unit/simple_model.py``'s ``TINY`` (vocab 128, hidden 64).  At
    W = 3 ``TINY``'s vocab 128 cannot shard: stage 3 raises in both.
  * **Trajectories at W = 3** (three gloo ranks, one spawn for the module,
    run while JAX computes): 3 AdamW steps with clipping, stages 0-3 in
    float32 and bf16, gas 2, and LAMB.  In float32 the losses equal the JAX
    engine's within rtol 1e-5 and the gathered parameters the one-rank
    port's within 1e-6 (Adam moves an entry by about lr whatever its
    gradient: all but 1e-3 of them), the same on every rank; LAMB's
    parameters match JAX's (its trust ratio is per whole tensor).  Each
    rank's state bytes are the sum of its slices.  An fp16 overflow put in
    one rank's slice skips the step on every rank.
  * ``tensor_fragment`` on a stage-3 engine at W = 3 against a JAX stage-3
    engine on ``data=3``; ``GatheredParameters``, ``zero.Init``, MiCS/hpZ,
    ``TiledLinear``, ``SparseTensor``/``sparse_allreduce``, the ``groups``
    sizes, and the config's ZeRO knobs.
  * **Checkpoints**: saved at stage 3, W = 3, loaded at stage 1, W = 3 and
    at stage 0, W = 1: the whole state is identical; ``zero_to_fp32`` gives
    the gathered master.

JAX is imported only inside the tests, so the ranks start without it.
"""

import dataclasses
import logging
import os
import sys
import threading
import weakref

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.comm.mesh import MESH_AXES, Mesh
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.models.convert import jax_leaves, jax_llama_to_state_dict
from deepspeed_tpu_torch.module_inject.tp_rules import param_shardings
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig, DeepSpeedConfigError
from deepspeed_tpu_torch.runtime.zero import (estimate_partitioned_bytes, grad_shardings,
                                              master_and_optstate_shardings, mics_zero_axes, resolve_partition_axes)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "unit"))

from test_torch_qgz import run_ranks  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: F401,E402 (autouse fixture)

W = 3
ROWS, SEQ, STEPS, LR, CLIP = 6, 16, 3, 1e-2, 0.5
DIV = tl.LlamaConfig(vocab_size=96, hidden_size=48, intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
                     num_key_value_heads=2, max_position_embeddings=64, rope_theta=1e4, dtype=torch.float32,
                     attention_impl="reference")
TINY = dataclasses.replace(DIV, vocab_size=128, hidden_size=64, intermediate_size=128)
FRAGMENT_NAMES = ("embed_tokens.weight", "layers.0.self_attn.o_proj.weight", "layers.1.mlp.down_proj.weight",
                  "layers.0.input_layernorm.weight", "lm_head.weight")
#: name → (stage, dtype, gas, optimizer) of the W = 3 runs
RUNS = {f"s{s}-{d}": (s, d, 1, "AdamW") for s in range(4) for d in ("f32", "bf16")}
RUNS.update({"s0-gas2": (0, "f32", 2, "AdamW"), "s2-gas2": (2, "f32", 2, "AdamW"), "s3-gas2": (3, "f32", 2, "AdamW"),
             "s0-lamb": (0, "f32", 1, "Lamb"), "s2-lamb": (2, "f32", 1, "Lamb")})
#: the other families ``models/convert.jax_leaves`` partitions, at widths
#: every tensor of which 3 divides: (port model module, its config's fields,
#: the JAX model module, the state-dict converter's name)
ZOO = {
    "falcon": ("falcon", dict(vocab_size=96, hidden_size=48, num_hidden_layers=2, num_attention_heads=4,
                              num_kv_heads=2, new_decoder_architecture=True, num_ln_in_parallel_attn=2, bias=True,
                              tie_word_embeddings=False, max_position_embeddings=64), "jax_falcon_to_state_dict"),
    "opt": ("opt", dict(vocab_size=96, hidden_size=48, ffn_dim=96, num_hidden_layers=2, num_attention_heads=4,
                        max_position_embeddings=64, word_embed_proj_dim=24), "jax_opt_to_state_dict"),
    "phi": ("phi", dict(vocab_size=96, hidden_size=48, intermediate_size=96, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=4, partial_rotary_factor=0.5, qk_layernorm=True,
                        max_position_embeddings=64), "jax_phi_to_state_dict"),
    "gpt2": ("gpt2", dict(vocab_size=96, n_positions=64, hidden_size=48, num_hidden_layers=2, num_attention_heads=4),
             "jax_gpt2_to_state_dict"),
}
_ZOO_CLASSES = {"falcon": ("FalconConfig", "FalconForCausalLM"), "opt": ("OPTConfig", "OPTForCausalLM"),
                "phi": ("PhiConfig", "PhiForCausalLM"), "gpt2": ("GPT2Config", "GPT2LMHeadModel")}


def _batch(seed: int, rows: int = ROWS, vocab: int = DIV.vocab_size):
    ids = np.random.default_rng(seed).integers(0, vocab, (rows, SEQ)).astype(np.int32)
    return {"input_ids": ids, "labels": ids}


def _config(stage, dtype="f32", gas=1, opt="AdamW", **zero):
    params = {"lr": LR, "weight_decay": 0.01}
    cfg = {"train_batch_size": ROWS, "gradient_accumulation_steps": gas, "steps_per_print": 0,
           "optimizer": {"type": opt, "params": params}, "gradient_clipping": CLIP,
           "zero_optimization": {"stage": stage, **zero}}
    if dtype == "bf16":
        cfg["bf16"] = {"enabled": True}
    return cfg


def _port(state, stage, dtype="f32", gas=1, opt="AdamW", cfg=DIV, **zero):
    model_cfg = dataclasses.replace(cfg, dtype=torch.bfloat16 if dtype == "bf16" else torch.float32)
    return tds.initialize(model=tl.LlamaForCausalLM(model_cfg, device="cpu"), params=state, device="cpu",
                          config=_config(stage, dtype, gas, opt, **zero))[0]


def _assert_close_share(got, want, tight, share, bound):
    """Every entry within ``bound``; all but ``share`` of the entries of the
    whole model within ``tight``.  Adam's and LAMB's early steps move an
    entry by about lr whatever its gradient, so where a gradient lies below
    the rounding difference of two summation orders (over ranks or slices)
    the two can step it by lr either way."""
    diff = np.concatenate([np.abs(np.asarray(got[k], np.float32) - np.asarray(want[k], np.float32)).ravel()
                           for k in want])
    assert diff.max() <= bound, diff.max()
    assert (diff > tight).mean() <= share, ((diff > tight).sum(), diff.size, diff.max())


def _zoo_port_model(family):
    """The port's tiny float32 model of ``family`` (``ZOO``)."""
    import importlib
    mod = importlib.import_module(f"deepspeed_tpu_torch.models.{ZOO[family][0]}")
    cfg_cls, model_cls = _ZOO_CLASSES[family]
    return getattr(mod, model_cls)(getattr(mod, cfg_cls)(**ZOO[family][1], dtype=torch.float32), device="cpu")


def _zoo_jax_model(family):
    """The JAX model of ``family`` (``ZOO``), unrolled, float32."""
    import importlib
    import jax.numpy as jnp
    mod = importlib.import_module(f"deepspeed_tpu.models.{ZOO[family][0]}")
    cfg_cls, model_cls = _ZOO_CLASSES[family]
    return getattr(mod, model_cls)(getattr(mod, cfg_cls)(**ZOO[family][1], dtype=jnp.float32, scan_layers=False))


def _np(sd):
    return {k: v.detach().float().numpy().copy() for k, v in sd.items()}


def _snapshot(engine):
    """The engine's whole state (``checkpoint/engine.engine_state``) as numpy."""
    from deepspeed_tpu_torch.checkpoint.engine import engine_state
    st = engine_state(engine)
    out = {f"params/{k}": v for k, v in _np(st["params"]).items()}
    if st["master"] is not None:
        out.update({f"master/{k}": v for k, v in _np(st["master"]).items()})
    for i, s in st["opt_state"]["state"].items():
        out.update({f"opt/{i}/{k}": v.float().numpy().copy() for k, v in s.items() if isinstance(v, torch.Tensor)})
    out["step_count"] = np.asarray(st["opt_state"]["step_count"])
    return out


def _parts(engine):
    z = engine.zero
    return None if z is None else {kind: [(p.name, p.dim, p.world) for p in parts] for kind, parts in
                                   (("param", z.param_parts), ("state", z.state_parts), ("grad", z.grad_parts))}


def _want_bytes(engine):
    """The bytes of the engine's slices by ``estimate_partitioned_bytes``."""
    z = engine.zero
    dt = torch.finfo(engine.compute_dtype).bits // 8
    params = estimate_partitioned_bytes(z.param_parts, dt) if z.stage >= 3 else \
        sum(p.numel() for p in engine.params) * dt
    state = estimate_partitioned_bytes(z.state_parts, 4)
    return {"params": params, "master": state if engine.use_master else 0, "moments": 2 * state}


# ------------------------------------------------------------------ the ranks

def _rank(rank, state, tiny_state, ckpt_dir, zoo_states):
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.runtime.sparse_tensor import SparseTensor, sparse_allreduce
    from deepspeed_tpu_torch.runtime.zero import GatheredParameters
    from deepspeed_tpu_torch.utils import groups, tensor_fragment as tf
    out = {"runs": {}}
    engines = {}
    for name, (stage, dtype, gas, opt) in RUNS.items():
        eng = _port(state, stage, dtype, gas, opt)
        losses = [float(eng.train_batch(batch=_batch(s))) for s in range(STEPS)]
        out["runs"][name] = {"losses": losses, "params": _np(eng.module_state_dict()), "parts": _parts(eng),
                             "bytes": eng.state_bytes(), "want_bytes": None if eng.zero is None else _want_bytes(eng),
                             "norm": eng.get_global_grad_norm()}
        if name in ("s3-f32", "s3-bf16"):
            engines[name] = eng

    # the other families at stages 0-3 (float32, AdamW with clipping)
    out["zoo"] = {}
    for family, zstate in zoo_states.items():
        for stage in range(4):
            eng = tds.initialize(model=_zoo_port_model(family), params=zstate, device="cpu",
                                 config=_config(stage))[0]
            losses = [float(eng.train_batch(batch=_batch(s))) for s in range(STEPS)]
            out["zoo"][f"{family}-s{stage}"] = {"losses": losses, "params": _np(eng.module_state_dict()),
                                                "parts": _parts(eng)}

    # the imperative path: forward, backward (of forward's loss, then of a
    # fresh forward), step at gas 2
    for stage in (0, 3):
        eng = _port(state, stage, gas=2)
        loss = eng.forward(_batch(0, rows=ROWS // 2))
        losses = [float(loss.detach()), float(eng.backward(loss)), float(eng.backward(batch=_batch(1, rows=ROWS // 2)))]
        losses.append(float(eng.step().loss))
        out["runs"][f"s{stage}-imperative"] = {"losses": losses, "params": _np(eng.module_state_dict())}

    # remat flash_saveable over the flash op (its plain version here), as the card trains
    flash = dataclasses.replace(DIV, attention_impl="flash", remat_policy="flash_saveable")
    for stage in (0, 3):
        eng = _port(state, stage, cfg=flash)
        out["runs"][f"s{stage}-flash"] = {"losses": [float(eng.train_batch(batch=_batch(s))) for s in range(STEPS)],
                                          "params": _np(eng.module_state_dict())}

    # no whole weight outlives its block: block 0's gathered q_proj is freed
    # before block 1 runs (a training step under remat, and an eval)
    eng = engines["s3-f32"]
    seen = {"alive": []}
    hooks = [eng.module.layers[0].self_attn.register_forward_pre_hook(
        lambda m, a: seen.__setitem__("q0", weakref.ref(m.q_proj.__dict__["weight"]))),
        eng.module.layers[1].register_forward_pre_hook(lambda m, a: seen["alive"].append(seen["q0"]() is not None))]
    losses = [float(eng.train_batch(batch=_batch(STEPS))), float(eng.eval_batch(batch=_batch(0)))]
    for h in hooks:
        h.remove()
    out["freed"] = {"alive_in_block_1": seen["alive"], "losses": losses,
                    "released": all(mod.__dict__[attr] is None for unit in eng.zero._units for mod, attr in unit.owners)}

    # tensor_fragment on the stage-3 float32 engine (its last batch)
    eng = engines["s3-f32"]
    frag = {}
    for n in FRAGMENT_NAMES:
        frag[n] = {"full": tf.safe_get_full_fp32_param(eng, n).numpy(), "local": tf.safe_get_local_fp32_param(eng, n).numpy(),
                   "full_grad": tf.safe_get_full_grad(eng, n).numpy(),
                   "local_grad": tf.safe_get_local_grad(eng, n).numpy(),
                   "exp_avg": tf.safe_get_full_optimizer_state(eng, n, "exp_avg").numpy(),
                   "local_exp_avg_sq": tf.safe_get_local_optimizer_state(eng, n, "exp_avg_sq").numpy()}
    up = "layers.0.mlp.up_proj.weight"
    tf.safe_set_full_fp32_param(eng, up, 0.5 * tf.safe_get_full_fp32_param(eng, up))
    tf.safe_set_full_optimizer_state(eng, up, 2.0 * tf.safe_get_full_optimizer_state(eng, up, "exp_avg"), "exp_avg")
    frag["set"] = {"param": tf.safe_get_full_fp32_param(eng, up).numpy(),
                   "module": eng.module_state_dict()[up].numpy().copy(),
                   "exp_avg": tf.safe_get_full_optimizer_state(eng, up, "mu").numpy()}
    out["fragment"] = frag

    # GatheredParameters: a read, a write by rank 0 (rank 1's is dropped)
    down = "layers.1.mlp.down_proj.weight"
    with GatheredParameters(eng, ["layers.1.mlp"]) as g:
        read = {k: g[k].numpy().copy() for k in g.keys()}
        try:
            g[down] = g[down] * 2
            refused = None
        except RuntimeError as e:
            refused = str(e)
    with GatheredParameters(eng, [down], modifier_rank=0) as g:
        g[down] = g[down] * (2.0 if rank == 0 else 3.0)
    out["gathered"] = {"read": read, "refused": refused, "after": eng.module_state_dict()[down].numpy().copy(),
                       "master_after": tf.safe_get_full_fp32_param(eng, down).numpy()}

    # checkpoints: the stage-3 bf16 engine saved; a fresh stage-1 engine loads it
    saver = engines["s3-bf16"]
    saver.save_checkpoint(ckpt_dir, tag="s3w3")
    out["saved"] = _snapshot(saver)
    loader = _port(state, 1, "bf16")
    loader.load_checkpoint(ckpt_dir)
    out["loaded_s1"] = _snapshot(loader)

    # set full at stage 3 in bf16: the float32 master slice and the bf16 parameter slice
    gate = "layers.1.mlp.gate_proj.weight"
    value = tf.safe_get_full_fp32_param(saver, gate) + 1e-3
    tf.safe_set_full_fp32_param(saver, gate, value)
    out["set_bf16"] = {"value": value.numpy(), "master": tf.safe_get_full_fp32_param(saver, gate).numpy(),
                       "param": saver.module_state_dict()[gate].float().numpy(),
                       "local": tf.safe_get_local_fp32_param(saver, gate).numpy()}

    # an fp16 overflow in rank 1's slice of the embedding's gradient
    eng = tds.initialize(model=tl.LlamaForCausalLM(dataclasses.replace(DIV, dtype=torch.float16), device="cpu"),
                         params=state, device="cpu",
                         config={**_config(2), "fp16": {"enabled": True, "initial_scale_power": 8, "hysteresis": 1}})[0]
    add = eng.zero.add_pending

    def poisoned(idxs, slices):
        slices = list(slices)
        if rank == 1:
            slices[0] = slices[0].clone()
            slices[0].view(-1)[0] = float("inf")
        add(idxs, slices)

    eng.zero.add_pending = poisoned
    before = tf.safe_get_full_fp32_param(eng, "layers.0.mlp.up_proj.weight")
    eng.train_batch(batch=_batch(0))
    out["fp16"] = {"sharded": eng.zero.grad_parts[0].sharded, "skipped": eng.skipped_steps,
                   "scale": eng.loss_scale,
                   "unchanged": bool(torch.equal(before, tf.safe_get_full_fp32_param(eng, "layers.0.mlp.up_proj.weight")))}

    # MiCS and hpZ at stage 3; TINY, whose vocab 3 does not divide
    layouts = {}
    for label, zero in (("mics3", {"mics_shard_size": 3}), ("mics1", {"mics_shard_size": 1}),
                        ("hpz3", {"zero_hpz_partition_size": 3}), ("mics2", {"mics_shard_size": 2}),
                        ("hpz2", {"zero_hpz_partition_size": 2})):
        try:
            layouts[label] = _parts(_port(state, 3, **zero))
        except ValueError as e:
            layouts[label] = f"ValueError: {e}"
    try:
        _port(tiny_state, 3, cfg=TINY)
        layouts["tiny3"] = None
    except ValueError as e:
        layouts["tiny3"] = str(e)
    layouts["tiny2"] = _parts(_port(tiny_state, 2, cfg=TINY))
    layouts["s3"] = _parts(engines["s3-f32"])
    out["layouts"] = layouts

    # reduce_scatter_tensor on both routes (the all-to-all one is gloo's on
    # CUDA tensors), recorded outside a step and not inside one
    x = torch.arange(W * 6, dtype=torch.float32) * (rank + 1)
    comm.configure(enabled=True)
    rs = {"native": comm.reduce_scatter_tensor(torch.empty(6), x.clone()).numpy(),
          "native_max": comm.reduce_scatter_tensor(torch.empty(6), x.clone(), op=comm.ReduceOp.MAX).numpy()}
    saved = dict(comm.REDUCE_SCATTER_ROUTES)
    comm.REDUCE_SCATTER_ROUTES[("gloo", "cpu")] = "all_to_all"
    try:
        rs["routed"] = comm.reduce_scatter_tensor(torch.empty(6), x.clone()).numpy()
        rs["routed_avg"] = comm.reduce_scatter_tensor(torch.empty(6), x.clone(), op=comm.ReduceOp.AVG).numpy()
    finally:
        comm.REDUCE_SCATTER_ROUTES.update(saved)
    rs["recorded"] = {k: sum(c for c, _ in v.values()) for k, v in comm.comms_logger().comms_dict.items()}
    _port(state, 2).train_batch(batch=_batch(0))
    rs["after_step"] = {k: sum(c for c, _ in v.values()) for k, v in comm.comms_logger().comms_dict.items()}
    out["reduce_scatter"] = rs

    # sparse_allreduce: rank r's rows r and r + 3 of an 8 x 4 gradient
    dense = torch.zeros(8, 4)
    dense[rank] = torch.arange(4.0) + 10 * rank + 1
    dense[rank + 3] = -(torch.arange(4.0) + rank)
    st = sparse_allreduce(SparseTensor(dense))
    out["sparse"] = {"indices": st.indices.numpy(), "values": st.values.numpy(), "dense": st.to_dense().numpy()}
    out["groups"] = {"dp": groups.get_data_parallel_world_size(), "mp": groups.get_model_parallel_world_size(),
                     "ep": groups.get_expert_parallel_world_size(), "sp": groups.get_sequence_parallel_world_size(),
                     "pp": groups.get_pipeline_parallel_world_size(), "rank": groups.get_data_parallel_rank(),
                     "group": groups.get_data_parallel_group()}
    comm.barrier()
    return out


# ------------------------------------------------------------------ JAX side

def _jax():
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.models import llama as jl
    from simple_model import TINY as JTINY
    jdiv = dataclasses.replace(JTINY, vocab_size=96, hidden_size=48, intermediate_size=96, dtype=jnp.float32,
                               scan_layers=False)
    return jax, jnp, jl, jdiv


def _jax_variables(jcfg, seed=11):
    """Every leaf N(0, 0.05²) from a numpy seed (norm scales 1), shapes by
    ``eval_shape``."""
    jax, jnp, jl, _ = _jax()
    shapes = jax.eval_shape(jl.LlamaForCausalLM(jcfg).init, jax.random.PRNGKey(0), jnp.zeros((1, SEQ), jnp.int32))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        if "norm" in jax.tree_util.keystr(path):
            return np.ones(s.shape, np.float32)
        return (0.05 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_engine_for(model, config, world, variables=None, **kw):
    """A JAX engine of ``model`` on ``data=world``."""
    jax = _jax()[0]
    import deepspeed_tpu as jds
    from deepspeed_tpu.comm.mesh import MeshSpec, create_mesh
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
    mesh = create_mesh(MeshSpec(data=world), devices=jax.devices()[:world])
    return jds.initialize(model=model, config=JaxConfig(dict(config), dp_world_size=world), mesh=mesh,
                          params=None if variables is None else variables["params"], dist_init_required=False,
                          **kw)[0]


def _jax_engine(jcfg, config, world, variables=None, **kw):
    jax, _, jl, _ = _jax()
    import deepspeed_tpu as jds
    from deepspeed_tpu.comm.mesh import MeshSpec, create_mesh
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
    mesh = create_mesh(MeshSpec(data=world), devices=jax.devices()[:world])
    return jds.initialize(model=jl.LlamaForCausalLM(jcfg), config=JaxConfig(dict(config), dp_world_size=world),
                          mesh=mesh, params=None if variables is None else variables["params"],
                          dist_init_required=False, **kw)[0]


def _jax_stage3_engine(jcfg, variables):
    """A JAX stage-3 engine on ``data=3`` in the layout its own initialisation
    gives (``initialize(params=...)`` unboxes the tree before it derives the
    shardings, and then shards nothing at stage 3), holding ``variables``:
    each leaf written through ``safe_set_full_fp32_param``."""
    jax = _jax()[0]
    from flax.linen import meta
    from deepspeed_tpu.utils import tensor_fragment as jtf
    eng = _jax_engine(jcfg, _config(3), W)
    eng._materialize_state(batch=_batch(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(meta.unbox(variables["params"]))
    for path, value in flat:
        jtf.safe_set_full_fp32_param(eng, "/".join(getattr(k, "key", str(k)) for k in path), np.asarray(value))
    return eng


def _port_name(path) -> str:
    """A JAX leaf path (unrolled tree) → the port's parameter name."""
    keys = [getattr(k, "key", k) for k in path]
    keys = [k for k in keys if k not in ("params", "model")]
    *mods, leaf = keys
    mods = [m.replace("layers_", "layers.") for m in mods]
    return ".".join(mods + ["bias" if leaf == "bias" else "weight"])


def _jax_specs(tree):
    """port name → the JAX NamedSharding of each leaf."""
    jax = _jax()[0]
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_port_name(path): sh for path, sh in flat}


@pytest.fixture(scope="module")
def div_variables():
    return _jax_variables(_jax()[3])


@pytest.fixture(scope="module")
def div_state(div_variables):
    jax = _jax()[0]
    return {k: v.numpy() for k, v in jax_llama_to_state_dict(jax.tree.map(np.asarray, div_variables), DIV).items()}


def _zoo_state(family, seed=5):
    """Seeded JAX params of ``family`` (``test_torch_gpt_family.seeded_params``)
    as the port's state dict (numpy)."""
    from deepspeed_tpu_torch.models import convert
    from test_torch_gpt_family import seeded_params
    import jax.numpy as jnp
    params = seeded_params(_zoo_jax_model(family), jnp.zeros((1, SEQ), jnp.int32), seed=seed)
    cfg = _zoo_port_model(family).cfg
    return {k: v.numpy() for k, v in getattr(convert, ZOO[family][2])({"params": params}, cfg).items()}


@pytest.fixture(scope="module")
def w3(tmp_path_factory, div_variables, div_state):
    """The three ranks' results, the JAX engines' runs and the one-rank
    port's runs (the spawn runs while the rest compute)."""
    jax, jnp, jl, jdiv = _jax()
    from simple_model import TINY as JTINY
    tiny_vars = _jax_variables(dataclasses.replace(JTINY, dtype=jnp.float32, scan_layers=False))
    tiny_state = {k: v.numpy() for k, v in jax_llama_to_state_dict(jax.tree.map(np.asarray, tiny_vars), TINY).items()}
    ckpt_dir = str(tmp_path_factory.mktemp("zero_ckpt"))
    zoo_states = {f: _zoo_state(f) for f in ZOO}
    ranks = {}

    def spawn():
        try:
            ranks["out"] = run_ranks(str(tmp_path_factory.mktemp("zero_w3")), _rank, div_state, tiny_state, ckpt_dir,
                                     zoo_states, world=W)
        except BaseException as e:
            ranks["error"] = e

    thread = threading.Thread(target=spawn)
    thread.start()
    try:
        batches = [_batch(s) for s in range(STEPS)]
        # one JAX engine on data=3 at stage 3 (the losses do not depend on the mesh) and its tensor_fragment
        from deepspeed_tpu.utils import tensor_fragment as jtf
        j3 = _jax_stage3_engine(jdiv, div_variables)
        jax_runs = {"f32": [float(j3.train_batch(batch=b)) for b in batches]}
        jax_runs["extra"] = [float(j3.train_batch(batch=_batch(STEPS))), float(j3.eval_batch(batch=_batch(0)))]
        fragment = {}
        for n in FRAGMENT_NAMES:
            path = _jax_path(n)
            fragment[n] = {"full": jtf.safe_get_full_fp32_param(j3, path),
                           "local": jtf.safe_get_local_fp32_param(j3, path),
                           "full_grad": jtf.safe_get_full_grad(j3, path),
                           "local_grad": jtf.safe_get_local_grad(j3, path),
                           "exp_avg": jtf.safe_get_full_optimizer_state(j3, path, "exp_avg"),
                           "local_exp_avg_sq": jtf.safe_get_local_optimizer_state(j3, path, "exp_avg_sq"),
                           "sharding": _leaf(j3.state.params, path).sharding}
        up = _jax_path("layers.0.mlp.up_proj.weight")
        jtf.safe_set_full_fp32_param(j3, up, 0.5 * jtf.safe_get_full_fp32_param(j3, up))
        jtf.safe_set_full_optimizer_state(j3, up, 2.0 * jtf.safe_get_full_optimizer_state(j3, up, "exp_avg"),
                                          "exp_avg")
        fragment["set"] = {"param": jtf.safe_get_full_fp32_param(j3, up),
                           "exp_avg": jtf.safe_get_full_optimizer_state(j3, up, "exp_avg")}
        jg = _jax_engine(jdiv, _config(0, gas=2), 1, div_variables)
        jax_runs["gas2"] = [float(jg.train_batch(batch=b)) for b in batches]
        jl_ = _jax_engine(jdiv, _config(0, opt="Lamb"), 1, div_variables)
        jax_runs["lamb"] = [float(jl_.train_batch(batch=b)) for b in batches]
        jax_runs["lamb_params"] = jax_llama_to_state_dict(jax.tree.map(np.asarray, jl_.state.params), DIV)
        one_rank = {}
        for name in ("s0-f32", "s0-gas2", "s0-lamb"):
            stage, dtype, gas, opt = RUNS[name]
            eng = _port(div_state, stage, dtype, gas, opt)
            one_rank[name] = {"losses": [float(eng.train_batch(batch=b)) for b in batches],
                              "params": _np(eng.module_state_dict())}
    finally:
        thread.join()
    if "error" in ranks:
        raise ranks["error"]
    return {"ranks": ranks["out"], "jax": jax_runs, "fragment": fragment, "one_rank": one_rank, "ckpt": ckpt_dir,
            "j3": j3}


def _jax_path(name: str) -> str:
    """The port name → the JAX unrolled tree's path."""
    parts = name.split(".")
    leaf = parts[-1]
    mods = parts[:-1]
    if mods[0] == "layers":
        mods = ["model", f"layers_{mods[1]}"] + mods[2:]
    kind = {"embed_tokens": "embedding", "norm": "weight"}.get(mods[-1], "kernel")
    if mods[-1].endswith("layernorm"):
        kind = "weight"
    return "/".join(mods + [kind if leaf == "weight" else "bias"])


def _leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _to_port(name: str, value, cfg=DIV) -> np.ndarray:
    """A JAX leaf's value in the port's layout."""
    part = param_shardings(jax_leaves(tl.LlamaForCausalLM(cfg, device="cpu")), _mesh(1), 0)[name]
    return part.port_view(torch.from_numpy(np.array(value, np.float32))).numpy()


def _mesh(world: int) -> Mesh:
    return Mesh({**dict.fromkeys(MESH_AXES, 1), "data": world})


# ------------------------------------------------------------------ layouts

def _port_layouts(cfg, world, stage, zero=None, model=None):
    from deepspeed_tpu_torch.runtime.config import ZeroConfig
    mesh = _mesh(world)
    param_axes, state_axes = resolve_partition_axes(mesh, ZeroConfig(stage=stage, **(zero or {})), stage)
    model = tl.LlamaForCausalLM(cfg, device="cpu") if model is None else model
    params = param_shardings(jax_leaves(model), mesh, stage, fsdp_axes=param_axes)
    return {"param": params, "state": master_and_optstate_shardings(params, mesh, stage, zero_axes=state_axes),
            "grad": grad_shardings(params, mesh, stage, zero_axes=state_axes)}


@pytest.mark.parametrize("world,which", [(3, "div"), (2, "tiny")])
@pytest.mark.parametrize("stage", [1, 2, 3])
def test_layouts_equal_the_jax_shardings(world, which, stage):
    """Each tensor's sharded dim and every rank's slice of a seeded tensor,
    for the parameter, the master, both moments and the gradient, equal the
    JAX engine's shardings (built abstractly: ``_materialize_state``)."""
    jax, jnp, jl, jdiv = _jax()
    from simple_model import TINY as JTINY
    jcfg = jdiv if which == "div" else dataclasses.replace(JTINY, dtype=jnp.float32, scan_layers=False)
    cfg = DIV if which == "div" else TINY
    eng = _jax_engine(jcfg, _config(stage, "bf16"), world)
    eng._materialize_state(batch={k: v[:2 * world] for k, v in _batch(0, rows=2 * world).items()}, abstract=True)
    from deepspeed_tpu.utils.tensor_fragment import _locate_moments
    moments = {name: _locate_moments(eng.state_shardings.opt_state, name) for name in ("exp_avg", "exp_avg_sq")}
    jax_sh = {"param": _jax_specs(eng.state_shardings.params), "state": _jax_specs(eng.state_shardings.master),
              "grad": _jax_specs(eng._grad_shardings),
              **{name: _jax_specs(getattr(c, field)) for name, (c, field, _) in moments.items()}}
    ours = _port_layouts(cfg, world, stage)
    ours["exp_avg"] = ours["exp_avg_sq"] = ours["state"]   # the moments take the master's partition
    devices = list(eng.mesh.devices.flat)
    rng = np.random.default_rng(3)
    sharded = 0
    for kind in jax_sh:
        assert set(jax_sh[kind]) == set(ours[kind])
        for name, sh in jax_sh[kind].items():
            part = ours[kind][name]
            dims = [d for d, e in enumerate(sh.spec) if e is not None]
            assert part.dim == (dims[0] if dims else None) and len(dims) <= 1, (kind, name, sh.spec, part)
            sharded += part.sharded
            value = rng.standard_normal(part.jax_shape).astype(np.float32)
            port = part.port_view(torch.from_numpy(value))     # the tensor in the port's layout
            index = sh.devices_indices_map(part.jax_shape)
            for r in range(world):
                np.testing.assert_array_equal(part.local(part.jax_view(port), r).numpy(), value[index[devices[r]]])
    assert sharded > 0
    if stage == 3:   # every tensor of these configs shards at stage 3
        assert all(p.sharded for p in ours["param"].values())


@pytest.mark.parametrize("stage", [1, 2, 3])
@pytest.mark.parametrize("family", list(ZOO))
def test_zoo_layouts_equal_the_jax_shardings(family, stage):
    """Falcon, OPT, Phi and GPT-2 at W = 3: each tensor's sharded dim and
    every rank's slice of a seeded tensor, for the parameter, the master,
    both moments and the gradient, equal the JAX engine's shardings (built
    abstractly); every tensor of these widths shards at stage 3 where JAX's
    logical axes carry ``embed`` or ``vocab``."""
    jax = _jax()[0]
    eng = _jax_engine_for(_zoo_jax_model(family), _config(stage, "bf16"), W)
    eng._materialize_state(batch=_batch(0, rows=2 * W), abstract=True)
    from deepspeed_tpu.utils.tensor_fragment import _locate_moments
    model = _zoo_port_model(family)
    names = {leaf.path: name for name, leaf in jax_leaves(model).items()}

    def specs(tree):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        return {names["/".join(getattr(k, "key", str(k)) for k in path)]: sh for path, sh in flat}

    moments = {name: _locate_moments(eng.state_shardings.opt_state, name) for name in ("exp_avg", "exp_avg_sq")}
    jax_sh = {"param": specs(eng.state_shardings.params), "state": specs(eng.state_shardings.master),
              "grad": specs(eng._grad_shardings),
              **{name: specs(getattr(c, field)) for name, (c, field, _) in moments.items()}}
    ours = _port_layouts(None, W, stage, model=model)
    ours["exp_avg"] = ours["exp_avg_sq"] = ours["state"]
    devices = list(eng.mesh.devices.flat)
    rng = np.random.default_rng(3)
    sharded = 0
    for kind in jax_sh:
        assert set(jax_sh[kind]) == set(ours[kind])
        for name, sh in jax_sh[kind].items():
            part = ours[kind][name]
            dims = [d for d, e in enumerate(sh.spec) if e is not None]
            assert part.dim == (dims[0] if dims else None) and len(dims) <= 1, (kind, name, sh.spec, part)
            sharded += part.sharded
            value = rng.standard_normal(part.jax_shape).astype(np.float32)
            port = part.port_view(torch.from_numpy(value))
            index = sh.devices_indices_map(part.jax_shape)
            for r in range(W):
                np.testing.assert_array_equal(part.local(part.jax_view(port), r).numpy(), value[index[devices[r]]])
    assert sharded > 0
    if stage == 3:
        annotated = [n for n, leaf in jax_leaves(model).items() if {"embed", "vocab"} & set(leaf.logical)]
        assert annotated and all(ours["param"][n].sharded for n in annotated)


@pytest.mark.parametrize("stage", [1, 2, 3])
@pytest.mark.parametrize("family", list(ZOO))
def test_zoo_trajectory_equals_stage_0(w3, family, stage):
    """Falcon, OPT, Phi and GPT-2 train 3 float32 AdamW steps at W = 3: each
    stage's losses equal stage 0's within rtol 1e-5 and its gathered
    parameters within 1e-6 for all but 1e-2 of the entries (OPT's learned
    positions and the key biases carry gradients at the rounding level of
    two summation orders, which Adam's early steps move by about lr either
    way), the same on every rank; the partitions are the rule functions'."""
    ranks = w3["ranks"]
    base = ranks[0]["zoo"][f"{family}-s0"]
    ours = _port_layouts(None, W, stage, model=_zoo_port_model(family))
    for r in ranks:
        run = r["zoo"][f"{family}-s{stage}"]
        np.testing.assert_allclose(run["losses"], base["losses"], rtol=1e-5)
        for k, v in run["params"].items():
            np.testing.assert_array_equal(v, ranks[0]["zoo"][f"{family}-s{stage}"]["params"][k])
        _assert_close_share(run["params"], base["params"], 1e-6, 1e-2, 2 * LR * STEPS)
        assert run["parts"] == {kind: [(p.name, p.dim, p.world) for p in ours[kind].values()] for kind in ours}
    assert base["parts"] is None and all(np.isfinite(base["losses"]))


def test_stage3_raises_where_jax_layout_raises():
    """``TINY`` at W = 3: vocab 128 does not divide by 3.  JAX refuses the
    layout when its engine initialises the weights into it (jit
    ``out_shardings``, at the first batch); the port raises naming the
    tensor, whatever gave the weights."""
    jax, jnp, jl, _ = _jax()
    from simple_model import TINY as JTINY
    jcfg = dataclasses.replace(JTINY, dtype=jnp.float32, scan_layers=False)
    with pytest.raises(ValueError, match="embed_tokens"):
        _jax_engine(jcfg, _config(3), W).train_batch(batch=_batch(0, vocab=JTINY.vocab_size))
    with pytest.raises(ValueError, match="embed_tokens.weight.*over 3 ranks"):
        _port_layouts(TINY, W, 3)
    assert not any(p.sharded for p in _port_layouts(TINY, W, 2)["grad"].values())   # stage 2 shards nothing


@pytest.mark.parametrize("size", [3, 1, 2, 4])
def test_mics_and_hpz_axes_match_jax(size):
    """``mics_zero_axes`` on the data-only mesh of 3: sizes of 3 or more take
    the data axis, 1 none, 2 raises; ``resolve_partition_axes`` as JAX's."""
    jax = _jax()[0]
    from deepspeed_tpu.comm.mesh import MeshSpec, create_mesh
    from deepspeed_tpu.runtime.config import DeepSpeedZeroConfig
    from deepspeed_tpu.runtime.zero import mics_zero_axes as jmics
    from deepspeed_tpu.runtime.zero import resolve_partition_axes as jresolve
    from deepspeed_tpu_torch.runtime.config import ZeroConfig
    jmesh = create_mesh(MeshSpec(data=W), devices=jax.devices()[:W])
    for key in ("mics_shard_size", "zero_hpz_partition_size"):
        try:
            want = (jmics(jmesh, size), jresolve(jmesh, DeepSpeedZeroConfig(stage=3, **{key: size}), 3))
        except ValueError as e:
            with pytest.raises(ValueError, match="must equal the product"):
                mics_zero_axes(_mesh(W), size)
            assert "must equal the product" in str(e)
            continue
        got = (mics_zero_axes(_mesh(W), size), resolve_partition_axes(_mesh(W), ZeroConfig(stage=3, **{key: size}), 3))
        assert got == want


# ------------------------------------------------------------------ trajectories

@pytest.mark.parametrize("name", [n for n in RUNS if n.endswith("f32") or "gas2" in n])
def test_float32_trajectory_matches_jax_and_one_rank(w3, name):
    """Losses within rtol 1e-5 of the JAX engine's on every rank; the
    gathered parameters equal on the ranks and within 1e-6 of the one-rank
    port's (all but 1e-3 of the model's entries, as stage 0 at W = 3: the
    ranks' shares of a gradient summed in another order)."""
    runs = [r["runs"][name] for r in w3["ranks"]]
    want = w3["jax"]["gas2" if "gas2" in name else "f32"]
    one = w3["one_rank"]["s0-gas2" if "gas2" in name else "s0-f32"]
    for run in runs:
        np.testing.assert_allclose(run["losses"], want, rtol=1e-5)
        for k, v in run["params"].items():
            np.testing.assert_array_equal(v, runs[0]["params"][k])
        _assert_close_share(run["params"], one["params"], 1e-6, 1e-3, 2 * LR * STEPS)
    assert len({r["norm"] for r in runs}) == 1   # get_global_grad_norm is the same on every rank


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_bf16_trajectory_matches_stage_0(w3, stage):
    """bf16 with a float32 master: every stage's losses equal stage 0's at
    W = 3 within rtol 1e-3 and its parameters within 2^-8 (all but 1e-3 of
    the entries: a float32 sum in another order rounds a master entry to
    the other bf16 neighbour, and Adam's step follows); the ranks agree bit
    for bit."""
    ranks = w3["ranks"]
    base = ranks[0]["runs"]["s0-bf16"]
    for r in ranks:
        run = r["runs"][f"s{stage}-bf16"]
        np.testing.assert_allclose(run["losses"], base["losses"], rtol=1e-3)
        for k, v in run["params"].items():
            np.testing.assert_array_equal(v, ranks[0]["runs"][f"s{stage}-bf16"]["params"][k])
        _assert_close_share(run["params"], base["params"], 2 ** -8, 1e-3, 2 * LR * STEPS)


@pytest.mark.parametrize("name", [n for n in RUNS if not n.startswith("s0")])
def test_each_rank_holds_its_slices(w3, name):
    """The per-rank state bytes equal ``estimate_partitioned_bytes`` of the
    engine's partitions: the master and the moments a third from stage 1,
    the parameters too at stage 3."""
    for r in w3["ranks"]:
        run = r["runs"][name]
        assert run["bytes"] == run["want_bytes"]
    stage = RUNS[name][0]
    full = sum(v.size for v in w3["ranks"][0]["runs"][name]["params"].values())
    assert w3["ranks"][0]["runs"][name]["bytes"]["moments"] == 2 * 4 * full // W
    if stage == 3:
        assert w3["ranks"][0]["runs"][name]["bytes"]["params"] * W == full * (2 if "bf16" in name else 4)


def test_stage3_frees_each_block_and_runs_remat_flash_saveable(w3):
    """At stage 3 block 0's gathered weight is gone when block 1 starts, in
    a training step (remat) and in ``eval_batch``, and nothing gathered is
    left after the step; their losses are JAX's.  Under remat
    ``flash_saveable`` over the flash op the stage-3 trajectory is stage
    0's."""
    jax_extra = w3["jax"]["extra"]
    for r in w3["ranks"]:
        # the step's forward, its remat recompute of block 1, the eval
        assert r["freed"]["alive_in_block_1"] == [False] * 3 and r["freed"]["released"]
        np.testing.assert_allclose(r["freed"]["losses"], jax_extra, rtol=1e-5)
        got, want = r["runs"]["s3-flash"], r["runs"]["s0-flash"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        _assert_close_share(got["params"], want["params"], 1e-6, 1e-3, 2 * LR * STEPS)


def test_stage3_imperative_path_matches_stage_0(w3):
    """``forward``, ``backward`` (of its loss, and of a fresh forward) and
    ``step()`` at gas 2 at stage 3: the losses and the update are stage 0's
    at W = 3."""
    for r in w3["ranks"]:
        got, want = r["runs"]["s3-imperative"], r["runs"]["s0-imperative"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
        _assert_close_share(got["params"], want["params"], 1e-6, 1e-3, 2 * LR)


def test_engine_layouts_are_the_rules(w3):
    """The engine's partitions at stage 3 are the rule functions' (the
    layouts held to JAX above)."""
    ours = _port_layouts(DIV, W, 3)
    for kind, parts in w3["ranks"][0]["layouts"]["s3"].items():
        assert parts == [(p.name, p.dim, p.world) for p in ours[kind].values()]


def test_lamb_at_stage_2_matches_jax(w3):
    """LAMB's trust ratio is per whole tensor: at stage 2 the slices' norms
    are summed over the ranks, and the trajectory matches JAX's."""
    for r in w3["ranks"]:
        run = r["runs"]["s2-lamb"]
        np.testing.assert_allclose(run["losses"], w3["jax"]["lamb"], rtol=1e-5)
        _assert_close_share(run["params"], {k: v.numpy() for k, v in w3["jax"]["lamb_params"].items()}, 1e-6, 1e-3,
                            2 * LR * STEPS)
        _assert_close_share(run["params"], r["runs"]["s0-lamb"]["params"], 1e-6, 1e-3, 2 * LR * STEPS)


def test_fp16_overflow_in_one_slice_skips_every_rank(w3):
    """An inf in rank 1's slice of a reduce-scattered gradient: every rank
    skips the step (master unchanged) and halves its scale."""
    for r in w3["ranks"]:
        assert r["fp16"] == {"sharded": True, "skipped": 1, "scale": 128.0, "unchanged": True}


# ------------------------------------------------------------------ the rest

def test_tensor_fragment_at_stage_3_matches_jax(w3):
    """Full and local parameter, gradient and moments of a stage-3 engine at
    W = 3 against a JAX stage-3 engine on ``data=3``; rank r's local slice
    is JAX's shard on device r (JAX's own "local" is device 0's)."""
    j3, jf = w3["j3"], w3["fragment"]
    devices = list(j3.mesh.devices.flat)
    for n in FRAGMENT_NAMES:
        want = jf[n]
        index = want["sharding"].devices_indices_map(np.shape(want["full"]))
        for r, rank in enumerate(w3["ranks"]):
            got = rank["fragment"][n]
            close = lambda a, b: _assert_close_share({"t": a}, {"t": b}, 1e-6, 1e-2, 2 * LR * STEPS)
            close(got["full"], _to_port(n, want["full"]))
            close(got["local"], np.asarray(want["full"])[index[devices[r]]])
            np.testing.assert_allclose(got["full_grad"], _to_port(n, want["full_grad"]), atol=1e-5, rtol=1e-3)
            np.testing.assert_allclose(got["local_grad"], np.asarray(want["full_grad"])[index[devices[r]]],
                                       atol=1e-5, rtol=1e-3)
            np.testing.assert_allclose(got["exp_avg"], _to_port(n, want["exp_avg"]), atol=1e-5, rtol=1e-3)
            if r == 0:   # JAX's local: the first addressable shard
                close(got["local"], want["local"])
                np.testing.assert_allclose(got["local_grad"], want["local_grad"], atol=1e-5, rtol=1e-3)
                np.testing.assert_allclose(got["local_exp_avg_sq"], want["local_exp_avg_sq"], atol=1e-9, rtol=1e-3)
    up = "layers.0.mlp.up_proj.weight"
    for rank in w3["ranks"]:
        got = rank["fragment"]["set"]
        _assert_close_share({"t": got["param"]}, {"t": _to_port(up, jf["set"]["param"])}, 1e-6, 1e-2, 2 * LR * STEPS)
        np.testing.assert_array_equal(got["module"], got["param"])   # the compute copy follows (float32)
        np.testing.assert_allclose(got["exp_avg"], _to_port(up, jf["set"]["exp_avg"]), atol=1e-5, rtol=1e-3)


def test_set_full_fp32_param_writes_master_and_bf16_copy(w3):
    """At stage 3 in bf16 ``safe_set_full_fp32_param`` writes this rank's
    float32 master slice and its bf16 parameter slice: the whole master
    reads back the value, the whole parameter its bf16 rounding, and rank
    r's local slice is its cut of the value."""
    for rank, r in enumerate(w3["ranks"]):
        got = r["set_bf16"]
        np.testing.assert_array_equal(got["master"], got["value"])
        np.testing.assert_array_equal(got["param"], torch.from_numpy(got["value"]).bfloat16().float().numpy())
        part = _port_layouts(DIV, W, 3)["state"]["layers.1.mlp.gate_proj.weight"]
        np.testing.assert_array_equal(got["local"], part.local(part.jax_view(torch.from_numpy(got["value"])),
                                                               rank).numpy())


def test_gathered_parameters_read_and_write(w3):
    """The gathered tensors are the whole parameters; a write without
    ``modifier_rank`` raises; with it, rank 0's value reaches every rank's
    parameter and master (rank 1's own write is dropped)."""
    for r in w3["ranks"]:
        g = r["gathered"]
        assert sorted(g["read"]) == [f"layers.1.mlp.{p}_proj.weight" for p in ("down", "gate", "up")]
        assert "modifier_rank" in g["refused"]
        down = "layers.1.mlp.down_proj.weight"
        np.testing.assert_array_equal(g["after"], 2 * g["read"][down])
        np.testing.assert_array_equal(g["master_after"], g["after"])


def test_zero_init_and_gathered_parameters_on_a_module():
    """``zero.Init`` is a context that changes nothing; ``GatheredParameters``
    over a module reads its parameters (writes are dropped with a warning)."""
    with tds.zero.Init() as ctx:
        model = tl.LlamaForCausalLM(TINY, device="cpu")
        tl.init_weights_(model, torch.Generator().manual_seed(0))
    assert ctx.enabled and tds.zero.MiCS_Init().__enter__() is not None
    with tds.zero.GatheredParameters(model, ["norm"], modifier_rank=0) as g:
        assert list(g.keys()) == ["layers.0.input_layernorm.weight", "layers.0.post_attention_layernorm.weight",
                                  "layers.1.input_layernorm.weight", "layers.1.post_attention_layernorm.weight",
                                  "norm.weight"]
        g["norm.weight"] = g["norm.weight"] * 2
    assert torch.equal(model.norm.weight, torch.ones(TINY.hidden_size))


def test_mics_hpz_and_tiny_in_the_engine(w3):
    """At stage 3 over 3 ranks: MiCS 3 and hpZ 3 are the plain layout, MiCS 1
    partitions nothing (the engine runs stage 0), sizes of 2 raise as JAX;
    ``TINY`` raises at stage 3 and shards nothing at stage 2."""
    lay = w3["ranks"][0]["layouts"]
    assert lay["mics3"] == lay["s3"] == lay["hpz3"]
    assert lay["mics1"] is None and lay["tiny2"] is None
    assert lay["mics2"].startswith("ValueError") and lay["hpz2"].startswith("ValueError")
    assert "embed_tokens.weight" in lay["tiny3"] and "3 ranks" in lay["tiny3"]


def test_checkpoint_is_the_same_whatever_the_stage_and_world(w3, div_state):
    """Saved at stage 3, W = 3 (whole tensors); loaded at stage 1, W = 3 and
    at stage 0, W = 1, the whole state equals what was saved, bit for bit;
    ``zero_to_fp32`` gives the gathered master."""
    from deepspeed_tpu_torch.checkpoint.zero_to_fp32 import get_fp32_state_dict_from_zero_checkpoint
    saved = w3["ranks"][0]["saved"]
    for r in w3["ranks"]:
        for k, v in saved.items():
            np.testing.assert_array_equal(r["saved"][k], v)
            np.testing.assert_array_equal(r["loaded_s1"][k], v)
    one = _port(div_state, 0, "bf16")
    one.load_checkpoint(w3["ckpt"])
    got = _snapshot(one)
    assert set(got) == set(saved)
    for k, v in saved.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    fp32 = get_fp32_state_dict_from_zero_checkpoint(w3["ckpt"])
    for k, v in fp32.items():
        np.testing.assert_array_equal(v.numpy(), saved[f"master/{k}"])


def test_tiled_linear_matches_jax():
    """``TiledLinear`` and ``copy_params_from_dense`` against the JAX layer:
    the same stacked kernel gives the same output; a dense kernel lands in
    the same tiles."""
    jax, jnp, _, _ = _jax()
    from deepspeed_tpu.runtime.zero import TiledLinear as JTiled
    from deepspeed_tpu.runtime.zero import copy_params_from_dense as jcopy
    from deepspeed_tpu_torch.runtime.zero import TiledLinear, copy_params_from_dense
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 12)).astype(np.float32)
    jl = JTiled(features=8, in_splits=3, out_splits=2)
    v = jl.init(jax.random.PRNGKey(1), x)
    ours = TiledLinear(12, 8, in_splits=3, out_splits=2)
    with torch.no_grad():
        ours.weight.copy_(torch.from_numpy(np.array(v["params"]["kernel"])))
    np.testing.assert_allclose(ours(torch.from_numpy(x)).detach().numpy(), np.asarray(jl.apply(v, x)), rtol=1e-5,
                               atol=1e-6)
    wd, bd = rng.standard_normal((12, 8)).astype(np.float32), rng.standard_normal(8).astype(np.float32)
    p2 = jcopy(v["params"], wd, bd)
    copy_params_from_dense(ours, torch.from_numpy(wd.T.copy()), torch.from_numpy(bd))
    np.testing.assert_array_equal(ours.weight.detach().numpy(), np.asarray(p2["kernel"]))
    np.testing.assert_allclose(ours(torch.from_numpy(x)).detach().numpy(), x @ wd + bd, rtol=1e-5, atol=1e-5)
    dense = torch.nn.Linear(12, 8)
    assert torch.equal(TiledLinear(12, 8, 3, 2).copy_params_from(dense)(torch.from_numpy(x)).detach(),
                       ours.copy_params_from(dense)(torch.from_numpy(x)).detach())


def test_sparse_tensor_and_allreduce_match_jax(w3):
    """``SparseTensor`` of a dense gradient as JAX's; ``sparse_allreduce`` at
    W = 3 against JAX's ``shard_map`` over 3 CPU devices: the same pairs in
    rank order (JAX's padded slots aside) and the same dense sum."""
    jax, jnp, _, _ = _jax()
    from jax.sharding import PartitionSpec as P
    from deepspeed_tpu.comm.mesh import MeshSpec, create_mesh
    from deepspeed_tpu.runtime.sparse_tensor import SparseTensor as JSparse
    from deepspeed_tpu.runtime.sparse_tensor import sparse_allreduce as jreduce
    from deepspeed_tpu_torch.runtime.sparse_tensor import SparseTensor
    dense = np.zeros((W, 8, 4), np.float32)
    for r in range(W):
        dense[r, r] = np.arange(4.0) + 10 * r + 1
        dense[r, r + 3] = -(np.arange(4.0) + r)
    j = JSparse(jnp.asarray(dense[1]))
    t = SparseTensor(torch.from_numpy(dense[1]))
    np.testing.assert_array_equal(t.indices.numpy(), np.asarray(j.indices))
    np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
    assert t.sparse_size() == j.sparse_size() and t.type().endswith("SparseTensor")
    np.testing.assert_array_equal(t.to_dense().numpy(), dense[1])
    np.testing.assert_array_equal(t.to_coo_tensor().to_dense().numpy(), dense[1])
    mesh = create_mesh(MeshSpec(data=W), devices=jax.devices()[:W])

    def body(d):
        st = jreduce(JSparse(d[0], max_nnz=2), "data")
        return st.indices, st.values, st.to_dense()

    idx, vals, summed = jax.shard_map(body, mesh=mesh, in_specs=P("data"), out_specs=(P(), P(), P()),
                                      check_vma=False)(jnp.asarray(dense))
    for r in w3["ranks"]:
        got = r["sparse"]
        np.testing.assert_array_equal(got["indices"], np.asarray(idx))
        np.testing.assert_array_equal(got["values"], np.asarray(vals))
        np.testing.assert_array_equal(got["dense"], np.asarray(summed))
        np.testing.assert_array_equal(got["dense"], dense.sum(0))


def test_reduce_scatter_tensor_routes_and_records(w3):
    """Chunk r of the sum over the ranks lands on rank r on both routes (the
    process group's, and the all-to-all with a sum in rank order that gloo
    takes for CUDA tensors; AVG divides by W, MAX is the group's); each call
    outside a step is recorded, a stage-2 step's (broadcasts at
    construction aside) are not."""
    total = sum(range(1, W + 1))
    for rank, r in enumerate(w3["ranks"]):
        got = r["reduce_scatter"]
        chunk = np.arange(rank * 6, rank * 6 + 6, dtype=np.float32)
        np.testing.assert_array_equal(got["native"], chunk * total)
        np.testing.assert_array_equal(got["routed"], chunk * total)
        np.testing.assert_array_equal(got["routed_avg"], chunk * total / W)
        np.testing.assert_array_equal(got["native_max"], chunk * W)
        assert got["recorded"] == {"reduce_scatter_tensor": 4}
        assert got["after_step"]["reduce_scatter_tensor"] == 4


def test_groups_sizes(w3):
    """The data group is the default process group (W = 3); every other axis has size 1."""
    for rank, r in enumerate(w3["ranks"]):
        assert r["groups"] == {"dp": W, "mp": 1, "ep": 1, "sp": 1, "pp": 1, "rank": rank, "group": None}


class _Warnings(logging.Handler):

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_zero_config_knobs():
    """Every knob of the JAX ``DeepSpeedZeroConfig`` is read and recorded
    (the ``stage3_*`` aliases too); qwZ raises naming item 7; the offload
    blocks parse (``tests/test_torch_offload.py`` holds their tiers), and the
    deprecated ``cpu_offload`` flag, which JAX stores without acting on it,
    raises naming itself; qgZ with a stage above 0 warns and keeps the
    float32 wire, as JAX."""
    base = {"train_batch_size": 2}
    knobs = {"stage": 3, "overlap_comm": True, "reduce_bucket_size": 10, "allgather_bucket_size": 10,
             "contiguous_gradients": False, "round_robin_gradients": True, "stage3_prefetch_bucket_size": 7,
             "stage3_max_live_parameters": 5, "stage3_param_persistence_threshold": 3, "sub_group_size": 4,
             "mics_shard_size": 2, "zero_hpz_partition_size": 2, "offload_optimizer": {"device": "none"}}
    zc = DeepSpeedConfig({**base, "zero_optimization": knobs}).zero_config
    assert (zc.stage, zc.overlap_comm, zc.reduce_bucket_size, zc.prefetch_bucket_size, zc.max_live_parameters,
            zc.param_persistence_threshold, zc.mics_shard_size, zc.round_robin_gradients) == \
        (3, True, 10, 7, 5, 3, 2, True)
    for bad, item in (({"zero_quantized_weights": True}, "item 7"), ({"cpu_offload": True}, "cpu_offload")):
        with pytest.raises(NotImplementedError, match=item):
            DeepSpeedConfig({**base, "zero_optimization": {"stage": 3, **bad}})
    zc = DeepSpeedConfig({**base, "zero_optimization": {"stage": 3, "offload_param": {"device": "cpu"},
                                                        "offload_optimizer": {"device": "nvme"}}}).zero_config
    assert (zc.offload_param.device, zc.offload_optimizer.device, zc.offload_optimizer.nvme_path) == \
        ("cpu", "nvme", None)
    with pytest.raises(DeepSpeedConfigError, match="unknown keys"):
        DeepSpeedConfig({**base, "zero_optimization": {"stage": 1, "no_such_knob": 1}})
    from deepspeed_tpu_torch.utils.logging import logger
    warned = _Warnings()
    logger.addHandler(warned)
    try:
        model = tl.init_weights_(tl.LlamaForCausalLM(TINY, device="cpu"), torch.Generator().manual_seed(0))
        eng = tds.initialize(model=model, device="cpu",
                             config={**base, "zero_optimization": {"stage": 2, "zero_quantized_gradients": True}})[0]
    finally:
        logger.removeHandler(warned)
    assert not eng.qgz and sum("zero_quantized_gradients needs" in m for m in warned.messages) == 1
