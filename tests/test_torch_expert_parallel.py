"""MoE over several ranks and expert parallelism (``comm/mesh.py``,
``utils/groups.py``, ``comm.AllToAll``, ``moe/``, the engine's expert
groups, ``runtime/zero`` with expert banks, Mixtral's JAX leaves and
universal atoms), against the JAX engine on ``MeshSpec(data=3)``,
``MeshSpec(data=2, expert=2)`` and ``MeshSpec(expert=3)`` over the virtual
CPU devices of ``tests/conftest.py``.  Tiny float32 Mixtrals (vocab 96,
hidden 48, 2 layers, top-2, capacity factor 1.0 so that groups drop
tokens) with 8 experts (``E8``) and 6 (``E6``).

  (a) every leaf's layout at stages 0-3 (parameter, master and moments,
      gradient) equals JAX's sharding, spec and every rank's slice: E8 and
      E6 at data 2 × expert 2, E6 at expert 3; an expert bank's partition
      within the experts a rank holds gives the same slices.  No spawn.
  (b) W = 3, expert 1 (E6): the trajectory, the loss a user sees
      (``eval_batch``), ``l_aux`` (the mean over the ranks' groups) and
      ``exp_counts`` (summed over the ranks) of a layer, and the
      parameters equal JAX's on ``data=3``;
  (c) expert 2 at W = 4 (E8) and expert 3 at W = 3 (E6): stages 0, 2 and 3
      equal JAX's on ``data=2, expert=2`` and ``expert=3``, and the port's
      expert-1 run at the same world; dense leaves are bit-identical on
      every rank and each rank's experts within its expert-data group;
  (d) the autograd all-to-all: an MoE layer's input and expert-weight
      gradients at expert 2 equal expert 1's (the banks' summed over the
      ranks);
  (e) a checkpoint saved at expert 2 (stage 2, W = 4) holds whole banks,
      loads into one rank, and its universal atoms load into JAX, whose
      next step equals the port's; JAX's atoms load back into the port;
  (f) what is not ported raises naming ROADMAP item 6.1; the comm and
      groups surface equals JAX's accessors.

One module-scoped spawn of 4 gloo ranks (run while JAX computes) re-forms
as 3 ranks for the W = 3 cases.  Tolerances, as ``tests/test_torch_zero.py``:
float32 losses rtol 1e-5; parameters within 2e-5 on all but 1e-3 of the
entries (Adam moves an entry by about lr whatever its gradient) and within
6·lr everywhere; ``l_aux`` rtol 1e-5; layer outputs and gradients within
1e-5 of their largest magnitude; counts exact.  JAX is imported only
inside the tests, so the ranks start without it.
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
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models import mixtral as tmix
from deepspeed_tpu_torch.models.convert import jax_leaves
from deepspeed_tpu_torch.module_inject.tp_rules import param_shardings
from deepspeed_tpu_torch.runtime.zero import grad_shardings, master_and_optstate_shardings

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "unit"))

from test_torch_qgz import run_ranks  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: F401,E402 (autouse fixture)

ROWS, SEQ, STEPS, LR, CLIP = 12, 16, 3, 1e-2, 0.5
SHAPE = dict(vocab_size=96, hidden_size=48, intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=64, rope_theta=1e4, num_experts_per_tok=2,
             capacity_factor=1.0)
EXPERTS = {"E8": 8, "E6": 6}
#: mesh name → (world, data, expert)
MESHES = {"d2e2": (4, 2, 2), "e3": (3, 1, 3), "d3": (3, 3, 1)}
#: run name → (experts, world, expert size, stage); ep 1 at each world is the port's own reference
RUNS4 = {f"ep2-s{s}": ("E8", 4, 2, s) for s in (0, 2, 3)}
RUNS4["ep1-s0"] = ("E8", 4, 1, 0)
RUNS3 = {f"ep3-s{s}": ("E6", 3, 3, s) for s in (0, 2, 3)}
RUNS3["ep1-s0"] = ("E6", 3, 1, 0)
#: what raises naming item 6.1 with MoE layers over several ranks: the zero block
RAISES = {"qgz": {"zero_quantized_gradients": True}, "loco": {"zero_quantized_gradients": True,
                                                               "zeropp_loco_param": {"err_beta": 0.8}},
          "mics": {"stage": 3, "mics_shard_size": 2}, "hpz": {"stage": 3, "zero_hpz_partition_size": 2},
          "offload_optimizer": {"stage": 2, "offload_optimizer": {"device": "cpu"}},
          "offload_param": {"stage": 3, "offload_param": {"device": "cpu"}}}


def _cfg(experts: str, remat: bool = True) -> tmix.MixtralConfig:
    return tmix.MixtralConfig(**SHAPE, num_local_experts=EXPERTS[experts], dtype=torch.float32,
                              attention_impl="reference", remat=remat)


def _batch(seed: int, rows: int = ROWS):
    ids = np.random.default_rng(seed).integers(0, SHAPE["vocab_size"], (rows, SEQ)).astype(np.int32)
    return {"input_ids": ids, "labels": ids}


def _config(stage: int, ep: int, **zero):
    return {"train_batch_size": ROWS, "steps_per_print": 0, "gradient_clipping": CLIP,
            "optimizer": {"type": "AdamW", "params": {"lr": LR, "weight_decay": 0.01}},
            "zero_optimization": {"stage": stage, **zero}, "moe": {"enabled": True, "expert_parallel_size": ep}}


def _port(state, experts, stage, ep, **zero):
    cfg = _cfg(experts)
    return tds.initialize(model=tmix.MixtralForCausalLM(cfg, device="cpu"), params=state, device="cpu",
                          config=_config(stage, ep, **zero), loss_fn=tmix.make_mixtral_loss_fn(cfg))[0]


def _np(sd):
    return {k: v.detach().float().numpy().copy() for k, v in sd.items()}


def _mesh(name: str) -> Mesh:
    _, data, expert = MESHES[name]
    return Mesh({**dict.fromkeys(MESH_AXES, 1), "data": data, "expert": expert})


def _assert_params_close(got, want):
    far = total = 0
    for k, w in want.items():
        diff = np.abs(np.asarray(got[k], np.float32) - np.asarray(w, np.float32))
        assert diff.max() <= 6 * LR, (k, diff.max())
        far += int((diff > 2e-5).sum())
        total += diff.size
    assert far <= 1e-3 * total, (far, total)


# ------------------------------------------------------------------ the ranks

def _train(state, experts, stage, ep, ckpt_dir=None):
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.utils import groups
    eng = _port(state, experts, stage, ep)
    comm.all_to_all_kinds.clear()
    losses = [float(eng.train_batch(batch=_batch(s))) for s in range(STEPS)]
    kinds = dict(comm.all_to_all_kinds)
    out = {"losses": losses, "eval": float(eng.eval_batch(batch=_batch(STEPS))),
           "params": _np(eng.module_state_dict()), "bytes": eng.state_bytes(), "kinds": kinds,
           "local_banks": {n: t.detach().numpy().copy() for n, t in eng.module.state_dict().items()
                           if ".experts." in n} if eng.zero is None or not eng.zero.units_on else None,
           "ed_rank": groups.get_expert_data_parallel_rank(), "ep_rank": groups.get_expert_parallel_rank()}
    if ckpt_dir is not None:
        eng.save_checkpoint(ckpt_dir, tag="ep2")
        from deepspeed_tpu_torch.checkpoint.engine import engine_state
        st = engine_state(eng)
        out["saved"] = {"params": _np(st["params"]),
                        "exp_avg": {n: st["opt_state"]["state"][i]["exp_avg"].numpy().copy()
                                    for i, n in enumerate(eng.param_names)}}
        out["next"] = float(eng.train_batch(batch=_batch(STEPS + 1)))
    return out


def _layer_grads(rank, ep, x, w, weights):
    """An MoE layer (E8's widths, whole weights ``weights``) at expert
    ``ep`` on this rank's rows ``x``: the input's gradient and the banks'
    gradients summed over the ranks that hold them (expert 1: all)."""
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.moe.layer import MoE
    from deepspeed_tpu_torch.utils import groups
    cfg = _cfg("E8")
    layer = tmix.moe_layer(cfg, "cpu")
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    if ep > 1:
        layer.experts.shard_(ep, groups.get_expert_parallel_rank())
    layer.set_expert_parallel(groups.get_expert_parallel_group() if ep > 1 else None, comm.get_world_size())
    xt = torch.from_numpy(x).requires_grad_(True)
    out, l_aux, counts = layer(xt)
    ((out * torch.from_numpy(w)).sum() + 0.1 * l_aux).backward()
    group = groups.get_expert_data_parallel_group() if ep > 1 else None
    banks = {}
    for n in layer.experts.WEIGHTS:
        g = getattr(layer.experts, n).grad.clone()
        comm.all_reduce(g, comm.ReduceOp.SUM, group=group)
        banks[n] = g.numpy()
    assert isinstance(layer, MoE)
    return {"out": out.detach().numpy(), "x_grad": xt.grad.numpy(), "banks": banks, "first": layer.experts.first_expert,
            "counts": counts.numpy()}


def _rank(rank, states, layer_inputs, ckpt_dir, init3):
    import deepspeed_tpu_torch.comm.comm as comm
    from deepspeed_tpu_torch.utils import groups
    from deepspeed_tpu_torch.utils import tensor_fragment as tf
    out = {4: {}, 3: {}}
    w4 = out[4]
    for name, (experts, _, ep, stage) in RUNS4.items():
        w4[name] = _train(states[experts], experts, stage, ep, ckpt_dir if name == "ep2-s2" else None)
    # the groups and the comm surface of the last engine's mesh (expert 2)
    _port(states["E8"], "E8", 0, 2)
    ep_group, ed_group = groups.get_expert_parallel_group(), groups.get_expert_data_parallel_group()
    w4["surface"] = {"dp": groups.get_data_parallel_world_size(), "ep": groups.get_expert_parallel_world_size(),
                     "ed": groups.get_expert_data_parallel_world_size(), "mp": groups.get_model_parallel_world_size(),
                     "ep_ranks": comm.get_all_ranks_from_group(ep_group),
                     "ed_ranks": comm.get_all_ranks_from_group(ed_group),
                     "world_ranks": comm.get_all_ranks_from_group(comm.get_world_group()),
                     "world_size": comm.get_world_size(comm.get_world_group()), "local_rank": comm.get_local_rank(),
                     "has": (comm.has_all_gather_into_tensor(), comm.has_reduce_scatter_tensor())}
    x, w, weights, _ = layer_inputs
    rows = x.shape[0] // 4
    mine = slice(rank * rows, (rank + 1) * rows)
    comm.all_to_all_kinds.clear()
    w4["layer"] = {ep: _layer_grads(rank, ep, x[mine], w[mine], weights) for ep in (1, 2)}
    w4["layer_kinds"] = dict(comm.all_to_all_kinds)
    raised = {}
    for name, zero in RAISES.items():
        zero = dict(zero)
        try:
            _port(states["E8"], "E8", zero.pop("stage", 0), 1, **zero)
            raised[name] = None
        except NotImplementedError as e:
            raised[name] = str(e)
    eng = _port(states["E8"], "E8", 0, 2)
    for name, call in (("rows", lambda: eng.train_batch(batch=_batch(0, rows=6))),
                       ("tensor_fragment", lambda: tf.safe_get_full_fp32_param(
                           eng, "layers.0.block_sparse_moe.experts.w_gate"))):
        try:
            call()
            raised[name] = None
        except NotImplementedError as e:
            raised[name] = str(e)
    w4["raised"] = raised
    # the all-to-all route of reduce_scatter_tensor (gloo's on CUDA tensors), whole and in chunks of 3 floats
    x = torch.randn(4 * 10, generator=torch.Generator().manual_seed(rank))
    saved, chunk = dict(comm.REDUCE_SCATTER_ROUTES), comm.ALL_TO_ALL_CHUNK_BYTES
    rs = {"native": comm.reduce_scatter_tensor(torch.empty(10), x.clone()).numpy()}
    try:
        comm.REDUCE_SCATTER_ROUTES[("gloo", "cpu")] = "all_to_all"
        rs["routed"] = comm.reduce_scatter_tensor(torch.empty(10), x.clone()).numpy()
        comm.ALL_TO_ALL_CHUNK_BYTES = 4 * 4 * 3
        calls = comm.call_counts["reduce_scatter_tensor"]
        rs["chunked"] = comm.reduce_scatter_tensor(torch.empty(10), x.clone()).numpy()
        rs["calls"] = comm.call_counts["reduce_scatter_tensor"] - calls
    finally:
        comm.REDUCE_SCATTER_ROUTES.update(saved)
        comm.ALL_TO_ALL_CHUNK_BYTES = chunk
    w4["reduce_scatter"] = rs
    from deepspeed_tpu_torch.runtime.zero import GatheredParameters
    bank = "layers.0.block_sparse_moe.experts.w_up"
    with GatheredParameters(eng, [bank], modifier_rank=0) as g:
        w4["gathered"] = {"bank": g[bank].numpy().copy(), "whole": _np(eng.module_state_dict())[bank]}
        g[bank] = 2.0 * g[bank]
    w4["gathered"]["written"] = _np(eng.module_state_dict())[bank]
    comm.barrier()
    torch.distributed.destroy_process_group()
    if rank == 3:
        return out
    comm.init_distributed(dist_backend="gloo", init_method=init3, rank=rank, world_size=3, verbose=False)
    for name, (experts, _, ep, stage) in RUNS3.items():
        out[3][name] = _train(states[experts], experts, stage, ep)
    # (b): the MoE layer of E6's first block on this rank's rows
    from deepspeed_tpu_torch.moe.layer import MoE
    model = tmix.MixtralForCausalLM(_cfg("E6"), device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in states["E6"].items()})
    ids = torch.from_numpy(_batch(0)["input_ids"][rank * 4:(rank + 1) * 4]).long()
    with torch.no_grad():
        out[3]["model_l_aux"] = float(model(ids)[1])
        layer = model.layers[0].block_sparse_moe
        layer.set_expert_parallel(None, 3)
        h = torch.from_numpy(layer_inputs[3][rank * 4:(rank + 1) * 4])
        o, l_aux, counts = layer(h)
    assert isinstance(layer, MoE)
    out[3]["layer"] = {"out": o.numpy(), "l_aux": float(l_aux), "counts": counts.numpy()}
    return out


# ------------------------------------------------------------------ JAX side

def _jax_cfg(experts: str):
    import jax.numpy as jnp
    from deepspeed_tpu.models import mixtral as jmix
    return jmix.MixtralConfig(**SHAPE, num_local_experts=EXPERTS[experts], dtype=jnp.float32, scan_layers=False,
                              remat=False, attention_impl="reference")


def _jax_model(experts: str):
    from deepspeed_tpu.models import mixtral as jmix
    return jmix.MixtralForCausalLM(_jax_cfg(experts))


def _jax_mesh(name: str):
    import jax
    from deepspeed_tpu.comm.mesh import MeshSpec, create_mesh
    world, data, expert = MESHES[name]
    return create_mesh(MeshSpec(data=data, expert=expert), devices=jax.devices()[:world])


def _seeded(experts: str, seed: int = 7):
    """JAX params from numpy (``test_torch_gpt_family.seeded_params``) and
    the port's state dict of them."""
    import jax
    import jax.numpy as jnp
    from test_torch_gpt_family import seeded_params
    params = seeded_params(_jax_model(experts), jnp.zeros((1, SEQ), jnp.int32), seed=seed)
    state = convert.jax_mixtral_to_state_dict(jax.tree.map(np.asarray, params), _cfg(experts))
    return params, {k: v.numpy() for k, v in state.items()}


def _jax_engine(experts: str, mesh_name: str, params=None):
    import deepspeed_tpu as jds
    from deepspeed_tpu.models import mixtral as jmix
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
    world, _, expert = MESHES[mesh_name]
    jcfg = _jax_cfg(experts)
    return jds.initialize(model=jmix.MixtralForCausalLM(jcfg), mesh=_jax_mesh(mesh_name), params=params,
                          config=JaxConfig(_config(0, expert), dp_world_size=world),
                          loss_fn=jmix.make_mixtral_loss_fn(jcfg), dist_init_required=False)[0]


def _jax_run(experts, mesh_name, params):
    import jax
    eng = _jax_engine(experts, mesh_name, params)
    losses = [float(eng.train_batch(batch=_batch(s))) for s in range(STEPS)]
    state = convert.jax_mixtral_to_state_dict(jax.tree.map(np.asarray, eng.state.params), _cfg(experts))
    return {"losses": losses, "eval": float(eng.eval_batch(batch=_batch(STEPS))), "params": _np(state), "engine": eng}


def _jax_layer(params, mesh_name, x):
    """JAX's first MoE layer of ``params`` on ``x`` under the mesh: (out, l_aux, exp_counts)."""
    import jax
    from deepspeed_tpu.comm.mesh import set_global_mesh
    from deepspeed_tpu.moe.layer import MoE as JMoE
    from jax.sharding import NamedSharding, PartitionSpec as P
    jcfg = _jax_cfg("E6")
    layer = JMoE(hidden_size=jcfg.hidden_size, num_experts=jcfg.num_local_experts,
                 intermediate_size=jcfg.intermediate_size, k=jcfg.num_experts_per_tok,
                 capacity_factor=jcfg.capacity_factor, eval_capacity_factor=jcfg.eval_capacity_factor,
                 min_capacity=jcfg.min_capacity, dtype=jcfg.dtype, param_dtype=jcfg.param_dtype)
    mesh = _jax_mesh(mesh_name)
    set_global_mesh(mesh)
    xs = jax.device_put(x, NamedSharding(mesh, P(("data", "expert"), None, None)))
    from flax import linen as nn
    weights = nn.meta.unbox(params["layers_0"]["block_sparse_moe"])
    out, l_aux, counts = jax.jit(lambda p, v: layer.apply({"params": p}, v))(weights, xs)
    return np.asarray(out), float(l_aux), np.asarray(counts)


def _jax_model_l_aux(params, mesh_name, ids):
    import jax
    from deepspeed_tpu.comm.mesh import set_global_mesh
    from jax.sharding import NamedSharding, PartitionSpec as P
    mesh = _jax_mesh(mesh_name)
    set_global_mesh(mesh)
    ids = jax.device_put(ids, NamedSharding(mesh, P(("data", "expert"), None)))
    from flax import linen as nn
    return float(jax.jit(lambda p, v: _jax_model("E6").apply({"params": p}, v))(nn.meta.unbox(params), ids)[1])


@pytest.fixture(scope="module")
def seeded():
    return {e: _seeded(e, seed=7 + i) for i, e in enumerate(EXPERTS)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, seeded):
    """The ranks' results and the JAX engines' runs (the spawn runs while JAX computes)."""
    states = {e: s for e, (_, s) in seeded.items()}
    rng = np.random.default_rng(5)
    layer_inputs = (rng.standard_normal((8, SEQ, 48)).astype(np.float32),
                    rng.standard_normal((8, SEQ, 48)).astype(np.float32),
                    {k.split("block_sparse_moe.")[1]: v for k, v in states["E8"].items()
                     if k.startswith("layers.0.block_sparse_moe.")},
                    rng.standard_normal((ROWS, SEQ, 48)).astype(np.float32))
    ckpt_dir = str(tmp_path_factory.mktemp("ep_ckpt"))
    spawn_dir = tmp_path_factory.mktemp("ep_ranks")
    ranks = {}

    def spawn():
        try:
            ranks["out"] = run_ranks(str(spawn_dir), _rank, states, layer_inputs, ckpt_dir,
                                     f"file://{spawn_dir}/rendezvous3", world=4)
        except BaseException as e:
            ranks["error"] = e

    thread = threading.Thread(target=spawn)
    thread.start()
    try:
        jax_runs = {"d2e2": _jax_run("E8", "d2e2", seeded["E8"][0]), "e3": _jax_run("E6", "e3", seeded["E6"][0]),
                    "d3": _jax_run("E6", "d3", seeded["E6"][0])}
        jax_runs["layer"] = _jax_layer(seeded["E6"][0], "d3", layer_inputs[3])
        jax_runs["model_l_aux"] = _jax_model_l_aux(seeded["E6"][0], "d3", _batch(0)["input_ids"])
    finally:
        thread.join()
    if "error" in ranks:
        raise ranks["error"]
    out = ranks["out"]
    return {"w4": [r[4] for r in out], "w3": [r[3] for r in out[:3]], "jax": jax_runs, "ckpt": ckpt_dir,
            "layer_inputs": layer_inputs}


# ------------------------------------------------------------------ (a) layouts

def _jax_layouts(experts, mesh_name, stage):
    """JAX's shardings of every leaf (the engine's ``_materialize_state``
    functions on the abstract boxed tree), by JAX path."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn
    from deepspeed_tpu.module_inject.tp_rules import param_shardings as jparam
    from deepspeed_tpu.runtime.zero.partition import grad_shardings as jgrad
    from deepspeed_tpu.runtime.zero.partition import master_and_optstate_shardings as jmaster
    mesh = _jax_mesh(mesh_name)
    model = _jax_model(experts)
    boxed = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, SEQ), jnp.int32))
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


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("case", ["E8-d2e2", "E6-d2e2", "E6-e3"])
def test_layouts_equal_the_jax_shardings(case, stage):
    """Every leaf's spec and every rank's slice of a seeded tensor equal
    JAX's, for the parameter, the master and moments, and the gradient; an
    expert bank's partition within a rank's experts (``within_held``, on
    its expert-data-parallel rank) cuts the same slices."""
    experts, mesh_name = case.split("-")
    jax_sh, devices = _jax_layouts(experts, mesh_name, stage)
    mesh = _mesh(mesh_name)
    model = tmix.MixtralForCausalLM(_cfg(experts), device="cpu")
    leaves = jax_leaves(model)
    params = param_shardings(leaves, mesh, stage)
    ours = {"param": params, "state": master_and_optstate_shardings(params, mesh, stage),
            "grad": grad_shardings(params, mesh, stage)}
    names = {leaf.path: name for name, leaf in leaves.items()}
    rng = np.random.default_rng(3)
    world, ep = MESHES[mesh_name][0], mesh.shape["expert"]
    checked_held = 0
    for kind, tree in jax_sh.items():
        assert set(names[p] for p in tree) == set(ours[kind])
        for path, sh in tree.items():
            part = ours[kind][names[path]]
            assert part.spec == _spec(sh.spec, len(part.jax_shape)), (kind, path, sh.spec, part.spec)
            value = rng.standard_normal(part.jax_shape).astype(np.float32)
            index = sh.devices_indices_map(part.jax_shape)
            for r in range(world):
                np.testing.assert_array_equal(part.local(torch.from_numpy(value), r).numpy(), value[index[devices[r]]])
            if "experts/" in path and ep > 1:
                local = part.jax_shape[0] // ep
                held = dataclasses.replace(part, shape=(local, ) + part.shape[1:], held=("expert", )).within_held()
                for r in range(world):
                    at = mesh.coords(r)
                    mine = torch.from_numpy(value[at["expert"] * local:(at["expert"] + 1) * local])
                    np.testing.assert_array_equal(held.local(mine, at["data"]).numpy(), value[index[devices[r]]])
                checked_held += 1
    assert (checked_held > 0) == (ep > 1)


def test_zero_shard_spec_extends_the_expert_dim_as_jax():
    """E8 at data 2 × expert 2: a bank's master is sharded ``(expert,
    data)`` on its expert dim (two whole experts a rank); E6 (6 % 4 != 0)
    puts ``data`` on its hidden dim."""
    from deepspeed_tpu_torch.runtime.zero.partition import zero_shard_spec
    mesh = _mesh("d2e2")
    assert zero_shard_spec((("expert", ), (), ()), (8, 48, 96), mesh) == (("expert", "data"), (), ())
    assert zero_shard_spec((("expert", ), (), ()), (6, 48, 96), mesh) == (("expert", ), ("data", ), ())
    assert zero_shard_spec(((), ()), (48, 96), mesh) == (("data", "expert"), ())
    assert zero_shard_spec((("expert", ), ("data", ), ()), (8, 48, 96), mesh) == (("expert", ), ("data", ), ())


# ------------------------------------------------------------------ (b)-(c) trajectories

@pytest.mark.parametrize("name", list(RUNS4) + [f"w3-{n}" for n in RUNS3])
def test_trajectory_equals_jax_and_expert_1(name, runs):
    """Losses (train and eval) within rtol 1e-5 of the JAX engine's on the
    run's mesh, the same on every rank; parameters as JAX's; an expert-
    parallel run's as the port's expert-1 run at the same world."""
    w3 = name.startswith("w3-")
    key = name[3:] if w3 else name
    experts, world, ep, stage = (RUNS3 if w3 else RUNS4)[key]
    ranks = runs["w3" if w3 else "w4"]
    mesh_name = {(4, 2): "d2e2", (4, 1): "d2e2", (3, 3): "e3", (3, 1): "d3"}[(world, ep)]
    want = runs["jax"][mesh_name]
    got = ranks[0][key]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    np.testing.assert_allclose(got["eval"], want["eval"], rtol=1e-5)
    assert all(r[key]["losses"] == got["losses"] and r[key]["eval"] == got["eval"] for r in ranks)
    _assert_params_close(got["params"], want["params"])
    if ep > 1:
        _assert_params_close(got["params"], ranks[0]["ep1-s0"]["params"])


@pytest.mark.parametrize("world", [4, 3])
def test_ranks_hold_identical_dense_leaves_and_banks_by_group(world, runs):
    """Whole parameters are bit-identical on every rank; each rank's own
    experts (stages 0 and 2) are bit-identical within its expert-data
    group, and are its slice of the whole bank."""
    ranks = runs["w4" if world == 4 else "w3"]
    for key in (RUNS4 if world == 4 else RUNS3):
        for r in ranks[1:]:
            for k, v in ranks[0][key]["params"].items():
                np.testing.assert_array_equal(r[key]["params"][k], v)
        for r in ranks:
            banks = r[key]["local_banks"]
            if banks is None:
                continue
            for n, local in banks.items():
                e = r[key]["ep_rank"]
                np.testing.assert_array_equal(local, r[key]["params"][n][e * local.shape[0]:(e + 1) * local.shape[0]])


def test_expert_parallel_state_bytes(runs):
    """State bytes a rank of the float32 stage-2 run at E8, data 2 × expert
    2: the parameters whole but for the banks' 4 experts of 8, no master,
    and the moments on the dense leaves' slices over 4 ranks and each
    bank's over its 2-rank expert-data group (2 whole experts a rank)."""
    model = tmix.MixtralForCausalLM(_cfg("E8"), device="cpu")
    leaves = jax_leaves(model)
    mesh = _mesh("d2e2")
    state = master_and_optstate_shardings(param_shardings(leaves, mesh, 2), mesh, 2)
    bank = [n for n in leaves if ".experts." in n]
    n_bank = sum(int(np.prod(leaves[n].shape)) for n in bank)
    n_dense = sum(int(np.prod(leaves[n].shape)) for n in leaves if n not in bank)
    dense_state = sum(state[n].local_numel for n in leaves if n not in bank)
    held = [dataclasses.replace(state[n], shape=(4, ) + state[n].shape[1:], held=("expert", )).within_held()
            for n in bank]
    assert sum(p.local_numel for p in held) == sum(state[n].local_numel for n in bank) == n_bank // 4
    assert all(p.group == "expert_data" and p.world == 2 for p in held)
    want = {"params": 4 * (n_dense + n_bank // 2), "master": 0, "moments": 8 * (dense_state + n_bank // 4)}
    for r in runs["w4"]:
        assert r["ep2-s2"]["bytes"] == want


def test_expert_parallel_all_to_alls_per_step(runs):
    """Each step of the expert-2 run makes 2 all-to-alls a layer forward
    (dispatch, combine), 2 more for the remat recompute and 2 backward; the
    expert-1 run none."""
    layers = SHAPE["num_hidden_layers"]
    for r in runs["w4"]:
        kinds = r["ep2-s2"]["kinds"]
        assert kinds == {("dispatch", "forward"): 2 * layers * STEPS, ("combine", "forward"): 2 * layers * STEPS,
                         ("dispatch", "backward"): layers * STEPS, ("combine", "backward"): layers * STEPS}
        assert r["ep1-s0"]["kinds"] == {}
        assert r["ep2-s0"]["bytes"]["params"] < r["ep1-s0"]["bytes"]["params"]


def test_layer_equals_jax_at_world_3(runs):
    """(b) the E6 layer on 3 ranks' rows: each rank's output rows, the mean
    of the ranks' ``l_aux`` and the summed ``exp_counts`` equal JAX's layer
    on ``data=3``; the model's ``l_aux`` averaged over the ranks equals
    JAX's model's."""
    out, l_aux, counts = runs["jax"]["layer"]
    ranks = runs["w3"]
    got = np.concatenate([r["layer"]["out"] for r in ranks])
    np.testing.assert_allclose(got, out, rtol=0, atol=1e-5 * np.abs(out).max())
    np.testing.assert_allclose(np.mean([r["layer"]["l_aux"] for r in ranks]), l_aux, rtol=1e-5)
    for r in ranks:
        np.testing.assert_array_equal(r["layer"]["counts"], counts)
    np.testing.assert_allclose(np.mean([r["model_l_aux"] for r in ranks]), runs["jax"]["model_l_aux"], rtol=1e-5)


# ------------------------------------------------------------------ (d) the all-to-all

def test_all_to_all_gradients_equal_expert_1(runs):
    """The layer at expert 2 against expert 1 on the same rows: outputs and
    input gradients within 1e-5 of their scale; each rank's bank gradients
    (summed over its expert-data group) equal its experts' rows of the
    expert-1 gradients summed over all ranks; one dispatch and one combine
    all-to-all each way."""
    ranks = runs["w4"]
    whole = ranks[0]["layer"][1]["banks"]     # expert 1: summed over all ranks already
    for r in ranks:
        one, two = r["layer"][1], r["layer"][2]
        for k in ("out", "x_grad"):
            np.testing.assert_allclose(two[k], one[k], rtol=0, atol=1e-5 * np.abs(one[k]).max())
        np.testing.assert_array_equal(two["counts"], one["counts"])
        for n, g in two["banks"].items():
            want = whole[n][two["first"]:two["first"] + g.shape[0]]
            np.testing.assert_allclose(g, want, rtol=0, atol=1e-5 * np.abs(want).max())
        assert r["layer_kinds"] == {(k, d): 1 for k in ("dispatch", "combine") for d in ("forward", "backward")}


# ------------------------------------------------------------------ (e) checkpoints

def test_checkpoint_at_expert_2_loads_at_one_rank_and_into_jax(runs, seeded, tmp_path):
    """The stage-2 expert-2 checkpoint holds whole banks: a one-rank engine
    loads it and its parameters and moments equal what the ranks saved; its
    universal atoms (JAX names and shapes) load into the JAX engine on
    ``data=2, expert=2``, whose next step equals the ranks' next step; that
    engine's own atoms load back into a port engine."""
    import jax
    from deepspeed_tpu.checkpoint import convert_to_universal as jconvert
    from deepspeed_tpu.checkpoint import load_universal_checkpoint as jload
    from deepspeed_tpu_torch.checkpoint import convert_to_universal, load_universal_atoms, load_universal_checkpoint
    saved = runs["w4"][0]["ep2-s2"]
    one = _port(seeded["E8"][1], "E8", 0, 1)
    one.load_checkpoint(runs["ckpt"], tag="ep2")
    assert one.dp_world == 1 and one.global_steps == STEPS
    got = _np(one.module_state_dict())
    for k, v in saved["saved"]["params"].items():
        np.testing.assert_array_equal(got[k], v)
    for i, n in enumerate(one.param_names):
        np.testing.assert_array_equal(one.optimizer.state[one._targets[i]]["exp_avg"].numpy(),
                                      saved["saved"]["exp_avg"][n])
    dst = convert_to_universal(runs["ckpt"], str(tmp_path / "uni"), tag="ep2")
    atoms = load_universal_atoms(dst)
    leaves = jax_leaves(one.module)
    assert sorted(atoms) == sorted(lf.path.replace("/", ".") for lf in leaves.values())
    assert all(atoms[lf.path.replace("/", ".")]["fp32"].shape == lf.shape for lf in leaves.values())
    jeng = runs["jax"]["d2e2"]["engine"]
    jload(jeng, dst)
    np.testing.assert_allclose(float(jeng.train_batch(batch=_batch(STEPS + 1))), saved["next"], rtol=1e-5)
    jeng.save_checkpoint(str(tmp_path / "jax"), tag="t")
    jconvert(str(tmp_path / "jax"), str(tmp_path / "juni"), tag="t")
    back = _port(seeded["E8"][1], "E8", 2, 1)
    load_universal_checkpoint(back, str(tmp_path / "juni"))
    assert back.global_steps == STEPS + 1
    _assert_params_close(_np(back.module_state_dict()),
                         {k: v.numpy() for k, v in convert.jax_mixtral_to_state_dict(
                             jax.tree.map(np.asarray, jeng.state.params), _cfg("E8")).items()})


# ------------------------------------------------------------------ (f) raises and the surface

@pytest.mark.parametrize("name", list(RAISES) + ["rows", "tensor_fragment"])
def test_unported_raise_naming_item_6_1(name, runs):
    """qgZ, LoCo, MiCS, hpZ and the offload tiers with MoE layers at W = 4,
    a micro-batch whose rows do not split over the ranks (JAX gates it as
    one group) and ``tensor_fragment`` of a bank cut over the expert group
    raise naming ROADMAP item 6.1."""
    msg = runs["w4"][0]["raised"][name]
    assert msg is not None and "item 6.1" in msg, msg


def test_gathered_parameters_hold_whole_banks(runs):
    """``GatheredParameters`` over an expert-2 engine gathers a bank whole
    (the expert group's experts too), and a write from rank 0 reaches every
    rank's experts."""
    for r in runs["w4"]:
        g = r["gathered"]
        assert g["bank"].shape == (EXPERTS["E8"], SHAPE["hidden_size"], SHAPE["intermediate_size"])
        np.testing.assert_array_equal(g["bank"], g["whole"])
        np.testing.assert_array_equal(g["written"], 2.0 * g["whole"])


def test_reduce_scatter_all_to_all_route_in_chunks(runs):
    """The all-to-all route of ``reduce_scatter_tensor`` sent in chunks
    (``ALL_TO_ALL_CHUNK_BYTES``: pinned host copies stay small) sums in the
    same rank order as in one piece, bit for bit, and is one call."""
    for r in runs["w4"]:
        rs = r["reduce_scatter"]
        np.testing.assert_array_equal(rs["chunked"], rs["routed"])
        np.testing.assert_allclose(rs["routed"], rs["native"], rtol=1e-6)
        assert rs["calls"] == 1


def test_groups_and_comm_surface_equal_jax(runs):
    """At data 2 × expert 2: the groups' sizes equal JAX's accessors on the
    same mesh; the expert group is ranks 2d, 2d + 1 and the expert-data
    group e, 2 + e (global ranks, in order); the world group's ranks are
    JAX's ``get_all_ranks_from_group`` of its world group."""
    from deepspeed_tpu.comm import comm as jcomm
    from deepspeed_tpu.comm.mesh import axis_size, set_global_mesh
    from deepspeed_tpu.utils import groups as jgroups
    mesh = _jax_mesh("d2e2")
    set_global_mesh(mesh)
    for rank, r in enumerate(runs["w4"]):
        s = r["surface"]
        assert s["dp"] == jgroups.get_data_parallel_world_size() == 4
        assert s["ep"] == jgroups.get_expert_parallel_world_size() == 2
        assert s["ed"] == axis_size(mesh, *jgroups.get_expert_data_parallel_group()) == 2
        assert s["mp"] == jgroups.get_model_parallel_world_size() == 1
        d, e = divmod(rank, 2)
        assert s["ep_ranks"] == [2 * d, 2 * d + 1] and s["ed_ranks"] == [e, 2 + e]
        assert s["world_ranks"] == jcomm.get_all_ranks_from_group(jcomm.get_world_group())
        assert s["world_size"] == jcomm.get_world_size(jcomm.get_world_group())
        assert s["local_rank"] == jcomm.get_local_rank() and s["has"] == (True, True)


def test_comms_logger_summary_equals_jax():
    """``CommsLogger.append`` (with the reference's record name),
    ``log_all`` and ``comm.log_summary`` keep and return what JAX's do."""
    from deepspeed_tpu.comm import comm as jcomm
    from deepspeed_tpu_torch.comm import comm
    entries = [("all_reduce", "all_reduce", 0.5e-3, 64), ("all_to_all_single", "moe", 1e-3, 128),
               ("all_reduce", "all_reduce", 0.25e-3, 64)]
    loggers = (comm.CommsLogger(), jcomm.CommsLogger())
    for lg in loggers:
        for e in entries:
            lg.append(*e)
    assert loggers[0].log_all(print_log=False) == loggers[1].log_all(print_log=False)
    assert comm.log_summary() == jcomm.log_summary() == {}
    comm.configure(enabled=True)
    jcomm.configure(enabled=True)
    try:
        for lg in (comm.comms_logger(), jcomm.comms_logger()):
            for e in entries:
                lg.append(*e)
        assert comm.log_summary() == jcomm.log_summary() == loggers[0].comms_dict
    finally:
        comm._COMMS_LOGGER = None
        jcomm._COMMS_LOGGER = None


def test_mesh_coordinates_follow_jax_device_order():
    """``Mesh.coords``/``rank`` and the groups' ranks follow JAX's device
    order (``MESH_AXES`` row-major) at data 2 × expert 2 and expert 3."""
    from deepspeed_tpu_torch.utils.groups import expert_ranks
    for name in ("d2e2", "e3"):
        jmesh = _jax_mesh(name)
        mesh = _mesh(name)
        ids = {d.id: i for i, d in enumerate(jmesh.devices.flat)}
        grid = np.vectorize(lambda d: ids[d.id])(jmesh.devices)
        for r in range(MESHES[name][0]):
            at = mesh.coords(r)
            assert grid[tuple(at[a] for a in MESH_AXES)] == r and mesh.rank(at) == r
            assert expert_ranks(mesh, "expert", r) == list(grid[0, at["data"], :, 0, 0])
            assert expert_ranks(mesh, "data", r) == list(grid[0, :, at["expert"], 0, 0])
