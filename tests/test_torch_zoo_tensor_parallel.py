"""Falcon, OPT and Phi at tensor > 1 (``models/{falcon,opt,phi,cache_zoo}.py``,
``module_inject/{layers,tp_rules}.py``, ``models/convert.py`` ``jax_leaves``,
the training engine, the v2 engine's tensor-parallel serving and
``compile_aot_serving``), and ``initialize(mpu=)`` (``comm/mesh.py``
``mesh_from_mpu``), against the JAX package on the CPU, on the same
numpy-seeded float32 weights and inputs.

Four tiny presets whose heads, kv heads, MLP and vocab 2 and 3 divide:
Falcon-RW (alibi, sequential blocks, 6:6 heads), Falcon's new decoder
architecture (parallel block off ``ln_attn``/``ln_mlp``, 12:6 heads), OPT
(learned positions, ``project_in``/``project_out`` of OPT-350M) and Phi
(partial rotary, ``qk_layernorm``, the biased head).

  * **Layouts** (no spawn): at ``MeshSpec(data=3, tensor=2)``, stages 0-3,
    every leaf's spec and every rank's slice equal JAX's shardings (its
    ``tp_rules`` and ``runtime/zero/partition`` functions on the abstract
    boxed tree); the biases the port cuts with their heads or vocab (q/k/v,
    the MLP's up projection, Phi's head) are whole in JAX, ``tensor`` on
    their first dim here.
  * **Training** (one spawn of 6 gloo ranks, run while JAX computes): each
    family at data 3 × tensor 2, stages 0 and 3, 3 AdamW steps with
    clipping, against the JAX engine at the same mesh: losses and the eval
    loss within rtol 1e-5 and equal on every rank, the parameters within
    2e-5 on all but 1e-3 of the entries; the replicated tensors (norms,
    row-parallel biases, OPT's positions and projections) bit-identical
    over each tensor group; ``model_parallel_rng_key`` differs per tensor
    rank and not per data rank; Phi's stage-3 checkpoint loads at tensor
    1.  ``initialize(mpu=FakeMPU(tp=2, dp=3))`` gives
    data 3 × tensor 2 with q/k/v cut in half (JAX
    ``test_mpu_grid_maps_to_mesh_and_shards_params``).
  * **Serving**: ranks 0-2, then 0-1, re-formed, serve each twin at tensor 3
    and 2 through ``build_engine`` (whole state dicts cut by the engine):
    every rank emits JAX's greedy tokens and the port's one-rank engine's,
    with one embed, 2 × L row-parallel (``o_proj``, ``down_proj``: a
    parallel block reduces its two branches apart) and one logits
    collective a forward; the arena holds the rank's kv heads.  Tiny
    Falcon-RW and OPT checkpoint directories (HF's names, Falcon's fused
    ``query_key_value``) go through ``build_hf_engine`` at tensor 3 and 2
    with the one-rank engine's tokens.
  * ``compile_aot_serving``: a rank's bytes at tensor 2 equal the sum of
    JAX's ``_serving_shardings`` shard shapes less half of the biases JAX
    keeps whole; Phi-2's reckoning (the chip's).
  * Falcon-7B's one kv head at tensor 2 raises JAX's ``ValueError``; an
    overcommitted ``mpu`` grid raises JAX's ``ValueError`` in both packages.

JAX is imported only inside the tests, so the ranks start without it.
"""

import dataclasses
import importlib
import os
import re
import sys
import threading

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.comm.mesh import MESH_AXES, Mesh
from deepspeed_tpu_torch.inference.v2 import (PagedKVConfig, RaggedInferenceEngineConfig, SchedulerConfig, build_engine,
                                              build_hf_engine, compile_aot_serving)
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models.convert import jax_leaves
from deepspeed_tpu_torch.module_inject.tp_rules import param_shardings
from deepspeed_tpu_torch.runtime.zero import grad_shardings, master_and_optstate_shardings

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "unit"))

from test_torch_qgz import run_ranks  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: F401,E402 (autouse fixture)

ROWS, SEQ, STEPS, LR, CLIP = 12, 16, 3, 1e-2, 0.5
DATA, TENSOR = 3, 2
#: family → (model module, config class, model class, config fields, the JAX tree's converter)
FAMILIES = {
    "falcon-rw": ("falcon", "FalconConfig", "FalconForCausalLM",
                  dict(vocab_size=96, hidden_size=48, num_hidden_layers=2, num_attention_heads=6, num_kv_heads=6,
                       alibi=True, parallel_attn=False, bias=True, max_position_embeddings=64),
                  "jax_falcon_to_state_dict"),
    "falcon-new": ("falcon", "FalconConfig", "FalconForCausalLM",
                   dict(vocab_size=96, hidden_size=48, num_hidden_layers=2, num_attention_heads=12, num_kv_heads=6,
                        new_decoder_architecture=True, num_ln_in_parallel_attn=2, bias=True,
                        tie_word_embeddings=False, max_position_embeddings=64), "jax_falcon_to_state_dict"),
    "opt": ("opt", "OPTConfig", "OPTForCausalLM",
            dict(vocab_size=96, hidden_size=48, ffn_dim=96, num_hidden_layers=2, num_attention_heads=6,
                 max_position_embeddings=64, word_embed_proj_dim=24), "jax_opt_to_state_dict"),
    "phi": ("phi", "PhiConfig", "PhiForCausalLM",
            dict(vocab_size=96, hidden_size=48, intermediate_size=96, num_hidden_layers=2, num_attention_heads=6,
                 num_key_value_heads=6, partial_rotary_factor=0.5, qk_layernorm=True, max_position_embeddings=64),
            "jax_phi_to_state_dict"),
}
#: the biases a family's rank holds cut (whole in JAX): q/k/v and the up projection a layer, Phi's head
CUT_BIASES = {"falcon-rw": 8, "falcon-new": 8, "opt": 8, "phi": 9}
STAGES = (0, 3)
#: the run whose checkpoint, saved at data 3 x tensor 2, one rank loads
CHECKPOINTED = ("phi", 3)
KV = dict(num_pages=64, page_size=8, max_pages_per_seq=8)
SCHED = dict(token_budget=64, max_seqs=8, prefill_chunk=8, decode_bucket=4)
PROMPTS = [[5, 9, 2, 7, 1], [3, 3, 8, 4, 6], [11, 4, 4, 9, 2]]
NEW = 6


def _mesh(data: int = 1, tensor: int = 1) -> Mesh:
    return Mesh({**dict.fromkeys(MESH_AXES, 1), "data": data, "tensor": tensor})


def _cfg(family: str, serve: bool = False):
    module, cfg_cls, _, fields, _ = FAMILIES[family]
    mod = importlib.import_module(f"deepspeed_tpu_torch.models.{module}")
    return getattr(mod, cfg_cls)(**fields, dtype=torch.float32, attention_impl="flash" if serve else "reference")


def _model(family: str, device="cpu", tensor_parallel: int = 1):
    module, _, model_cls, _, _ = FAMILIES[family]
    mod = importlib.import_module(f"deepspeed_tpu_torch.models.{module}")
    return getattr(mod, model_cls)(_cfg(family), device=device, tensor_parallel=tensor_parallel)


def _batch(seed: int, rows: int = ROWS):
    ids = np.random.default_rng(seed).integers(0, 96, (rows, SEQ)).astype(np.int32)
    return {"input_ids": ids, "labels": ids}


def _config(stage: int, tensor: int = TENSOR):
    return {"train_batch_size": ROWS, "steps_per_print": 0, "gradient_clipping": CLIP,
            "optimizer": {"type": "AdamW", "params": {"lr": LR, "weight_decay": 0.01}},
            "zero_optimization": {"stage": stage}, "tensor_parallel": {"autotp_size": tensor}}


def _np(sd):
    return {k: v.detach().float().numpy().copy() for k, v in sd.items()}


def _econf(tp: int = 1):
    return RaggedInferenceEngineConfig(kv=PagedKVConfig(**KV), scheduler=SchedulerConfig(**SCHED),
                                       kv_dtype=torch.float32, tensor_parallel=tp)


class FakeMPU:
    """A Megatron-style grid (JAX ``tests/unit/inference/test_megatron.py:16``)."""

    def __init__(self, tp=2, dp=4, pp=1):
        self._tp, self._dp, self._pp = tp, dp, pp

    def get_model_parallel_world_size(self):
        return self._tp

    def get_data_parallel_world_size(self):
        return self._dp

    def get_pipeline_model_parallel_world_size(self):
        return self._pp


# ------------------------------------------------------------------ the ranks

def _train(family, state, stage, ckpt_dir=None):
    eng = tds.initialize(model=_model(family), params=state, device="cpu", config=_config(stage))[0]
    losses = [float(eng.train_batch(batch=_batch(s))) for s in range(STEPS)]
    out = {"losses": losses, "eval": float(eng.eval_batch(batch=_batch(STEPS))),
           "params": _np(eng.module_state_dict()), "local": _np(eng.module.state_dict()) if stage < 3 else None}
    if ckpt_dir is not None:
        eng.save_checkpoint(ckpt_dir, tag="tp2")
        opt = eng.full_optimizer_state_dict()["state"]
        out["exp_avg"] = {n: opt[i]["exp_avg"].numpy().copy() for i, n in enumerate(eng.param_names)}
    return out


def _mpu_run(state):
    """JAX's mpu case at ``FakeMPU(tp=2, dp=3)``: the engine's mesh, a rank's
    q_proj rows and one step's loss."""
    from deepspeed_tpu_torch.models import llama as tl
    cfg = tl.LlamaConfig(vocab_size=96, hidden_size=48, intermediate_size=96, num_hidden_layers=2,
                         num_attention_heads=6, num_key_value_heads=6, max_position_embeddings=64, rope_theta=1e4,
                         dtype=torch.float32, attention_impl="reference")
    eng = tds.initialize(model=tl.init_weights_(tl.LlamaForCausalLM(cfg, device="cpu"),
                                                torch.Generator().manual_seed(2)),
                         mpu=FakeMPU(tp=2, dp=3), device="cpu",
                         config={"train_batch_size": 6, "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
                                 "tensor_parallel": {"autotp_size": 2}, "zero_optimization": {"stage": 0}})
    ids = np.zeros((6, 16), np.int32)
    loss = float(eng[0].train_batch(batch={"input_ids": ids, "labels": ids}))
    return {"mesh": dict(eng[0].mesh.shape), "q_rows": tuple(eng[0].module.layers[0].self_attn.q_proj.weight.shape),
            "loss": loss}


def _serve(states, tp, hf_dirs):
    from deepspeed_tpu_torch.comm import comm
    out = {}
    for family in FAMILIES:
        comm.tensor_parallel_kinds.clear()
        eng = build_engine(_cfg(family, serve=True), states[family], _econf(tp), device="cpu")
        out[family] = {"tokens": eng.generate(PROMPTS, max_new_tokens=NEW), "forwards": eng.forward_calls,
                       "kinds": dict(comm.tensor_parallel_kinds), "arena": tuple(eng.cache[0].shape)}
    for kind, path in hf_dirs.items():
        out[f"hf-{kind}"] = build_hf_engine(path, _econf(tp), device="cpu").generate(PROMPTS, max_new_tokens=NEW)
    return out


#: what stays out of scope for Phi at tensor 2: the config's ``zero_optimization`` block
OUT_OF_SCOPE_ZERO = {"qgz": {"stage": 0, "zero_quantized_gradients": True},
                     "loco": {"stage": 0, "zero_quantized_gradients": True, "zeropp_loco_param": {"err_beta": 0.8}},
                     "mics": {"stage": 3, "mics_shard_size": 3}, "hpz": {"stage": 3, "zero_hpz_partition_size": 3},
                     "offload": {"stage": 2, "offload_optimizer": {"device": "cpu"}}}


def _out_of_scope(state, trained):
    """What stays out of scope at tensor 2 (each a NotImplementedError's
    text, or None): the ZeRO wire, MiCS/hpZ and offload for Phi, a custom
    loss without ``rank_share``, ``tensor_fragment`` of a cut tensor, CLIP
    in the v1 engine."""
    from deepspeed_tpu_torch.models.clip import ClipModel, ClipTextConfig, ClipVisionConfig
    from deepspeed_tpu_torch.utils.tensor_fragment import safe_get_full_fp32_param
    calls = {name: (lambda zero=zero: tds.initialize(model=_model("phi"), params=state, device="cpu",
                                                     config={**_config(0), "zero_optimization": zero}))
             for name, zero in OUT_OF_SCOPE_ZERO.items()}
    calls["loss_fn"] = lambda: tds.initialize(model=_model("phi"), params=state, device="cpu", config=_config(0),
                                              loss_fn=lambda outputs, batch: outputs.float().mean())
    calls["tensor_fragment"] = lambda: safe_get_full_fp32_param(trained, "layers.0.self_attn.q_proj.weight")
    calls["v1-clip"] = lambda: tds.init_inference(ClipModel(ClipTextConfig(), ClipVisionConfig(), device="meta"),
                                                  tensor_parallel=2, device="cpu")
    raised = {}
    for name, call in calls.items():
        try:
            call()
            raised[name] = None
        except NotImplementedError as e:
            raised[name] = str(e)
    return raised


def _rank(rank, states, inits, hf_dirs, ckpt_dir):
    from deepspeed_tpu_torch.comm import comm
    out = {"train": {}}
    for family in FAMILIES:
        for stage in STAGES:
            save = ckpt_dir if (family, stage) == CHECKPOINTED else None
            out["train"][(family, stage)] = _train(family, states[family], stage, save)
    trained = tds.initialize(model=_model("phi"), params=states["phi"], device="cpu", config=_config(0))[0]
    out["raised"] = _out_of_scope(states["phi"], trained)
    out["mpu"] = _mpu_run(states["phi"])
    from deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing import model_parallel_rng_key
    out["rng"] = torch.rand(8, generator=model_parallel_rng_key(17, device="cpu")).numpy()
    for world, init in zip((3, 2), inits):
        comm.barrier()
        torch.distributed.destroy_process_group()
        if rank >= world:
            return out
        comm.init_distributed(dist_backend="gloo", init_method=init, rank=rank, world_size=world, verbose=False)
        out[world] = _serve(states, world, hf_dirs)
    return out


# ------------------------------------------------------------------ JAX side

def _jax_cfg(family):
    import jax.numpy as jnp
    module, cfg_cls, _, fields, _ = FAMILIES[family]
    mod = importlib.import_module(f"deepspeed_tpu.models.{module}")
    return getattr(mod, cfg_cls)(**fields, dtype=jnp.float32, scan_layers=False, remat=False,
                                 attention_impl="reference")


def _jax_model(family):
    module, _, model_cls, _, _ = FAMILIES[family]
    return getattr(importlib.import_module(f"deepspeed_tpu.models.{module}"), model_cls)(_jax_cfg(family))


def _jax_mesh(data=1, tensor=1):
    import jax
    from deepspeed_tpu.comm.mesh import MeshSpec, create_mesh
    return create_mesh(MeshSpec(data=data, tensor=tensor), devices=jax.devices()[:data * tensor])


def _seeded(family, seed):
    """JAX params from numpy (``test_torch_gpt_family.seeded_params``) and
    the port's state dict of them."""
    import jax
    import jax.numpy as jnp
    from test_torch_gpt_family import seeded_params
    params = seeded_params(_jax_model(family), jnp.zeros((1, SEQ), jnp.int32), seed=seed)
    state = getattr(convert, FAMILIES[family][4])({"params": jax.tree.map(np.asarray, params)}, _cfg(family))
    return params, {k: v.numpy() for k, v in state.items()}


def _jax_run(family, params):
    import jax
    import deepspeed_tpu as jds
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
    eng = jds.initialize(model=_jax_model(family), config=JaxConfig(_config(0), dp_world_size=DATA),
                         mesh=_jax_mesh(DATA, TENSOR), params=params, dist_init_required=False)[0]
    losses = [float(eng.train_batch(batch=_batch(s))) for s in range(STEPS)]
    state = getattr(convert, FAMILIES[family][4])({"params": jax.tree.map(np.asarray, eng.state.params)},
                                                  _cfg(family))
    return {"losses": losses, "eval": float(eng.eval_batch(batch=_batch(STEPS))), "params": _np(state)}


def _jax_tokens(family, params):
    """JAX's greedy tokens of the family's model (its v1 engine, float32)."""
    import deepspeed_tpu as jds
    from deepspeed_tpu.comm.mesh import set_global_mesh
    set_global_mesh(_jax_mesh())
    eng = jds.init_inference(model=_jax_model(family), config={"dtype": "fp32"}, params={"params": params})
    out = np.asarray(eng.generate(np.asarray(PROMPTS, np.int32), max_new_tokens=NEW))
    return [list(map(int, row[len(PROMPTS[0]):])) for row in out]


@pytest.fixture(scope="module")
def seeded():
    return {family: _seeded(family, 31 + i) for i, family in enumerate(FAMILIES)}


#: the families served again from HF checkpoint directories through ``build_hf_engine`` (bf16): Falcon-RW
#: (alibi, its fused ``query_key_value`` laid out per head) and OPT (``project_in``/``project_out``)
HF_CHECKPOINTS = {"falcon-rw": ("falcon", "transformer."), "opt": ("opt", "model.decoder.")}


def _hf_state(family, state):
    """The port's whole state dict of a family under HF's names: Falcon's
    q/k/v fused per head (``[q, k, v]`` of each head) and its MLP under
    ``mlp.``; OPT's under ``model.decoder.``."""
    cfg, prefix = _cfg(family), HF_CHECKPOINTS[family][1]
    out = {}
    for k, v in state.items():
        v = torch.from_numpy(v)
        m = re.fullmatch(r"h\.(\d+)\.self_attention\.q_proj\.(weight|bias)", k)
        if m:
            parts = [torch.from_numpy(state[f"h.{m[1]}.self_attention.{x}_proj.{m[2]}"]) for x in "qkv"]
            heads = [p.reshape(cfg.num_attention_heads, cfg.head_dim, *p.shape[1:]) for p in parts]
            out[f"{prefix}h.{m[1]}.self_attention.query_key_value.{m[2]}"] = torch.stack(heads, 1).reshape(
                -1, *v.shape[1:])
        elif not re.search(r"self_attention\.[kv]_proj", k):
            out[prefix + re.sub(r"^(h\.\d+)\.(dense_h_to_4h|dense_4h_to_h)", r"\1.mlp.\2", k)] = v
    return out


def _hf_dirs(root, states):
    """Each of HF_CHECKPOINTS as ``config.json`` and ``pytorch_model.bin``;
    the policy carries it back to the port's state exactly."""
    import json
    from deepspeed_tpu_torch.inference.v2 import checkpoint_io
    from deepspeed_tpu_torch.inference.v2.model_implementations import policy_for
    out = {}
    for family, (model_type, _) in HF_CHECKPOINTS.items():
        path = root / family
        path.mkdir()
        fields = {**FAMILIES[family][3], "model_type": model_type}
        if model_type == "falcon":
            fields.update(multi_query=False, new_decoder_architecture=False)
        (path / "config.json").write_text(json.dumps(fields))
        torch.save(_hf_state(family, states[family]), path / "pytorch_model.bin")
        policy = policy_for(model_type)
        cfg = policy.build_config(checkpoint_io.read_config(str(path)))
        back = policy.convert(checkpoint_io.load_state_dict(str(path)), cfg)
        assert back.keys() == states[family].keys()
        assert all(np.array_equal(back[k].numpy(), v) for k, v in states[family].items())
        out[family] = str(path)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory, seeded):
    """The ranks' results and JAX's (the spawn runs while JAX computes)."""
    states = {family: s for family, (_, s) in seeded.items()}
    spawn_dir = tmp_path_factory.mktemp("zoo_tp_ranks")
    inits = [f"file://{spawn_dir}/rendezvous{w}" for w in (3, 2)]
    hf_dirs = _hf_dirs(tmp_path_factory.mktemp("zoo_tp_hf"), states)
    ckpt_dir = tmp_path_factory.mktemp("zoo_tp_ckpt")
    ranks = {}

    def spawn():
        try:
            ranks["out"] = run_ranks(str(spawn_dir), _rank, states, inits, hf_dirs, str(ckpt_dir),
                                     world=DATA * TENSOR)
        except BaseException as e:
            ranks["error"] = e

    thread = threading.Thread(target=spawn)
    thread.start()
    try:
        jax_runs = {family: _jax_run(family, p) for family, (p, _) in seeded.items()}
        jax_tokens = {family: _jax_tokens(family, p) for family, (p, _) in seeded.items()}
        one = {family: build_engine(_cfg(family, serve=True), states[family], _econf(), device="cpu").generate(
            PROMPTS, max_new_tokens=NEW) for family in FAMILIES}
        one.update({f"hf-{kind}": build_hf_engine(path, _econf(), device="cpu").generate(PROMPTS, max_new_tokens=NEW)
                    for kind, path in hf_dirs.items()})
    finally:
        thread.join()
    if "error" in ranks:
        raise ranks["error"]
    family = CHECKPOINTED[0]
    eng = tds.initialize(model=_model(family), params=states[family], device="cpu", config=_config(0, tensor=1))[0]
    eng.load_checkpoint(str(ckpt_dir), tag="tp2")
    opt = eng.full_optimizer_state_dict()["state"]
    loaded = {"params": _np(eng.module_state_dict()), "step": eng.global_steps,
              "exp_avg": {n: opt[i]["exp_avg"].numpy().copy() for i, n in enumerate(eng.param_names)}}
    return {"ranks": ranks["out"], "jax": jax_runs, "jax_tokens": jax_tokens, "one": one, "loaded": loaded}


# ------------------------------------------------------------------ layouts

def _jax_layouts(family, stage):
    """JAX's shardings of every leaf at data 3 × tensor 2 (its ``tp_rules``
    and ZeRO partition functions over the abstract boxed tree), by path."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn
    from deepspeed_tpu.module_inject.tp_rules import param_shardings as jparam
    from deepspeed_tpu.runtime.zero.partition import grad_shardings as jgrad
    from deepspeed_tpu.runtime.zero.partition import master_and_optstate_shardings as jmaster
    mesh = _jax_mesh(DATA, TENSOR)
    boxed = jax.eval_shape(_jax_model(family).init, jax.random.PRNGKey(0), jnp.zeros((1, SEQ), jnp.int32))
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
@pytest.mark.parametrize("family", list(FAMILIES))
def test_layouts_equal_the_jax_shardings(family, stage):
    """Every leaf's spec and every rank's slice equal JAX's (parameter,
    master and moments, gradient); a slice's partition within its data
    group cuts the same slices from it.  The biases the port cuts are whole
    in JAX: ``tensor`` on their first dim here, held over ``tensor``."""
    jax_sh, devices = _jax_layouts(family, stage)
    mesh = _mesh(DATA, TENSOR)
    leaves = jax_leaves(_model(family, device="meta", tensor_parallel=TENSOR))
    params = param_shardings(leaves, mesh, stage)
    ours = {"param": params, "state": master_and_optstate_shardings(params, mesh, stage),
            "grad": grad_shardings(params, mesh, stage)}
    names = {leaf.path: name for name, leaf in leaves.items()}
    rng = np.random.default_rng(3)
    cut_biases, held = 0, 0
    for kind, tree in jax_sh.items():
        assert set(names[p] for p in tree) == set(ours[kind])
        for path, sh in tree.items():
            part = ours[kind][names[path]]
            want_spec = _spec(sh.spec, len(part.jax_shape))
            if "tensor" in part.held and all("tensor" not in e for e in want_spec):
                assert path.endswith("/bias") and part.spec[0] == ("tensor", ), (path, part.spec)
                cut_biases += kind == "param"
                continue
            assert part.spec == want_spec, (kind, path, sh.spec, part.spec)
            value = rng.standard_normal(part.jax_shape).astype(np.float32)
            index = sh.devices_indices_map(part.jax_shape)
            inner = part.within_held()
            for r in range(len(devices)):
                want = value[index[devices[r]]]
                np.testing.assert_array_equal(part.local(torch.from_numpy(value), r).numpy(), want)
                at = mesh.coords(r)
                mine = torch.from_numpy(value)
                for d, axes in enumerate(part.spec):
                    if "tensor" in axes and "tensor" in part.held:
                        n = part.jax_shape[d] // TENSOR
                        mine = mine.narrow(d, at["tensor"] * n, n)
                np.testing.assert_array_equal(inner.local(mine, at["data"]).numpy(), want)
            held += "tensor" in part.held
    assert held > 0 and cut_biases == CUT_BIASES[family]


# ------------------------------------------------------------------ training

@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_trajectory_equals_jax(family, stage, runs):
    """Losses (train and eval) within rtol 1e-5 of the JAX engine's at data
    3 × tensor 2, the same on every rank; the parameters as JAX's."""
    ranks = [r["train"][(family, stage)] for r in runs["ranks"]]
    want = runs["jax"][family]
    np.testing.assert_allclose(ranks[0]["losses"], want["losses"], rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["eval"], want["eval"], rtol=1e-5)
    assert all(r["losses"] == ranks[0]["losses"] and r["eval"] == ranks[0]["eval"] for r in ranks)
    far = total = 0
    for k, w in want["params"].items():
        diff = np.abs(ranks[0]["params"][k] - w)
        assert diff.max() <= 6 * LR, (k, diff.max())
        if k.endswith("k_proj.bias"):
            # its gradient is zero but for rounding (it shifts a query's
            # scores by one constant, which the softmax cancels), so Adam
            # moves each entry by ±lr on the sign of that noise, in JAX too
            continue
        far, total = far + int((diff > 2e-5).sum()), total + diff.size
    assert far <= 1e-3 * total, (far, total)
    for r in ranks[1:]:
        for k, v in ranks[0]["params"].items():
            np.testing.assert_array_equal(r["params"][k], v)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_replicated_tensors_are_bit_identical_over_a_tensor_group(family, runs):
    """The norms, the row-parallel biases and OPT's learned positions and
    projections, held whole, are bit-identical on the ranks of a tensor
    group; a cut tensor is its coordinate's slice of the whole."""
    from deepspeed_tpu_torch.module_inject.layers import tp_dims
    cut = tp_dims(_model(family, device="meta", tensor_parallel=TENSOR))
    whole_names = 0
    for r, res in enumerate(runs["ranks"]):
        got = res["train"][(family, 0)]
        for k, local in got["local"].items():
            whole = got["params"][k]
            if k in cut:
                n = whole.shape[cut[k]] // TENSOR
                whole = np.take(whole, range(r % TENSOR * n, (r % TENSOR + 1) * n), axis=cut[k])
            np.testing.assert_array_equal(local, whole, err_msg=f"{k} on rank {r}")
            if k not in cut and r % TENSOR:
                np.testing.assert_array_equal(local, runs["ranks"][r - 1]["train"][(family, 0)]["local"][k])
                whole_names += 1
    assert whole_names > 0


def test_checkpoint_at_tensor_2_loads_at_tensor_1(runs):
    """Phi's stage-3 checkpoint saved at data 3 x tensor 2 holds whole
    tensors: one rank at tensor 1 loads the trained parameters and Adam's
    first moments exactly, and the step."""
    saved = runs["ranks"][0]["train"][CHECKPOINTED]
    got = runs["loaded"]
    assert got["step"] == STEPS
    assert got["params"].keys() == saved["params"].keys() and got["exp_avg"].keys() == saved["exp_avg"].keys()
    for k, v in saved["params"].items():
        np.testing.assert_array_equal(got["params"][k], v)
    for k, v in saved["exp_avg"].items():
        np.testing.assert_array_equal(got["exp_avg"][k], v)


def test_mpu_grid_maps_to_mesh_and_shards_params(runs):
    """JAX ``test_mpu_grid_maps_to_mesh_and_shards_params`` at
    ``FakeMPU(tp=2, dp=3)``: the engine's mesh is data 3 × tensor 2, a
    rank's q_proj holds half the heads, a step's loss is finite and equal
    on every rank."""
    got = [r["mpu"] for r in runs["ranks"]]
    for g in got:
        assert (g["mesh"]["data"], g["mesh"]["tensor"]) == (3, 2)
        assert g["q_rows"] == (24, 48)
        assert np.isfinite(g["loss"]) and g["loss"] == got[0]["loss"]


def test_model_parallel_rng_key_differs_per_tensor_rank_and_not_per_data_rank(runs):
    """``model_parallel_rng_key(seed)`` on the data 3 x tensor 2 mesh (JAX
    folds ``axis_index("tensor")`` into the key; the port's bits differ,
    so the property is held): the ranks of one tensor coordinate draw the
    same numbers, the two coordinates different ones, and neither is the
    seed's own stream."""
    draws = [r["rng"] for r in runs["ranks"]]
    for r, d in enumerate(draws):
        np.testing.assert_array_equal(d, draws[r % TENSOR])
    assert not np.array_equal(draws[0], draws[1])
    plain = torch.rand(8, generator=torch.Generator().manual_seed(17)).numpy()
    assert not any(np.array_equal(d, plain) for d in draws[:TENSOR])


def test_out_of_scope_raises_naming_item_6_2(runs):
    """What stays queued under ROADMAP item 6.2.5 raises naming item 6.2 on
    every rank: the qgZ/LoCo wire, MiCS/hpZ, offload and a loss without
    ``rank_share`` for Phi at tensor 2, ``tensor_fragment`` of a cut
    tensor, CLIP in the v1 engine."""
    for r in runs["ranks"]:
        assert set(r["raised"]) == set(OUT_OF_SCOPE_ZERO) | {"loss_fn", "tensor_fragment", "v1-clip"}
        for name, msg in r["raised"].items():
            assert msg is not None and "item 6.2" in msg, (name, msg)


def test_mpu_overcommitted_grid_raises():
    """JAX ``test_mpu_overcommitted_grid_raises``: both packages' error; the
    port's pipeline stages name item 6.4."""
    from deepspeed_tpu.comm.mesh import mesh_from_mpu as jax_mesh_from_mpu
    from deepspeed_tpu_torch.comm.mesh import mesh_from_mpu
    with pytest.raises(ValueError, match="needs"):
        jax_mesh_from_mpu(FakeMPU(tp=16, dp=4))
    with pytest.raises(ValueError, match="needs 64 devices"):
        mesh_from_mpu(FakeMPU(tp=16, dp=4))
    with pytest.raises(NotImplementedError, match="item 6.4"):
        mesh_from_mpu(FakeMPU(tp=1, dp=1, pp=2), world_size=2)
    with pytest.raises(ValueError, match="does not cover"):
        mesh_from_mpu(FakeMPU(tp=2, dp=1), world_size=6)


# ------------------------------------------------------------------ serving

@pytest.mark.parametrize("tp", [2, 3])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_tp_serving_equals_jax(family, tp, runs):
    """Every rank's greedy tokens equal JAX's and the port's one-rank
    engine's; a forward runs the embedding's all-reduce, two row-parallel
    all-reduces a layer and the logits gather; the arena holds the rank's
    kv heads."""
    want = runs["jax_tokens"][family]
    assert runs["one"][family] == want
    cfg = _cfg(family)
    kv = getattr(cfg, "num_kv_heads", None) or getattr(cfg, "num_key_value_heads", None) or cfg.num_attention_heads
    for r in runs["ranks"][:tp]:
        got = r[tp][family]
        assert got["tokens"] == want, (got["tokens"], want)
        n = got["forwards"]
        assert got["kinds"] == {("embed", "forward"): n, ("o_proj", "forward"): 2 * n,
                                ("down_proj", "forward"): 2 * n, ("logits", "forward"): n}
        assert got["arena"][3] == kv // tp


@pytest.mark.parametrize("tp", [2, 3])
@pytest.mark.parametrize("kind", list(HF_CHECKPOINTS))
def test_build_hf_engine_at_tensor_parallel_equals_one_rank(kind, tp, runs):
    """An HF directory through ``build_hf_engine`` with ``tensor_parallel``
    (the policy splits Falcon's fused ``query_key_value`` whole, the engine
    cuts each whole tensor to the rank's slices) serves, in bf16, the
    one-rank engine's greedy tokens on every rank."""
    want = runs["one"][f"hf-{kind}"]
    assert [len(g) for g in want] == [NEW] * len(PROMPTS)
    for r in runs["ranks"][:tp]:
        assert r[tp][f"hf-{kind}"] == want


def _jax_shard_bytes(family, tp: int):
    """JAX's serving shardings at tensor ``tp``: the parameter count, a
    device's parameter and arena bytes from each leaf's ``shard_shape``,
    and the bytes of the biases it keeps whole that the port cuts."""
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.inference.v2.engine_v2 import _serving_shardings
    from deepspeed_tpu.inference.v2.engine_v2 import build_cache_model as jax_build_cache_model
    from deepspeed_tpu.models.llama_cache import PagedKVConfig as JaxPagedKVConfig
    from flax import linen as nn
    cfg = _jax_cfg(family)
    abs_vars, cache_abs, param_sh, cache_sh, _ = _serving_shardings(jax_build_cache_model(cfg, KV["page_size"]), cfg,
                                                                    JaxPagedKVConfig(**KV), jnp.float32,
                                                                    _jax_mesh(tensor=tp))
    flat, _ = jax.tree_util.tree_flatten_with_path(nn.meta.unbox(abs_vars))
    leaves = jax_leaves(_model(family, device="meta", tensor_parallel=tp))
    # the port's leaves are unrolled (``h_0/...``), the serving twin's stacked (``h/...``)
    cut_paths = {re.sub(r"^(\w+)_\d+/", r"\1/", lf.path) for lf in leaves.values()
                 if lf.tp_dim is not None and not lf.logical}
    param_bytes = bias_bytes = 0
    for (path, leaf), sh in zip(flat, jax.tree.leaves(param_sh)):
        n = int(np.prod(sh.shard_shape(leaf.shape))) * leaf.dtype.itemsize
        param_bytes += n
        name = "/".join(str(getattr(k, "key", k)) for k in path if str(getattr(k, "key", k)) != "params")
        bias_bytes += n if name in cut_paths else 0
    arena = int(np.prod(cache_sh.shard_shape(cache_abs.shape))) * cache_abs.dtype.itemsize
    return sum(int(np.prod(leaf.shape)) for _, leaf in flat), param_bytes, arena, bias_bytes


@pytest.mark.parametrize("family", list(FAMILIES))
def test_aot_budget_at_tensor_2_equals_jax_less_the_cut_biases(family):
    """A rank's bytes at tensor 2 equal the sum of JAX's shard shapes, less
    half of the biases JAX keeps whole and the port cuts with their heads
    or vocab."""
    budget, n_params = compile_aot_serving(_cfg(family, serve=True), _mesh(tensor=2), _econf(), batch=4, chunk=1)
    n, param_bytes, arena, bias = _jax_shard_bytes(family, 2)
    assert bias > 0
    assert (n_params, budget.param_bytes, budget.arena_bytes) == (n, param_bytes - bias // 2, arena)


def test_rank_parameter_counts_of_the_chip_configs():
    """The reckonings ``chip_smoke.py`` holds its ranks to (meta tensors:
    nothing allocated): a tensor-2 rank of the Phi-2 twin holds
    1,390,008,320 of 2,779,683,840 parameters (each block's LayerNorm, the
    ``dense`` and ``fc2`` biases and the final LayerNorm whole, the rest
    halved, the head's bias with the vocab); Phi-2's widths at 2 layers
    209,784,320 of 419,543,040, of which ZeRO-2 at data 2 x tensor 2 keeps
    35,840 whole over the data group."""
    from deepspeed_tpu_torch.models.cache_zoo import build_cache_model
    from deepspeed_tpu_torch.models.phi import PhiConfig, PhiForCausalLM
    count = lambda m: sum(p.numel() for p in m.parameters())
    phi2 = PhiConfig()
    assert count(build_cache_model(phi2, 16, device="meta", tensor_parallel=2)) == 1_390_008_320
    assert count(build_cache_model(phi2, 16, device="meta")) == 2_779_683_840
    cut = dataclasses.replace(phi2, num_hidden_layers=2)
    model = PhiForCausalLM(cut, device="meta", tensor_parallel=2)
    assert count(model) == 209_784_320
    assert count(PhiForCausalLM(cut, device="meta")) == 419_543_040
    # of a rank's, those ZeRO-2 holds whole over its data group at data 2 x tensor 2: the 1-D biases cut over
    # tensor (fc1's and the head's) have no dim left for data
    leaves = jax_leaves(model)
    state = master_and_optstate_shardings(param_shardings(leaves, _mesh(2, 2), 2), _mesh(2, 2), 2)
    sizes = dict(model.named_parameters())
    whole = {n for n, part in state.items() if all("data" not in axes for axes in part.spec)}
    assert whole == {"layers.0.fc1.bias", "layers.1.fc1.bias", "lm_head.bias"}
    assert sum(sizes[n].numel() for n in whole) == 35_840


def test_falcon_7b_at_tensor_2_raises_jax_s_error():
    """Falcon-7B's 71 query heads on one kv head do not divide over 2 ranks:
    the training model and the serving engine raise JAX's ``ValueError``
    (the engine's text is JAX's ``_setup_tp``'s) rather than cut one kv
    head."""
    from deepspeed_tpu_torch.models.falcon import FalconConfig, FalconForCausalLM
    cfg = FalconConfig(attention_impl="reference")
    with pytest.raises(ValueError, match="must divide .*num_key_value_heads=1"):
        FalconForCausalLM(cfg, device="meta", tensor_parallel=2)
    with pytest.raises(ValueError, match="tensor_parallel=2 must divide num_key_value_heads=1 and "
                                         "num_attention_heads=71"):
        build_engine(cfg, {}, _econf(2), device="cpu")


@pytest.mark.parametrize("rank", [0, 1])
def test_seeded_init_keeps_the_whole_model_s_slices(rank):
    """A tensor-parallel Falcon, OPT or Phi seeded by ``init_weights_`` holds
    exactly its rank's slices of the one-rank model of the same seed."""
    from deepspeed_tpu_torch.models import llama as tl
    from deepspeed_tpu_torch.module_inject.layers import TensorParallel, set_tensor_parallel_, slice_state, tp_dims
    for family in FAMILIES:
        whole = tl.init_weights_(_model(family), torch.Generator().manual_seed(4)).state_dict()
        tp = TensorParallel(2, rank)
        cut_model = _model(family, tensor_parallel=2)
        mine = tl.init_weights_(set_tensor_parallel_(cut_model, tp), torch.Generator().manual_seed(4)).state_dict()
        want = slice_state(whole, tp_dims(cut_model), tp)
        assert set(mine) == set(want)
        for k, v in want.items():
            torch.testing.assert_close(mine[k], v, rtol=0, atol=0)
