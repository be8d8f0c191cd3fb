"""Universal checkpoints (``checkpoint/ds_to_universal.py``,
``checkpoint/universal.py``) between the port and the JAX package, on the
CPU, for Llama and Phi (one of the families ``models/convert.jax_leaves``
gained with them).

  * JAX -> port: the JAX engine (unrolled tree) trains 2 float32 AdamW
    steps, saves and converts with the JAX converter; the port's
    ``load_universal_checkpoint`` loads the atoms into an engine of another
    stage, and its next step equals the JAX engine's next step (loss within
    1e-5, parameters as ``tests/test_torch_offload.py`` holds them).
  * port -> JAX: the port trains 2 steps, saves and converts with its own
    converter (the atoms carry JAX's names and leaf shapes); the JAX
    package's ``load_universal_checkpoint`` loads them into a fresh JAX
    engine, whose next step equals the port's.
  * port -> port: the atoms of a bf16 stage-3 run load into every offload
    tier and into another stage, and each continues as the saver does; a
    partial set of moment atoms is refused; the CLI converts.
"""

import os
import sys

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.checkpoint import convert_to_universal, load_universal_atoms, load_universal_checkpoint
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.models import phi as tphi
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse fixture)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "unit"))

ROWS, SEQ, LR, CLIP, V = 6, 16, 1e-2, 1.0, 96
SHAPES = {"llama": dict(vocab_size=V, hidden_size=48, intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
                        num_key_value_heads=2, max_position_embeddings=64, rope_theta=1e4),
          "phi": dict(vocab_size=V, hidden_size=48, intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=4, partial_rotary_factor=0.5, max_position_embeddings=64)}


def _batch(seed: int):
    ids = np.random.default_rng(seed).integers(0, V, (ROWS, SEQ)).astype(np.int32)
    return {"input_ids": ids, "labels": ids}


def _config(zero, dtype="f32"):
    cfg = {"train_batch_size": ROWS, "steps_per_print": 0, "gradient_clipping": CLIP,
           "optimizer": {"type": "AdamW", "params": {"lr": LR, "weight_decay": 0.01}}, "zero_optimization": zero}
    if dtype == "bf16":
        cfg["bf16"] = {"enabled": True}
    return cfg


def _port_model(family, dtype=torch.float32):
    if family == "llama":
        return tl.LlamaForCausalLM(tl.LlamaConfig(**SHAPES[family], dtype=dtype, attention_impl="reference"),
                                   device="cpu")
    return tphi.PhiForCausalLM(tphi.PhiConfig(**SHAPES[family], dtype=dtype), device="cpu")


def _port(family, state, zero, dtype="f32"):
    model = _port_model(family, torch.bfloat16 if dtype == "bf16" else torch.float32)
    return tds.initialize(model=model, params=state, device="cpu", config=_config(zero, dtype))[0]


def _jax_model(family):
    import jax.numpy as jnp
    from deepspeed_tpu.models import llama as jl
    from deepspeed_tpu.models import phi as jphi
    if family == "llama":
        return jl.LlamaForCausalLM(jl.LlamaConfig(**SHAPES[family], dtype=jnp.float32, scan_layers=False))
    return jphi.PhiForCausalLM(jphi.PhiConfig(**SHAPES[family], dtype=jnp.float32, scan_layers=False))


def _to_state(family, params) -> dict:
    import jax
    fn = convert.jax_llama_to_state_dict if family == "llama" else convert.jax_phi_to_state_dict
    cfg = _port_model(family).cfg
    return {k: v.numpy() for k, v in fn(jax.tree.map(lambda x: np.asarray(x, np.float32), params), cfg).items()}


def _jax_engine(family, variables=None):
    import jax
    import deepspeed_tpu as jds
    from deepspeed_tpu.comm.mesh import MeshSpec, create_mesh
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
    mesh = create_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    eng = jds.initialize(model=_jax_model(family), config=JaxConfig(_config({"stage": 0}), dp_world_size=1),
                         mesh=mesh, params=None if variables is None else variables["params"],
                         dist_init_required=False)[0]
    eng._ensure_ready(_batch(0))
    return eng


@pytest.fixture(scope="module", params=["llama", "phi"])
def family(request):
    return request.param


def _seeded(family):
    """(JAX variables, the port's state dict) from one numpy seed."""
    import jax.numpy as jnp
    from test_torch_gpt_family import seeded_params
    params = seeded_params(_jax_model(family), jnp.zeros((1, SEQ), jnp.int32), seed=3)
    return {"params": params}, _to_state(family, params)


@pytest.fixture(scope="module")
def seeded(family):
    return _seeded(family)


@pytest.fixture(scope="module")
def llama_state():
    return _seeded("llama")[1]


def _assert_params_close(got, want):
    """All but 1e-3 of the entries within 2e-5 and every entry within
    2·lr·steps (Adam moves an entry by about lr whatever its gradient:
    ``tests/test_torch_training.py``'s rule)."""
    far = total = 0
    for k, w in want.items():
        diff = np.abs(np.asarray(got[k], np.float32) - w)
        assert diff.max() <= 6 * LR, (k, diff.max())
        far += int((diff > 2e-5).sum())
        total += diff.size
    assert far <= 1e-3 * total, (far, total)


def _np(sd):
    return {k: v.detach().float().numpy().copy() for k, v in sd.items()}


def test_jax_atoms_load_into_the_port(tmp_path, family, seeded):
    """JAX trains 2 steps, saves, converts; the port loads the atoms into a
    stage-3 engine (another stage than the saver's 0) and its third step
    equals JAX's third step."""
    from deepspeed_tpu.checkpoint import convert_to_universal as jconvert
    variables, state = seeded
    jeng = _jax_engine(family, variables)
    for s in range(2):
        jeng.train_batch(batch=_batch(s))
    jeng.save_checkpoint(str(tmp_path / "jax"), tag="t")
    jconvert(str(tmp_path / "jax"), str(tmp_path / "uni"), tag="t")
    want = float(jeng.train_batch(batch=_batch(2)))
    port = _port(family, state, {"stage": 3})
    load_universal_checkpoint(port, str(tmp_path / "uni"))
    assert port.global_steps == 2 and port.optimizer.step_count == 2
    got = float(port.train_batch(batch=_batch(2)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_params_close(_np(port.module_state_dict()), _to_state(family, jeng.state.params))


def test_port_atoms_load_into_jax(tmp_path, family, seeded):
    """The port trains 2 steps, saves, converts with its own converter (JAX's
    names and leaf shapes); JAX's ``load_universal_checkpoint`` loads the
    atoms into a fresh JAX engine, whose next step equals the port's."""
    from deepspeed_tpu.checkpoint import load_universal_checkpoint as jload
    variables, state = seeded
    port = _port(family, state, {"stage": 2})
    for s in range(2):
        port.train_batch(batch=_batch(s))
    port.save_checkpoint(str(tmp_path / "port"), tag="t")
    dst = convert_to_universal(str(tmp_path / "port"), str(tmp_path / "uni"))
    atoms = load_universal_atoms(dst)
    leaves = convert.jax_leaves(_port_model(family))
    assert sorted(atoms) == sorted(lf.path.replace("/", ".") for lf in leaves.values())
    assert all(atoms[lf.path.replace("/", ".")]["fp32"].shape == lf.shape for lf in leaves.values())
    assert all(set(a) == {"fp32", "exp_avg", "exp_avg_sq"} for a in atoms.values())
    jeng = _jax_engine(family)
    jload(jeng, str(tmp_path / "uni"))
    want = float(port.train_batch(batch=_batch(2)))
    got = float(jeng.train_batch(batch=_batch(2)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_params_close(_to_state(family, jeng.state.params), _np(port.module_state_dict()))


@pytest.mark.parametrize("target", ["stage0", "stage2", "a", "b", "c", "d"])
def test_port_atoms_load_into_any_stage_and_tier(tmp_path, llama_state, target):
    """A bf16 stage-3 run's atoms load into another stage and into each
    offload tier: the next two losses equal the saver's (float32 tiers and
    stages: the same arithmetic on the same master and moments; bf16 within
    1e-3), and a streamed tier's host groups hold the moments."""
    state = llama_state
    saver = _port("llama", state, {"stage": 3}, "bf16")
    for s in range(2):
        saver.train_batch(batch=_batch(s))
    saver.save_checkpoint(str(tmp_path / "ckpt"), tag="t")
    convert_to_universal(str(tmp_path / "ckpt"), str(tmp_path / "uni"), tag="t")
    want = [float(saver.train_batch(batch=_batch(s))) for s in (2, 3)]
    zero = {"stage0": {"stage": 0}, "stage2": {"stage": 2},
            "a": {"stage": 2, "offload_optimizer": {"device": "cpu"}},
            "b": {"stage": 2, "offload_optimizer": {"device": "cpu", "pipeline_read": True, "buffer_count": 3}},
            "c": {"stage": 0, "offload_optimizer": {"device": "nvme", "nvme_path": str(tmp_path / "nvme")}},
            "d": {"stage": 3, "offload_param": {"device": "cpu"}}}[target]
    eng = _port("llama", state, zero, "bf16")
    load_universal_checkpoint(eng, str(tmp_path / "uni"))
    if eng._nvme_opt is not None:
        assert any(float(m.abs().max()) > 0 for m in eng._nvme_opt.leaves("mu"))
    got = [float(eng.train_batch(batch=_batch(s))) for s in (2, 3)]
    np.testing.assert_allclose(got, want, rtol=1e-3)
    if target in ("stage0", "stage2", "a", "d"):   # the same master, moments and arithmetic
        assert got == want


def test_partial_moments_refused_and_the_cli(tmp_path, llama_state):
    """An ``exp_avg`` atom missing for one parameter: the optimizer load is
    refused (weights only still load); ``main`` is the converter's CLI."""
    from deepspeed_tpu_torch.checkpoint.ds_to_universal import main
    state = llama_state
    eng = _port("llama", state, {"stage": 0})
    eng.train_batch(batch=_batch(0))
    eng.save_checkpoint(str(tmp_path / "ckpt"))
    main(["--input_folder", str(tmp_path / "ckpt"), "--output_folder", str(tmp_path / "uni")])
    tag = (tmp_path / "uni" / "latest_universal").read_text()
    assert tag == "global_step1"
    os.remove(tmp_path / "uni" / tag / "zero" / "model.layers_0.self_attn.q_proj.kernel" / "exp_avg.npy")
    fresh = _port("llama", state, {"stage": 0})
    with pytest.raises(ValueError, match="partial optimizer restore"):
        load_universal_checkpoint(fresh, str(tmp_path / "uni"))
    load_universal_checkpoint(fresh, str(tmp_path / "uni"), load_optimizer_states=False)
    assert all(torch.equal(a, b) for a, b in zip(fresh.module_state_dict().values(), eng.module_state_dict().values()))
