"""The v1 engine over tensor-parallel ranks (``inference/engine.py``,
``models/gpt2.py``, ``models/gpt_family.py``, ``module_inject/layers.py``)
and ``partition_activations`` at tensor 2
(``runtime/activation_checkpointing/checkpointing.py``), against the JAX
package on the CPU, in float32.

One spawn of 2 gloo ranks (run while JAX computes):

  * GPT-2, BLOOM, GPT-NeoX, GPT-J and GPT-Neo (tiny, 4 heads of 16) through
    ``init_inference(model, tensor_parallel=2)``: every rank's logits within
    ``LOGIT_TOL`` of the largest of JAX's ``InferenceEngine`` at tensor 2,
    and its greedy tokens equal JAX's; a rank holds its heads, its MLP
    slice and its vocab rows; a forward runs one embed, 2 × L row-parallel
    all-reduces and one logits gather.  GPT-2's fused ``c_attn`` cut as one
    contiguous block of rows (not by heads within q, k and v) gives other
    logits.  Kernel injection (a GPT-NeoX of head dim 64) gives the logits
    of the one-rank engine.
  * ``partition_activations``: JAX's ``test_partition_activations_numerics``
    at tensor 2 (the value within rtol 1e-6 of JAX's), the gradients equal
    to the unpartitioned checkpoint's, the saved bytes half of a reentrant
    checkpoint's (which saves its inputs whole), and one counted gather an
    input in the recompute.

JAX is imported only inside the tests, so the ranks start without it.
"""

import dataclasses
import os
import sys
import threading

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "unit"))

from test_torch_qgz import run_ranks  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: F401,E402 (autouse fixture)

TP = 2
LOGIT_TOL = 1e-5   # of the largest |logit|
FAMILIES = ["gpt2", "bloom", "gpt_neox", "gptj", "gpt_neo"]
IDS = np.array([[5, 9, 2, 7, 1, 3, 11, 4, 8, 6, 10, 12], [3, 3, 8, 4, 6, 0, 2, 9, 1, 7, 5, 14]], np.int64)
PROMPT = np.array([[5, 9, 2, 7], [1, 3, 11, 4]], np.int32)
NEW = 5
#: a GPT-NeoX whose head dim (64) K1 takes, for kernel injection
NEOX_K1 = dict(vocab_size=96, hidden_size=128, intermediate_size=256, num_hidden_layers=2, num_attention_heads=2,
               rotary_pct=0.25)


def _build(kind, cfg):
    from deepspeed_tpu_torch.inference.v2.model_implementations import policies
    from deepspeed_tpu_torch.models import gpt2
    if kind == "gpt2":
        return gpt2.GPT2LMHeadModel(cfg, device="cpu")
    return policies.policy_for(kind).build_model(cfg, device="cpu")


def _engine(kind, cfg, state, **kw):
    import deepspeed_tpu_torch as tds
    model = _build(kind, cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return tds.init_inference(model, config={"dtype": "fp32"}, device="cpu", **kw)


def _mlp(w1, w2, x):
    """JAX's ``_mlp`` (``tests/unit/runtime/activation_checkpointing/test_activation_checkpointing.py:19``)."""
    return (torch.tanh(x @ w1) @ w2).square().sum()


def _jax_mlp(w1, w2, x):
    import jax.numpy as jnp
    return jnp.sum((jnp.tanh(x @ w1) @ w2)**2)


def _mlp_inputs(seed=0):
    """JAX's ``_inputs`` (the same test file, ``:24``) as numpy float32."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for shape in ((16, 32), (32, 8), (4, 16))]


def _saved_run(fn, inputs):
    """``fn`` on leaf copies of ``inputs`` (``w1``, ``w2`` requiring a
    gradient): its value, the gradients and the bytes autograd saved."""
    w1, w2, x = (torch.from_numpy(a).requires_grad_(i < 2) for i, a in enumerate(inputs))
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn(w1, w2, x)
    out.backward()   # a reentrant checkpoint takes no torch.autograd.grad
    return float(out), [w1.grad.numpy(), w2.grad.numpy()], sum(saved)


def _partition_activations(inputs):
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing
    checkpointing.configure(partition_activations=True)
    comm.tensor_parallel_kinds.clear()
    part = _saved_run(lambda *a: checkpointing.checkpoint(_mlp, *a), inputs)
    kinds = dict(comm.tensor_parallel_kinds)
    checkpointing.reset()
    whole = _saved_run(lambda *a: torch.utils.checkpoint.checkpoint(_mlp, *a, use_reentrant=True), inputs)
    return {"part": part, "whole": whole, "kinds": kinds}


def _rank(rank, cases, neox_state, mlp_inputs):
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.models import gpt_family as tgf
    out = {}
    for kind, (cfg, state) in cases.items():
        comm.tensor_parallel_kinds.clear()
        eng = _engine(kind, cfg, state, tensor_parallel=TP)
        logits = eng(torch.from_numpy(IDS)).numpy()
        kinds = dict(comm.tensor_parallel_kinds)
        out[kind] = {"logits": logits, "kinds": kinds, "tokens": eng.generate(PROMPT, max_new_tokens=NEW),
                     "shapes": {k: tuple(v.shape) for k, v in eng.module.state_dict().items()}, "tp": eng.tp.rank}
    # GPT-2's c_attn cut as one contiguous block of its 3E rows
    cfg, state = cases["gpt2"]
    model = _build("gpt2", cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    for block in model.h:
        block.attn.c_attn.parts = 1
    import deepspeed_tpu_torch as tds
    out["contiguous"] = tds.init_inference(model, config={"dtype": "fp32"}, tensor_parallel=TP,
                                           device="cpu")(torch.from_numpy(IDS)).numpy()
    # kernel injection over the rank's head
    cfg = tgf.GPTNeoXConfig(**NEOX_K1, dtype=torch.float32)
    eng = _engine("gpt_neox", cfg, neox_state, tensor_parallel=TP, replace_with_kernel_inject=True)
    out["injected"] = {"logits": eng(torch.from_numpy(IDS)).numpy(), "impl": eng.module.cfg.attention_impl}
    out["partition"] = _partition_activations(mlp_inputs)
    return out


# ------------------------------------------------------------------ JAX side

def _cases():
    """kind → (JAX model, JAX params, the port's config, its state dict as numpy)."""
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.inference.v2.model_implementations import policies as jpol
    from deepspeed_tpu.models import gpt2 as jgpt2
    from deepspeed_tpu_torch.inference.v2.model_implementations import policies as tpol
    from deepspeed_tpu_torch.models import convert
    from deepspeed_tpu_torch.models import gpt2 as tgpt2
    from test_torch_gpt_family import hf_checkpoint, seeded_params
    out = {}
    for kind in FAMILIES:
        if kind == "gpt2":
            jcfg = dataclasses.replace(jgpt2.PRESETS["tiny"], dtype=jnp.float32, scan_layers=False, remat=False)
            jmodel = jgpt2.GPT2LMHeadModel(jcfg)
            params = seeded_params(jmodel, jnp.zeros((1, 16), jnp.int32), seed=5)
            cfg = dataclasses.replace(tgpt2.PRESETS["tiny"], dtype=torch.float32, remat=False)
            state = convert.jax_gpt2_to_state_dict({"params": jax.tree.map(np.asarray, params)}, cfg)
        else:
            hf_cfg, sd = hf_checkpoint(kind)
            jcfg, params = jpol.convert_hf_state_dict(sd, hf_cfg)
            jmodel = jpol.policy_for(kind).build_model(dataclasses.replace(jcfg, dtype=jnp.float32))
            cfg, state = tpol.convert_hf_state_dict(sd, hf_cfg)
            cfg = dataclasses.replace(cfg, dtype=torch.float32)
        out[kind] = (jmodel, params, cfg, {k: v.float().numpy() for k, v in state.items()})
    return out


def _jax_engine(jmodel, params):
    """JAX's ``InferenceEngine`` at tensor 2 (``MeshSpec(data=1, tensor=2)``)."""
    import jax
    import deepspeed_tpu as jds
    from deepspeed_tpu.comm.mesh import MeshSpec, create_mesh
    mesh = create_mesh(MeshSpec(data=1, tensor=TP), devices=jax.devices()[:TP])
    return jds.init_inference(model=jmodel, config={"dtype": "fp32", "tensor_parallel": TP},
                              params={"params": params}, mesh=mesh)


def _jax_partition_value(inputs):
    """JAX's ``test_partition_activations_numerics`` at tensor 2: the jitted
    checkpoint's value under the partition constraint."""
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.comm.mesh import MeshSpec, create_mesh, set_global_mesh
    from deepspeed_tpu.runtime.activation_checkpointing import checkpointing as ckpt
    mesh = create_mesh(MeshSpec(tensor=TP, data=1), devices=jax.devices()[:TP])
    set_global_mesh(mesh)
    ckpt.configure(partition_activations=True)
    try:
        with mesh:
            out = jax.jit(lambda a, b, c: ckpt.checkpoint(_jax_mlp, a, b, c))(*(jnp.asarray(a) for a in inputs))
        return float(out)
    finally:
        ckpt.reset()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax.numpy as jnp
    from deepspeed_tpu_torch.models import gpt_family as tgf
    from deepspeed_tpu_torch.models import llama as tl
    cases = _cases()
    neox = tl.init_weights_(tgf.GPTNeoXForCausalLM(tgf.GPTNeoXConfig(**NEOX_K1, dtype=torch.float32), device="cpu"),
                            torch.Generator().manual_seed(3))
    neox_state = {k: v.numpy() for k, v in neox.state_dict().items()}
    mlp_inputs = _mlp_inputs()
    spawn_dir = tmp_path_factory.mktemp("v1_tp_ranks")
    ranks = {}

    def spawn():
        try:
            ranks["out"] = run_ranks(str(spawn_dir), _rank, {k: (c[2], c[3]) for k, c in cases.items()}, neox_state,
                                     mlp_inputs, world=TP)
        except BaseException as e:
            ranks["error"] = e

    thread = threading.Thread(target=spawn)
    thread.start()
    try:
        jax_out = {}
        for kind, (jmodel, params, _, _) in cases.items():
            jeng = _jax_engine(jmodel, params)
            jax_out[kind] = {"logits": np.asarray(jeng.forward(jnp.asarray(IDS, jnp.int32))),
                             "tokens": np.asarray(jeng.generate(PROMPT, max_new_tokens=NEW))}
        jax_partition = _jax_partition_value(mlp_inputs)
        one = _engine("gpt_neox", tgf.GPTNeoXConfig(**NEOX_K1, dtype=torch.float32), neox_state)
        neox_one = one(torch.from_numpy(IDS)).numpy()
    finally:
        thread.join()
    if "error" in ranks:
        raise ranks["error"]
    return {"ranks": ranks["out"], "jax": jax_out, "jax_partition": jax_partition, "neox_one": neox_one,
            "cases": {k: (c[2], c[3]) for k, c in cases.items()}}


# ------------------------------------------------------------------ the v1 engine

@pytest.mark.parametrize("kind", FAMILIES)
def test_v1_engine_at_tensor_2_equals_jax(kind, runs):
    """Every rank's whole logits within LOGIT_TOL of JAX's engine at tensor
    2, its greedy tokens equal JAX's; one embed, 2 × L row-parallel and one
    logits collective a forward."""
    want = runs["jax"][kind]
    cfg, _ = runs["cases"][kind]
    for r, res in enumerate(runs["ranks"]):
        got = res[kind]
        assert got["tp"] == r
        np.testing.assert_allclose(got["logits"], want["logits"], rtol=0,
                                   atol=LOGIT_TOL * np.abs(want["logits"]).max(), err_msg=f"{kind} rank {r}")
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        layers = cfg.num_hidden_layers
        assert got["kinds"] == {("embed", "forward"): 1, ("o_proj", "forward"): layers,
                                ("down_proj", "forward"): layers, ("logits", "forward"): 1}, got["kinds"]


@pytest.mark.parametrize("kind", FAMILIES)
def test_a_rank_holds_its_heads_mlp_slice_and_vocab_rows(kind, runs):
    """Each tensor the Megatron layout cuts holds half its whole rows (or
    columns); the norms, the row-parallel biases and the learned positions
    stay whole."""
    from deepspeed_tpu_torch.module_inject.layers import tp_dims
    cfg, state = runs["cases"][kind]
    model = _build(kind, cfg)
    for _, m in model.named_modules():
        if hasattr(m, "parts"):
            m.parts = 1   # tp_dims refuses a fused layer cut over ranks; the whole model's dims are the same
    dims = tp_dims(model)
    shapes = runs["ranks"][0][kind]["shapes"]
    assert dims and any("weight" in k for k in dims)
    for k, whole in state.items():
        want = list(whole.shape)
        if k in dims:
            want[dims[k]] //= TP
        assert list(shapes[k]) == want, (k, shapes[k], whole.shape)


def test_a_contiguous_cut_of_gpt2_s_fused_c_attn_gives_other_logits(runs):
    """``c_attn``'s outputs are q, k and v laid out ``(3, H, D)``: a rank
    must keep its heads of each.  Cut as one contiguous block of rows (all
    of q and half of k on rank 0), the same weights give logits far from
    JAX's."""
    want = runs["jax"]["gpt2"]["logits"]
    tol = LOGIT_TOL * np.abs(want).max()
    for res in runs["ranks"]:
        assert np.abs(res["contiguous"] - want).max() > 100 * tol
        np.testing.assert_allclose(res["gpt2"]["logits"], want, rtol=0, atol=tol)


def test_kernel_injection_at_tensor_2_gives_the_one_rank_logits(runs):
    """``replace_with_kernel_inject=True`` at tensor 2 (K1 over the rank's
    head of 64; its plain version on the CPU) gives the one-rank engine's
    logits."""
    want = runs["neox_one"]
    for res in runs["ranks"]:
        assert res["injected"]["impl"] == "flash"
        np.testing.assert_allclose(res["injected"]["logits"], want, rtol=0, atol=LOGIT_TOL * np.abs(want).max())


def test_v1_engine_at_tensor_2_without_its_ranks_raises():
    """Tensor 2 needs a process group of 2 ranks; a degree that does not
    divide the heads raises JAX's ``ValueError``; BERT and CLIP name item 6.2."""
    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch.models import bert as tbert
    from deepspeed_tpu_torch.models import gpt2 as tgpt2
    cfg = dataclasses.replace(tgpt2.PRESETS["tiny"], dtype=torch.float32)
    with pytest.raises(ValueError, match="process group has 1 ranks"):
        tds.init_inference(tgpt2.GPT2LMHeadModel(cfg, device="cpu"), tensor_parallel=2, device="cpu")
    with pytest.raises(ValueError, match="must divide num_attention_heads=4"):
        tds.init_inference(tgpt2.GPT2LMHeadModel(cfg, device="cpu"), tensor_parallel=3, device="cpu")
    bert = tbert.BertConfig(vocab_size=96, hidden_size=48, num_hidden_layers=1, num_attention_heads=4,
                            intermediate_size=96, max_position_embeddings=64, dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="item 6.2"):
        tds.init_inference(tbert.BertForMaskedLM(bert, device="cpu"), tensor_parallel=2, device="cpu")


def test_init_inference_merges_config_keys_given_as_keywords():
    """As the reference's ``init_inference``, keyword config keys
    (``dtype``, ``max_out_tokens``...) merge over ``config``'s."""
    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch.models import gpt2 as tgpt2
    cfg = dataclasses.replace(tgpt2.PRESETS["tiny"], dtype=torch.float32)
    eng = tds.init_inference(tgpt2.GPT2LMHeadModel(cfg, device="cpu"), config={"dtype": "bf16", "max_out_tokens": 3},
                             dtype=torch.float32, device="cpu")
    assert (eng.config.dtype, eng.config.max_out_tokens, eng.config.tensor_parallel) == (torch.float32, 3, 1)


# ------------------------------------------------------------------ partition_activations

def test_partition_activations_numerics_at_tensor_2(runs):
    """JAX's ``test_partition_activations_numerics`` at tensor 2: the value
    within rtol 1e-6 of JAX's and of the unpartitioned checkpoint's, the
    gradients equal to the unpartitioned checkpoint's."""
    for res in runs["ranks"]:
        (value, grads, _), (whole_value, whole_grads, _) = res["partition"]["part"], res["partition"]["whole"]
        np.testing.assert_allclose(value, runs["jax_partition"], rtol=1e-6)
        np.testing.assert_allclose(value, whole_value, rtol=1e-6)
        for g, w in zip(grads, whole_grads):
            np.testing.assert_array_equal(g, w)


def test_partition_activations_halve_the_saved_bytes_and_gather_in_the_recompute(runs):
    """The inputs (each last dim divides by 2) are saved as the rank's half:
    half the bytes of a reentrant checkpoint, which saves them whole; the
    recompute gathers each over the tensor group, counted once an input."""
    for res in runs["ranks"]:
        part, whole = res["partition"]["part"][2], res["partition"]["whole"][2]
        assert whole > 0 and 2 * part == whole, (part, whole)
        assert res["partition"]["kinds"] == {("partition_activations", "backward"): 3}


def test_rank_parameter_count_of_the_chip_config():
    """The reckoning ``chip_smoke.py`` holds the v1 engine's ranks to (meta
    tensors: nothing allocated): a tensor-2 rank of pythia-6.9b holds
    3,429,048,320 of 6,857,302,016 parameters (each block's LayerNorms and
    its two row-parallel biases and the final LayerNorm whole, the rest
    halved)."""
    from deepspeed_tpu_torch.models import gpt_family as tgf
    from deepspeed_tpu_torch.module_inject.layers import TensorParallel, cut_tensor_parallel_
    pythia = {"vocab_size": 50432, "hidden_size": 4096, "intermediate_size": 16384, "num_hidden_layers": 32,
              "num_attention_heads": 32, "rotary_pct": 0.25, "rotary_emb_base": 10000,
              "use_parallel_residual": True, "layer_norm_eps": 1e-5, "max_position_embeddings": 2048}
    model = tgf.GPTNeoXForCausalLM(tgf.GPTNeoXConfig.from_hf(pythia), device="meta")
    assert sum(p.numel() for p in model.parameters()) == 6_857_302_016
    cut_tensor_parallel_(model, TensorParallel(TP, 1))
    assert sum(p.numel() for p in model.parameters()) == 3_429_048_320
