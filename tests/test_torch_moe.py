"""The port's MoE gating and layer (``deepspeed_tpu_torch/moe``) against the
JAX package's (``deepspeed_tpu/moe``) on the CPU.

  * ``_capacity`` on a grid, the ``min_capacity`` clamp included: equal;
  * top-1 without noise, top-2 with capacity below demand (so that the
    choice-major priority decides which choices are dropped) and top-3 with
    ``drop_tokens=False``, on seeded numpy logits: the kept (token, expert,
    slot) triples and ``exp_counts`` equal JAX's exactly, the combine
    weights and ``l_aux`` within 1e-6;
  * the noisy top-1 (``RSample``) by its properties: its seeded generator
    reproduces it, and it drops nothing its capacity allows;
  * the ``MoE`` layer's forward with JAX's weights carried across, in
    float32: the output within 1e-5 of its largest magnitude, ``l_aux``
    within 1e-6, ``exp_counts`` equal, both in training and as the paged
    twin calls it (``train=False``, the evaluation capacity);
  * the raises: ``moe.expert_parallel_size`` 2, an MoE model on two
    data-parallel ranks, the token mappings at tensor-parallel size 1 and 2,
    and a non-default layer setting under ``moe``, which the engine does not
    read.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.comm.mesh import MeshSpec, create_mesh, set_global_mesh
from deepspeed_tpu.moe import sharded_moe as jmoe
from deepspeed_tpu.moe.layer import MoE as JaxMoE
from deepspeed_tpu_torch.moe import MoE, mappings, sharded_moe as tmoe
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse fixture)

WEIGHT_TOL = 1e-6   # combine weights and l_aux, absolute (they are O(1))


@pytest.fixture(autouse=True)
def one_device_mesh():
    """One JAX device: one gating group, as on the port's one device."""
    set_global_mesh(create_mesh(MeshSpec(), devices=jax.devices()[:1]))


def _logits(s, e, seed, skew=0.0):
    x = np.random.default_rng(seed).standard_normal((s, e)).astype(np.float32)
    x[:, 0] += skew    # a popular expert: its demand passes the capacity
    return x


def _jax_kept(combine):
    """{(token, expert, slot): weight} of JAX's combine tensor."""
    c = np.asarray(combine)
    return {tuple(int(i) for i in idx): float(c[tuple(idx)]) for idx in np.argwhere(c > 0)}


def _port_kept(g):
    kept = {}
    for i, s in zip(*np.nonzero(g.keep.numpy())):
        kept[(int(s), int(g.experts[i, s]), int(g.slots[i, s]))] = float(g.weights[i, s])
    return kept


def _assert_same_gating(jax_out, g):
    l_aux, combine, _, counts = jax_out
    want, got = _jax_kept(combine), _port_kept(g)
    assert set(got) == set(want)
    np.testing.assert_allclose([got[k] for k in want], [want[k] for k in want], rtol=0, atol=WEIGHT_TOL)
    np.testing.assert_array_equal(g.exp_counts.numpy(), np.asarray(counts))
    assert abs(float(g.l_aux) - float(l_aux)) <= WEIGHT_TOL


@pytest.mark.parametrize("tokens,experts,factor,min_cap,k", [(64, 8, 1.0, 4, 1), (64, 8, 2.0, 4, 1), (8, 8, 1.0, 4, 1),
                                                             (64, 8, 1.0, 4, 2), (37, 6, 1.25, 4, 2),
                                                             (5, 60, 1.25, 4, 4), (2048, 8, 1.25, 4, 2)])
def test_capacity_equals_jax(tokens, experts, factor, min_cap, k):
    assert tmoe._capacity(tokens, experts, factor, min_cap, k) == jmoe._capacity(tokens, experts, factor, min_cap, k)


def test_top1_gating_equals_jax():
    logits = _logits(32, 4, seed=0, skew=1.0)
    capacity = 6
    jax_out = jax.jit(jmoe.top1_gating, static_argnums=1)(logits, capacity)
    _assert_same_gating(jax_out, tmoe.top1_gating(torch.from_numpy(logits), capacity))


def test_top2_gating_with_drops_equals_jax():
    logits = _logits(24, 4, seed=1, skew=1.5)
    capacity = 7
    jax_out = jax.jit(jmoe.topk_gating, static_argnums=(1, 2))(logits, 2, capacity)
    g = tmoe.topk_gating(torch.from_numpy(logits), 2, capacity)
    _assert_same_gating(jax_out, g)
    # the data makes the priority decide: an earlier token's second choice
    # is dropped at an expert that keeps a later token's first choice
    keep, experts = g.keep.numpy(), g.experts.numpy()
    assert any(not keep[1, s1] and keep[0, s2] and experts[0, s2] == experts[1, s1]
               for s1 in range(24) for s2 in range(s1 + 1, 24))


def test_topk_without_drops_equals_jax():
    logits = _logits(20, 6, seed=2, skew=2.0)
    g = tmoe.topk_gating(torch.from_numpy(logits), 3, 20, drop_tokens=False)
    _assert_same_gating(jax.jit(jmoe.topk_gating, static_argnums=(1, 2, 3))(logits, 3, 20, False), g)
    assert bool(g.keep.all())


def test_top_k_orders_ties_by_the_lower_index():
    x = torch.tensor([[0.25, 0.25, 0.1, 0.25, 0.15]])
    vals, idx = tmoe.top_k(x, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    assert idx.tolist() == np.asarray(ji).tolist() == [[0, 1, 3]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_noisy_top1_reproduces_and_drops_only_past_capacity():
    logits = torch.from_numpy(_logits(64, 4, seed=3, skew=1.0))
    capacity = 10
    run = lambda seed: tmoe.top1_gating(logits, capacity, "RSample", torch.Generator().manual_seed(seed))
    a, b, c = run(5), run(5), run(6)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a.experts, c.experts)              # the noise moves some choices
    assert not torch.equal(a.experts, tmoe.top1_gating(logits, capacity).experts)
    routed = torch.bincount(a.experts[0], minlength=4)
    assert torch.equal(a.exp_counts, torch.clamp(routed, max=capacity).float())
    assert torch.equal(a.keep, a.slots < capacity)
    assert bool((a.weights[a.keep] > 0).all())


def _seeded(shapes, seed):
    """Every leaf N(0, 0.3²) from one numpy generator, out of flax's boxes."""
    from flax.linen import meta
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (0.3 * rng.standard_normal(s.shape)).astype(np.float32), meta.unbox(shapes))


@pytest.mark.parametrize("k,drop", [(1, True), (2, True), (2, False)])
def test_moe_layer_forward_equals_jax(k, drop):
    kw = dict(hidden_size=32, num_experts=4, intermediate_size=48, k=k, capacity_factor=0.75, min_capacity=4,
              drop_tokens=drop)
    jlayer = JaxMoE(**kw, dtype=jnp.float32)
    x = np.random.default_rng(4).standard_normal((2, 16, 32)).astype(np.float32)
    params = _seeded(jax.eval_shape(jlayer.init, jax.random.PRNGKey(0), jnp.asarray(x)), seed=5 + k)["params"]
    layer = MoE(**kw, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        layer.gate.weight.copy_(torch.from_numpy(np.asarray(params["gate"]["kernel"]).T))
        for name in ("w_gate", "w_up", "w_down"):
            getattr(layer.experts, name).copy_(torch.from_numpy(np.asarray(params["experts"][name])))
    for train in (True, False):
        want_out, want_aux, want_counts = jax.jit(jlayer.apply, static_argnames="train")({"params": params}, x,
                                                                                         train=train)
        with torch.no_grad():
            out, l_aux, counts = layer(torch.from_numpy(x), train=train)
        train_counts = counts if train else train_counts
        scale = np.abs(np.asarray(want_out)).max()
        np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=0, atol=1e-5 * scale)
        assert abs(float(l_aux) - float(want_aux)) <= WEIGHT_TOL
        np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    if drop:   # demand passed capacity in training: top-1 counts the kept tokens, top-k every choice
        counts = train_counts
        assert float(counts.sum()) < 32 if k == 1 else float(counts.max()) > layer.capacity(32, True)


def test_expert_parallel_config_raises_naming_item_6():
    """``moe.expert_parallel_size`` is the mesh's expert axis: a size the
    world does not divide raises JAX's error (one rank here: any size above
    1); a size that divides it resolves the mesh."""
    from deepspeed_tpu_torch.comm.mesh import MeshSpec
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    base = {"train_batch_size": 2}
    cfg = DeepSpeedConfig({**base, "moe": {"enabled": True, "expert_parallel_size": 1}})
    assert cfg.moe.enabled and cfg.mesh_spec == MeshSpec(data=-1, expert=1)
    with pytest.raises(ValueError, match="not divisible by pipe\\*expert\\*seq\\*tensor=2"):
        DeepSpeedConfig({**base, "moe": {"enabled": True, "expert_parallel_size": 2}})
    assert MeshSpec(expert=2).resolve(4) == (1, 2, 2, 1, 1)


@pytest.mark.parametrize("key,value", [("num_experts", 8), ("top_k", 2), ("capacity_factor", 1.25),
                                       ("drop_tokens", False), ("noisy_gate_policy", "RSample")])
def test_moe_config_layer_fields_raise_unless_default(key, value):
    """The engine reads none of the layer's settings, so a non-default one
    raises rather than being silently ignored."""
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig, MoEConfig
    base = {"train_batch_size": 2}
    default = {f.name: f.default for f in dataclasses.fields(MoEConfig)}[key]
    assert getattr(DeepSpeedConfig({**base, "moe": {"enabled": True, key: default}}).moe, key) == default
    with pytest.raises(NotImplementedError, match="the MoE layer takes it"):
        DeepSpeedConfig({**base, "moe": {"enabled": True, key: value}})


def test_moe_model_over_two_ranks_raises_naming_item_6(monkeypatch):
    """Over two ranks a Mixtral gates each rank's rows as one group: a
    micro-batch whose rows do not split over the ranks (JAX gates it as one
    group) raises naming ROADMAP item 6.1, before any collective."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.mixtral import PRESETS, MixtralForCausalLM, make_mixtral_loss_fn
    cfg = PRESETS["tiny"]
    model = MixtralForCausalLM(cfg, device="cpu")
    engine = deepspeed_tpu_torch.initialize(model=model, config={"train_batch_size": 2}, device="cpu",
                                            loss_fn=make_mixtral_loss_fn(cfg))[0]
    monkeypatch.setattr(engine, "dp_world", 2)
    ids = np.zeros((3, 8), np.int64)
    with pytest.raises(NotImplementedError, match="item 6.1"):
        engine.train_batch(batch={"input_ids": ids, "labels": ids})


def test_token_mappings_are_the_identity_at_tp_1_and_raise_above():
    """Degree 1 returns the tensor itself; above it drop keeps the rank's
    token slice and raises where the degree does not divide the token dim
    (the collectives run in ``tests/test_torch_moe_tensor_parallel.py``)."""
    from deepspeed_tpu_torch.module_inject.layers import TensorParallel
    x = torch.randn(2, 4, 3)
    assert mappings.drop_tokens(x, 1) is x and mappings.gather_tokens(x, 1) is x
    torch.testing.assert_close(mappings.drop_tokens(x, 1, TensorParallel(2, 1)), x[:, 2:], rtol=0, atol=0)
    with pytest.raises(ValueError, match="does not divide"):
        mappings.drop_tokens(torch.randn(2, 3, 4), 1, TensorParallel(2, 0))
