"""Block-sparse attention of the PyTorch port (``deepspeed_tpu_torch.ops.
sparse_attention``) against the JAX package's, on the CPU.

Layouts must be bit-identical (the port keeps its own copy of the numpy
configs).  The port's golden and its kernel path (whose CPU tensors run the
plain versions of K6a–c) are held to the JAX golden ``sparse_attention``
within 2e-5 in float32, and their gradients to ``jax.grad`` of it within
5e-5, the tolerances of ``tests/unit/ops/test_sparse_attention.py``: the two
sides sum in other orders.  The plain forward is also held to the Pallas
kernel in interpret mode, as the JAX package's own tests run it.  Inputs come
from numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu.ops.sparse_attention import pallas_kernel as jpk
from deepspeed_tpu_torch.ops import sparse_attention as tsa
from deepspeed_tpu_torch.ops.sparse_attention import kernel as tk
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

FWD_TOL, GRAD_TOL = 2e-5, 5e-5
B, H, S, D, BLK = 2, 4, 64, 16, 8

#: DeepSpeed's documented ``sparse_attention`` example (config-json, "Sparse Attention")
DOC_FIXED = {"mode": "fixed", "block": 16, "different_layout_per_head": True, "num_local_blocks": 4,
             "num_global_blocks": 1, "attention": "bidirectional", "horizontal_global_attention": False,
             "num_different_global_patterns": 4}


def _configs(m):
    """(name, config, causal) for the configs of the JAX tests and a few
    more knobs, built by module ``m`` (the JAX package's or the port's)."""
    return [
        ("dense", m.DenseSparsityConfig(num_heads=H, block=BLK), False),
        ("fixed-bi", m.FixedSparsityConfig(num_heads=H, block=BLK, num_local_blocks=4, num_global_blocks=1), False),
        ("fixed-uni", m.FixedSparsityConfig(num_heads=H, block=BLK, num_local_blocks=4, attention="unidirectional"),
         True),
        ("fixed-per-head", m.FixedSparsityConfig(num_heads=H, block=BLK, different_layout_per_head=True,
                                                 num_local_blocks=4, num_global_blocks=1,
                                                 horizontal_global_attention=True, num_different_global_patterns=4),
         False),
        ("bigbird", m.BigBirdSparsityConfig(num_heads=H, block=BLK, num_random_blocks=1, num_sliding_window_blocks=3,
                                            num_global_blocks=1), False),
        ("bigbird-uni-per-head", m.BigBirdSparsityConfig(num_heads=H, block=BLK, different_layout_per_head=True,
                                                         num_random_blocks=2, attention="unidirectional", seed=3),
         True),
        ("bslongformer", m.BSLongformerSparsityConfig(num_heads=H, block=BLK, num_sliding_window_blocks=3,
                                                      global_block_indices=[0]), False),
        ("bslongformer-ranges", m.BSLongformerSparsityConfig(num_heads=H, block=BLK, global_block_indices=[0, 5],
                                                             global_block_end_indices=[2, 6]), False),
        ("local", m.LocalSlidingWindowSparsityConfig(num_heads=H, block=BLK, num_sliding_window_blocks=3), True),
        ("variable", m.VariableSparsityConfig(num_heads=H, block=BLK, num_random_blocks=1, local_window_blocks=[2, 4],
                                              global_block_indices=[0]), False),
        ("variable-uni-per-head", m.VariableSparsityConfig(num_heads=H, block=BLK, different_layout_per_head=True,
                                                           num_random_blocks=2, local_window_blocks=[1, 3],
                                                           global_block_indices=[1], global_block_end_indices=[3],
                                                           attention="unidirectional", seed=7), True),
    ]


PORT_CONFIGS = _configs(tsa)
IDS = [c[0] for c in PORT_CONFIGS]


def _qkv(b=B, h=H, s=S, d=D, seed=0, n=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, s, d)).astype(np.float32) for _ in range(n)]


# ---------------------------------------------------------------- layouts


@pytest.mark.parametrize("s", [64, 256])
@pytest.mark.parametrize("name,cfg,causal", PORT_CONFIGS, ids=IDS)
def test_layouts_bit_identical(name, cfg, causal, s):
    """Each config's ``make_layout`` equals the JAX package's, value and dtype
    (the random blocks of Variable and BigBird come from the same numpy rng)."""
    want = _configs(jsa)[IDS.index(name)][1].make_layout(s)
    got = _configs(tsa)[IDS.index(name)][1].make_layout(s)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("s", [1024, 4096])
def test_make_sparsity_config_from_the_documented_block(s):
    got = tsa.make_sparsity_config(dict(DOC_FIXED), num_heads=16).make_layout(s)
    want = jsa.make_sparsity_config(dict(DOC_FIXED), num_heads=16).make_layout(s)
    assert np.array_equal(got, want)
    for mode in ("dense", "bigbird", "bslongformer", "local_sliding_window", "variable"):
        d = {"mode": mode, "block": 16, "num_heads": 2}
        assert np.array_equal(tsa.make_sparsity_config(d).make_layout(s), jsa.make_sparsity_config(d).make_layout(s))


@pytest.mark.parametrize("name,cfg,causal", PORT_CONFIGS, ids=IDS)
def test_tables_are_the_row_and_column_gather_maps(name, cfg, causal):
    """The CSR tables list, per (head, block), the same blocks in the same
    order as JAX's padded ``_row_gather_maps`` / ``_col_gather_maps``, and the
    launch order puts the widest rows and columns first."""
    layout = cfg.make_layout(S)
    t = tk.build_tables(layout)
    for (ptr, idx, order), (cols, valid) in (
            ((t.row_ptr, t.row_idx, t.row_order), jsa.sparse_self_attention._row_gather_maps(layout)),
            ((t.col_ptr, t.col_idx, t.col_order), jpk._col_gather_maps(layout))):
        assert ptr.dtype == idx.dtype == order.dtype == torch.int32
        want = [c[v].tolist() for c, v in zip(cols.reshape(-1, cols.shape[-1]), valid.reshape(-1, valid.shape[-1]))]
        got = [idx[ptr[i]:ptr[i + 1]].tolist() for i in range(len(ptr) - 1)]
        assert got == want
        counts = (ptr[1:] - ptr[:-1])[order.long()]
        assert sorted(order.tolist()) == list(range(len(order))) and bool((counts[:-1] >= counts[1:]).all())


# ---------------------------------------------------------------- forward


def _jax_golden(q, k, v, layout, causal, kpm=None, block=BLK):
    return np.asarray(jsa.sparse_attention(*map(jnp.asarray, (q, k, v)), layout, block, causal=causal,
                                           key_padding_mask=kpm))


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("name,cfg,_causal", PORT_CONFIGS, ids=IDS)
def test_forward_matches_jax_golden(name, cfg, _causal, causal):
    """The port's golden and its kernel path (plain K6a on CPU tensors)
    against the JAX golden, with and without causal."""
    q, k, v = _qkv(seed=1)
    layout = cfg.make_layout(S)
    want = _jax_golden(q, k, v, layout, causal)
    tq, tk_, tv = map(torch.from_numpy, (q, k, v))
    golden = tsa.sparse_attention(tq, tk_, tv, layout, BLK, causal=causal)
    kernel_path = tsa.sparse_attention_kernel(tq, tk_, tv, layout, BLK, causal=causal)
    np.testing.assert_allclose(golden.numpy(), want, atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(kernel_path.numpy(), want, atol=FWD_TOL, rtol=FWD_TOL)


def _padding_mask(seed=4):
    kp = np.ones((B, S), bool)
    kp[0, S // 2:] = False                                   # second half of the keys of batch 0
    kp[1] = np.random.default_rng(seed).random(S) > 0.3      # scattered keys of batch 1
    return kp


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("name", ["dense", "fixed-per-head", "bigbird", "local"])
def test_forward_with_key_padding_mask_matches_jax_golden(name, causal):
    """``key_padding_mask`` on the golden and on the kernel path (the plain
    versions mask kept keys as the kernels do) against the JAX golden."""
    q, k, v = _qkv(seed=2)
    cfg = PORT_CONFIGS[IDS.index(name)][1]
    layout = cfg.make_layout(S)
    kp = _padding_mask()
    want = _jax_golden(q, k, v, layout, causal, kpm=kp)
    tq, tk_, tv = map(torch.from_numpy, (q, k, v))
    for got in (tsa.sparse_attention(tq, tk_, tv, layout, BLK, causal=causal, key_padding_mask=torch.from_numpy(kp)),
                tsa.sparse_attention_kernel(tq, tk_, tv, layout, BLK, causal=causal,
                                            key_padding_mask=torch.from_numpy(kp))):
        np.testing.assert_allclose(got.numpy(), want, atol=FWD_TOL, rtol=FWD_TOL)


def _jax_test_layout(h, nb):
    """The layout of ``test_pallas_kernel_matches_jnp``: two sliding blocks
    and a global block 0."""
    layout = np.zeros((h, nb, nb), np.int64)
    for hh in range(h):
        for r in range(nb):
            layout[hh, r, max(0, r - 1):r + 1] = 1
            layout[hh, r, 0] = 1
    return layout


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_plain_forward_matches_pallas_kernel(causal):
    """o and lse of the plain K6a against the Pallas forward in interpret
    mode at the JAX test's size (B 2, H 2, S 256, D 64, block 64)."""
    b, h, s, d, block = 2, 2, 256, 64, 64
    layout = _jax_test_layout(h, s // block)
    q, k, v = _qkv(b, h, s, d, seed=0)
    want_o, want_lse = jpk._fwd_impl(*map(jnp.asarray, (q, k, v)), layout, block, causal=causal, interpret=True,
                                     emit_lse=True)
    tables = tk.build_tables(layout)
    o, lse = tk.sparse_attn_fwd_plain(*map(torch.from_numpy, (q, k, v)), tables, block, causal=causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0].reshape(b, h, s), atol=FWD_TOL,
                               rtol=FWD_TOL)


def _masked_row_layout():
    """``test_pallas_fully_masked_row_emits_zeros``: row block 0 admits only
    the last (future) block."""
    nb = 4
    layout = np.zeros((1, nb, nb), np.int64)
    layout[0, 0, nb - 1] = 1
    for r in range(1, nb):
        layout[0, r, :r + 1] = 1
    return layout


def _empty_rows_cols_layout():
    """``test_pallas_bwd_sparse_layout_and_no_dense_intermediate``: head 0 has
    an empty kv column (1) and an empty q row (2); head 1 is local."""
    nb = 4
    layout = np.zeros((2, nb, nb), np.int64)
    layout[0, 0, 0] = layout[0, 1, 0] = 1
    layout[0, 3, [0, 3]] = 1
    for r in range(nb):
        layout[1, r, max(0, r - 1):r + 1] = 1
    return layout


def test_fully_masked_and_empty_rows_emit_zeros_and_big_lse():
    block = 32
    for layout in (_masked_row_layout(), _empty_rows_cols_layout()):
        h, nb = layout.shape[:2]
        q, k, v = _qkv(1, h, nb * block, 32, seed=3)
        tables = tk.build_tables(layout)
        o, lse = tk.sparse_attn_fwd_plain(*map(torch.from_numpy, (q, k, v)), tables, block, causal=True)
        want = _jax_golden(q, k, v, layout, True, block=block)
        np.testing.assert_allclose(o.numpy(), want, atol=FWD_TOL, rtol=FWD_TOL)
        dead = (o == 0).all(-1)
        assert bool(dead.any()) and bool((lse[dead] == tk.EMPTY_ROW_LSE).all())
        assert bool((lse[~dead] < 1e3).all())


# ---------------------------------------------------------------- gradients


def _jax_grads(q, k, v, do, layout, block, causal, kpm=None):
    def loss(q_, k_, v_):
        out = jsa.sparse_attention(q_, k_, v_, layout, block, causal=causal, key_padding_mask=kpm)
        return jnp.sum(out * jnp.asarray(do))

    out = _jax_golden(q, k, v, layout, causal, kpm=kpm, block=block)
    return out, [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))]


def _torch_grads(fn, q, k, v, do):
    tq, tk_, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fn(tq, tk_, tv)
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [t.grad.numpy() for t in (tq, tk_, tv)]


def _assert_grads(got, want):
    (o, grads), (want_o, want_grads) = got, want
    np.testing.assert_allclose(o, want_o, atol=FWD_TOL, rtol=FWD_TOL)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want_grads):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("name,cfg,causal", PORT_CONFIGS, ids=IDS)
def test_gradients_match_jax_grad_of_golden(name, cfg, causal):
    """dq, dk, dv of the kernel path (the ``ds_torch::sparse_attn_bwd`` op:
    plain K6b and K6c on CPU tensors) and of the port's golden through
    autograd, against ``jax.grad`` of the JAX golden."""
    q, k, v, do = _qkv(seed=5, n=4)
    ssa = tsa.SparseSelfAttention(cfg)
    layout = ssa.get_layout(S)
    want = _jax_grads(q, k, v, do, layout, BLK, causal)
    _assert_grads(_torch_grads(ssa, q, k, v, do), want)
    _assert_grads(_torch_grads(lambda a, b_, c: tsa.sparse_attention(a, b_, c, layout, BLK, causal=causal),
                               q, k, v, do), want)


@pytest.mark.parametrize("case", ["masked-row", "empty-rows-cols"])
def test_gradients_with_empty_rows_and_columns(case):
    """The layouts of the JAX backward tests: a row whose admitted keys are
    all in its future, an empty q row and an empty kv column.  Their
    gradients are exactly zero and nothing is NaN."""
    layout = _masked_row_layout() if case == "masked-row" else _empty_rows_cols_layout()
    block = 32
    h, nb = layout.shape[:2]
    q, k, v, do = _qkv(1, h, nb * block, 32, seed=6, n=4)
    want = _jax_grads(q, k, v, do, layout, block, True)
    got = _torch_grads(lambda a, b_, c: tsa.sparse_attention_kernel(a, b_, c, layout, block, causal=True),
                       q, k, v, do)
    _assert_grads(got, want)
    if case == "empty-rows-cols":
        dq, dk, dv = got[1]
        assert not dq[0, 0, 2 * block:3 * block].any()                       # empty q row 2 of head 0
        assert not dk[0, 0, block:2 * block].any() and not dv[0, 0, block:2 * block].any()   # empty column 1


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_gradients_with_key_padding_mask(causal):
    q, k, v, do = _qkv(seed=7, n=4)
    cfg = PORT_CONFIGS[IDS.index("bigbird")][1]
    layout = cfg.make_layout(S)
    kp = _padding_mask(seed=8)
    want = _jax_grads(q, k, v, do, layout, BLK, causal, kpm=kp)
    got = _torch_grads(lambda a, b_, c: tsa.sparse_attention_kernel(a, b_, c, layout, BLK, causal=causal,
                                                                    key_padding_mask=torch.from_numpy(kp)),
                       q, k, v, do)
    _assert_grads(got, want)
    assert not got[1][1][0, :, S // 2:].any()          # padded keys get no dk


def test_plain_backward_pieces():
    """delta is rowsum(do·o); the backward op's CPU branch is the plain
    backward; ``do`` is taken in q's dtype."""
    q, k, v, do = map(torch.from_numpy, _qkv(seed=9, n=4))
    layout = PORT_CONFIGS[IDS.index("fixed-per-head")][1].make_layout(S)
    tables = tk.build_tables(layout)
    o, lse = tk.sparse_attn_fwd_plain(q, k, v, tables, BLK)
    torch.testing.assert_close(tk.sparse_attn_delta_plain(o, do), torch.einsum("bhsd,bhsd->bhs", o, do))
    via_op = torch.ops.ds_torch.sparse_attn_bwd(q, k, v, o, lse, do, tables.tensors(), None, BLK, False,
                                                1 / np.sqrt(D))
    for a, b_ in zip(via_op, tk.sparse_attn_bwd_plain(q, k, v, o, lse, do.double(), tables, BLK)):
        torch.testing.assert_close(a, b_)


@pytest.mark.slow
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_gradients_match_jax_grad_of_pallas_kernels(causal):
    """The kernel path's gradients against ``jax.grad`` of
    ``sparse_attention_pallas`` in interpret mode (its dq and dk/dv Pallas
    kernels), at the JAX test's size."""
    b, h, s, d, block = 1, 2, 128, 32, 32
    layout = _jax_test_layout(h, s // block)
    q, k, v, do = _qkv(b, h, s, d, seed=10, n=4)

    def loss(q_, k_, v_):
        return jnp.sum(jpk.sparse_attention_pallas(q_, k_, v_, layout, block, causal=causal, interpret=True)
                       * jnp.asarray(do))

    want_o = np.asarray(jpk.sparse_attention_pallas(*map(jnp.asarray, (q, k, v)), layout, block, causal=causal,
                                                    interpret=True))
    want = [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))]
    got = _torch_grads(lambda a, b_, c: tsa.sparse_attention_kernel(a, b_, c, layout, block, causal=causal),
                       q, k, v, do)
    _assert_grads(got, (want_o, want))


# ---------------------------------------------------------------- wrapper, utils, config


def test_self_attention_wrapper_caches_and_defaults():
    """``impl="kernel"`` is the default; layouts are cached per length and
    their tables per device; ``causal`` follows the config's attention;
    ``impl="plain"`` runs the golden and agrees."""
    cfg = tsa.FixedSparsityConfig(num_heads=H, block=BLK, num_local_blocks=4, attention="unidirectional")
    ssa = tsa.SparseSelfAttention(cfg)
    assert ssa.impl == "kernel"
    q, k, v = map(torch.from_numpy, _qkv(seed=11))
    out = ssa(q, k, v)
    assert S in ssa._layouts and S in ssa._sparse_layouts
    tables = ssa.get_sparse_layout(S).tables("cpu")
    ssa(q, k, v)
    assert ssa.get_sparse_layout(S).tables("cpu") is tables
    torch.testing.assert_close(out, tsa.SparseSelfAttention(cfg, impl="plain")(q, k, v), atol=FWD_TOL, rtol=FWD_TOL)
    torch.testing.assert_close(out, tsa.sparse_attention_kernel(q, k, v, cfg.make_layout(S), BLK, causal=True))
    with pytest.raises(ValueError, match="impl"):
        tsa.SparseSelfAttention(cfg, impl="pallas")


def test_wrapper_and_registry_match_jax_wrapper():
    """``SparseSelfAttention`` built from a registry dict, as the JAX test
    builds it, against the JAX wrapper."""
    d = {"mode": "bslongformer", "num_heads": H, "block": BLK}
    q, k, v = _qkv(seed=12)
    want = np.asarray(jsa.SparseSelfAttention(jsa.make_sparsity_config(d))(*map(jnp.asarray, (q, k, v))))
    got = tsa.SparseSelfAttention(tsa.make_sparsity_config(d))(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_TOL, rtol=FWD_TOL)


def test_cuda_wrappers_refuse_cpu_tensors_and_unsupported_shapes():
    q, k, v = map(torch.from_numpy, _qkv())
    tables = tk.build_tables(tsa.DenseSparsityConfig(num_heads=H, block=BLK).make_layout(S))
    with pytest.raises(ValueError, match="CUDA"):
        tk.sparse_attn_fwd_cuda(q, k, v, tables, BLK)
    with pytest.raises(ValueError, match="does not fit"):
        tk.sparse_attn_fwd_plain(q, k, v, tables, 2 * BLK)


@pytest.mark.parametrize("seq,block", [(13, 8), (16, 8), (30, 16)])
def test_pad_and_unpad_match_jax(seq, block):
    rng = np.random.default_rng(seq)
    ids = rng.integers(1, 100, (2, seq)).astype(np.int32)
    mask = np.ones((2, seq), np.int32)
    emb = rng.normal(size=(2, seq, 4)).astype(np.float32)
    want = jsa.pad_to_block_size(block, jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                                 inputs_embeds=jnp.asarray(emb), pad_token_id=5)
    got = tsa.pad_to_block_size(block, torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                                inputs_embeds=torch.from_numpy(emb), pad_token_id=5)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    out = rng.normal(size=(2, seq + got[0], 4)).astype(np.float32)
    np.testing.assert_array_equal(tsa.unpad_sequence_output(got[0], torch.from_numpy(out)).numpy(),
                                  np.asarray(jsa.unpad_sequence_output(want[0], jnp.asarray(out))))


@pytest.mark.parametrize("max_position", [300, 512, 4096])
def test_extend_position_embedding_matches_jax(max_position):
    """BERT-large's 512 learned positions tiled to a long context."""
    pos = np.random.default_rng(0).normal(size=(512, 8)).astype(np.float32)
    want = jsa.extend_position_embedding(jnp.asarray(pos), max_position)
    got = tsa.extend_position_embedding(torch.from_numpy(pos), max_position)
    assert tuple(got.shape) == (max_position, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_config_accepts_sparse_attention_block():
    """``sparse_attention`` is kept as the raw dict, as the JAX config keeps
    it, and ``make_sparsity_config`` turns it into the documented layout."""
    cfg = DeepSpeedConfig({"train_batch_size": 4, "sparse_attention": dict(DOC_FIXED)})
    assert cfg.sparse_attention == DOC_FIXED
    assert DeepSpeedConfig({"train_batch_size": 4}).sparse_attention is None
    sc = tsa.make_sparsity_config(cfg.sparse_attention, num_heads=16)
    assert isinstance(sc, tsa.FixedSparsityConfig) and sc.num_different_global_patterns == 4
    assert np.array_equal(sc.make_layout(1024), jsa.make_sparsity_config(dict(DOC_FIXED), num_heads=16).make_layout(1024))
