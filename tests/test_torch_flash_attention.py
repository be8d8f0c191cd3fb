"""The flash-attention op of the PyTorch port (``deepspeed_tpu_torch.ops.
flash_attention``) against the JAX package's Pallas kernels, run in interpret
mode on the CPU as the JAX package's own tests run them.

The port's plain versions (what the CUDA kernels K1, K2a, K2b compute) are
held against ``_flash_fwd2`` / ``_flash_bwd2``, and the op's autograd path
against ``jax.vjp`` of the JAX op.  Inputs come from numpy seeds.  Tolerance
2e-5 in float32, as ``tests/unit/ops/test_flash_attention.py`` uses: the two
sides sum in other orders (the Pallas kernels blockwise and online, the
plain versions over whole rows)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import flash_attention as jfa
from deepspeed_tpu_torch.ops.attention import chunked_attention
from deepspeed_tpu_torch.ops import flash_attention as tfa
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse fixture)

TOL = 2e-5
BLOCK = 64


def _inputs(b=1, sq=128, sk=128, h=4, hk=2, d=32, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, hk, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, hk, d)).astype(np.float32)
    do = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    return q, k, v, do


def _packed(x):
    b, s, n, d = x.shape
    return jnp.asarray(x.reshape(b, s, n * d))


# (causal, h, hk, sq, sk, q_offset)
CASES = [
    pytest.param(True, 4, 4, 128, 128, 0, id="causal-mha"),
    pytest.param(False, 4, 4, 128, 128, 0, id="full-mha"),
    pytest.param(True, 4, 2, 128, 128, 0, id="causal-gqa"),
    pytest.param(False, 4, 2, 128, 128, 0, id="full-gqa"),
    pytest.param(True, 4, 2, 128, 256, 128, id="q-offset-128"),
    pytest.param(True, 4, 2, 128, 256, 0, id="sk-gt-sq"),
]


@pytest.mark.parametrize("causal,h,hk,sq,sk,q_offset", CASES)
def test_flash_fwd_plain_matches_pallas_kernel(causal, h, hk, sq, sk, q_offset):
    q, k, v, _ = _inputs(sq=sq, sk=sk, h=h, hk=hk)
    d = q.shape[-1]
    want_o, want_lse = jfa._flash_fwd2(_packed(q), _packed(k), _packed(v), h=h, hk=hk, causal=causal,
                                       block_q=BLOCK, block_k=BLOCK, interpret=True, q_offset=q_offset)
    o, lse = tfa.flash_fwd_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal, q_offset)
    assert o.shape == q.shape and lse.shape == (1, h, sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy().reshape(1, sq, h * d), np.asarray(want_o), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("causal,h,hk,sq,sk,q_offset", CASES)
def test_flash_bwd_plain_matches_pallas_kernels(causal, h, hk, sq, sk, q_offset):
    """dq against ``_dq2_kernel``, dk/dv against ``_dkv2_kernel``, from the
    same o and lse (lse lane-broadcast to the JAX layout)."""
    q, k, v, do = _inputs(sq=sq, sk=sk, h=h, hk=hk, seed=1)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = tfa.flash_fwd_plain(tq, tk, tv, causal, q_offset)
    jlse = jnp.broadcast_to(jnp.asarray(lse.numpy())[..., None], lse.shape + (jfa.LANE, ))
    want = jfa._flash_bwd2(_packed(q), _packed(k), _packed(v), _packed(o.numpy()), jlse, _packed(do), h=h,
                           hk=hk, causal=causal, block_q=BLOCK, block_k=BLOCK, interpret=True, q_offset=q_offset)
    got = tfa.flash_bwd_plain(tq, tk, tv, o, lse, tdo, causal, q_offset)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy().reshape(np.shape(w)), np.asarray(w), atol=TOL, rtol=TOL, err_msg=name)
    if causal and sk > sq + q_offset:
        # keys past the last query's position are seen by no row
        assert not got[1][:, sq + q_offset:].any() and not got[2][:, sq + q_offset:].any()


def test_flash_delta_plain_is_rowsum():
    q, k, v, do = map(torch.from_numpy, _inputs())
    o, _ = tfa.flash_fwd_plain(q, k, v, True, 0)
    delta = tfa.flash_delta_plain(o, do)
    assert delta.shape == (1, 4, 128)
    torch.testing.assert_close(delta, torch.einsum("bshd,bshd->bhs", o, do), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_autograd_matches_jax_vjp(causal):
    """The op on CPU tensors (``ds_torch::flash_fwd`` with its registered
    backward) against ``jax.vjp`` of the JAX op in interpret mode."""
    q, k, v, do = _inputs(seed=2)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_o, vjp = jax.vjp(
        lambda a, b_, c: jfa.flash_attention(a, b_, c, causal=causal, block_q=BLOCK, block_k=BLOCK,
                                             interpret=True), jq, jk, jv)
    want_grads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = tfa.flash_attention(tq, tk, tv, causal=causal)
    o.backward(torch.from_numpy(do))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(want_o), atol=TOL, rtol=TOL)
    for name, t, w in zip(("dq", "dk", "dv"), (tq, tk, tv), want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=TOL, rtol=TOL, err_msg=name)


MASKED = [
    pytest.param(dict(), 96, id="seq-96"),
    pytest.param(dict(segment_ids="seg"), 128, id="segment-ids"),
    pytest.param(dict(sliding_window=48), 128, id="sliding-window"),
]


@pytest.mark.parametrize("kw,s", MASKED)
def test_dispatch_takes_chunked_path(kw, s, monkeypatch):
    """A mask, or a length that is not a multiple of 128, goes to
    ``chunked_attention`` (``flash_attention.py:525-534``) and never reaches
    the flash op; ``q_position_offset`` with either raises."""
    q, k, v, _ = map(torch.from_numpy, _inputs(sq=s, sk=s))
    if kw.get("segment_ids") == "seg":
        kw = dict(segment_ids=torch.from_numpy(np.repeat(np.arange(2), s // 2)[None].astype(np.int32)))

    def refuse(*a, **k_):
        raise AssertionError("the flash op must not run for a masked or unaligned input")

    monkeypatch.setattr(tfa, "flash_fwd", refuse)
    got = tfa.flash_attention(q, k, v, causal=True, **kw)
    want = chunked_attention(q, k, v, causal=True, **kw)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="q_position_offset"):
        tfa.flash_attention(q, k, v, causal=True, q_position_offset=128, **kw)


def test_dispatch_masked_paths_match_jax():
    """The chunked fallback with a sliding window against the JAX op's."""
    q, k, v, _ = _inputs(sq=128, sk=128, seed=3)
    want = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True, sliding_window=48, interpret=True)
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True, sliding_window=48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


NEGATIVE_OFFSET_CALLS = {
    "flash_fwd_cuda": lambda q, k, v, o, lse, do: tfa.flash_fwd_cuda(q, k, v, True, -64),
    "flash_dq_cuda": lambda q, k, v, o, lse, do: tfa.flash_dq_cuda(q, k, v, o, lse, do, True, -64),
    "flash_dkv_cuda": lambda q, k, v, o, lse, do: tfa.flash_dkv_cuda(q, k, v, do, lse, lse, True, -64),
    "flash_fwd": lambda q, k, v, o, lse, do: tfa.flash_fwd(q, k, v, True, -64),
    "flash_bwd": lambda q, k, v, o, lse, do: tfa.flash_bwd(q, k, v, o, lse, do, True, -64),
    "flash_attention": lambda q, k, v, o, lse, do: tfa.flash_attention(q, k, v, causal=True, q_position_offset=-64),
}


@pytest.mark.parametrize("name", list(NEGATIVE_OFFSET_CALLS))
def test_negative_q_offset_is_rejected(name):
    """Causal rows with ``q_offset < 0`` see no key; the routes do not define
    them alike (JAX's table gives their block no kv block, the plain version
    attends uniformly), so every wrapper raises before any launch."""
    q, k, v, do = map(torch.from_numpy, _inputs(sq=128, sk=128))
    o, lse = tfa.flash_fwd_plain(q, k, v, True, 0)
    with pytest.raises(ValueError, match="q_offset must be >= 0"):
        NEGATIVE_OFFSET_CALLS[name](q, k, v, o, lse, do)
