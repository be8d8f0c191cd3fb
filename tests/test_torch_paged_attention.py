"""K3 paged attention of the PyTorch port (``deepspeed_tpu_torch``) against
the JAX package: the plain ``paged_attention`` and the in-place
``write_pages`` against ``deepspeed_tpu.models.llama_cache``'s, on the CPU,
from the same seeded numpy inputs; the split route's plain partials and
their merge against the same golden; the kernels' row map and split choice.
The CUDA kernels themselves run only on a GPU
(``tests/test_torch_cuda_kernels.py``); here their wrappers must refuse CPU
tensors rather than fall back."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.llama_cache import _write_pages as jax_write_pages
from deepspeed_tpu.models.llama_cache import paged_attention as jax_paged_attention
from deepspeed_tpu_torch.models import llama_cache as port
from deepspeed_tpu_torch.ops import paged_attention as port_op

ATOL = 2e-5   # float32: the two frameworks' einsum/softmax summation orders


def _setup(b=4, c=4, h=8, n_kv=4, d=32, page_size=8, max_pages=6, seed=0, starts=(0, 5, 13, 0)):
    """numpy inputs: an arena holding per-sequence histories (unused block
    table slots point at the null page 0), this chunk's q/k/v, and a batch of
    a prefill row, a continuation row, a decode-depth row and a padding row
    (chunk_len 0, all-null block table)."""
    rng = np.random.default_rng(seed)
    start_pos = np.array(starts[:b], np.int32)
    chunk_lens = np.array([c, max(c - 1, 1), 1, 0][:b], np.int32)
    block_table = np.zeros((b, max_pages), np.int32)
    next_page = 1
    for i in range(b):
        if chunk_lens[i] == 0:
            continue
        for s in range(-(-(start_pos[i] + c) // page_size)):
            block_table[i, s] = next_page
            next_page += 1
    pages = rng.normal(size=(next_page + 2, page_size, 2, n_kv, d)).astype(np.float32)
    pages[0] = 0.0    # the null page holds zeros, as the engine keeps it
    return dict(pages=pages, q=rng.normal(size=(b, c, h, d)).astype(np.float32),
                k=rng.normal(size=(b, c, n_kv, d)).astype(np.float32),
                v=rng.normal(size=(b, c, n_kv, d)).astype(np.float32), block_table=block_table,
                start_pos=start_pos, chunk_lens=chunk_lens, page_size=page_size)


def _jax_written(x):
    return jax_write_pages(jnp.asarray(x["pages"]), jnp.asarray(x["k"]), jnp.asarray(x["v"]),
                           jnp.asarray(x["block_table"]), jnp.asarray(x["start_pos"]), x["page_size"],
                           jnp.asarray(x["chunk_lens"]))


def _port_written(x):
    pages = torch.from_numpy(x["pages"].copy())
    port.write_pages(pages, torch.from_numpy(x["k"]), torch.from_numpy(x["v"]), torch.from_numpy(x["block_table"]),
                     torch.from_numpy(x["start_pos"]), x["page_size"], torch.from_numpy(x["chunk_lens"]))
    return pages


CASES = [pytest.param(dict(c=1, h=8, n_kv=8), id="mha-decode"), pytest.param(dict(c=4, h=8, n_kv=8), id="mha-chunk"),
         pytest.param(dict(c=1, h=8, n_kv=2), id="gqa-decode"), pytest.param(dict(c=4, h=8, n_kv=2), id="gqa-chunk")]


@pytest.mark.parametrize("shape", CASES)
def test_write_pages_matches_jax(shape):
    """The scatter is a copy: bit-identical arenas, padding redirected to
    the null page with zeroed values."""
    x = _setup(**shape)
    got = _port_written(x).numpy()
    np.testing.assert_array_equal(got, np.asarray(_jax_written(x)))
    np.testing.assert_array_equal(got[0], 0.0)


@pytest.mark.parametrize("shape", CASES)
def test_plain_paged_attention_matches_jax(shape):
    x = _setup(**shape)
    want = np.asarray(jax_paged_attention(jnp.asarray(x["q"]), _jax_written(x), jnp.asarray(x["block_table"]),
                                          jnp.asarray(x["start_pos"]), jnp.asarray(x["chunk_lens"]),
                                          x["page_size"]))
    args = (torch.from_numpy(x["q"]), _port_written(x), torch.from_numpy(x["block_table"]),
            torch.from_numpy(x["start_pos"]), torch.from_numpy(x["chunk_lens"]), x["page_size"])
    got = port.paged_attention(*args).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_array_equal(got[3], 0.0)       # padding row
    # the op the model calls takes the plain version for a CPU tensor
    np.testing.assert_array_equal(port_op.paged_attention(*args).numpy(), got)


def test_paged_attention_core_writes_then_attends():
    x = _setup(c=4, h=8, n_kv=2)
    pages = torch.from_numpy(x["pages"].copy())
    t = {k: torch.from_numpy(x[k]) for k in ("q", "k", "v", "block_table", "start_pos", "chunk_lens")}
    out = port.paged_attention_core(t["q"], t["k"], t["v"], pages, t["block_table"], t["start_pos"],
                                    t["chunk_lens"], x["page_size"], attention_impl="flash")
    np.testing.assert_array_equal(pages.numpy(), _port_written(x).numpy())
    want = port.paged_attention(t["q"], pages, t["block_table"], t["start_pos"], t["chunk_lens"], x["page_size"])
    np.testing.assert_array_equal(out.numpy(), want.numpy())
    with pytest.raises(ValueError, match="attention_impl"):
        port.paged_attention_core(t["q"], t["k"], t["v"], pages, t["block_table"], t["start_pos"],
                                  t["chunk_lens"], x["page_size"], attention_impl="chunked")


@pytest.mark.slow
def test_plain_matches_pallas_interpret():
    """The Pallas kernel itself (interpret mode on the CPU) as the golden."""
    from deepspeed_tpu.ops.paged_attention import paged_attention_pallas
    x = _setup(c=4, h=8, n_kv=2)
    want = np.asarray(paged_attention_pallas(jnp.asarray(x["q"]), _jax_written(x), jnp.asarray(x["block_table"]),
                                             jnp.asarray(x["start_pos"]), jnp.asarray(x["chunk_lens"]),
                                             x["page_size"], interpret=True))
    got = port.paged_attention(torch.from_numpy(x["q"]), _port_written(x), torch.from_numpy(x["block_table"]),
                               torch.from_numpy(x["start_pos"]), torch.from_numpy(x["chunk_lens"]), x["page_size"])
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper launches or raises: a CPU tensor is an error, not
    a reason to run the plain version."""
    x = _setup(c=1, h=8, n_kv=2)
    before = port_op.paged_attention_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        port_op.paged_attention_cuda(torch.from_numpy(x["q"]), torch.from_numpy(x["pages"]),
                                     torch.from_numpy(x["block_table"]), torch.from_numpy(x["start_pos"]),
                                     torch.from_numpy(x["chunk_lens"]), x["page_size"])
    assert port_op.paged_attention_cuda.launches == before


def test_entry_points_raise_without_gpu():
    """Without a GPU, asking for CUDA (the default) raises; nothing moves to
    the CPU unless the caller says device="cpu"."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the no-GPU rule cannot be exercised")
    from deepspeed_tpu_torch.accelerator import resolve_device
    from deepspeed_tpu_torch.inference.v2 import build_engine
    from deepspeed_tpu_torch.models.llama import PRESETS
    cfg = PRESETS["tiny"]
    for call in (lambda: resolve_device(None), lambda: port.LlamaForCausalLMWithCache(cfg),
                 lambda: build_engine(cfg, {}, device="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")


# ---------------------------------------------------------------- the split route


def test_row_tiles_are_position_major():
    """A 64-row tile spans 64/rep consecutive chunk positions, each with its
    rep heads side by side; a decode row's rep heads share one 16-row tile."""
    assert port_op.tile_rows(4, 1) == 16 and port_op.tile_rows(1, 16) == 16
    assert port_op.tile_rows(4, 256) == 64 and port_op.tile_rows(1, 17) == 64
    rows = [port_op.tile_row(3, i, 4, 64) for i in range(64)]
    assert [c for c, _ in rows] == [48 + i // 4 for i in range(64)]
    assert [r for _, r in rows] == [i % 4 for i in range(64)]
    assert [port_op.tile_row(0, i, 4, 16) for i in range(4)] == [(0, 0), (0, 1), (0, 2), (0, 3)]
    assert {port_op.tile_row(0, i, 1, 64)[1] for i in range(64)} == {0}   # rep 1: one head per position


def test_n_split_comes_from_shapes(monkeypatch):
    """Llama-3-8B (H 32, n_kv 8, D 128), a 128-page table of 16: 16 decode
    rows make 128 CTAs, so four splits pass 3 × 132; 8 decode rows make 64,
    seven splits; a prefill chunk (4 × 256 rows, 512 CTAs) and a mixed step
    (8 × 256, 1024 CTAs) stay whole.  At most one split per 256 keys, and
    the partials stay within the scratch budget (scaled down here to bind)."""
    cap = 128 * 16
    assert port_op.choose_n_split(16, 1, 32, 8, 128, cap) == 4
    assert port_op.choose_n_split(8, 1, 32, 8, 128, cap) == 7
    assert port_op.choose_n_split(1, 1, 32, 8, 128, cap) == 8       # 8 CTAs: the key cap binds
    assert port_op.choose_n_split(1, 1, 32, 8, 128, 600) == 2       # 600 keys: two splits of >= 256
    assert port_op.choose_n_split(4, 256, 32, 8, 128, cap) == 1
    assert port_op.choose_n_split(8, 256, 32, 8, 128, cap) == 1
    assert port_op.choose_n_split(1, 1, 32, 32, 64, cap) == 8       # rep 1: 32 CTAs
    # the partials of one decode split at B 16 are 16 · 32 · 130 · 4 B = 266,240 B
    monkeypatch.setattr(port_op, "SPLIT_SCRATCH_BYTES", 2 * 266_240)
    assert port_op.choose_n_split(16, 1, 32, 8, 128, cap) == 2
    for keys, n in ((2048, 3), (2048, 1), (48, 5), (1000, 4)):
        length = port_op.split_len(keys, n)
        assert length % port_op.KEYS_PER_TILE == 0 and length * n >= keys and (length - 64) * n < keys


SPLIT_CASES = [pytest.param(dict(c=4, h=8, n_kv=2), n, id=f"gqa-chunk-split{n}") for n in (1, 2, 4)] + \
    [pytest.param(dict(c=1, h=8, n_kv=8), 3, id="mha-decode-split3"),
     pytest.param(dict(c=4, h=8, n_kv=2, page_size=16, max_pages=20), 7, id="gqa-chunk-split7")]


@pytest.mark.parametrize("shape,n_split", SPLIT_CASES)
def test_merged_partials_match_jax(shape, n_split):
    """The split route in plain form: each split's partial (m in base 2, l,
    unnormalised O), merged, against the JAX golden at the f32 ATOL.  The
    histories reach 200 keys over 256-key tables, so with 4 or 7 splits the
    short rows leave whole splits empty (m = -inf), and the padding row
    (chunk_len 0) sees nothing in any split."""
    x = _setup(**{"max_pages": 32, **shape}, starts=(0, 70, 200, 0))
    jax_pages = _jax_written(x)
    want = np.asarray(jax_paged_attention(jnp.asarray(x["q"]), jax_pages, jnp.asarray(x["block_table"]),
                                          jnp.asarray(x["start_pos"]), jnp.asarray(x["chunk_lens"]),
                                          x["page_size"]))
    args = (torch.from_numpy(x["q"]), _port_written(x), torch.from_numpy(x["block_table"]),
            torch.from_numpy(x["start_pos"]), torch.from_numpy(x["chunk_lens"]), x["page_size"])
    m, l, o = port_op.paged_attention_partials_plain(*args, n_split)
    assert m.shape == (n_split, ) + x["q"].shape[:3] and o.shape == (n_split, ) + x["q"].shape
    assert bool((m[:, 3] == -np.inf).all()) and bool((l[:, 3] == 0).all())   # padding row: empty everywhere
    if n_split >= 4:
        assert bool((m[1:, 0, 0] == -np.inf).all())    # the 1-key row: every split past the first is empty
    o = torch.where((m == -np.inf)[..., None], torch.nan, o)   # an empty split's O is never read
    got = port_op.merge_partials_plain(m, l, o, args[4]).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_array_equal(got[3], 0.0)


def test_split_wrappers_refuse_cpu_tensors():
    x = _setup(c=1, h=8, n_kv=2)
    t = [torch.from_numpy(x[k]) for k in ("q", "pages", "block_table", "start_pos", "chunk_lens")]
    m, l, o = port_op.paged_attention_partials_plain(*t, x["page_size"], 2)
    with pytest.raises(ValueError, match="CUDA"):
        port_op.merge_partials_cuda(m, l, o, t[4])
    with pytest.raises(ValueError, match="CUDA"):
        port_op.paged_attention_partials_cuda(t[0].to(torch.bfloat16), t[1].to(torch.bfloat16), *t[2:],
                                              x["page_size"], 2)
