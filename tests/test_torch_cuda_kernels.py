"""The PyTorch port's CUDA kernels on the card: K3 (paged attention),
K1/K2a/K2b (flash attention forward and backward), K6a/K6b/K6c
(block-sparse attention forward and backward) and K4a/K4b/K5a/K5b (block
int8/int4 quantize and dequantize).  Every test is marked
``cuda`` and skips without a GPU.  This file imports nothing of the JAX
package, so a GPU host without JAX runs it on its own:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference.v2 import (PagedKVConfig, RaggedInferenceEngineConfig, SchedulerConfig,
                                              build_engine)
from deepspeed_tpu_torch.models.llama import PRESETS, LlamaForCausalLM, init_weights_
from deepspeed_tpu_torch.models.llama_cache import LlamaForCausalLMWithCache, paged_attention
from deepspeed_tpu_torch.ops.paged_attention import (choose_n_split, merge_partials_cuda, merge_partials_plain,
                                                     mma_probe_cuda, paged_attention_cuda,
                                                     paged_attention_partials_cuda, paged_attention_partials_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _needs_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _case(c, dtype, d=64, h=8, n_kv=2, page=16, seed=0, clens=None):
    """A prefill row, a continuation row, a decode-depth row and a padding
    row (chunk_len 0, all-null block table) over shuffled physical pages;
    the table holds 5 pages more than the longest row needs (null pages)."""
    rng = np.random.default_rng(seed)
    start = np.array([0, 5, 40, 0], np.int32)
    clens = np.array(clens if clens is not None else [c, max(c - 1, 1), 1, 0], np.int32)
    need = [-(-(int(s) + int(n)) // page) if n else 0 for s, n in zip(start, clens)]
    max_pages = max(need) + 5
    bt = np.zeros((4, max_pages), np.int32)
    phys = list(rng.permutation(np.arange(1, sum(need) + 1)))
    for i, n in enumerate(need):
        bt[i, :n] = phys[:n]
        phys = phys[n:]
    pages = torch.from_numpy(rng.normal(size=(sum(need) + 1, page, 2, n_kv, d)).astype(np.float32)).cuda().to(dtype)
    q = torch.from_numpy(rng.normal(size=(4, c, h, d)).astype(np.float32)).cuda().to(dtype)
    return q, pages, torch.from_numpy(bt).cuda(), torch.from_numpy(start).cuda(), torch.from_numpy(clens).cuda(), page


K3_CASES = [pytest.param(torch.float32, 64, c, 1, id=f"f32-c{c}") for c in (1, 4, 256)] + \
    [pytest.param(torch.bfloat16, d, c, n, id=f"bf16-d{d}-c{c}-split{n or 'auto'}")
     for d in (64, 128) for c in (1, 4, 256) for n in (None, 1, 3)]


@pytest.mark.parametrize("dtype,d,c,n_split", K3_CASES)
def test_paged_attention_kernel_matches_plain(dtype, d, c, n_split):
    """K3 against its plain version on the same CUDA tensors, at decode (c
    1: rep·C = 4 rows, the 16-row CTA whose warps split each key tile), a
    short chunk and a 256-row chunk (64-row CTAs), whole and split over the
    context (bf16; ``None``: the wrapper's choice).  Tolerance: float32
    differs only in summation order; bf16 rounds p and the output at other
    points, a few ulps of 2^-8."""
    args = _case(c, dtype, d=d)
    before = (paged_attention_cuda.launches, paged_attention_cuda.split_calls)
    got = paged_attention_cuda(*args) if n_split is None else paged_attention_cuda(*args, n_split=n_split)
    want = paged_attention(*args)
    torch.cuda.synchronize()
    split = n_split if n_split is not None else (
        1 if dtype == torch.float32 else choose_n_split(4, c, 8, 2, d, args[2].shape[1] * 16))
    assert (paged_attention_cuda.launches, paged_attention_cuda.split_calls) == (before[0] + 1,
                                                                                 before[1] + (split > 1))
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert bool((got[3] == 0).all())


@pytest.mark.parametrize("n_split", [None, 1, 2])
def test_paged_attention_kernel_at_the_verify_shape(n_split):
    """K3 at the speculative verify round of Llama-3-8B (the engine's
    ("verify", 8, 5) key): 8 rows of C = 5 (the last token and 4 drafts),
    32/8 heads of 128, bf16, contexts 64-1024 over shuffled pages, whole and
    split over the context, against the plain version (tolerance as above)."""
    rng = np.random.default_rng(5)
    page, b, c = 16, 8, 5
    start = rng.integers(64, 1020, b).astype(np.int32)
    need = [-(-(int(s) + c) // page) for s in start]
    bt = np.zeros((b, 65), np.int32)
    phys = list(rng.permutation(np.arange(1, sum(need) + 1)))
    for i, n in enumerate(need):
        bt[i, :n] = phys[:n]
        phys = phys[n:]
    pages = torch.from_numpy(rng.normal(size=(sum(need) + 1, page, 2, 8, 128)).astype(np.float32)).cuda()
    q = torch.from_numpy(rng.normal(size=(b, c, 32, 128)).astype(np.float32)).cuda()
    args = (q.to(torch.bfloat16), pages.to(torch.bfloat16), torch.from_numpy(bt).cuda(),
            torch.from_numpy(start).cuda(), torch.full((b, ), c, dtype=torch.int32, device="cuda"), page)
    got = paged_attention_cuda(*args) if n_split is None else paged_attention_cuda(*args, n_split=n_split)
    want = paged_attention(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=1e-2)


def test_paged_attention_kernel_mixed_padding_rows():
    """A mixed SplitFuse batch inside one C = 256 chunk: a prefill row, a
    130-row continuation, a decode row (its rep heads in one row tile, the
    rest of its chunk padding) and a padding row; rows at c >= chunk_len
    are zeros, whole or split."""
    args = _case(256, torch.bfloat16, d=128, clens=[256, 130, 1, 0])
    want = paged_attention(*args).float()
    for n_split in (1, 2):
        got = paged_attention_cuda(*args, n_split=n_split)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want, atol=1e-2, rtol=1e-2)
        assert bool((got[1, 130:] == 0).all()) and bool((got[2, 1:] == 0).all()) and bool((got[3] == 0).all())


def test_paged_attention_merge_kernel_matches_plain():
    """The merge kernel against ``merge_partials_plain`` on the partials the
    first kernel wrote (empty splits included: the decode-depth row has 41
    keys of a 4-split table), and those partials against the plain ones."""
    q, pages, bt, sp, cl, page = _case(1, torch.bfloat16, d=128)
    m, l, o = paged_attention_partials_cuda(q, pages, bt, sp, cl, page, 4)
    pm, pl, po = paged_attention_partials_plain(q, pages, bt, sp, cl, page, 4)
    torch.cuda.synchronize()
    assert bool(((m == -np.inf) == (pm == -np.inf)).all())
    live = pm != -np.inf
    torch.testing.assert_close(m[live], pm[live], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(l[live], pl[live], atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(o[live], po[live], atol=1e-2, rtol=1e-2)
    got = merge_partials_cuda(m, l, o, cl)
    want = merge_partials_plain(m, l, o, cl)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want, atol=1e-2, rtol=1e-2)


def test_paged_attention_mma_fragments():
    """One m16n8k16 product through the kernel's ldmatrix / ldmatrix.trans
    fragment loaders against torch.matmul in float32 (exact sums of bf16
    products)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    a, k, v = (torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16) for s in ((16, 16), (8, 16), (16, 8)))
    c1, c2 = mma_probe_cuda(a, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(c1, a.float() @ k.float().t(), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(c2, a.float() @ v.float(), atol=1e-5, rtol=1e-5)


def test_paged_attention_kernel_rejects_what_it_does_not_take():
    q, pages, bt, sp, cl, page = _case(1, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        paged_attention_cuda(q[..., :32].contiguous(), pages[..., :32].contiguous(), bt, sp, cl, page)
    with pytest.raises(ValueError, match="int32"):
        paged_attention_cuda(q, pages, bt.long(), sp, cl, page)
    with pytest.raises(ValueError, match="dtype"):
        paged_attention_cuda(q, pages.to(torch.bfloat16), bt, sp, cl, page)


def test_engine_kernel_path_matches_plain_path():
    """A small Llama engine on the card: greedy streams of the kernel path
    and the plain path are identical in float32, and the kernel launched
    once per layer per forward."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(PRESETS["tiny"], hidden_size=256, intermediate_size=512, dtype=torch.float32,
                              param_dtype=torch.float32)                    # head dim 64
    model = LlamaForCausalLMWithCache(cfg, page_size=16, device="cuda")
    state = init_weights_(model, torch.Generator(device="cuda").manual_seed(0)).state_dict()
    econf = RaggedInferenceEngineConfig(kv=PagedKVConfig(num_pages=64, page_size=16, max_pages_per_seq=8),
                                        scheduler=SchedulerConfig(token_budget=64, max_seqs=8, prefill_chunk=16,
                                                                  decode_bucket=4), kv_dtype=torch.float32)
    prompts = [[5, 9, 2, 7, 1], list(range(1, 40)), [3, 3, 8]]
    streams = {}
    for impl in ("flash", "reference"):
        eng = build_engine(dataclasses.replace(cfg, attention_impl=impl), state, econf, device="cuda")
        before = paged_attention_cuda.launches
        streams[impl] = eng.generate(prompts, max_new_tokens=12)
        launched = paged_attention_cuda.launches - before
        assert launched == (cfg.num_hidden_layers * eng.forward_calls if impl == "flash" else 0)
    assert streams["flash"] == streams["reference"]


# ---------------------------------------------------------------- K1, K2a, K2b

# |kernel − plain| <= a·|plain| + b·rms(vector) + f·rms(tensor) for o, dq,
# dk, dv (the vector: one head's D values at one row or key), and
# stat·(|plain| + rms) for the float32 lse and delta; chip_smoke.py phase 5
# states where each term comes from
FLASH_TOL = {torch.bfloat16: dict(a=2**-7, b=2**-6, f=2**-8, stat=2**-14),
             torch.float32: dict(a=2**-16, b=2**-14, f=2**-14, stat=2**-16)}


def _within(got, want, tol, vector=True) -> bool:
    got, want = got.float(), want.float()
    rms = want.square().mean().sqrt()
    if vector:
        limit = tol["a"] * want.abs() + tol["b"] * want.square().mean(-1, keepdim=True).sqrt() + tol["f"] * rms
    else:
        limit = tol["stat"] * (want.abs() + rms)
    return bool(((got - want).abs() <= limit).all())


FLASH_CASES = [
    pytest.param(True, 4, 4, 64, 128, 128, 0, id="causal-mha-d64"),
    pytest.param(False, 4, 4, 64, 128, 128, 0, id="full-mha-d64"),
    pytest.param(True, 8, 2, 128, 128, 128, 0, id="causal-gqa-d128"),
    pytest.param(True, 6, 2, 64, 256, 384, 128, id="q-offset-rep3"),
    pytest.param(True, 4, 2, 128, 128, 256, 0, id="sk-gt-sq"),
    pytest.param(True, 16, 2, 128, 256, 256, 0, id="causal-rep8-d128"),
    pytest.param(True, 4, 2, 64, 192, 256, 64, id="tail-sq192-q-offset"),
    pytest.param(True, 6, 2, 128, 256, 256, 0, id="causal-rep3-d128"),
]


def _flash_inputs(h, hk, d, sq, sk, dtype, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda().to(dtype)

    return t(2, sq, h, d), t(2, sk, hk, d), t(2, sk, hk, d), t(2, sq, h, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal,h,hk,d,sq,sk,q_offset", FLASH_CASES)
def test_flash_kernels_match_plain(dtype, causal, h, hk, d, sq, sk, q_offset):
    """K1, K2a (dq and delta) and K2b against their plain versions on the
    same CUDA tensors, element by element against each row's or key's own
    scale (``FLASH_TOL``)."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    q, k, v, do = _flash_inputs(h, hk, d, sq, sk, dtype)
    tol = FLASH_TOL[dtype]
    before = (fa.flash_fwd_cuda.launches, fa.flash_dq_cuda.launches, fa.flash_dkv_cuda.launches)
    o, lse = fa.flash_fwd_cuda(q, k, v, causal, q_offset)
    want_o, want_lse = fa.flash_fwd_plain(q, k, v, causal, q_offset)
    assert _within(o, want_o, tol) and _within(lse, want_lse, tol, vector=False)
    dq, delta = fa.flash_dq_cuda(q, k, v, o, lse, do, causal, q_offset)
    dk, dv = fa.flash_dkv_cuda(q, k, v, do, lse, delta, causal, q_offset)
    want = fa.flash_bwd_plain(q, k, v, o, lse, do, causal, q_offset)
    torch.cuda.synchronize()
    assert _within(delta, fa.flash_delta_plain(o, do), tol, vector=False)
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert _within(g, w, tol), name
    # the check rejects a K2b that leaves out the last kv tile it must write
    t1 = min(sk, sq + q_offset) // 64 * 64
    dk_faulty = dk.clone()
    dk_faulty[:, t1 - 64:t1] = 0
    assert not _within(dk_faulty, want[1], tol)
    if causal and sk > sq + q_offset:
        assert not dk[:, sq + q_offset:].any() and not dv[:, sq + q_offset:].any()
    after = (fa.flash_fwd_cuda.launches, fa.flash_dq_cuda.launches, fa.flash_dkv_cuda.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]


@pytest.mark.parametrize("kernel", ["dkv", "dq"])
@pytest.mark.parametrize("causal,h,hk,d,sq,sk,q_offset", [FLASH_CASES[2], FLASH_CASES[3], FLASH_CASES[-3],
                                                          FLASH_CASES[-2], FLASH_CASES[-1]])
def test_flash_dkv_kernel_is_deterministic(kernel, causal, h, hk, d, sq, sk, q_offset):
    """K2b (``dkv``) sums over the query heads and q tiles inside one block,
    K2a (``dq``) over the kv tiles of its rows, each in a fixed order (no
    atomics): two launches give bit-identical dk and dv, or dq and delta."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    q, k, v, do = _flash_inputs(h, hk, d, sq, sk, torch.bfloat16, seed=3)
    o, lse = fa.flash_fwd_cuda(q, k, v, causal, q_offset)
    _, delta = fa.flash_dq_cuda(q, k, v, o, lse, do, causal, q_offset)
    if kernel == "dq":
        first = fa.flash_dq_cuda(q, k, v, o, lse, do, causal, q_offset)
        second = fa.flash_dq_cuda(q, k, v, o, lse, do, causal, q_offset)
    else:
        first = fa.flash_dkv_cuda(q, k, v, do, lse, delta, causal, q_offset)
        second = fa.flash_dkv_cuda(q, k, v, do, lse, delta, causal, q_offset)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_flash_kernels_reject_what_they_do_not_take():
    from deepspeed_tpu_torch.ops import flash_attention as fa
    q, k, v, _ = _flash_inputs(4, 2, 64, 128, 128, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q[..., :32].contiguous(), k[..., :32].contiguous(), v[..., :32].contiguous())
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_fwd_cuda(q, k.to(torch.bfloat16), v, True, 0)


def test_flash_training_step_launches_each_kernel_once_per_layer():
    """A small Llama trained under ``flash_saveable`` on the card: K1, K2a
    and K2b each launch once per layer per micro-step (no K1 relaunch in
    the recompute), and the losses match the chunked path in float32."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.ops import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(PRESETS["tiny"], hidden_size=256, intermediate_size=512, vocab_size=512,
                              num_hidden_layers=3, dtype=torch.float32, remat=True, remat_policy="flash_saveable")
    ids = np.random.default_rng(1).integers(0, 512, (4, 256)).astype(np.int32)
    losses = {}
    for impl in ("flash", "chunked"):
        model = init_weights_(LlamaForCausalLM(dataclasses.replace(cfg, attention_impl=impl), device="cuda"),
                              torch.Generator(device="cuda").manual_seed(0))
        eng = ds.initialize(model=model, config={"train_batch_size": 4, "gradient_accumulation_steps": 2,
                                                 "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}})[0]
        fa.flash_fwd_cuda.launches = fa.flash_dq_cuda.launches = fa.flash_dkv_cuda.launches = 0
        losses[impl] = [float(eng.train_batch(batch={"input_ids": ids, "labels": ids})) for _ in range(2)]
        launches = (fa.flash_fwd_cuda.launches, fa.flash_dq_cuda.launches, fa.flash_dkv_cuda.launches)
        n = cfg.num_hidden_layers * 2 * 2 if impl == "flash" else 0
        assert launches == (n, n, n), (impl, launches)
    np.testing.assert_allclose(losses["flash"], losses["chunked"], rtol=1e-4)


# ---------------------------------------------------------------- K6a, K6b, K6c


def _sparse_layout(h, nb, seed):
    """Random blocks (density ~0.3) with head 0 holding a global row and
    column (block 0) and head 1 an empty q row (1) and an empty kv column
    (2); the diagonal stays admitted elsewhere so causal rows see a key."""
    rng = np.random.default_rng(seed)
    layout = (rng.random((h, nb, nb)) < 0.3).astype(np.int64)
    layout[:, np.arange(nb), np.arange(nb)] = 1
    layout[0, 0, :] = layout[0, :, 0] = 1
    layout[1, 1, :] = 0
    layout[1, :, 2] = 0
    return layout


def _fixed_layout(h, nb, block):
    """DeepSpeed's fixed layout, bidirectional windows of 4 blocks with one
    global column each: the 4 rows of a window, its 3 plain columns and the
    global columns admit identical lists, so the bf16 K6b and K6c run groups
    of 2–4 blocks in one CTA."""
    from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig
    return FixedSparsityConfig(h, block, num_local_blocks=4, num_global_blocks=1).make_layout(nb * block)


SPARSE_CASES = [
    pytest.param(16, 64, False, False, "random", id="b16-d64"),
    pytest.param(16, 64, True, True, "random", id="b16-d64-causal-kpm"),
    pytest.param(32, 128, True, False, "random", id="b32-d128-causal"),
    pytest.param(64, 64, False, True, "random", id="b64-d64-kpm"),
    pytest.param(128, 128, True, False, "random", id="b128-d128-causal"),
    pytest.param(16, 64, True, True, "fixed", id="b16-d64-causal-kpm-fixed"),
    pytest.param(32, 128, True, True, "fixed", id="b32-d128-causal-kpm-fixed"),
]


def _sparse_inputs(block, d, use_kpm, kind, dtype):
    """B 2, H 3, S 512: the layout, its tables on the card, q, k, v, do and
    the key padding mask (or None)."""
    from deepspeed_tpu_torch.ops.sparse_attention import kernel as sk
    b, h, s = 2, 3, 512
    if kind == "fixed":
        layout = _fixed_layout(h, s // block, block)
    else:
        layout = _sparse_layout(h, s // block, seed=block + d)
    tables = sk.build_tables(layout, block, "cuda")
    rng = np.random.default_rng(block)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(b, h, s, d)).astype(np.float32)).cuda().to(dtype)
                   for _ in range(4))
    kpm = None
    if use_kpm:
        kpm = torch.from_numpy(rng.random((b, s)) > 0.2).cuda()
    return layout, tables, q, k, v, do, kpm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("block,d,causal,use_kpm,kind", SPARSE_CASES)
def test_sparse_kernels_match_plain(dtype, block, d, causal, use_kpm, kind):
    """K6a (o, lse), K6b (dq, delta) and K6c (dk, dv) against their plain
    versions on the same CUDA tensors (``FLASH_TOL``).  Random layout: the
    empty q row emits zeros with lse 3e38, the empty kv column gets zero dk
    and dv, and the check rejects a K6c that loses the global column's dk.
    Fixed layout: the groups hold 2–4 blocks, and the check rejects a K6c
    that loses the dk of one member of a group."""
    from deepspeed_tpu_torch.ops.sparse_attention import kernel as sk
    layout, tables, q, k, v, do, kpm = _sparse_inputs(block, d, use_kpm, kind, dtype)
    args = (tables, block, causal, None, kpm)
    tol = FLASH_TOL[dtype]
    before = (sk.sparse_attn_fwd_cuda.launches, sk.sparse_attn_dq_cuda.launches, sk.sparse_attn_dkv_cuda.launches)
    o, lse = sk.sparse_attn_fwd_cuda(q, k, v, *args)
    want_o, want_lse = sk.sparse_attn_fwd_plain(q, k, v, *args)
    dq, delta = sk.sparse_attn_dq_cuda(q, k, v, o, lse, do, *args)
    dk, dv = sk.sparse_attn_dkv_cuda(q, k, v, do, lse, delta, *args)
    want = sk.sparse_attn_bwd_plain(q, k, v, o, lse, do, *args)
    torch.cuda.synchronize()
    live = want_lse != sk.EMPTY_ROW_LSE    # rows that attend to a key; the others must read exactly 3e38
    assert _within(o, want_o, tol) and _within(lse[live], want_lse[live], tol, vector=False)
    assert bool((lse[~live] == sk.EMPTY_ROW_LSE).all())
    assert _within(delta, sk.sparse_attn_delta_plain(o, do), tol, vector=False)
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert _within(g, w, tol), name
    dk_faulty = dk.clone()
    if kind == "random":
        rows = slice(block, 2 * block)
        assert not o[:, 1, rows].any() and bool((lse[:, 1, rows] == sk.EMPTY_ROW_LSE).all())
        cols = slice(2 * block, 3 * block)
        assert not dk[:, 1, cols].any() and not dv[:, 1, cols].any()
        dk_faulty[:, 0, :block] = 0   # the global column of head 0
    else:
        widths = [int((g >= 0).sum(1).max()) for g in (tables.row_groups, tables.col_groups)]
        assert widths == [64 // block] * 2, widths
        groups = tables.col_groups.cpu().numpy()
        hb = int(groups[(groups >= 0).sum(1) >= 2][0, 1])   # the second member of a column group
        h, blk = divmod(hb, layout.shape[1])
        dk_faulty[:, h, blk * block:(blk + 1) * block] = 0
    assert not _within(dk_faulty, want[1], tol)
    after = (sk.sparse_attn_fwd_cuda.launches, sk.sparse_attn_dq_cuda.launches, sk.sparse_attn_dkv_cuda.launches)
    assert [a - b_ for a, b_ in zip(after, before)] == [1, 1, 1]


@pytest.mark.parametrize("block,d,causal,use_kpm,kind", SPARSE_CASES)
def test_sparse_backward_kernels_are_deterministic(block, d, causal, use_kpm, kind):
    """The bf16 K6b sums over its list, and K6c over the rows of its column
    group, in a fixed order inside one CTA (no atomics): two launches give
    bit-identical dq and delta, and dk and dv."""
    from deepspeed_tpu_torch.ops.sparse_attention import kernel as sk
    _, tables, q, k, v, do, kpm = _sparse_inputs(block, d, use_kpm, kind, torch.bfloat16)
    args = (tables, block, causal, None, kpm)
    o, lse = sk.sparse_attn_fwd_cuda(q, k, v, *args)
    first = sk.sparse_attn_dq_cuda(q, k, v, o, lse, do, *args)
    second = sk.sparse_attn_dq_cuda(q, k, v, o, lse, do, *args)
    delta = first[1]
    first += sk.sparse_attn_dkv_cuda(q, k, v, do, lse, delta, *args)
    second += sk.sparse_attn_dkv_cuda(q, k, v, do, lse, delta, *args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b_) for a, b_ in zip(first, second))


@pytest.mark.parametrize("block,d", [(16, 64), (32, 128), (64, 64), (128, 128)])
def test_sparse_fwd_kernel_rows_with_no_visible_key(block, d):
    """K6a on rows that see no key: head 1's row block 1 admits no block, and
    kpm masks every key of batch row 1 and, in batch row 0, the keys of
    blocks 2..5, every key that the local window (the block and the one
    before it, causal) admits to blocks 3..5.  Those rows read exactly 0 in
    o and 3e38 in lse; the others agree with the plain version in bf16."""
    from deepspeed_tpu_torch.ops.sparse_attention import kernel as sk
    b, h, s = 2, 3, 8 * block
    layout = np.zeros((h, 8, 8), np.int64)
    layout[:, np.arange(8), np.arange(8)] = 1
    layout[:, np.arange(1, 8), np.arange(7)] = 1
    layout[1, 1, :] = 0
    tables = sk.build_tables(layout, block, "cuda")
    rng = np.random.default_rng(block + d)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, h, s, d)).astype(np.float32)).cuda().to(torch.bfloat16)
               for _ in range(3))
    kpm = torch.ones((b, s), dtype=torch.bool, device="cuda")
    kpm[1] = False
    kpm[0, 2 * block:6 * block] = False
    o, lse = sk.sparse_attn_fwd_cuda(q, k, v, tables, block, True, None, kpm)
    want_o, want_lse = sk.sparse_attn_fwd_plain(q, k, v, tables, block, True, None, kpm)
    torch.cuda.synchronize()
    empty = torch.zeros((b, h, s), dtype=torch.bool, device="cuda")
    empty[1] = True
    empty[0, :, 3 * block:6 * block] = True
    empty[:, 1, block:2 * block] = True
    assert torch.equal(want_lse == sk.EMPTY_ROW_LSE, empty)
    assert not o[empty].any() and bool((lse[empty] == sk.EMPTY_ROW_LSE).all())
    tol = FLASH_TOL[torch.bfloat16]
    assert _within(o, want_o, tol) and _within(lse[~empty], want_lse[~empty], tol, vector=False)


def test_sparse_kernels_reject_what_they_do_not_take():
    from deepspeed_tpu_torch.ops.sparse_attention import kernel as sk
    layout = _sparse_layout(2, 8, seed=0)
    q = torch.randn((1, 2, 64, 64), device="cuda")
    with pytest.raises(ValueError, match="block"):
        sk.sparse_attn_fwd_cuda(q, q, q, sk.build_tables(layout, 8, "cuda"), 8)
    tables = sk.build_tables(_sparse_layout(2, 4, seed=0), 16, "cuda")
    with pytest.raises(ValueError, match="head dim"):
        sk.sparse_attn_fwd_cuda(q[..., :32].contiguous(), q[..., :32].contiguous(), q[..., :32].contiguous(),
                                tables, 16)
    with pytest.raises(ValueError, match="dtype"):
        sk.sparse_attn_fwd_cuda(q.half(), q.half(), q.half(), tables, 16)
    with pytest.raises(ValueError, match="int32"):
        sk.sparse_attn_fwd_cuda(q, q, q, sk.build_tables(_sparse_layout(2, 4, seed=0), 16, "cpu"), 16)


def test_sparse_self_attention_on_the_card_matches_the_cpu_path():
    """``SparseSelfAttention`` forward and backward on CUDA tensors launch
    K6a, K6b and K6c once each and agree with the same op on CPU tensors
    (the plain versions) in float32."""
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    from deepspeed_tpu_torch.ops.sparse_attention import kernel as sk
    cfg = sa.BigBirdSparsityConfig(num_heads=4, block=16, different_layout_per_head=True)
    ssa = sa.SparseSelfAttention(cfg)
    rng = np.random.default_rng(3)
    x = [rng.normal(size=(2, 4, 256, 64)).astype(np.float32) for _ in range(4)]
    results = {}
    for dev in ("cuda", "cpu"):
        q, k, v = (torch.from_numpy(a).to(dev).requires_grad_() for a in x[:3])
        sk.sparse_attn_fwd_cuda.launches = sk.sparse_attn_dq_cuda.launches = sk.sparse_attn_dkv_cuda.launches = 0
        out = ssa(q, k, v)
        out.backward(torch.from_numpy(x[3]).to(dev))
        launches = (sk.sparse_attn_fwd_cuda.launches, sk.sparse_attn_dq_cuda.launches, sk.sparse_attn_dkv_cuda.launches)
        assert launches == ((1, 1, 1) if dev == "cuda" else (0, 0, 0))
        results[dev] = [t.detach().cpu() for t in (out, q.grad, k.grad, v.grad)]
    for a, b_ in zip(results["cuda"], results["cpu"]):
        torch.testing.assert_close(a, b_, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------- K4a, K4b, K5a, K5b


def _quant_input(block, nb, dtype, seed):
    """Blocks at scales 1e-6..1e3, an all-zero block, and a block of ±(k + ½)
    with absmax 7: int4's scale is exactly 1 there, so x/scale lands on
    ties (round half to even)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    scale = 10.0**(torch.rand((nb, 1), generator=gen, device="cuda") * 9 - 6)
    x = torch.randn((nb, block), generator=gen, device="cuda") * scale
    x[1] = 0
    ties = (torch.arange(block, device="cuda") % 7 + 0.5) * (1 - 2 * (torch.arange(block, device="cuda") % 2))
    ties[0] = 7.0
    x[2] = ties
    return x.reshape(-1).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("block,nb", [(256, 4096), (256, 1001), (64, 37), (1024, 9), (100, 13)])
def test_quant_kernels_match_plain(dtype, block, nb):
    """K4a/K4b and K5a/K5b against their plain versions on the same CUDA
    tensors: codes, scales and dequantized values identical (both divide
    with a correctly rounded divide, round half to even and multiply once)."""
    from deepspeed_tpu_torch.ops import quant_kernels as qk
    from deepspeed_tpu_torch.ops import quantizer as plain
    x = _quant_input(block, nb, dtype, seed=block + nb)
    kernels = (qk.quantize_int8_cuda, qk.dequantize_int8_cuda, qk.quantize_int4_cuda, qk.dequantize_int4_cuda)
    before = [k.launches for k in kernels]
    for quant, dequant, pq, pd in ((qk.quantize_int8_cuda, qk.dequantize_int8_cuda, plain.quantize_int8,
                                    plain.dequantize_int8),
                                   (qk.quantize_int4_cuda, qk.dequantize_int4_cuda, plain.quantize_int4,
                                    plain.dequantize_int4)):
        if quant is qk.quantize_int4_cuda and block % 2:
            continue
        q, s = quant(x, block)
        want_q, want_s = pq(x, block)
        out = dequant(q, s, (2, nb * block // 2) if nb % 2 == 0 else (nb * block, ))
        torch.cuda.synchronize()
        assert torch.equal(q, want_q) and torch.equal(s, want_s)
        assert torch.equal(out, pd(q, s, out.shape))
        # the zero block: scale 1 and code 0, which int4 stores as 8 in each nibble
        assert float(s[1]) == 1.0 and bool((q[1] == (0 if quant is qk.quantize_int8_cuda else 0x88)).all())
    launched = [k.launches - b for k, b in zip(kernels, before)]
    assert launched == ([1, 1, 1, 1] if block % 2 == 0 else [1, 1, 0, 0])


def test_quant_kernels_reject_what_they_do_not_take():
    from deepspeed_tpu_torch.ops import quant_kernels as qk
    x = torch.zeros(4096, device="cuda")
    with pytest.raises(ValueError, match="block 2048"):
        qk.quantize_int8_cuda(x, 2048)
    with pytest.raises(ValueError, match="even"):
        qk.quantize_int4_cuda(x[:4095], 63)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        qk.quantize_int8_cuda(x.half(), 256)
    q, s = qk.quantize_int8_cuda(x, 256)
    with pytest.raises(ValueError, match="codes and float32 scales"):
        qk.dequantize_int8_cuda(q.view(torch.uint8), s, (4096, ))


#: a mixed table: sizes that are and are not multiples of the block, and
#: cuts (1001, 333) that leave the next tensors' starts off 16-byte alignment
GROUPED_NUMELS = (768, 1000, 4096, 65536, 300, 1001, 333, 24576)


def _grouped_input(dtype, seed, lead=0):
    """The tensors of GROUPED_NUMELS back to back (the fifth all zero), as a
    view that starts ``lead`` elements into its storage."""
    total = sum(GROUPED_NUMELS)
    x = _quant_input(256, -(-(total + lead) // 256), torch.float32, seed)[:total + lead].clone()
    start = lead + sum(GROUPED_NUMELS[:4])
    x[start:start + GROUPED_NUMELS[4]] = 0
    return x.to(dtype)[lead:]


@pytest.mark.parametrize("lead", [0, 1], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("block", [256, 96])
@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_grouped_quant_kernels_match_plain(dtype, world, block, lead):
    """The grouped K4a/K4b on a mixed table against their plain versions on
    the same CUDA tensors, bit for bit: the rank-major codes and scales, the
    values back in tensor order (through bf16 where the input is bf16), and
    the identity layout of the received copies.  Block 96 takes the generic
    kernels; a misaligned input takes the scalar loads."""
    from deepspeed_tpu_torch.ops import quant_kernels as qk
    from deepspeed_tpu_torch.ops import quantizer as plain
    x = _grouped_input(dtype, seed=world * block + lead, lead=lead)
    table = qk.SegmentTable(GROUPED_NUMELS, world, block)
    before = [k.launches for k in (qk.quantize_int8_cuda, qk.dequantize_int8_cuda)]
    q, s = qk.quantize_int8_cuda(x, block, table)
    through = dtype if dtype == torch.bfloat16 else None
    out = qk.dequantize_int8_cuda(q, s, (table.total, ), table, through)
    received = qk.dequantize_int8_cuda(q, s, (world, table.chunk * block))
    torch.cuda.synchronize()
    want_q, want_s = plain.quantize_int8_grouped(x, table)
    assert torch.equal(q, want_q) and torch.equal(s, want_s)
    assert torch.equal(out, plain.dequantize_int8_grouped(want_q, want_s, table, through))
    assert torch.equal(received, plain.dequantize_int8(want_q, want_s, received.shape))
    zero = slice(table.chunk_offsets[4], table.chunk_offsets[4] + table.chunk_rows[4])
    assert bool((s.view(world, -1)[:, zero] == 1.0).all())
    assert [k.launches - b for k, b in zip((qk.quantize_int8_cuda, qk.dequantize_int8_cuda), before)] == [1, 2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_one_segment_launch_equals_the_single_tensor_call(dtype):
    """A one-tensor table at world 1 is the identity layout: the grouped
    launch gives the single-tensor call's codes, scales and values."""
    from deepspeed_tpu_torch.ops import quant_kernels as qk
    from deepspeed_tpu_torch.ops import quantizer as plain
    x = _quant_input(256, 4096, dtype, seed=7)
    table = qk.SegmentTable([x.numel()], 1)
    q, s = qk.quantize_int8_cuda(x, 256, table)
    q1, s1 = qk.quantize_int8_cuda(x, 256)
    out = qk.dequantize_int8_cuda(q, s, (x.numel(), ), table)
    out1 = qk.dequantize_int8_cuda(q1, s1, (x.numel(), ))
    torch.cuda.synchronize()
    want_q, want_s = plain.quantize_int8(x, 256)
    assert torch.equal(q, q1) and torch.equal(s, s1) and torch.equal(q, want_q) and torch.equal(s, want_s)
    assert torch.equal(out, out1) and torch.equal(out, plain.dequantize_int8(want_q, want_s, (x.numel(), )))


def test_k4b_takes_codes_that_start_off_a_word_boundary():
    """Codes viewed one byte into their storage (valid, contiguous int8)
    dequantize as the aligned ones do, in the grouped and the identity
    layout: the kernel takes byte loads there instead of 4-byte words."""
    from deepspeed_tpu_torch.ops import quant_kernels as qk
    from deepspeed_tpu_torch.ops import quantizer as plain
    table = qk.SegmentTable(GROUPED_NUMELS, 2)
    q, s = qk.quantize_int8_cuda(_grouped_input(torch.float32, seed=11), 256, table)
    odd = torch.empty(q.numel() + 1, dtype=torch.int8, device=q.device)[1:].view(q.shape)
    odd.copy_(q)
    assert odd.data_ptr() % 4 == 1 and odd.is_contiguous()
    out = qk.dequantize_int8_cuda(odd, s, (table.total, ), table)
    received = qk.dequantize_int8_cuda(odd, s, (2, table.chunk * 256))
    torch.cuda.synchronize()
    assert torch.equal(out, plain.dequantize_int8_grouped(q, s, table))
    assert torch.equal(received, plain.dequantize_int8(q, s, received.shape))


def test_grouped_quant_kernels_reject_what_they_do_not_take():
    from deepspeed_tpu_torch.ops import quant_kernels as qk
    table = qk.SegmentTable(GROUPED_NUMELS, 2)
    x = _grouped_input(torch.float32, seed=3)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        qk.quantize_int8_cuda(x.half(), 256, table)
    with pytest.raises(ValueError, match="flat"):
        qk.quantize_int8_cuda(x[:-1], 256, table)
    with pytest.raises(ValueError, match="differs from the table"):
        qk.quantize_int8_cuda(x, 128, table)
    with pytest.raises(ValueError, match="contiguous"):
        qk.quantize_int8_cuda(torch.stack([x, x], 1)[:, 0], 256, table)
    q, s = qk.quantize_int8_cuda(x, 256, table)
    with pytest.raises(ValueError, match="not the table's"):
        qk.dequantize_int8_cuda(q[:-2], s[:-2], (table.total, ), table)
    with pytest.raises(ValueError, match="does not hold"):
        qk.dequantize_int8_cuda(q, s, (table.total - 1, ), table)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        qk.dequantize_int8_cuda(q, s, (table.total, ), table, through=torch.float16)
    with pytest.raises(ValueError, match="codes and float32 scales"):
        qk.dequantize_int8_cuda(q.view(torch.uint8), s, (table.total, ), table)
