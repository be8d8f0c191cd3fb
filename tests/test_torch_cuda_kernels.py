"""The PyTorch port's CUDA kernels on the card: K3 (paged attention) and
K1/K2a/K2b (flash attention forward and backward).  Every test is marked
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
from deepspeed_tpu_torch.ops.paged_attention import paged_attention_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _needs_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _case(c, dtype, d=64, h=8, n_kv=2, page=16, seed=0):
    """A prefill row, a continuation row, a decode-depth row and a padding
    row (chunk_len 0, all-null block table) over shuffled physical pages."""
    rng = np.random.default_rng(seed)
    start = np.array([0, 5, 40, 0], np.int32)
    clens = np.array([c, max(c - 1, 1), 1, 0], np.int32)
    max_pages = 4
    bt = np.zeros((4, max_pages), np.int32)
    phys = list(rng.permutation(np.arange(1, 13)))
    for i in range(3):
        n = -(-(int(start[i]) + c) // page)
        bt[i, :n] = phys[:n]
        phys = phys[n:]
    pages = torch.from_numpy(rng.normal(size=(13, page, 2, n_kv, d)).astype(np.float32)).cuda().to(dtype)
    q = torch.from_numpy(rng.normal(size=(4, c, h, d)).astype(np.float32)).cuda().to(dtype)
    return q, pages, torch.from_numpy(bt).cuda(), torch.from_numpy(start).cuda(), torch.from_numpy(clens).cuda(), page


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c", [1, 4])
def test_paged_attention_kernel_matches_plain(dtype, c):
    """K3 against its plain version on the same CUDA tensors.  Tolerance:
    float32 differs only in summation order; bf16 rounds p and the output
    at other points, a few ulps of 2^-8."""
    args = _case(c, dtype)
    before = paged_attention_cuda.launches
    got = paged_attention_cuda(*args)
    want = paged_attention(*args)
    torch.cuda.synchronize()
    assert paged_attention_cuda.launches == before + 1
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert bool((got[3] == 0).all())


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
