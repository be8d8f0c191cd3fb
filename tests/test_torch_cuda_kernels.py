"""The PyTorch port's CUDA kernels on the card.  Every test is marked
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
from deepspeed_tpu_torch.models.llama import PRESETS, init_weights_
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
