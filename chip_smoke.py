#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA GPU (Hopper: the kernels are built for sm_90a) and ``nvcc``;
builds every kernel from ``deepspeed_tpu_torch/csrc``, one ``nvcc`` per
source, all started together.  Phases:

  1. environment: card name and power limit, versions, kernel build time,
     and ptxas's registers of the bf16 K6b/K6c instantiations (a spill
     fails the run);
  2. K3 paged attention against its plain PyTorch version at the serving
     shapes of Llama-3-8B (H=32, n_kv=8, D=128, page 16, bf16): decode,
     decode with every context at 2000 keys (both split over the context),
     a prefill chunk, a mixed step with padding rows and null pages, and the
     speculative verify shape (8 rows of C = 5 at contexts 64-1024) —
     error, kernel / plain / library (SDPA) time and the roofline bound;
     float32 decode (the scalar kernel), forced empty splits, rep 1 at head
     dim 64, one tensor-core product against torch.matmul, the merge
     kernel against its plain version, faulty kernels the check must
     reject, and the decode time by split count;
  3. serving: ``build_engine`` → ``put`` / ``step`` on Llama-3-8B at full
     width and depth with seeded random weights, continuous batching of 8
     requests with SplitFuse chunking, fused decode and a prefix-cache hit,
     each step a replay of a CUDA graph captured at its key's first
     dispatch; asserts token counts, page accounting, that every layer of
     every forward launched K3 and that decode took its split route;
  4. path parity: the kernel path against the plain path — identical greedy
     streams in float32 (2 layers, full width), and close first-step logits
     in bf16 at full depth;
  5. K1/K2a/K2b flash attention against their plain versions at the
     training shapes of Llama-125M (B 24, S 1024, 12 heads of 64) and of
     Llama-3-8B (B 1, S 4096, 32/8 heads of 128), bf16 and f32, causal and
     full, with a query offset and with Sk > Sq — error, kernel / plain /
     library (SDPA forward, SDPA backward) time and the roofline bound;
     K2a and K2b launched twice on each case give bit-identical dq, delta,
     dk and dv; two bf16 GQA cases whose blocks hold rows that are not
     valid (rep 3, and an Sq tail with a query offset);
  6. training: ``initialize`` → ``train_batch`` on Llama-125M at the JAX
     package's bench configuration (B 24, S 1024, bf16, AdamW, ZeRO-2,
     remat ``flash_saveable``), full width and depth with seeded random
     weights — tokens/s, step time, MFU, peak memory, losses falling on a
     repeated batch, K1/K2a/K2b launches per step (one per layer each), and
     a profiled step;
  7. training parity, kernel path (``attention_impl="flash"``) against the
     plain path (``"chunked"``): 3 float32 AdamW steps at 125M width, and 3
     bf16 steps at Llama-3-8B width (2 layers, S 2048) held against a
     float32 run;
  8. K6a/K6b/K6c block-sparse attention against their plain versions at
     BERT-large's attention (B 4, 16 heads of 64, S 4096, block 16, bf16)
     for seven layouts (DeepSpeed's documented fixed example, fixed
     unidirectional, BigBird, BSLongformer, variable, local window, dense),
     with faulty kernels the check must reject, a key padding mask (and one
     that leaves rows with no visible key: o exactly 0, lse 3e38), float32
     at S 1024, head dim 128 at blocks 32, 64 and 128; kernel / plain /
     library (SDPA with the layout as a token mask) time and the roofline
     bound for the fixed example and BigBird, and a layout with global
     blocks against a local one of the same density (the straggler's
     share); the documented example's row and column groups (the CTAs of
     the bf16 K6b and K6c), K6b and K6c launched twice on every case with
     bit-identical dq, delta, dk and dv, and a K6c that loses one group
     member's dk among the faulty kernels;
  9. the sparse path through its entry points: ``DeepSpeedConfig`` with the
     documented ``sparse_attention`` block → ``make_sparsity_config`` →
     ``SparseSelfAttention`` forward and backward on CUDA tensors, three
     iterations — K6a/K6b/K6c launches per call, finite gradients, outputs
     against the plain versions, peak memory, and each kernel's device time
     inside the path (CUDA events around its launch);
 10. K4a/K4b/K5a/K5b block quantization against their plain versions at
     the qgZ wire's shapes (the 24,576,000-element embedding of Llama-125M
     in f32 and bf16, a padded norm weight, 1001 blocks), codes, scales and
     dequantized values identical, with two faulty kernels the check must
     reject; kernel / plain time and the bound; then the grouped K4a/K4b on
     one qgZ step's real table (the 111 gradients of Llama-125M at W 2, bf16
     input): the send buffer, the received copies, the shards and the
     gathered tensors identical to the plain versions, two faulty grouped
     kernels rejected, per-step device ms beside the per-step bound;
 11. data-parallel training through the entry points: two spawned ranks on
     the one card over gloo (NCCL takes one card per rank), each
     ``initialize`` → ``train_batch`` on Llama-125M at full width and depth
     with ``zero_quantized_gradients`` (12 of the 24 rows per rank) —
     K4a/K4b launches (2 each per step, the grouped exchange), 4 wire
     collectives per step, K1/K2 once per layer, step and wire time,
     tokens/s, peak memory, bit-identical ranks, the CommsLogger's bytes,
     one step's real gradients through the grouped exchange equal to the
     per-tensor route bit for bit, the codec's ms per step with host issue
     included on both routes; then LoCo (K4b 3 per step), a float32-wire
     control and the int4 collectives (K5a/K5b) against their plain
     versions;
 12. the serving stack above the engine (run after phase 4, on phase 3's
     weights): ``ServingEngine`` on a wall clock over ``build_engine`` with
     a ``TieredKVManager``, 16 open-loop requests (prompts 64-1024, two
     pairs sharing a 512-token prefix, 32-64 new tokens, two priority
     classes) into a device arena of ~40% of the mix's pages, so KV
     pressure preempts by demoting to the host tier — TTFT and TPOT p50/p99,
     goodput, decode tok/s, preemptions, demotions and promotions, staged
     bytes and the d2h/h2d GB/s of ``export_pages``/``import_pages``, wall
     and peak memory; every request done with its tokens, every promoted
     block re-exported equal to the bytes imported and among the demoted
     snapshots', pages and host tier accounted for, K3 launches == layers x
     forwards; then one request migrated out after 8 tokens and resubmitted
     with its snapshot, its tokens equal to the bare engine's;
 13. the step set as CUDA graphs, and speculative decoding (run after phase
     12, on phase 3's weights): ``warm_all`` captures the six keys of a
     spec engine (decode, the 256-token chunk, the fused rungs of 2, 4 and
     8 rounds, the verify of 5 positions), each key's replay against its
     eager step on a real packed batch (tokens and KV arena bit for bit),
     K3's kernels inside a profiled replay, the fused rung's wall ms per
     round and device busy share eager and as a graph on the same batch;
     phase 3's greedy mix plus two prompts that repeat a pattern served
     with and without speculation (verify rounds, acceptance, rollback
     pages, pages accounted); then float32 at phase 4's setting, where the
     spec and plain streams must be equal but for reported rounding ties.

Prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero, without that line, if
there is no GPU or any phase fails.
"""

import copy
import dataclasses
import gc
import hashlib
import json
import math
import re
import subprocess
import sys
import time
import traceback
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.accelerator import get_accelerator
from deepspeed_tpu_torch.inference.v2 import (PagedKVConfig, RaggedInferenceEngineConfig, SchedulerConfig,
                                              SpecConfig, build_engine)
from deepspeed_tpu_torch.models.llama import PRESETS, LlamaConfig, LlamaForCausalLM, init_weights_
from deepspeed_tpu_torch.models.llama_cache import LlamaForCausalLMWithCache
from deepspeed_tpu_torch.models.llama_cache import paged_attention as paged_attention_plain
from deepspeed_tpu_torch.ops.op_builder import KERNEL_SOURCES, build_kernel
from deepspeed_tpu_torch.ops.flash_attention import (flash_bwd_plain, flash_delta_plain, flash_dkv_cuda,
                                                     flash_dq_cuda, flash_fwd_cuda, flash_fwd_plain)
from deepspeed_tpu_torch.ops.paged_attention import (choose_n_split, merge_partials_cuda, merge_partials_plain,
                                                     mma_probe_cuda, paged_attention_cuda,
                                                     paged_attention_partials_cuda)
from deepspeed_tpu_torch.ops.quant_kernels import (SegmentTable, dequantize_int4_cuda, dequantize_int8_cuda,
                                                   quantize_int4_cuda, quantize_int8_cuda)
from deepspeed_tpu_torch.ops.quantizer import dequantize_int4 as dequantize_int4_plain
from deepspeed_tpu_torch.ops.quantizer import dequantize_int8 as dequantize_int8_plain
from deepspeed_tpu_torch.ops.quantizer import dequantize_int8_grouped as dequantize_int8_grouped_plain
from deepspeed_tpu_torch.ops.quantizer import quantize_int4 as quantize_int4_plain
from deepspeed_tpu_torch.ops.quantizer import quantize_int8 as quantize_int8_plain
from deepspeed_tpu_torch.ops.quantizer import quantize_int8_grouped as quantize_int8_grouped_plain
from deepspeed_tpu_torch.ops.sparse_attention import (BigBirdSparsityConfig, BSLongformerSparsityConfig,
                                                      DenseSparsityConfig, FixedSparsityConfig,
                                                      LocalSlidingWindowSparsityConfig, SparseSelfAttention,
                                                      VariableSparsityConfig, extend_position_embedding,
                                                      make_sparsity_config)
from deepspeed_tpu_torch.ops.sparse_attention.kernel import (EMPTY_ROW_LSE, build_tables, sparse_attn_bwd_plain,
                                                             sparse_attn_delta_plain, sparse_attn_dkv_cuda,
                                                             sparse_attn_dq_cuda, sparse_attn_fwd_cuda,
                                                             sparse_attn_fwd_plain)
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.serving import RequestState, ServingEngine, WallClock
from deepspeed_tpu_torch.serving.kvtier import TierConfig, TieredKVManager

# published H100 SXM peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# H=32 query heads over n_kv=8 kv heads of D=128, as Llama-3-8B serves them
H, N_KV, D, PAGE = 32, 8, 128, 16
MAX_PAGES = 128
# |kernel - plain| <= ATOL + RTOL·|plain|.  bf16: both versions round p to
# bf16 (the plain one after normalising, the kernel before) and round the
# output to bf16, one ulp of which is 2^-8 relative, so a few ulps relative
# plus 1e-2 absolute for small outputs.  float32: only the summation order
# and exp differ.
TOLERANCE = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (1e-4, 1e-4)}
LAUNCH_COUNTERS = (paged_attention_cuda, flash_fwd_cuda, flash_dq_cuda, flash_dkv_cuda, sparse_attn_fwd_cuda,
                   sparse_attn_dq_cuda, sparse_attn_dkv_cuda, quantize_int8_cuda, dequantize_int8_cuda,
                   quantize_int4_cuda, dequantize_int4_cuda)


def reset_launch_counts() -> None:
    """Every kernel's launch count to 0: done just before each path is driven."""
    for fn in LAUNCH_COUNTERS:
        fn.launches = 0
    paged_attention_cuda.split_calls = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 1


def phase_environment() -> dict:
    smi = card()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t_all = time.perf_counter()

    def build(name):
        t0 = time.perf_counter()
        return build_kernel(name), time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(KERNEL_SOURCES)) as pool:   # one nvcc per source, all at once
        built = dict(zip(KERNEL_SOURCES, pool.map(build, KERNEL_SOURCES)))
    for name, (output, seconds) in built.items():
        log(f"  {name}: nvcc {seconds:.2f} s" + ("" if output else " (already built)"))
        for line in output.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"    {line.strip()}")
    log(f"kernels built in {time.perf_counter() - t_all:.2f} s")
    regs = ptxas_report(built["sparse_attention"][0], ("sparse_dq_kernel_tc", "sparse_dkv_kernel_tc"))
    log("  sparse_dq_kernel_tc / sparse_dkv_kernel_tc (D, CTA rows): " + json.dumps(regs))
    spills = {k: r for k, r in regs.items() if r["spill_bytes"]}
    if spills:
        raise AssertionError(f"ptxas spills in the bf16 K6b/K6c: {spills}")
    return {"card": smi, "sparse_bwd_registers": regs}


def ptxas_report(output: str, names) -> dict:
    """``name D=.. ROWS=..`` → registers and spill bytes of each instantiation
    of the kernels ``names`` (``template <int D, int ROWS>``), from nvcc's
    ``-Xptxas -v`` output; empty when the library was already built."""
    out, key = {}, None
    for line in output.splitlines():
        if "Compiling entry" in line or "Function properties for" in line:
            key = None
            m = re.search(r"(" + "|".join(names) + r")ILi(\d+)ELi(\d+)E", line)
            if m:
                key = f"{m.group(1)} D={m.group(2)} ROWS={m.group(3)}"
                out.setdefault(key, {"registers": None, "spill_bytes": 0})
        elif key and "spill" in line:
            out[key]["spill_bytes"] += sum(int(x) for x in re.findall(r"(\d+) bytes spill", line))
        elif key and "Used" in line and "registers" in line:
            out[key]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return out


# ---------------------------------------------------------------- phase 2


def make_case(starts, clens, c, dtype, seed, h=H, n_kv=N_KV, d=D):
    """A paged arena of random K/V with per-sequence block tables over
    shuffled physical pages; rows with clen 0 keep an all-null table."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    need = [-(-(s + n) // PAGE) if n > 0 else 0 for s, n in zip(starts, clens)]
    n_pages = 1 + sum(need)
    phys = (torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(seed)) + 1).tolist()
    bt = torch.zeros((len(starts), MAX_PAGES), dtype=torch.int32)
    for i, n in enumerate(need):
        bt[i, :n] = torch.tensor(phys[:n], dtype=torch.int32)
        phys = phys[n:]
    pages = torch.randn((n_pages, PAGE, 2, n_kv, d), generator=gen, device="cuda").to(dtype)
    q = torch.randn((len(starts), c, h, d), generator=gen, device="cuda").to(dtype)
    return dict(q=q, pages=pages, block_table=bt.cuda(), start_pos=torch.tensor(starts, dtype=torch.int32).cuda(),
                chunk_lens=torch.tensor(clens, dtype=torch.int32).cuda(), page_size=PAGE)


def case_args(case) -> tuple:
    return (case["q"], case["pages"], case["block_table"], case["start_pos"], case["chunk_lens"], PAGE)


def time_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean device time of ``fn`` with a cold L2: every launch is preceded
    by a write of ``flush`` (larger than the 50 MB L2) and a ~1 ms device
    spin, which keeps the card busy while the host enqueues the timed work,
    so host launch latency stays out of the reading."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def bound_ms(case, dtype) -> tuple:
    """Least time for the work: the bytes it must move — each live KV byte,
    the q rows of real queries (a padding row's output is zero whatever its
    q holds), the live block-table entries, start_pos and chunk_lens read
    once, every out row (zeros included) written once — against the flops
    the visible keys need."""
    esize = torch.finfo(dtype).bits // 8
    b, c, h, d = case["q"].shape
    n_kv = case["pages"].shape[3]
    starts = case["start_pos"].tolist()
    clens = case["chunk_lens"].tolist()
    live_keys = sum(s + n for s, n in zip(starts, clens) if n > 0)
    live_pages = sum(-(-(s + n) // PAGE) for s, n in zip(starts, clens) if n > 0)
    row_bytes = h * d * esize
    nbytes = (live_keys * 2 * n_kv * d * esize + sum(clens) * row_bytes + b * c * row_bytes +
              4 * (live_pages + 2 * b))
    flops = sum(4 * h * d * (s + j + 1) for s, n in zip(starts, clens) for j in range(n))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_inputs(case):
    """q [B, H, C, D], K/V gathered per sequence [B, H, S, D] (GQA heads
    repeated) and the boolean mask of what each row may see."""
    q, pages, bt = case["q"], case["pages"], case["block_table"]
    b, c, h, d = q.shape
    n_kv = pages.shape[3]
    s_max = max(1, max(s + n for s, n in zip(case["start_pos"].tolist(), case["chunk_lens"].tolist())))
    n_pg = -(-s_max // PAGE)
    g = pages[bt[:, :n_pg].reshape(-1).long()].reshape(b, n_pg * PAGE, 2, n_kv, d)[:, :s_max]
    k = g[:, :, 0].repeat_interleave(h // n_kv, dim=2).transpose(1, 2).contiguous()
    v = g[:, :, 1].repeat_interleave(h // n_kv, dim=2).transpose(1, 2).contiguous()
    qpos = case["start_pos"].long()[:, None] + torch.arange(c, device="cuda")[None, :]
    mask = torch.arange(s_max, device="cuda")[None, None, :] <= qpos[..., None]
    return q.transpose(1, 2).contiguous(), k, v, mask[:, None]


def k3_ratio(got: torch.Tensor, want: torch.Tensor, dtype) -> float:
    """Largest |got − want| over the TOLERANCE limit: at most 1 passes."""
    atol, rtol = TOLERANCE[dtype]
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return float(((got.float() - want.float()).abs() / (atol + rtol * want.float().abs())).max())


def run_case(name, case, dtype, flush, timed=True, n_split=None) -> dict:
    args = case_args(case)
    b, c, h, d = case["q"].shape
    split = 1 if dtype == torch.float32 else n_split or choose_n_split(b, c, h, case["pages"].shape[3], d,
                                                                          MAX_PAGES * PAGE)
    got = paged_attention_cuda(*args, n_split=n_split)
    want = paged_attention_plain(*args)
    torch.cuda.synchronize()
    max_err = float((got.float() - want.float()).abs().max())
    ratio = k3_ratio(got, want, dtype)
    pad = case["chunk_lens"] == 0
    if bool(pad.any()) and not bool((got[pad] == 0).all()):
        raise AssertionError(f"{name}: padding rows are not zero")
    if not ratio <= 1:
        atol, rtol = TOLERANCE[dtype]
        raise AssertionError(f"{name}: kernel disagrees with the plain version: max |err| {max_err:.3e}, "
                             f"|err|/limit {ratio:.3g} (tolerance {atol} + {rtol}·|plain|)")
    row = {"case": name, "n_split": split, "max_abs_err": max_err, "err_over_limit": ratio}
    b_ms, b_by = bound_ms(case, dtype)
    row.update(bound_ms=b_ms, bound_by=b_by)
    if timed:
        row["ms"] = time_ms(lambda: paged_attention_cuda(*args, n_split=n_split), 20, flush)
        row["plain_ms"] = time_ms(lambda: paged_attention_plain(*args), 5, flush)
        qs, ks, vs, mask = sdpa_inputs(case)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        row["library_ms"] = time_ms(lambda: sdpa(qs, ks, vs, attn_mask=mask), 10, flush)
        row["bound_share"] = b_ms / row["ms"]
    log(f"  K3 {name}: " + ", ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                                     for k, v in row.items() if k != "case"))
    return row


def k3_mutants(decode, prefill) -> dict:
    """Faulty kernels the check must reject, made from the kernels' outputs:
    the split route with one split's partial dropped for the longest decode
    row; the causal edge off by one (the key at start + c hidden: the plain
    version one position early); one head of a row tile attending with its
    neighbour's q.  Each must exceed the TOLERANCE limit."""
    args = case_args(decode)
    want = paged_attention_plain(*args)
    longest = int(decode["start_pos"].argmax())
    m, l, o = paged_attention_partials_cuda(*args, 4)
    m[0, longest] = -float("inf")                 # split 0 holds keys 0..511 of the 2000-key row
    dropped = merge_partials_cuda(m, l, o, decode["chunk_lens"])
    pargs = list(case_args(prefill))
    pwant = paged_attention_plain(*pargs)
    early = paged_attention_plain(*pargs[:3], pargs[3] - 1, *pargs[4:])
    q_swapped = pargs[0].clone()
    q_swapped[:, :, 1] = pargs[0][:, :, 2]        # head 1 of kv group 0 takes head 2's q
    swapped = paged_attention_cuda(*pargs)
    swapped[:, :, 1] = paged_attention_plain(q_swapped, *pargs[1:])[:, :, 1]
    caught = {"split_dropped": k3_ratio(dropped, want, torch.bfloat16),
              "causal_edge_off_by_one": k3_ratio(early, pwant, torch.bfloat16),
              "neighbour_q": k3_ratio(swapped, pwant, torch.bfloat16)}
    log("  K3 faulty kernels' |err|/limit: " + ", ".join(f"{n}={r:.4g}" for n, r in caught.items()))
    if not all(r > 1 for r in caught.values()):
        raise AssertionError(f"K3: the check passes a faulty kernel: {caught}")
    return caught


def k3_fragments() -> dict:
    """One m16n8k16 product through the kernel's fragment loaders against
    torch.matmul (float32 sums of bf16 products: exact up to order)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    a, k, v = (torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16) for s in ((16, 16), (8, 16), (16, 8)))
    c1, c2 = mma_probe_cuda(a, k, v)
    err = {"q_kt": float((c1 - a.float() @ k.float().t()).abs().max()),
           "p_v": float((c2 - a.float() @ v.float()).abs().max())}
    log(f"  K3 one mma (ldmatrix, ldmatrix.trans) vs torch.matmul: max |err| {err}")
    if not all(e <= 1e-4 for e in err.values()):
        raise AssertionError(f"K3 mma fragments disagree with torch.matmul: {err}")
    return err


def k3_merge(decode) -> dict:
    """The merge kernel against merge_partials_plain on the split kernel's
    partials of the decode case (empty splits included)."""
    args = case_args(decode)
    n = choose_n_split(*decode["q"].shape[:3], N_KV, D, MAX_PAGES * PAGE)
    m, l, o = paged_attention_partials_cuda(*args, n)
    got = merge_partials_cuda(m, l, o, decode["chunk_lens"])
    want = merge_partials_plain(m, l, o, decode["chunk_lens"])
    torch.cuda.synchronize()
    empty = int((m == -float("inf")).sum())
    ratio = k3_ratio(got, want, torch.bfloat16)
    log(f"  K3 merge kernel vs merge_partials_plain: n_split={n}, empty partials {empty} of {m.numel()}, "
        f"|err|/limit {ratio:.4g}")
    if not (ratio <= 1 and empty > 0):
        raise AssertionError(f"K3 merge kernel: |err|/limit {ratio}, empty partials {empty}")
    return {"n_split": n, "empty_partials": empty, "err_over_limit": ratio}


def phase_kernels() -> dict:
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    rng = np.random.default_rng(0)
    ctx = rng.integers(1, 2001, 16)
    ctx[0], ctx[-1] = 1, 2000
    decode = ([int(x) - 1 for x in ctx], [1] * 16, 1)
    prefill = ([0, 256, 768, 1536], [256, 256, 256, 200], 256)
    # a mixed SplitFuse step: two prefill rows, three decode rows, three
    # padding rows (chunk_len 0, all-null block table)
    mixed = ([0, 512, 900, 33, 1999, 0, 0, 0], [256, 130, 1, 1, 1, 0, 0, 0], 256)
    decode_long = ([1999] * 16, [1] * 16, 1)   # every sequence at 2000 keys
    # a speculative verify round: 8 rows of the last token and 4 drafts
    verify = ([int(x) for x in rng.integers(64, 1020, 8)], [5] * 8, 5)
    k3_fragments()
    cases = {name: make_case(*shape, torch.bfloat16, seed=i)
             for i, (name, shape) in enumerate((("decode", decode), ("prefill", prefill), ("mixed", mixed),
                                                ("decode_long", decode_long), ("verify", verify)))}
    rows = {name: run_case(name, case, torch.bfloat16, flush) for name, case in cases.items()}
    rows["decode_f32"] = run_case("decode_f32", make_case(*decode, torch.float32, seed=7), torch.float32, flush,
                                  timed=False)
    if not (rows["decode"]["n_split"] > 1 and rows["decode_long"]["n_split"] > 1):
        raise AssertionError(f"decode did not take the split route: {rows['decode']}, {rows['decode_long']}")
    # empty splits: at 8 splits of 256 keys the 1-key row and every row
    # under 1793 keys leave splits empty; whole (one split) for comparison
    run_case("decode_8_splits", cases["decode"], torch.bfloat16, flush, timed=False, n_split=8)
    run_case("decode_unsplit", cases["decode"], torch.bfloat16, flush, timed=False, n_split=1)
    # rep 1 at head dim 64: 16 heads of their own kv head, a chunk and decode
    for name, shape in (("rep1_d64_chunk", prefill), ("rep1_d64_decode", decode)):
        run_case(name, make_case(*shape, torch.bfloat16, seed=9, h=16, n_kv=16, d=64), torch.bfloat16, flush,
                 timed=False)
    k3_merge(cases["decode"])
    k3_mutants(cases["decode"], cases["prefill"])
    # how the decode time moves with the split, at four decode batches (the
    # wrapper picks n_split from shapes: the lengths live on the device)
    sweeps = {"decode": cases["decode"], "decode_long": cases["decode_long"],
              "decode_b8": make_case([500 + 13 * i for i in range(8)], [1] * 8, 1, torch.bfloat16, seed=12),
              "decode_b4": make_case([1000, 1300, 1700, 1999], [1] * 4, 1, torch.bfloat16, seed=13)}
    for name, case in sweeps.items():
        b = case["q"].shape[0]
        sweep = {n: time_ms(lambda: paged_attention_cuda(*case_args(case), n_split=n), 20, flush)
                 for n in range(1, 9)}
        chosen = choose_n_split(b, 1, H, N_KV, D, MAX_PAGES * PAGE)
        log(f"  K3 {name} (B {b}) ms by n_split (chosen {chosen}): " +
            json.dumps({str(k): round(v, 5) for k, v in sweep.items()}))
        if name in rows:
            rows[name]["ms_by_n_split"] = sweep
    return rows


# ---------------------------------------------------------------- phase 3


def llama3_8b(layers: int, dtype: torch.dtype, seed: int) -> tuple:
    """Llama-3-8B at full width, ``layers`` deep, random weights from a
    seeded generator, stored in the compute dtype."""
    cfg = dataclasses.replace(PRESETS["llama3-8b"], num_hidden_layers=layers, dtype=dtype, param_dtype=dtype,
                              attention_impl="flash")
    model = LlamaForCausalLMWithCache(cfg, page_size=PAGE, device="cuda")
    init_weights_(model, torch.Generator(device="cuda").manual_seed(seed))
    return cfg, model.state_dict()


def engine_config(dtype: torch.dtype, num_pages: int) -> RaggedInferenceEngineConfig:
    return RaggedInferenceEngineConfig(kv=PagedKVConfig(num_pages=num_pages, page_size=PAGE, max_pages_per_seq=MAX_PAGES),
                                       scheduler=SchedulerConfig(token_budget=512, max_seqs=8, prefill_chunk=256,
                                                                 decode_bucket=8),
                                       max_new_tokens=64, kv_dtype=dtype, enable_prefix_cache=True,
                                       decode_steps_per_dispatch=8)


def serving_mix(vocab: int) -> tuple:
    """Phase 3's 8 requests: prompts of 64-1024 tokens, the last sharing
    512 tokens with the second, and 32-64 new tokens each."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, vocab, n).tolist() for n in (64, 1024, 300, 700, 128, 512, 900, 100)]
    prompts[7] = prompts[1][:512] + prompts[7]             # shares 32 full pages with request 1
    return prompts, rng.integers(32, 65, len(prompts)).tolist()


def phase_serving(cfg, state, smi: str) -> dict:
    layers = cfg.num_hidden_layers
    log(f"  depth {layers} of {PRESETS['llama3-8b'].num_hidden_layers} layers, full width "
        f"(hidden {cfg.hidden_size}, {cfg.num_attention_heads}/{cfg.num_key_value_heads} heads, "
        f"vocab {cfg.vocab_size}), bf16")
    eng = build_engine(cfg, state, engine_config(torch.bfloat16, 1024), device="cuda")
    eng.generate([list(range(1, 20))], max_new_tokens=9)  # warm-up: cuBLAS handles, allocator
    pc = eng.kv.prefix_cache
    pc.evict(pc.cached_pages)
    free0 = eng.kv.allocator.free_pages

    prompts, max_new = serving_mix(cfg.vocab_size)
    lens = [len(p) for p in prompts]
    late = 7                                               # admitted once request 1 has its first token

    acc = get_accelerator()
    acc.synchronize()
    acc.reset_peak_memory_stats()
    reset_launch_counts()
    eng.forward_calls = 0
    t0 = time.perf_counter()
    put_t, reused = {}, {}    # reused: prompt tokens whose KV the prefix cache supplied at admission
    for uid in range(len(prompts)):
        if uid != late:
            eng.put([uid], [prompts[uid]], max_new_tokens=max_new[uid])
            put_t[uid] = t0
            reused[uid] = eng.state.seqs[uid].seen_tokens
    first, steps = {}, []
    while any(not s.done for s in eng.state.seqs.values()) or late not in put_t:
        if len(steps) > 1000:
            raise AssertionError("serving made no progress in 1000 steps")
        ts = time.perf_counter()
        out = eng.step()                                    # ends in the step's readback
        now = time.perf_counter()
        steps.append((ts, now, sum(len(v) for v in out.values()), len(first) == len(prompts)))
        for uid, toks in out.items():
            first.setdefault(uid, now)
        if late not in put_t and 1 in first:
            eng.put([late], [prompts[late]], max_new_tokens=max_new[late])
            put_t[late] = time.perf_counter()
            reused[late] = eng.state.seqs[late].seen_tokens
    t_end = time.perf_counter()
    launches, forwards = paged_attention_cuda.launches, eng.forward_calls
    split_calls = paged_attention_cuda.split_calls

    for uid in range(len(prompts)):
        got = len(eng.state.seqs[uid].generated)
        if got != max_new[uid]:
            raise AssertionError(f"request {uid} produced {got} tokens, asked for {max_new[uid]}")
    hits = pc.hits
    for uid in range(len(prompts)):
        eng.flush(uid)
    pc.evict(pc.cached_pages)
    if eng.kv.allocator.free_pages != free0:
        raise AssertionError(f"pages leaked: {eng.kv.allocator.free_pages} free after flush, {free0} before")
    if hits < 1 or reused[late] == 0:
        raise AssertionError(f"the shared-prefix request did not hit the prefix cache: {reused}")
    if launches != layers * forwards or launches == 0:
        raise AssertionError(f"K3 launched {launches} times over {forwards} forwards of {layers} layers")
    if split_calls == 0:
        raise AssertionError("no K3 call of the decode rounds took the split route")

    # prefill tok/s: prompt tokens computed over the time to the last first
    # token; decode tok/s: tokens of the steps after every request had its
    # first token, over those steps' time
    ttft = {uid: first[uid] - put_t[uid] for uid in first}
    t_prefilled = max(first.values())
    prefill_tokens = sum(lens) - sum(reused.values())
    decode_steps = [s for s in steps if s[3]]
    decode_tokens = sum(s[2] for s in decode_steps)
    decode_s = sum(s[1] - s[0] for s in decode_steps)
    res = {"requests": len(prompts), "prompt_tokens": sum(lens), "generated": sum(max_new), "steps": len(steps),
           "forwards": forwards, "k3_launches": launches, "k3_split_calls": split_calls, "prefix_hits": hits,
           "prefix_tokens_reused": sum(reused.values()),
           "prefill_tok_s": prefill_tokens / (t_prefilled - t0), "decode_tok_s": decode_tokens / decode_s,
           "ttft_ms_mean": 1e3 * float(np.mean(list(ttft.values()))), "ttft_ms_max": 1e3 * max(ttft.values()),
           "wall_s": t_end - t0, "peak_mem_gb": acc.max_memory_allocated() / 1e9, "card": smi}
    log("  serving: " + json.dumps(res))
    return res


# ---------------------------------------------------------------- phase 4


def phase_parity_f32() -> dict:
    """Greedy streams of the kernel path and the plain path, float32,
    Llama-3-8B width, 2 layers: identical."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, state = llama3_8b(2, torch.float32, seed=1)
    econf = engine_config(torch.float32, 256)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (40, 300, 700)]
    streams = {}
    for impl in ("flash", "reference"):
        eng = build_engine(dataclasses.replace(cfg, attention_impl=impl), state, econf, device="cuda")
        streams[impl] = eng.generate(prompts, max_new_tokens=24)
        del eng
    if streams["flash"] != streams["reference"]:
        raise AssertionError(f"f32 greedy streams differ: {streams}")
    log(f"  f32 parity: {len(prompts)} greedy streams of 24 tokens identical on both paths")
    return {"f32_streams_identical": True}


def first_step_logits(eng, prompt) -> torch.Tensor:
    """Last-token logits of a prompt's first (single-chunk) step."""
    uid = 10_000
    eng.put([uid], [prompt], max_new_tokens=1)
    seq = eng.state.seqs[uid]
    rb = eng.state.pack([(seq, len(prompt))], eng.econfig.scheduler.prefill_chunk, pad_to=eng._bucket_batch(1))
    dev = [torch.from_numpy(a).cuda() for a in (rb.tokens, rb.start_pos, rb.block_tables, rb.chunk_lens)]
    with torch.no_grad():
        logits = eng.model(dev[0], dev[1], dev[2], eng.cache, dev[3])[0, len(prompt) - 1].float()
    eng.flush(uid)
    return logits


def phase_parity_bf16(cfg, state) -> dict:
    """First-step last-token logits of the bf16 kernel path and the bf16
    plain path, both held against the plain path in float32 on the same
    (upcast) weights.  Tolerance: the bf16 rounding error of the plain path
    itself, e = ||plain - f32|| / ||f32||.  Each of the layers rounds
    attention's probabilities and output to bf16 at other points on the two
    paths, and the residual stream carries the differences through depth,
    so the two bf16 paths may differ by about sqrt(2)·e; the kernel path must
    stay within 2·e of the plain path and within 1.5·e of float32."""
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab_size, 200).tolist()
    runs = {"flash": (cfg, state), "reference": (dataclasses.replace(cfg, attention_impl="reference"), state),
            "f32": (dataclasses.replace(cfg, dtype=torch.float32, param_dtype=torch.float32,
                                        attention_impl="reference"), None)}
    logits = {}
    for name, (c, st) in runs.items():
        if st is None:
            st = {k: v.float() for k, v in state.items()}
        eng = build_engine(c, st, engine_config(c.dtype, 64), device="cuda")
        logits[name] = first_step_logits(eng, prompt)
        del eng, st
        torch.cuda.empty_cache()

    def rel(a, b):
        return float((logits[a] - logits[b]).norm() / logits[b].norm())

    res = {"kernel_vs_plain": rel("flash", "reference"), "kernel_vs_f32": rel("flash", "f32"),
           "plain_vs_f32": rel("reference", "f32"),
           "max_abs_kernel_vs_plain": float((logits["flash"] - logits["reference"]).abs().max()),
           "argmax_equal": bool(logits["flash"].argmax() == logits["reference"].argmax())}
    log(f"  bf16 parity ({cfg.num_hidden_layers} layers, relative L2 of logits): {json.dumps(res)}")
    e = res["plain_vs_f32"]
    if not (np.isfinite(res["kernel_vs_plain"]) and res["kernel_vs_plain"] <= 2 * e
            and res["kernel_vs_f32"] <= 1.5 * e):
        raise AssertionError(f"bf16 kernel path out of tolerance: {res}")
    return res


def phase_profile(cfg, state) -> dict:
    """Where a decode step's time goes: one fused decode dispatch (k rounds
    of 8 sequences at ~512-token contexts) under torch.profiler — the
    device time and the kernels that take it — and the wall time of the
    next, identical dispatch, not profiled.  The busy share is the device
    time over that unprofiled wall time (the profiler slows the host)."""
    from torch.profiler import ProfilerActivity, profile
    eng = build_engine(cfg, state, engine_config(cfg.dtype, 1024), device="cuda")
    rng = np.random.default_rng(4)
    uids = list(range(8))
    for u in uids:
        eng.put([u], [rng.integers(0, cfg.vocab_size, 512).tolist()], max_new_tokens=33)
    while not all(s.in_decode for s in eng.state.seqs.values()):
        eng.step()                                         # prefill
    eng.step()                                             # one decode dispatch, warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = eng.step()
        wall = time.perf_counter() - t0
    k = len(next(iter(out.values())))
    t0 = time.perf_counter()
    eng.step()                                             # the same dispatch, not profiled
    wall_plain = time.perf_counter() - t0
    # device rows only (kernels, memcpy/memset): a CPU op's row also carries
    # the device time of the kernels it launched
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = {e.key: e.self_device_time_total for e in rows}
    busy_ms = sum(dev_us.values()) / 1e3
    top = sorted(((v / 1e3, n) for n, v in dev_us.items() if v > 0), reverse=True)[:8]
    res = {"rounds": k, "wall_ms_per_round": 1e3 * wall_plain / k, "profiled_wall_ms_per_round": 1e3 * wall / k,
           "device_ms_per_round": busy_ms / k, "device_busy_share": busy_ms / (1e3 * wall_plain),
           "device_busy_share_profiled": busy_ms / (1e3 * wall), "device_ops_per_round": sum(e.count for e in rows) / k,
           "top_kernels_ms_per_round": [[n[:60], t / k] for t, n in top]}
    log("  decode profile: " + json.dumps(res))
    return res


# ---------------------------------------------------------------- phase 5

# training shapes: Llama-125M at the bench configuration, and Llama-3-8B
FLASH_SHAPES = {"bench": dict(b=24, s=1024, h=12, hk=12, d=64), "llama3-8b": dict(b=1, s=4096, h=32, hk=8, d=128)}
# untimed shapes whose blocks hold rows that are not valid: at rep 3 a block
# has 63 rows (21 positions) and the last one stops at Sq; at rep 2 with a
# query offset the rows end at Sq 192, below the 256 keys
FLASH_EDGE_SHAPES = {"rep3": dict(b=2, h=6, hk=2, d=128), "tail": dict(b=2, h=4, hk=2, d=64)}
# Kernel against plain, element by element.  o, dq, dk, dv:
#   |kernel − plain| <= a·|plain| + b·rms(vector) + f·rms(tensor),
# the vector being the D values of one head at one query row (o, dq) or key
# (dk, dv).  a: the two versions round the same f32 value to the output
# dtype, at most one ulp apart (2^-7 relative in bf16).  b: the kernel rounds
# p (and ds) to bf16 at the online softmax's running max, the plain version
# at the row's final max; each rounding moves a term by up to 2^-9 of itself,
# so the sum moves by a few 2^-9 of the vector's own scale.  f: a floor for
# vectors that are cancellation noise (dq of a row that sees one key is 0 up
# to f32 rounding).  lse and delta are float32 statistics computed from the
# same f32 terms on both sides: |err| <= stat·(|plain| + rms(plain)).  The
# float32 kernels differ from the plain version only in summation order; the
# float32 floor f is set above the noise of the causal rows that see few
# keys (2^-16 failed on dq at Llama-3-8B shapes, H100 readings in PERF.md).
FLASH_TOL = {torch.bfloat16: dict(a=2**-7, b=2**-6, f=2**-8, stat=2**-14),
             torch.float32: dict(a=2**-16, b=2**-14, f=2**-14, stat=2**-16)}


def tolerance_ratio(got: torch.Tensor, want: torch.Tensor, tol: dict, vector: bool) -> float:
    """Largest |got − want| over its limit (see FLASH_TOL): at most 1 passes."""
    got, want = got.float(), want.float()
    rms = want.square().mean().sqrt()
    if vector:
        limit = tol["a"] * want.abs() + tol["b"] * want.square().mean(-1, keepdim=True).sqrt() + tol["f"] * rms
    else:
        limit = tol["stat"] * (want.abs() + rms)
    ratio = (got - want).abs() / limit.clamp_min(torch.finfo(torch.float32).tiny)
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return float(ratio.max())


def flash_mutants(q, k, v, causal, q_offset, o, lse, dq, dk, dv) -> dict:
    """Faulty kernels the check must reject, made from the kernel's outputs:
    K1 that stops one kv tile (64 keys) short of the diagonal for the second
    half of the rows; K2a that zeroes dq of one query head in the last q tile;
    K2b that zeroes dk and dv of the last kv tile at or below the diagonal
    (the keys with the smallest gradients)."""
    sq, sk = q.shape[1], k.shape[1]
    half, tile = sq // 2, 64
    short_o, short_lse = flash_fwd_plain(q, k, v, causal, q_offset - tile)
    o_m, lse_m = o.clone(), lse.clone()
    o_m[:, half:], lse_m[:, :, half:] = short_o[:, half:], short_lse[:, :, half:]
    dq_m = dq.clone()
    dq_m[:, -tile:, -1] = 0
    t1 = min(sk, sq + q_offset) // tile * tile
    dk_m, dv_m = dk.clone(), dv.clone()
    dk_m[:, t1 - tile:t1] = 0
    dv_m[:, t1 - tile:t1] = 0
    return {"o": o_m, "lse": lse_m, "dq": dq_m, "dk": dk_m, "dv": dv_m}


def visible_keys(sq: int, sk: int, causal: bool, q_offset: int) -> int:
    """Keys seen by the Sq query rows of one head: the causal triangle, or all."""
    if not causal:
        return sq * sk
    return sum(min(sk, q_offset + i + 1) for i in range(sq))


def flash_bounds(b, sq, sk, h, hk, d, dtype, vis) -> dict:
    """Least time of each kernel: each input read once and each output
    written once, against 4/6/8·B·H·D·vis flops (QK+PV; QK, dO·Vᵀ, dS·K;
    QK, dO·Vᵀ, Pᵀ·dO, dSᵀ·Q) at the bf16 tensor-core peak."""
    e = torch.finfo(dtype).bits // 8
    qb, kvb, st = b * sq * h * d * e, b * sk * hk * d * e, b * h * sq * 4
    nbytes = {"flash_fwd": qb + 2 * kvb + qb + st,                         # q k v → o lse
              "flash_dq": qb + 2 * kvb + 2 * qb + st + qb + st,            # q k v o do lse → dq delta
              "flash_dkv": qb + 2 * kvb + qb + 2 * st + 2 * kvb}           # q k v do lse delta → dk dv
    flops = {"flash_fwd": 4, "flash_dq": 6, "flash_dkv": 8}
    out = {}
    for name in nbytes:
        t_bytes = nbytes[name] / HBM_BYTES_PER_S * 1e3
        t_ops = flops[name] * b * h * d * vis / PEAK_FLOPS[torch.bfloat16] * 1e3
        out[name] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return out


def flash_case(shape: str, dtype, causal: bool, sq: int, sk: int, q_offset: int, flush, timed: bool) -> dict:
    g = FLASH_SHAPES[shape] if shape in FLASH_SHAPES else FLASH_EDGE_SHAPES[shape]
    b, h, hk, d = g["b"], g["h"], g["hk"], g["d"]
    gen = torch.Generator(device="cuda").manual_seed(sq + sk + q_offset + int(causal))
    q, do = (torch.randn((b, sq, h, d), generator=gen, device="cuda").to(dtype) for _ in range(2))
    k, v = (torch.randn((b, sk, hk, d), generator=gen, device="cuda").to(dtype) for _ in range(2))
    o, lse = flash_fwd_cuda(q, k, v, causal, q_offset)
    dq, delta = flash_dq_cuda(q, k, v, o, lse, do, causal, q_offset)
    dk, dv = flash_dkv_cuda(q, k, v, do, lse, delta, causal, q_offset)
    want_o, want_lse = flash_fwd_plain(q, k, v, causal, q_offset)
    want_dq, want_dk, want_dv = flash_bwd_plain(q, k, v, o, lse, do, causal, q_offset)
    torch.cuda.synchronize()
    tol = FLASH_TOL[dtype]
    label = f"{shape} {dtype} causal={causal} Sq={sq} Sk={sk} q_offset={q_offset}"
    # output: (kernel, plain, is a vector per head and row/key)
    outputs = {"flash_fwd": {"o": (o, want_o, True), "lse": (lse, want_lse, False)},
               "flash_dq": {"dq": (dq, want_dq, True), "delta": (delta, flash_delta_plain(o, do), False)},
               "flash_dkv": {"dk": (dk, want_dk, True), "dv": (dv, want_dv, True)}}
    errs, ratios = {}, {}
    for name, outs in outputs.items():
        errs[name] = max(float((got.float() - want.float()).abs().max()) for got, want, _ in outs.values())
        for out, (got, want, vector) in outs.items():
            ratios[out] = tolerance_ratio(got, want, tol, vector)
    log(f"  {label}: |err|/limit " + ", ".join(f"{n}={r:.3g}" for n, r in ratios.items()))
    bad = {n: r for n, r in ratios.items() if not r <= 1}
    if bad:
        raise AssertionError(f"{label}: kernel disagrees with the plain version, |err|/limit {bad}")
    if causal and sk > sq + q_offset and (dk[:, sq + q_offset:].any() or dv[:, sq + q_offset:].any()):
        raise AssertionError(f"{label}: keys above the diagonal got nonzero dk/dv")
    # K2a and K2b sum inside one block in a fixed order, no atomics: a
    # second launch gives the same bits
    dq2, delta2 = flash_dq_cuda(q, k, v, o, lse, do, causal, q_offset)
    if not (torch.equal(dq, dq2) and torch.equal(delta, delta2)):
        raise AssertionError(f"{label}: two K2a launches gave different dq/delta")
    dk2, dv2 = flash_dkv_cuda(q, k, v, do, lse, delta, causal, q_offset)
    if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
        raise AssertionError(f"{label}: two K2b launches gave different dk/dv")
    if causal and dtype == torch.bfloat16 and sq == sk:
        mutants = flash_mutants(q, k, v, causal, q_offset, o, lse, dq, dk, dv)
        wants = {out: (want, vector) for outs in outputs.values() for out, (_, want, vector) in outs.items()}
        caught = {n: tolerance_ratio(m, wants[n][0], tol, wants[n][1]) for n, m in mutants.items()}
        log(f"  {label}: faulty kernels' |err|/limit " + ", ".join(f"{n}={r:.3g}" for n, r in caught.items()))
        if not all(r > 1 for r in caught.values()):
            raise AssertionError(f"{label}: the check passes a faulty kernel: {caught}")
    case = f"{shape} {str(dtype)[6:]} {'causal' if causal else 'full'} Sq={sq} Sk={sk} off={q_offset}"
    rows = {k_: {"case": case, "max_abs_err": e_} for k_, e_ in errs.items()}
    if timed:
        vis = visible_keys(sq, sk, causal, q_offset)
        for name, (t, by) in flash_bounds(b, sq, sk, h, hk, d, dtype, vis).items():
            rows[name].update(bound_ms=t, bound_by=by)
        rows["flash_fwd"]["ms"] = time_ms(lambda: flash_fwd_cuda(q, k, v, causal, q_offset), 10, flush)
        rows["flash_dq"]["ms"] = time_ms(lambda: flash_dq_cuda(q, k, v, o, lse, do, causal, q_offset), 10, flush)
        rows["flash_dkv"]["ms"] = time_ms(lambda: flash_dkv_cuda(q, k, v, do, lse, delta, causal, q_offset), 10,
                                          flush)
        rows["flash_fwd"]["plain_ms"] = time_ms(lambda: flash_fwd_plain(q, k, v, causal, q_offset), 3, flush)
        # the plain backward computes dq, dk and dv in one call: its time
        # stands beside both backward kernels
        bwd_ms = time_ms(lambda: flash_bwd_plain(q, k, v, o, lse, do, causal, q_offset), 3, flush)
        rows["flash_dq"]["plain_ms"] = rows["flash_dkv"]["plain_ms"] = bwd_ms
        # library: SDPA on [B, H, S, D] with the GQA heads repeated (not
        # timed); its backward (dq, dk, dv together) by autograd.grad
        rep = h // hk
        qs = q.transpose(1, 2).contiguous().requires_grad_()
        ks, vs = (x.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous().requires_grad_() for x in (k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        with torch.no_grad():
            rows["flash_fwd"]["library_ms"] = time_ms(lambda: sdpa(qs, ks, vs, is_causal=causal), 10, flush)
        out = sdpa(qs, ks, vs, is_causal=causal)
        gout = do.transpose(1, 2).contiguous()
        lib_bwd = time_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), gout, retain_graph=True), 10, flush)
        rows["flash_dq"]["library_ms"] = rows["flash_dkv"]["library_ms"] = lib_bwd
    for name, row in rows.items():
        log(f"  {name} {case}: " + ", ".join(f"{k_}={v_:.4g}" if isinstance(v_, float) else f"{k_}={v_}"
                                             for k_, v_ in row.items() if k_ != "case"))
    return rows


def phase_flash_kernels() -> dict:
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    timed = {}
    for shape, g in FLASH_SHAPES.items():
        s = g["s"]
        timed[shape] = flash_case(shape, torch.bfloat16, True, s, s, 0, flush, timed=True)
        flash_case(shape, torch.bfloat16, False, s, s, 0, flush, timed=False)
        flash_case(shape, torch.float32, True, s, s, 0, flush, timed=False)
        flash_case(shape, torch.float32, False, s, s, 0, flush, timed=False)
        for dtype in (torch.bfloat16, torch.float32):
            flash_case(shape, dtype, True, s // 2, s, s // 2, flush, timed=False)   # queries at an offset
            flash_case(shape, dtype, True, s // 2, s, 0, flush, timed=False)        # keys past the last query
    flash_case("rep3", torch.bfloat16, True, 256, 384, 128, flush, timed=False)
    flash_case("tail", torch.bfloat16, True, 192, 256, 64, flush, timed=False)
    del flush
    torch.cuda.empty_cache()
    return timed


# ---------------------------------------------------------------- phase 6

BENCH_B, BENCH_S = 24, 1024
BENCH_DS_CONFIG = {"train_batch_size": BENCH_B, "optimizer": {"type": "AdamW",
                                                              "params": {"lr": 1e-4, "weight_decay": 0.01}},
                   "zero_optimization": {"stage": 2}, "bf16": {"enabled": True}, "steps_per_print": 0}


def llama_125m(**overrides) -> LlamaConfig:
    """Llama-125M as the JAX package's bench trains it."""
    fields = dict(max_position_embeddings=BENCH_S, rope_theta=1e4, remat=True, remat_policy="flash_saveable",
                  attention_impl="flash")
    return dataclasses.replace(PRESETS["125m"], **{**fields, **overrides})


def build_trainer(cfg: LlamaConfig, ds_config: dict, seed: int = 0, state=None):
    model = LlamaForCausalLM(cfg, device="cuda")
    if state is None:
        init_weights_(model, torch.Generator(device="cuda").manual_seed(seed))
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config=ds_config, params=state)
    return engine


def phase_training(smi: str) -> dict:
    cfg = llama_125m()
    ids = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (BENCH_B, BENCH_S),
                                                             dtype=np.int32)).cuda()
    batch = {"input_ids": ids, "labels": ids}
    acc = get_accelerator()
    acc.synchronize()
    acc.reset_peak_memory_stats()
    reset_launch_counts()
    engine = build_trainer(cfg, BENCH_DS_CONFIG)
    losses = [float(engine.train_batch(batch=batch)) for _ in range(3)]   # warm-up
    windows, steps_per_window = [], 5
    for _ in range(2):
        t0 = time.perf_counter()
        for _ in range(steps_per_window):
            loss = engine.train_batch(batch=batch)
        losses.append(float(loss))                                       # the value fetch syncs
        windows.append((time.perf_counter() - t0) / steps_per_window)
    steps = 3 + 2 * steps_per_window
    launches = (flash_fwd_cuda.launches, flash_dq_cuda.launches, flash_dkv_cuda.launches)
    layers = cfg.num_hidden_layers
    if launches != (layers * steps, ) * 3:
        raise AssertionError(f"K1/K2a/K2b launched {launches} times over {steps} steps of {layers} layers: "
                             f"expected {layers} each per step")
    if paged_attention_cuda.launches:
        raise AssertionError("the training path launched the serving kernel K3")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling on a repeated batch: {losses}")
    n_params = sum(p.numel() for p in engine.module.parameters())
    step_s = min(windows)
    tok_s = BENCH_B * BENCH_S / step_s
    # bench.py:160-162: 6N per token plus the attention term
    flops_per_token = 6 * n_params + 12 * layers * cfg.hidden_size * BENCH_S
    res = {"params": n_params, "step_ms": 1e3 * step_s, "window_step_ms": [1e3 * w for w in windows],
           "tok_s": tok_s, "mfu": tok_s * flops_per_token / PEAK_FLOPS[torch.bfloat16],
           "peak_mem_gb": acc.max_memory_allocated() / 1e9, "losses": losses, "steps": steps,
           "launches": dict(zip(("flash_fwd", "flash_dq", "flash_dkv"), launches)),
           "launches_per_step": launches[0] / steps, "card": smi}
    log("  training: " + json.dumps(res))
    res["profile"] = profile_training_step(engine, batch)
    del engine
    torch.cuda.empty_cache()
    return res


def profile_training_step(engine, batch) -> dict:
    """One training step under torch.profiler: the device time and the
    kernels that take it; the busy share is that device time over the wall
    time of the next, identical step, not profiled."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(engine.train_batch(batch=batch))
        wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    float(engine.train_batch(batch=batch))
    wall_plain = time.perf_counter() - t0
    # device rows only, without the GPU-side span of a user annotation (the
    # optimizer's ``Optimizer.step#...`` region), which would count the
    # kernels inside it twice
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and not e.key.startswith("Optimizer.step#")]
    dev_us = {e.key: e.self_device_time_total for e in rows}
    busy_ms = sum(dev_us.values()) / 1e3
    top = sorted(((v / 1e3, n) for n, v in dev_us.items() if v > 0), reverse=True)[:10]
    groups = {"flash_fwd": ("flash_fwd_kernel", ), "flash_dq": ("flash_dq_kernel", ),
              "flash_dkv": ("flash_dkv_kernel", ), "gemm": ("nvjet", "gemm", "cutlass", "sm90_xmma"),
              "reduce": ("reduce_kernel", ), "elementwise_copy": ("elementwise", "copy")}
    by_group = {g: 0.0 for g in list(groups) + ["other"]}
    for name, us in dev_us.items():
        g = next((g for g, keys in groups.items() if any(k in name for k in keys)), "other")
        by_group[g] += us / 1e3
    # the same device time by the host operator that launched each kernel
    ops = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CPU
           and e.self_device_time_total > 0]
    top_ops = sorted(((e.self_device_time_total / 1e3, e.key, e.count) for e in ops), reverse=True)[:12]
    res = {"wall_ms": 1e3 * wall_plain, "profiled_wall_ms": 1e3 * wall, "device_ms": busy_ms,
           "device_busy_share": busy_ms / (1e3 * wall_plain), "device_ops": sum(e.count for e in rows),
           "device_ms_by_group": by_group, "top_kernels_ms": [[n[:70], t] for t, n in top],
           "top_host_ops_ms_calls": [[n, t, c] for t, n, c in top_ops]}
    log("  training profile: " + json.dumps(res))
    return res


# ---------------------------------------------------------------- phase 7


QKV = ("q_proj", "k_proj", "v_proj")


def run_steps(engine, batches) -> dict:
    """The first batch's gradients of every q/k/v projection, from the
    engine's own forward (the loss ``train_batch`` differentiates), then one
    ``train_batch`` per batch: its loss and its global grad norm (before
    clipping)."""
    params = {n: p for n, p in engine.module.named_parameters() if n.split(".")[-2] in QKV}
    grads = torch.autograd.grad(engine.forward(batches[0]), list(params.values()))
    run = {"grads": {n: g.float() for n, g in zip(params, grads)}, "losses": [], "grad_norms": []}
    for b in batches:
        run["losses"].append(float(engine.train_batch(batch=b)))
        run["grad_norms"].append(engine.get_global_grad_norm())
    return run


def run_differences(a: dict, b: dict) -> dict:
    """How far run ``a`` is from run ``b``: the largest relative difference
    of a per-step loss and of a per-step global grad norm, and per q/k/v
    leaf the relative L2 distance of the first step's gradients."""

    def rel(x, y):
        return max(abs(u - v) / abs(v) for u, v in zip(x, y))

    return {"loss": rel(a["losses"], b["losses"]), "grad_norm": rel(a["grad_norms"], b["grad_norms"]),
            "qkv_grads": {n: float((g - b["grads"][n]).norm() / b["grads"][n].norm()) for n, g in a["grads"].items()}}


def phase_training_parity_f32() -> dict:
    """3 AdamW steps with clipping, float32, 125M width, 2 layers, B 4, S 512:
    the kernel path against the chunked path on the same weights and
    batches.  The two sum in other orders (the f32 kernels on the CUDA
    cores, the chunked path in cuBLAS f32), so losses, global grad norms and
    the first step's q/k/v gradients agree to 1e-5 relative; a K2 that
    scaled dq, dk or dv, or got one head wrong, moves those gradients by
    percents.  Adam's update is about lr·sign(g) where the gradient is
    small, so a parameter whose gradient is below the two paths' rounding
    difference may step by lr either way: all but 1e-4 of the parameters
    within 2e-5, every one within 2·sum(lr)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama_125m(num_hidden_layers=2, dtype=torch.float32, max_position_embeddings=512)
    ds_config = {"train_batch_size": 4, "gradient_clipping": 1.0,
                 "optimizer": {"type": "AdamW", "params": {"lr": 1e-4, "weight_decay": 0.01}}}
    rng = np.random.default_rng(6)
    batches = []
    for _ in range(3):
        ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 512), dtype=np.int32)).cuda()
        batches.append({"input_ids": ids, "labels": ids})
    state = None
    runs, params = {}, {}
    for impl in ("flash", "chunked"):
        eng = build_trainer(dataclasses.replace(cfg, attention_impl=impl), ds_config, seed=1, state=state)
        if state is None:
            state = {k: v.clone() for k, v in eng.module.state_dict().items()}
        runs[impl] = run_steps(eng, batches)
        params[impl] = {k: v.clone() for k, v in eng.module.state_dict().items()}
        del eng
    d = run_differences(runs["flash"], runs["chunked"])
    diff = torch.cat([(params["flash"][k] - params["chunked"][k]).abs().flatten() for k in params["flash"]])
    res = {"losses_kernel": runs["flash"]["losses"], "losses_plain": runs["chunked"]["losses"],
           "grad_norms_kernel": runs["flash"]["grad_norms"], "grad_norms_plain": runs["chunked"]["grad_norms"],
           "kernel_vs_plain": d, "max_param_abs": float(diff.max()),
           "share_param_beyond_2e-5": float((diff > 2e-5).float().mean())}
    log("  f32 training parity (125M width, 2 layers): " + json.dumps(res))
    if not (d["loss"] <= 1e-5 and d["grad_norm"] <= 1e-5 and max(d["qkv_grads"].values()) <= 1e-5
            and res["share_param_beyond_2e-5"] < 1e-4 and res["max_param_abs"] <= 2 * 3e-4):
        raise AssertionError(f"f32 training parity out of tolerance: {res}")
    torch.cuda.empty_cache()
    return res


def phase_training_parity_bf16() -> dict:
    """3 AdamW steps at Llama-3-8B width (2 layers, GQA 32/8, head dim 128,
    vocab 128256), B 1, S 2048: the bf16 kernel path and the bf16 chunked
    path, both held against the chunked path in float32 on the same
    weights.  Tolerance, as phase 4: the plain path's own bf16 error e (per
    measure: the per-step loss, the per-step global grad norm, and per q/k/v
    leaf the first step's gradients); the kernel path must stay within 2·e
    of the plain path and within 1.5·e of float32."""
    cfg = dataclasses.replace(PRESETS["llama3-8b"], num_hidden_layers=2, remat=True, remat_policy="flash_saveable",
                              attention_impl="flash")
    ds_config = {"train_batch_size": 1, "gradient_clipping": 1.0,
                 "optimizer": {"type": "AdamW", "params": {"lr": 1e-5, "weight_decay": 0.01}}}
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(3):
        ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 2048), dtype=np.int32)).cuda()
        batches.append({"input_ids": ids, "labels": ids})
    model = LlamaForCausalLM(cfg, device="cuda")
    state = init_weights_(model, torch.Generator(device="cuda").manual_seed(2)).state_dict()
    del model
    configs = {"flash": (cfg, {**ds_config, "bf16": {"enabled": True}}),
               "chunked": (dataclasses.replace(cfg, attention_impl="chunked"),
                           {**ds_config, "bf16": {"enabled": True}}),
               "f32": (dataclasses.replace(cfg, attention_impl="chunked", dtype=torch.float32), ds_config)}
    runs = {}
    for name, (c, dsc) in configs.items():
        reset_launch_counts()
        eng = build_trainer(c, dsc, state=state)
        runs[name] = run_steps(eng, batches)
        if (flash_fwd_cuda.launches > 0) != (name == "flash"):
            raise AssertionError(f"{name}: K1 launched {flash_fwd_cuda.launches} times")
        del eng
        torch.cuda.empty_cache()
    res = {"losses": {n: r["losses"] for n, r in runs.items()},
           "grad_norms": {n: r["grad_norms"] for n, r in runs.items()},
           "kernel_vs_plain": run_differences(runs["flash"], runs["chunked"]),
           "kernel_vs_f32": run_differences(runs["flash"], runs["f32"]),
           "plain_vs_f32": run_differences(runs["chunked"], runs["f32"])}
    log("  bf16 training parity (Llama-3-8B width, 2 layers): " + json.dumps(res))
    e, kp, kf = res["plain_vs_f32"], res["kernel_vs_plain"], res["kernel_vs_f32"]
    within = [kp[m] <= 2 * e[m] and kf[m] <= 1.5 * e[m] for m in ("loss", "grad_norm")]
    within += [kp["qkv_grads"][n] <= 2 * e["qkv_grads"][n] and kf["qkv_grads"][n] <= 1.5 * e["qkv_grads"][n]
               for n in e["qkv_grads"]]
    if not (all(np.isfinite(res["losses"]["flash"])) and all(within)):
        raise AssertionError(f"bf16 training parity out of tolerance: {res}")
    return res


# ---------------------------------------------------------------- phase 8

# BERT-large's attention (deepspeed_tpu/models/bert.py: 16 heads of 64) at a
# 4096-token context (its 512 learned positions tiled by
# extend_position_embedding), bf16
SPARSE_B, SPARSE_H, SPARSE_S, SPARSE_D, SPARSE_BLOCK = 4, 16, 4096, 64, 16
#: the ``sparse_attention`` block of DeepSpeed's config documentation
#: (config-json, "Sparse Attention")
DOC_SPARSE_ATTENTION = {"mode": "fixed", "block": 16, "different_layout_per_head": True, "num_local_blocks": 4,
                        "num_global_blocks": 1, "attention": "bidirectional", "horizontal_global_attention": False,
                        "num_different_global_patterns": 4}
SPARSE_NAMES = ("sparse_attn_fwd", "sparse_attn_dq", "sparse_attn_dkv")


def sparse_configs(h: int, block: int) -> dict:
    """name → (sparsity config, causal) of the layouts phase 8 checks."""
    return {
        "fixed": (make_sparsity_config({**DOC_SPARSE_ATTENTION, "block": block}, num_heads=h), False),
        "fixed_uni": (FixedSparsityConfig(h, block, True, num_local_blocks=4, num_global_blocks=1,
                                          attention="unidirectional", num_different_global_patterns=4), True),
        "bigbird": (BigBirdSparsityConfig(h, block, True, num_random_blocks=1, num_sliding_window_blocks=3,
                                          num_global_blocks=1), False),
        "bslongformer": (BSLongformerSparsityConfig(h, block, True, num_sliding_window_blocks=3,
                                                    global_block_indices=[0]), False),
        "variable": (VariableSparsityConfig(h, block, True, num_random_blocks=1, local_window_blocks=[2, 4],
                                            global_block_indices=[0]), False),
        "local": (LocalSlidingWindowSparsityConfig(h, block, num_sliding_window_blocks=3), True),
        "dense": (DenseSparsityConfig(h, block), False),
    }


def sparse_inputs(b, h, s, d, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((b, h, s, d), generator=gen, device="cuda").to(dtype) for _ in range(4)]


def sparse_kernels(q, k, v, do, tables, block, causal, kpm=None) -> dict:
    """K6a, then K6b and K6c from its outputs."""
    o, lse = sparse_attn_fwd_cuda(q, k, v, tables, block, causal, None, kpm)
    dq, delta = sparse_attn_dq_cuda(q, k, v, o, lse, do, tables, block, causal, None, kpm)
    dk, dv = sparse_attn_dkv_cuda(q, k, v, do, lse, delta, tables, block, causal, None, kpm)
    return {"o": o, "lse": lse, "dq": dq, "delta": delta, "dk": dk, "dv": dv}


def sparse_plain(q, k, v, do, got, tables, block, causal, kpm=None) -> dict:
    """The plain versions on the same inputs; the backward from the kernel's
    o and lse, as K6b and K6c take them."""
    o, lse = sparse_attn_fwd_plain(q, k, v, tables, block, causal, None, kpm)
    dq, dk, dv = sparse_attn_bwd_plain(q, k, v, got["o"], got["lse"], do, tables, block, causal, None, kpm)
    return {"o": o, "lse": lse, "dq": dq, "delta": sparse_attn_delta_plain(got["o"], do), "dk": dk, "dv": dv}


def sparse_ratio(name: str, got: torch.Tensor, want: torch.Tensor, tol: dict) -> float:
    """``tolerance_ratio`` of one output; lse is held on the rows that attend
    to a key, and must read exactly 3e38 on the others."""
    if name in ("lse", "delta"):
        live = want != EMPTY_ROW_LSE
        if not torch.equal(got[~live], want[~live]):
            return float("inf")
        return tolerance_ratio(got[live], want[live], tol, vector=False) if bool(live.any()) else 0.0
    return tolerance_ratio(got, want, tol, vector=True)


def sparse_mutants(q, k, v, layout, block, causal, kpm, got, tables) -> dict:
    """Faulty kernels the check must reject, made from the kernel's outputs,
    as name → (output, faulty tensor): K6a that drops the first admitted kv
    block of the first row block (of head 0) that admits two; K6b that zeroes
    that row block's dq; K6c that zeroes dk and dv of head 0's widest column
    (a global column where the layout has one); and, where a column group
    holds two blocks or more, K6c that loses the dk of its second member."""
    counts = layout[0].sum(-1)
    r = int(np.argmax(counts >= 2))
    cut = layout[:1].copy()
    cut[0, r, np.nonzero(layout[0, r])[0][0]] = 0
    o_cut, lse_cut = sparse_attn_fwd_plain(q[:, :1], k[:, :1], v[:, :1], build_tables(cut, block, "cuda"), block,
                                           causal, None, kpm)
    rows = slice(r * block, (r + 1) * block)
    out = {n: got[n].clone() for n in ("o", "lse", "dq", "dk", "dv")}
    out["o"][:, 0, rows], out["lse"][:, 0, rows] = o_cut[:, 0, rows], lse_cut[:, 0, rows]
    out["dq"][:, 0, rows] = 0
    c = int(np.argmax(layout[0].sum(-2)))
    out["dk"][:, 0, c * block:(c + 1) * block] = 0
    out["dv"][:, 0, c * block:(c + 1) * block] = 0
    faulty = {n: (n, t) for n, t in out.items()}
    groups = tables.col_groups.cpu().numpy()
    multi = groups[(groups >= 0).sum(1) >= 2]
    if len(multi):
        h, blk = divmod(int(multi[0, 1]), layout.shape[1])
        dk = got["dk"].clone()
        dk[:, h, blk * block:(blk + 1) * block] = 0
        faulty["dk_group_member"] = ("dk", dk)
    return faulty


def sparse_case(label, cfg, causal, b, s, d, dtype, kpm=None, mutants=True, empty_rows=False) -> dict:
    """Hold K6a/K6b/K6c to their plain versions on one layout; with
    ``mutants``, fail unless the check rejects each faulty kernel.  A row
    with no visible key must get exactly 0 in o (and 3e38 in lse, see
    ``sparse_ratio``); with ``empty_rows`` the case must have such rows.
    Returns per kernel the largest |kernel − plain|."""
    h, block = cfg.num_heads, cfg.block
    layout = np.asarray(cfg.make_layout(s))
    tables = build_tables(layout, block, "cuda")
    q, k, v, do = sparse_inputs(b, h, s, d, dtype, seed=s + d + block + int(causal))
    got = sparse_kernels(q, k, v, do, tables, block, causal, kpm)
    want = sparse_plain(q, k, v, do, got, tables, block, causal, kpm)
    torch.cuda.synchronize()
    tol = FLASH_TOL[dtype]
    ratios = {n: sparse_ratio(n, got[n], want[n], tol) for n in got}
    log(f"  {label}: density {layout.mean():.4f}, |err|/limit " + ", ".join(f"{n}={r:.3g}" for n, r in ratios.items()))
    bad = {n: r for n, r in ratios.items() if not r <= 1}
    if bad:
        raise AssertionError(f"{label}: kernel disagrees with the plain version, |err|/limit {bad}")
    empty = want["lse"] == EMPTY_ROW_LSE
    if bool(got["o"][empty].any()):
        raise AssertionError(f"{label}: a row with no visible key got a nonzero o")
    if empty_rows and not bool(empty.any()):
        raise AssertionError(f"{label}: the case has no row without a visible key")
    # a kv block no row admits gets zero dk/dv
    dead_cols = torch.from_numpy(layout.sum(-2) == 0).cuda().repeat_interleave(block, dim=1)   # [H, S]
    if bool(dead_cols.any()) and (got["dk"][:, dead_cols].any() or got["dv"][:, dead_cols].any()):
        raise AssertionError(f"{label}: a kv block no row admits got nonzero dk/dv")
    # a second launch of K6b and K6c gives bit-identical dq, delta, dk and dv
    again = sparse_attn_dq_cuda(q, k, v, got["o"], got["lse"], do, tables, block, causal, None, kpm)
    again += sparse_attn_dkv_cuda(q, k, v, do, got["lse"], got["delta"], tables, block, causal, None, kpm)
    torch.cuda.synchronize()
    if not all(torch.equal(a, got[n]) for a, n in zip(again, ("dq", "delta", "dk", "dv"))):
        raise AssertionError(f"{label}: two launches of K6b/K6c differ")
    if mutants:
        faulty = sparse_mutants(q, k, v, layout, block, causal, kpm, got, tables)
        caught = {n: sparse_ratio(out, m, want[out], tol) for n, (out, m) in faulty.items()}
        log(f"  {label}: faulty kernels' |err|/limit " + ", ".join(f"{n}={r:.3g}" for n, r in caught.items()))
        if not all(r > 1 for r in caught.values()):
            raise AssertionError(f"{label}: the check passes a faulty kernel: {caught}")
    outs = {"sparse_attn_fwd": ("o", "lse"), "sparse_attn_dq": ("dq", "delta"), "sparse_attn_dkv": ("dk", "dv")}
    return {kname: max(float((got[n].float() - want[n].float()).abs().max()) for n in names)
            for kname, names in outs.items()}


def visible_pairs(layout: np.ndarray, block: int, causal: bool) -> int:
    """(query, key) token pairs the layout lets attend, per batch row: a whole
    block for an admitted block, its lower triangle on the diagonal and
    nothing above it with causal."""
    if not causal:
        return int(layout.astype(bool).sum()) * block * block
    h, r, c = np.nonzero(layout)
    return int((c < r).sum()) * block * block + int((c == r).sum()) * block * (block + 1) // 2


def sparse_bounds(layout, block, b, d, causal, tables, dtype) -> dict:
    """Least time of each kernel: each input read once (the index tables
    included) and each output written once, against 4/6/8·D flops per
    visible pair (QK+PV; QK, dO·Vᵀ, dS·K; QK, dO·Vᵀ, Pᵀ·dO, dSᵀ·Q) at the
    bf16 tensor-core peak."""
    h, nb, _ = layout.shape
    x = b * h * nb * block * d * (torch.finfo(dtype).bits // 8)      # one [B, H, S, D] tensor
    st = b * h * nb * block * 4                                        # one [B, H, S] f32 statistic
    def table_bytes(*ts):
        return 4 * sum(t.numel() for t in ts)

    rows = table_bytes(tables.row_ptr, tables.row_idx, tables.row_order)
    # the bf16 K6b and K6c read the group tables in place of the order tables
    row_groups = table_bytes(tables.row_ptr, tables.row_idx, tables.row_groups, tables.row_group_order)
    col_groups = table_bytes(tables.col_ptr, tables.col_idx, tables.col_groups, tables.col_group_order)
    nbytes = {"sparse_attn_fwd": 3 * x + rows + x + st,                # q k v → o lse
              "sparse_attn_dq": 5 * x + st + row_groups + x + st,      # q k v o do lse → dq delta
              "sparse_attn_dkv": 4 * x + 2 * st + col_groups + 2 * x}  # q k v do lse delta → dk dv
    pairs = b * visible_pairs(layout, block, causal)
    out = {}
    for name, per_pair in zip(SPARSE_NAMES, (4, 6, 8)):
        t_bytes = nbytes[name] / HBM_BYTES_PER_S * 1e3
        t_ops = per_pair * d * pairs / PEAK_FLOPS[torch.bfloat16] * 1e3
        out[name] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return out


def sparse_timing(label, cfg, causal, flush, plain=True, library=True, tables=None) -> dict:
    """Kernel (cold L2), plain and library time of K6a/K6b/K6c at the full
    configuration, beside each kernel's bound."""
    b, s, d, dtype = SPARSE_B, SPARSE_S, SPARSE_D, torch.bfloat16
    block = cfg.block
    layout = np.asarray(cfg.make_layout(s))
    tables = tables if tables is not None else build_tables(layout, block, "cuda")
    q, k, v, do = sparse_inputs(b, cfg.num_heads, s, d, dtype, seed=1)
    got = sparse_kernels(q, k, v, do, tables, block, causal)
    rows = {n: {"case": label, "density": float(layout.mean())} for n in SPARSE_NAMES}
    for name, (t, by) in sparse_bounds(layout, block, b, d, causal, tables, dtype).items():
        rows[name].update(bound_ms=t, bound_by=by)
    rows["sparse_attn_fwd"]["ms"] = time_ms(lambda: sparse_attn_fwd_cuda(q, k, v, tables, block, causal), 10, flush)
    rows["sparse_attn_dq"]["ms"] = time_ms(
        lambda: sparse_attn_dq_cuda(q, k, v, got["o"], got["lse"], do, tables, block, causal), 10, flush)
    rows["sparse_attn_dkv"]["ms"] = time_ms(
        lambda: sparse_attn_dkv_cuda(q, k, v, do, got["lse"], got["delta"], tables, block, causal), 10, flush)
    if plain:
        rows["sparse_attn_fwd"]["plain_ms"] = time_ms(
            lambda: sparse_attn_fwd_plain(q, k, v, tables, block, causal), 3, flush)
        # the plain backward computes dq, dk and dv in one call: its time
        # stands beside both backward kernels
        bwd_ms = time_ms(lambda: sparse_attn_bwd_plain(q, k, v, got["o"], got["lse"], do, tables, block, causal), 3,
                         flush)
        rows["sparse_attn_dq"]["plain_ms"] = rows["sparse_attn_dkv"]["plain_ms"] = bwd_ms
    if library:
        # SDPA on the same [B, H, S, D] tensors with the layout expanded to a
        # boolean token mask [1, H, S, S] (built outside the timing); its
        # backward (dq, dk, dv together) by autograd.grad
        mask = torch.from_numpy(layout != 0).cuda().repeat_interleave(block, 1).repeat_interleave(block, 2)
        if causal:
            mask &= torch.ones((s, s), dtype=torch.bool, device="cuda").tril()
        qs, ks, vs = (x.detach().clone().requires_grad_() for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        with torch.no_grad():
            rows["sparse_attn_fwd"]["library_ms"] = time_ms(lambda: sdpa(qs, ks, vs, attn_mask=mask[None]), 10, flush)
        out = sdpa(qs, ks, vs, attn_mask=mask[None])
        lib_bwd = time_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), do, retain_graph=True), 10, flush)
        rows["sparse_attn_dq"]["library_ms"] = rows["sparse_attn_dkv"]["library_ms"] = lib_bwd
        del mask, out
    for name, row in rows.items():
        log(f"  {name} {label}: " + ", ".join(f"{k_}={v_:.4g}" if isinstance(v_, float) else f"{k_}={v_}"
                                             for k_, v_ in row.items() if k_ != "case"))
    return rows


def phase_sparse_kernels() -> dict:
    b, h, s, d = SPARSE_B, SPARSE_H, SPARSE_S, SPARSE_D
    errs = {n: 0.0 for n in SPARSE_NAMES}

    def check(*args, **kwargs):
        for n, e in sparse_case(*args, **kwargs).items():
            errs[n] = max(errs[n], e)

    # the documented example's groups: the 4 rows of a local window admit one
    # list, as do the 3 plain columns of a window and a head's 64 global columns
    t = build_tables(sparse_configs(h, SPARSE_BLOCK)["fixed"][0].make_layout(s), SPARSE_BLOCK, "cuda")
    groups = {"row_groups": t.row_groups.shape[0], "col_groups": t.col_groups.shape[0],
              "row_blocks": t.row_order.numel()}
    log(f"  fixed S{s} block {SPARSE_BLOCK}: CTAs of the bf16 K6b/K6c per batch row " + json.dumps(groups))
    if (groups["row_groups"], groups["col_groups"]) != (1024, 1280):
        raise AssertionError(f"fixed layout groups {groups}, expected 1024 row and 1280 column groups")
    for name, (cfg, causal) in sparse_configs(h, SPARSE_BLOCK).items():
        check(f"{name} bf16 B{b} S{s} D{d} block {SPARSE_BLOCK}", cfg, causal, b, s, d, torch.bfloat16)
    # padded sequences: the last 10% of batch row 1's keys and a scattered 5% of row 3's
    kpm = torch.ones((b, s), dtype=torch.bool, device="cuda")
    kpm[1, -s // 10:] = False
    kpm[3] = torch.rand(s, generator=torch.Generator(device="cuda").manual_seed(3), device="cuda") > 0.05
    for name in ("fixed", "fixed_uni"):
        cfg, causal = sparse_configs(h, SPARSE_BLOCK)[name]
        check(f"{name} bf16 key_padding_mask", cfg, causal, b, s, d, torch.bfloat16, kpm=kpm)
    # rows with no visible key: kpm masks batch row 2 whole and keys 1024..2047
    # of row 0, which hold every key the local window admits to the rows of
    # blocks 65..127
    kpm_empty = torch.ones((b, s), dtype=torch.bool, device="cuda")
    kpm_empty[2] = False
    kpm_empty[0, 1024:2048] = False
    cfg, causal = sparse_configs(h, SPARSE_BLOCK)["local"]
    check("local bf16 key_padding_mask, rows with no visible key", cfg, causal, b, s, d, torch.bfloat16,
          kpm=kpm_empty, empty_rows=True)
    for name, (cfg, causal) in sparse_configs(h, SPARSE_BLOCK).items():
        check(f"{name} f32 S1024", cfg, causal, b, 1024, d, torch.float32, mutants=False)
    for dtype in (torch.bfloat16, torch.float32):
        for name in ("fixed", "fixed_uni"):
            cfg, causal = sparse_configs(h, 64)[name]
            check(f"{name} {str(dtype)[6:]} D128 block 64", cfg, causal, b, s, 128, dtype,
                  mutants=dtype == torch.bfloat16)
    # K6a's tiles of 2 and 4 warps: block 32, and block 128 (two sub-tiles of 64)
    for block in (32, 128):
        cfg, causal = sparse_configs(h, block)["fixed_uni"]
        check(f"fixed_uni bf16 D128 block {block}", cfg, causal, b, s, 128, torch.bfloat16)
    log(f"  max |kernel - plain|: " + json.dumps(errs))

    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    timed = {}
    for name in ("fixed", "bigbird"):
        cfg, causal = sparse_configs(h, SPARSE_BLOCK)[name]
        timed[name] = sparse_timing(name, cfg, causal, flush)
    # the straggler: BSLongformer's global row and column admit all 256
    # blocks, a local window of the same density admits at most 5; both
    # launched heaviest first, and BSLongformer also in table order
    straggler = {}
    cfg_g, _ = sparse_configs(h, SPARSE_BLOCK)["bslongformer"]
    cfg_l = LocalSlidingWindowSparsityConfig(h, SPARSE_BLOCK, num_sliding_window_blocks=5, attention="bidirectional")
    straggler["bslongformer"] = sparse_timing("bslongformer", cfg_g, False, flush, plain=False, library=False)
    straggler["local5"] = sparse_timing("local5", cfg_l, False, flush, plain=False, library=False)
    t = build_tables(cfg_g.make_layout(s), SPARSE_BLOCK, "cuda")

    def natural(order):
        return torch.arange(order.numel(), dtype=torch.int32, device="cuda")

    straggler["bslongformer_table_order"] = sparse_timing(
        "bslongformer table order", cfg_g, False, flush, plain=False, library=False,
        tables=dataclasses.replace(t, row_order=natural(t.row_order), col_order=natural(t.col_order),
                                   row_group_order=natural(t.row_group_order),
                                   col_group_order=natural(t.col_group_order)))
    share = {n: 1 - straggler["local5"][n]["ms"] / straggler["bslongformer"][n]["ms"] for n in SPARSE_NAMES}
    log("  straggler share (1 - local5 / bslongformer): " + json.dumps(share))
    del flush
    torch.cuda.empty_cache()
    return {"errs": errs, "timed": timed, "straggler": straggler, "straggler_share": share, "groups": groups}


# ---------------------------------------------------------------- phase 9


def phase_sparse_path(smi: str) -> dict:
    """The sparse path through its entry points, as a user would call it:
    the DeepSpeed config's ``sparse_attention`` block → a sparsity config →
    ``SparseSelfAttention`` forward and backward on CUDA tensors.  Each
    iteration's wall time ends in a synchronize; the first one also builds
    the layout, its index tables and the ops' dispatch state."""
    b, h, s, d = SPARSE_B, SPARSE_H, SPARSE_S, SPARSE_D
    ds_config = DeepSpeedConfig({"train_batch_size": b, "bf16": {"enabled": True},
                                 "sparse_attention": dict(DOC_SPARSE_ATTENTION)})
    sparsity = make_sparsity_config(ds_config.sparse_attention, num_heads=h)
    attn = SparseSelfAttention(sparsity)
    # BERT-large's 512 learned positions tiled to the 4096-token context
    pos = extend_position_embedding(torch.randn((512, h * d), device="cuda", dtype=torch.bfloat16), s)
    if tuple(pos.shape) != (s, h * d) or not torch.equal(pos[512:1024], pos[:512]):
        raise AssertionError(f"extend_position_embedding gave {tuple(pos.shape)}")
    gen = torch.Generator(device="cuda").manual_seed(9)
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda").to(torch.bfloat16).requires_grad_()
               for _ in range(3))
    do = torch.randn((b, h, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    acc = get_accelerator()
    acc.synchronize()
    acc.reset_peak_memory_stats()
    reset_launch_counts()
    iters, walls = 3, []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = attn(q, k, v)
        grads = torch.autograd.grad(out, (q, k, v), do)
        acc.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    launches = {n: fn.launches for n, fn in zip(SPARSE_NAMES, (sparse_attn_fwd_cuda, sparse_attn_dq_cuda,
                                                                sparse_attn_dkv_cuda))}
    if list(launches.values()) != [iters] * 3:
        raise AssertionError(f"K6a/K6b/K6c launched {launches} times over {iters} forward and backward calls")
    if any(fn.launches for fn in (paged_attention_cuda, flash_fwd_cuda, flash_dq_cuda, flash_dkv_cuda)):
        raise AssertionError("the sparse path launched a dense attention kernel")
    if tuple(out.shape) != (b, h, s, d) or not all(bool(torch.isfinite(t).all()) for t in (out, *grads)):
        raise AssertionError("the sparse path gave non-finite outputs or gradients")
    # the path's outputs against the plain versions on the same inputs
    tables = attn.get_sparse_layout(s).tables("cuda")
    want_o, _ = sparse_attn_fwd_plain(q.detach(), k.detach(), v.detach(), tables, sparsity.block)
    o, lse = sparse_attn_fwd_cuda(q.detach(), k.detach(), v.detach(), tables, sparsity.block)
    want_grads = sparse_attn_bwd_plain(q.detach(), k.detach(), v.detach(), o, lse, do, tables, sparsity.block)
    tol = FLASH_TOL[torch.bfloat16]
    ratios = {n: tolerance_ratio(g, w, tol, vector=True)
              for n, g, w in zip(("o", "dq", "dk", "dv"), (out.detach(), *grads), (want_o, *want_grads))}
    if not all(r <= 1 for r in ratios.values()):
        raise AssertionError(f"the sparse path disagrees with the plain versions: |err|/limit {ratios}")
    res = {"config": ds_config.sparse_attention, "shape": [b, h, s, d], "density": float(attn.get_layout(s).mean()),
           "launches": launches, "iters": iters, "wall_ms_per_iter": walls, "ratios": ratios,
           "peak_mem_gb": acc.max_memory_allocated() / 1e9, "card": smi}
    log("  sparse path: " + json.dumps(res))
    res["profile"] = profile_sparse_iteration(attn, q, k, v, do)
    return res


def launch_events(fn):
    """Run ``fn`` with a pair of CUDA events recorded on the launch stream
    around every K6a/K6b/K6c launch (the wrappers' ``_launch``): returns
    ``fn``'s result and [(kernel, start, end)] in launch order, to be read
    after a synchronize."""
    from deepspeed_tpu_torch.ops.sparse_attention import kernel as sk
    marks, launch = [], sk._launch

    def timed(name, f, q, *args):
        stream = torch.cuda.current_stream(q.device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
        launch(name, f, q, *args)
        end.record(stream)
        marks.append((name.replace("_cuda", ""), start, end))

    sk._launch = timed
    try:
        return fn(), marks
    finally:
        sk._launch = launch


def profile_sparse_iteration(attn, q, k, v, do) -> dict:
    """One forward and backward, its kernels timed in the path: each K6a,
    K6b and K6c launch between two CUDA events on its stream, and the span
    from the iteration's first event to its last.  The busy share is the
    kernels' device time over the wall time of the next, identical
    iteration.  torch.profiler, over a third iteration, adds the device time
    by kernel where it records device events (as the third profiler session
    of the whole script it records none)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    _, marks = launch_events(lambda: torch.autograd.grad(attn(q, k, v), (q, k, v), do))
    torch.cuda.synchronize()
    kernel_ms = {n: s_.elapsed_time(e) for n, s_, e in marks}
    if sorted(kernel_ms) != sorted(SPARSE_NAMES) or len(marks) != 3:
        raise AssertionError(f"one iteration launched {[m[0] for m in marks]}, expected one each of {SPARSE_NAMES}")
    span_ms = marks[0][1].elapsed_time(marks[-1][2])
    t0 = time.perf_counter()
    torch.autograd.grad(attn(q, k, v), (q, k, v), do)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.autograd.grad(attn(q, k, v), (q, k, v), do)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    top = sorted(((e.self_device_time_total / 1e3, e.key) for e in rows if e.self_device_time_total > 0),
                 reverse=True)[:6]
    res = {"kernel_ms": kernel_ms, "kernels_ms": sum(kernel_ms.values()), "device_span_ms": span_ms,
           "wall_ms": wall_ms, "device_busy_share": sum(kernel_ms.values()) / wall_ms,
           "profiler_device_ops": sum(e.count for e in rows), "profiler_top_kernels_ms": [[n[:70], t] for t, n in top]}
    log("  sparse path profile: " + json.dumps(res))
    return res


# ---------------------------------------------------------------- phase 10

QUANT_N = 32000 * 768     # the embedding (and lm_head) of Llama-125M: its largest gradient
QUANT_BLOCK = 256
QUANT_NAMES = ("quantize_int8", "dequantize_int8", "quantize_int4", "dequantize_int4")
QUANT_REPLACES = {"quantize_int8": "deepspeed_tpu/ops/quant_kernels.py:31",
                  "dequantize_int8": "deepspeed_tpu/ops/quant_kernels.py:39",
                  "quantize_int4": "deepspeed_tpu/ops/quant_kernels.py:44",
                  "dequantize_int4": "deepspeed_tpu/ops/quant_kernels.py:56"}


def quant_input(n: int, dtype: torch.dtype, seed: int) -> torch.Tensor:
    """Gradient-like values in blocks of 256 at scales 1e-6..1e2, block 1 all
    zero, block 2 x/scale ties for int8 (absmax 127: scale exactly 1) and
    block 3 for int4 (absmax 7)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    nb = n // QUANT_BLOCK
    scale = 10.0**(torch.rand((nb, 1), generator=gen, device="cuda") * 8 - 6)
    x = torch.randn((nb, QUANT_BLOCK), generator=gen, device="cuda") * scale
    x[1] = 0
    j = torch.arange(QUANT_BLOCK, device="cuda")
    sign = 1 - 2 * (j % 2)
    for row, qmax in ((2, 127), (3, 7)):
        x[row] = (j % qmax + 0.5) * sign
        x[row, 0] = qmax
    return x.reshape(-1).to(dtype)


def quant_check(label: str, x: torch.Tensor) -> dict:
    """The four kernels on ``x`` against their plain versions on the same
    CUDA tensors: codes, scales and dequantized values must be identical.
    The dequantize kernels run at the shape the W=2 wire gives them,
    [2·nb/2, 256] into [2, n/2].  Returns per kernel the largest
    |kernel − plain| (0 when they agree)."""
    n = x.numel()
    out = {}
    for bits, quant, dequant in ((8, quantize_int8_cuda, dequantize_int8_cuda),
                                 (4, quantize_int4_cuda, dequantize_int4_cuda)):
        pq, pd = (quantize_int8_plain, dequantize_int8_plain) if bits == 8 else (quantize_int4_plain,
                                                                                 dequantize_int4_plain)
        q, s = quant(x, QUANT_BLOCK)
        want_q, want_s = pq(x, QUANT_BLOCK)
        shape = (2, n // 2) if n % (2 * QUANT_BLOCK) == 0 else (n, )
        deq = dequant(q, s, shape)
        want_deq = pd(q, s, shape)
        torch.cuda.synchronize()
        same = torch.equal(q, want_q) and torch.equal(s, want_s) and torch.equal(deq, want_deq)
        out[f"quantize_int{bits}"] = max(float((q.int() - want_q.int()).abs().max()), float((s - want_s).abs().max()))
        out[f"dequantize_int{bits}"] = float((deq - want_deq).abs().max())
        if not same or not bool(torch.isfinite(deq).all()):
            raise AssertionError(f"{label}: int{bits} kernels differ from the plain versions: {out}")
    log(f"  {label}: n {n}, codes, scales and dequantized values identical to the plain versions")
    return out


def quant_mutants(x: torch.Tensor) -> dict:
    """Faulty kernels the check must reject, made from the kernels' outputs:
    K4a that rounds x/scale half away from zero, and K5a that swaps the
    halves of its bytes (element i in the high nibble, i + 128 in the low)."""
    q8, s8 = quantize_int8_cuda(x, QUANT_BLOCK)
    r = x.float().reshape(-1, QUANT_BLOCK) / s8[:, None]
    away = torch.clamp(torch.sign(r) * torch.floor(r.abs() + 0.5), -127, 127).to(torch.int8)
    q4, _ = quantize_int4_cuda(x, QUANT_BLOCK)
    swapped = (q4 >> 4) | (q4 << 4)
    want8, _ = quantize_int8_plain(x, QUANT_BLOCK)
    want4, _ = quantize_int4_plain(x, QUANT_BLOCK)
    torch.cuda.synchronize()
    caught = {"round_half_away": not torch.equal(away, want8), "int4_halves_swapped": not torch.equal(swapped, want4),
              "codes_off_by_round_half_away": int((away != want8).sum()),
              "bytes_off_by_swap": int((swapped != want4).sum())}
    log(f"  faulty kernels: {json.dumps(caught)}")
    if not (caught["round_half_away"] and caught["int4_halves_swapped"]):
        raise AssertionError(f"the check passes a faulty quant kernel: {caught}")
    return caught


def quant_bounds(n: int, in_bytes: int) -> dict:
    """Least time of each kernel at n elements: its input read once and its
    output written once at the HBM rate (a few operations per element: all
    four are bound by bytes)."""
    scales = 4 * (n // QUANT_BLOCK)
    nbytes = {"quantize_int8": in_bytes * n + n + scales, "dequantize_int8": n + scales + 4 * n,
              "quantize_int4": in_bytes * n + n // 2 + scales, "dequantize_int4": n // 2 + scales + 4 * n}
    return {k: (v / HBM_BYTES_PER_S * 1e3, "bytes") for k, v in nbytes.items()}


def llama_125m_wire_shapes() -> list:
    """The shapes of Llama-125M's 111 gradients as the qgZ wire carries them
    (the engine's order; ``nn.Linear`` weights transposed)."""
    model = LlamaForCausalLM(llama_125m(), device="meta")
    linear = {id(m.weight) for m in model.modules() if isinstance(m, torch.nn.Linear)}
    return [tuple(p.t().shape) if id(p) in linear else tuple(p.shape) for p in model.parameters()
            if p.is_floating_point()]


def grouped_step_bounds(table: SegmentTable, in_bytes: int) -> dict:
    """Least time of one qgZ step's grouped launches: K4a over the step's
    tensors (``in_bytes`` an element, unpadded: the padding is not read) and
    over the f32 shards; K4b over the received copies (identity) and the
    gathered codes (into f32 tensors, cut).  Each input read once, each
    output written once, at the HBM rate."""
    rows, shard_rows, b = table.rows, table.chunk, table.block
    k4a = in_bytes * table.total + rows * (b + 4) + shard_rows * (4 * b + b + 4)
    k4b = rows * (b + 4) + 4 * rows * b + rows * (b + 4) + 4 * table.total
    return {"quantize_int8": k4a / HBM_BYTES_PER_S * 1e3, "dequantize_int8": k4b / HBM_BYTES_PER_S * 1e3}


def grouped_mutants(x, table, q, s, through) -> dict:
    """Faulty grouped kernels the check must reject: K4a that ignores each
    tensor's end (a block past n_t reads the next tensor's elements, not
    zeros: the real kernel fed a table whose counts are the padded ones, over
    an input with room behind it), and K4b that writes rank 1's chunk where
    rank 0's belongs (the real kernel fed the code rows with the two chunks
    swapped)."""
    want_q, want_s = quantize_int8_grouped_plain(x, table)
    want_out = dequantize_int8_grouped_plain(want_q, want_s, table, through)
    ignore_ends = copy.copy(table)
    records, row_segments = table.device_tables(x.device)
    records = records.clone()
    records[:, 0] = torch.tensor([c * table.world * table.block for c in table.chunk_rows], device=x.device)
    ignore_ends._on_device = {x.device: (records, row_segments)}
    roomy = torch.cat([x, torch.zeros(table.world * table.block, dtype=x.dtype, device=x.device)])[:table.total]
    bad_q, bad_s = quantize_int8_cuda(roomy, table.block, ignore_ends)
    c = table.chunk
    swapped = dequantize_int8_cuda(torch.cat([q[c:2 * c], q[:c], q[2 * c:]]),
                                   torch.cat([s[c:2 * c], s[:c], s[2 * c:]]), (table.total, ), table, through)
    torch.cuda.synchronize()
    caught = {"k4a_ignores_tensor_ends": not (torch.equal(bad_q, want_q) and torch.equal(bad_s, want_s)),
              "k4b_rank_chunks_swapped": not torch.equal(swapped, want_out),
              "rows_off_by_ignored_ends": int((bad_q != want_q).any(dim=1).sum()),
              "values_off_by_swap": int((swapped != want_out).sum())}
    log(f"  faulty grouped kernels: {json.dumps(caught)}")
    if not (caught["k4a_ignores_tensor_ends"] and caught["k4b_rank_chunks_swapped"]):
        raise AssertionError(f"the check passes a faulty grouped quant kernel: {caught}")
    return caught


def quant_step(flush) -> dict:
    """One qgZ step's grouped launches on the step's real table (the 111
    Llama-125M gradients at W 2, bf16 input as the bench configuration sends
    them): the send buffer (K4a), the received copies (K4b, identity), the
    f32 shards (K4a, identity) and the gathered tensors (K4b, through bf16),
    each bit-identical to its plain version; two faulty grouped kernels;
    per-step device ms (each launch cold) beside the per-step bound."""
    table = SegmentTable([int(np.prod(s)) for s in llama_125m_wire_shapes()], DP_WORLD, QUANT_BLOCK)
    x = quant_input(table.rows * QUANT_BLOCK, torch.float32, seed=14)[:table.total]
    x = x.to(torch.bfloat16)
    q, s = quantize_int8_cuda(x, QUANT_BLOCK, table)
    received = (DP_WORLD, table.chunk * QUANT_BLOCK)
    recv = dequantize_int8_cuda(q, s, received)
    reduced = recv.sum(dim=0) / torch.full_like(recv[0], DP_WORLD)
    q2, s2 = quantize_int8_cuda(reduced, QUANT_BLOCK)
    out = dequantize_int8_cuda(q, s, (table.total, ), table, torch.bfloat16)
    torch.cuda.synchronize()
    want_q, want_s = quantize_int8_grouped_plain(x, table)
    want_q2, want_s2 = quantize_int8_plain(reduced, QUANT_BLOCK)
    same = {"send": torch.equal(q, want_q) and torch.equal(s, want_s),
            "received": torch.equal(recv, dequantize_int8_plain(want_q, want_s, received)),
            "shards": torch.equal(q2, want_q2) and torch.equal(s2, want_s2),
            "gathered": torch.equal(out, dequantize_int8_grouped_plain(want_q, want_s, table, torch.bfloat16))}
    if not all(same.values()) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"grouped quant kernels differ from their plain versions on the step's table: {same}")
    log(f"  step table: {len(table)} tensors, {table.total} elements, {table.rows} code rows (chunk {table.chunk}); "
        f"grouped K4a/K4b identical to the plain versions: {json.dumps(same)}")
    mutants = grouped_mutants(x, table, q, s, torch.bfloat16)
    launches = {"k4a_send": lambda: quantize_int8_cuda(x, QUANT_BLOCK, table),
                "k4b_received": lambda: dequantize_int8_cuda(q, s, received),
                "k4a_shards": lambda: quantize_int8_cuda(reduced, QUANT_BLOCK),
                "k4b_gathered": lambda: dequantize_int8_cuda(q, s, (table.total, ), table, torch.bfloat16)}
    ms = {k: time_ms(fn, 10, flush) for k, fn in launches.items()}
    bounds = grouped_step_bounds(table, 2)
    step = {"quantize_int8": ms["k4a_send"] + ms["k4a_shards"],
            "dequantize_int8": ms["k4b_received"] + ms["k4b_gathered"]}
    res = {"tensors": len(table), "elements": table.total, "rows": table.rows, "launch_ms": ms, "step_ms": step,
           "step_bound_ms": bounds, "step_bound_ms_f32_input": grouped_step_bounds(table, 4),
           "codec_ms": sum(ms.values()), "codec_bound_ms": sum(bounds.values()), "mutants": mutants}
    log("  grouped step: " + json.dumps({k: v for k, v in res.items() if k != "mutants"}))
    return res


def phase_quant_kernels() -> dict:
    """K4a/K4b/K5a/K5b against their plain versions at the wire's shapes:
    the embedding's 24,576,000 elements in f32 and bf16, a 768-element norm
    weight padded to 1024, an nb (1001) that is not a multiple of the 8
    blocks of a CTA; two faulty kernels must be rejected; kernel / plain time
    (cold L2) at the embedding's shape beside the bound; then the grouped
    K4a/K4b on one qgZ step's real table (``quant_step``)."""
    x = quant_input(QUANT_N, torch.float32, seed=10)
    errs = quant_check("embedding f32", x)
    for label, t in (("embedding bf16", quant_input(QUANT_N, torch.bfloat16, seed=11)),
                     ("norm 768 padded to 1024", torch.cat([quant_input(1024, torch.float32, seed=12)[:768],
                                                            torch.zeros(256, device="cuda")])),
                     ("nb 1001", quant_input(1001 * QUANT_BLOCK, torch.float32, seed=13))):
        for k, v in quant_check(label, t).items():
            errs[k] = max(errs[k], v)
    mutants = quant_mutants(x)
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    q8, s8 = quantize_int8_cuda(x, QUANT_BLOCK)
    q4, s4 = quantize_int4_cuda(x, QUANT_BLOCK)
    shape = (2, QUANT_N // 2)
    timed = {
        "quantize_int8": (lambda: quantize_int8_cuda(x, QUANT_BLOCK), lambda: quantize_int8_plain(x, QUANT_BLOCK)),
        "dequantize_int8": (lambda: dequantize_int8_cuda(q8, s8, shape), lambda: dequantize_int8_plain(q8, s8, shape)),
        "quantize_int4": (lambda: quantize_int4_cuda(x, QUANT_BLOCK), lambda: quantize_int4_plain(x, QUANT_BLOCK)),
        "dequantize_int4": (lambda: dequantize_int4_cuda(q4, s4, shape), lambda: dequantize_int4_plain(q4, s4, shape)),
    }
    rows = {}
    for name, (t_bound, by) in quant_bounds(QUANT_N, 4).items():
        kernel, plain = timed[name]
        rows[name] = {"case": f"f32 n={QUANT_N}", "max_abs_err": errs[name], "ms": time_ms(kernel, 20, flush),
                      "plain_ms": time_ms(plain, 5, flush), "bound_ms": t_bound, "bound_by": by, "library_ms": None}
        log(f"  {name}: " + ", ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                                      for k, v in rows[name].items()))
    step = quant_step(flush)
    del flush
    torch.cuda.empty_cache()
    return {"rows": rows, "mutants": mutants, "step": step}


# ---------------------------------------------------------------- phase 11

DP_WORLD = 2
DP_TIMEOUT_S = 600
DP_WARMUP, DP_TIMED, DP_LOCO_STEPS, DP_CONTROL_STEPS = 3, 5, 3, 5
DP_DS_CONFIG = {**BENCH_DS_CONFIG, "zero_optimization": {"stage": 0, "zero_quantized_gradients": True}}
QUANT_COUNTERS = (quantize_int8_cuda, dequantize_int8_cuda, quantize_int4_cuda, dequantize_int4_cuda)


def quant_replay_ms(numels, rank: int) -> dict:
    """Ms of one qgZ step's exchange on this card, host issue included (CUDA
    events around 3 calls, no spin ahead of them), with its collectives
    replaced by device copies of the same sizes (the rank's own codes stand
    in for what it would receive), timed while the other rank waits at a
    barrier (two ranks' CUDA contexts time-slice the card, so events inside
    the shared step would count the other rank's work too), for both routes
    over the step's gradients in bf16, as the engine feeds them:
      * ``per_tensor``: ``padded_quant_allreduce`` of each tensor (the
        engine's route before the grouped exchange), 444 launches of K4a/K4b;
      * ``grouped``: ``GroupedQuantAllreduce``, the engine's exchange, 4."""
    from unittest import mock

    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.runtime.comm import GroupedQuantAllreduce, padded_quant_allreduce
    xs = [torch.randn(n, device="cuda").to(torch.bfloat16) for n in numels]
    wire = GroupedQuantAllreduce([(n, ) for n in numels], torch.bfloat16, "cuda")
    routes = (("per_tensor", lambda: [padded_quant_allreduce(x) for x in xs]), ("grouped", lambda: wire(xs)))

    def all_to_all(out, t, group=None):
        return out.copy_(t)

    def all_gather(out, t, group=None):
        out.view(DP_WORLD, *t.shape).copy_(t)
        return out

    ms = {}
    for turn in range(DP_WORLD):
        comm.barrier()
        if turn == rank:
            with mock.patch.object(comm, "all_to_all_single", all_to_all), \
                    mock.patch.object(comm, "all_gather_into_tensor", all_gather):
                for name, step in routes:
                    step()
                    torch.cuda.synchronize()
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(3):
                        step()
                    end.record()
                    end.synchronize()
                    ms[name] = start.elapsed_time(end) / 3
    comm.barrier()
    return ms


def param_digest(engine) -> str:
    """sha256 over every parameter's and master tensor's bytes."""
    h = hashlib.sha256()
    for t in [p.detach() for p in engine.module.parameters()] + list(engine.master):
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def dp_batch():
    ids = torch.from_numpy(np.random.default_rng(5).integers(0, PRESETS["125m"].vocab_size, (BENCH_B, BENCH_S),
                                                             dtype=np.int32)).cuda()
    return {"input_ids": ids, "labels": ids}


def dp_train(ds_config: dict, steps: int, timed_from=None) -> dict:
    """A fresh engine on this rank (seeded weights, broadcast from rank 0) and
    ``steps`` train_batch calls on the repeated global batch; the steps from
    ``timed_from`` on are timed as one window ended by a fetch of the loss.
    ``collectives``: the calls of each collective over the steps."""
    from deepspeed_tpu_torch.comm import comm
    engine = build_trainer(llama_125m(), ds_config)
    batch = dp_batch()
    calls = comm.call_counts.copy()
    losses = []
    for i in range(steps):
        if i == timed_from:
            float(losses[-1])
            wire0 = {k: list(v) for k, v in comm.comms_logger().comms_dict["all_to_all_quant_reduce"].items()}
            t0 = time.perf_counter()
        losses.append(engine.train_batch(batch=batch))
    float(losses[-1])                    # the value fetch ends the window
    res = {"engine": engine, "losses": [float(l) for l in losses], "collectives": dict(comm.call_counts - calls)}
    if timed_from is not None:
        n = steps - timed_from
        window_s = time.perf_counter() - t0
        wire1 = comm.comms_logger().comms_dict["all_to_all_quant_reduce"]
        wire_s = sum(v[1] for v in wire1.values()) - sum(v[1] for v in wire0.values())
        res.update(step_ms=1e3 * window_s / n, wire_ms_per_step=1e3 * wire_s / n)
    return res


def dp_rank(rank: int) -> dict:
    """Phase 11 on one rank: qgZ steps (3 warm-up, 5 timed), LoCo steps, the
    float32-wire control, and the int4 collectives over the embedding's
    gradient against their plain versions on CPU copies."""
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.runtime.comm import all_to_all_quant_reduce, padded_quant_allreduce, quantized_all_gather
    comm.configure(enabled=True)
    acc = get_accelerator()
    acc.reset_peak_memory_stats()
    reset_launch_counts()
    run = dp_train(DP_DS_CONFIG, DP_WARMUP + DP_TIMED, timed_from=DP_WARMUP)
    launches = {f.__name__: f.launches for f in LAUNCH_COUNTERS}
    engine = run.pop("engine")
    res = {"qgz": run, "launches": launches, "numels": [p.numel() for p in engine.params], "qgz_active": engine.qgz,
           "wire_bytes": engine._compressed_wire_bytes,
           "comms": {str(k): v[0] for k, v in comm.comms_logger().comms_dict["all_to_all_quant_reduce"].items()},
           "digest": param_digest(engine), "peak_mem_gb": acc.max_memory_allocated() / 1e9,
           "backend": comm.get_backend()}
    res["qgz"]["codec_ms_per_step"] = quant_replay_ms(res["numels"], rank)
    # one step's gradients of this rank's rows: the grouped exchange against
    # the per-tensor route, and the embedding's for the int4 calls
    rows = {k: v[rank * BENCH_B // DP_WORLD:(rank + 1) * BENCH_B // DP_WORLD] for k, v in dp_batch().items()}
    grads = torch.autograd.grad(engine.forward(rows), engine.params)
    wire = [engine._to_wire(g.float(), t) for g, t in zip(grads, engine._wire_transposed)]
    grouped = engine._wire(wire)
    per_tensor = [padded_quant_allreduce(g.to(engine.compute_dtype)).float() for g in wire]
    res["grouped_equals_per_tensor"] = all(torch.equal(a, b) for a, b in zip(grouped, per_tensor))
    grad = grads[[id(p) for p in engine.params].index(id(engine.module.embed_tokens.weight))].float()
    del engine, grads, wire, grouped, per_tensor
    torch.cuda.empty_cache()

    for counter in QUANT_COUNTERS:
        counter.launches = 0
    shard = all_to_all_quant_reduce(grad, bits=4)
    full = quantized_all_gather(shard, bits=4)
    torch.cuda.synchronize()
    res["int4_launches"] = {f.__name__: f.launches for f in (quantize_int4_cuda, dequantize_int4_cuda)}
    shard_cpu = all_to_all_quant_reduce(grad.cpu(), bits=4)
    full_cpu = quantized_all_gather(shard_cpu, bits=4)
    res["int4_identical"] = torch.equal(shard.cpu(), shard_cpu) and torch.equal(full.cpu(), full_cpu)
    del grad, shard, full

    loco_cfg = {**DP_DS_CONFIG, "zero_optimization": {**DP_DS_CONFIG["zero_optimization"],
                                                      "zeropp_loco_param": {"err_beta": 0.8}}}
    for counter in QUANT_COUNTERS:
        counter.launches = 0
    loco = dp_train(loco_cfg, DP_LOCO_STEPS)
    loco["launches"] = {f.__name__: f.launches for f in (quantize_int8_cuda, dequantize_int8_cuda)}
    engine = loco.pop("engine")
    res["loco"] = {**loco, "error_abs_max": max(float(e.abs().max()) for e in engine.loco_error),
                   "digest": param_digest(engine)}
    del engine
    torch.cuda.empty_cache()
    control = dp_train({**DP_DS_CONFIG, "zero_optimization": {"stage": 0}}, DP_CONTROL_STEPS)
    engine = control.pop("engine")
    res["control"] = {**control, "digest": param_digest(engine), "qgz_active": engine.qgz}
    del engine
    torch.cuda.empty_cache()
    return res


def dp_rank_main(rank: int, init_method: str, queue) -> None:
    """A spawned rank: both ranks share the one card (cuda:0) over gloo."""
    from deepspeed_tpu_torch.comm import comm
    try:
        torch.cuda.set_device(0)
        comm.init_distributed(dist_backend="gloo", init_method=init_method, rank=rank, world_size=DP_WORLD,
                              timeout=DP_TIMEOUT_S, verbose=False)
        queue.put((rank, dp_rank(rank), None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))
        raise
    finally:
        if comm.is_initialized():
            torch.distributed.destroy_process_group()


def phase_data_parallel(smi: str) -> dict:
    """The data-parallel path through its entry points: two ranks on the one
    card (spawned; gloo: NCCL refuses two ranks on one card), each
    ``initialize`` → ``train_batch`` on Llama-125M at full width and depth
    with ``zero_quantized_gradients`` (qgZ), 12 of the 24 rows per rank."""
    import multiprocessing
    import socket
    gc.collect()
    torch.cuda.empty_cache()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=dp_rank_main, args=(r, f"tcp://127.0.0.1:{port}", queue)) for r in range(DP_WORLD)]
    for p in procs:
        p.start()
    ranks = {}
    try:
        for _ in range(DP_WORLD):
            rank, res, err = queue.get(timeout=DP_TIMEOUT_S)
            if err is not None:
                raise AssertionError(f"data-parallel rank {rank} failed:\n{err}")
            ranks[rank] = res
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"data-parallel ranks exited with {[p.exitcode for p in procs]}")
    r0, r1 = ranks[0], ranks[1]
    steps = DP_WARMUP + DP_TIMED
    layers = PRESETS["125m"].num_hidden_layers
    n_tensors = len(r0["numels"])
    unit = DP_WORLD * 256     # JAX engine.py:1016-1026: per direction the padded int8 payload and its scales
    want_bytes = sum(2 * (n + 4 * (n // 256)) for n in (-(-m // unit) * unit for m in r0["numels"]))
    checks = {
        "qgz_active": r0["qgz_active"] and r1["qgz_active"] and not r0["control"]["qgz_active"],
        "backend_gloo": r0["backend"] == "gloo",
        "k4a_k4b_2_per_step": all(
            r["launches"]["quantize_int8_cuda"] == r["launches"]["dequantize_int8_cuda"] == 2 * steps
            for r in (r0, r1)),
        "wire_4_collectives_per_step": all(
            r["qgz"]["collectives"] == {"all_to_all_single": 2 * steps, "all_gather_into_tensor": 2 * steps,
                                        "all_reduce": 2 * steps} for r in (r0, r1)),
        "grouped_equals_per_tensor": r0["grouped_equals_per_tensor"] and r1["grouped_equals_per_tensor"],
        "k1_k2_once_per_layer": all(r["launches"][k] == layers * steps for r in (r0, r1)
                                    for k in ("flash_fwd_cuda", "flash_dq_cuda", "flash_dkv_cuda")),
        "k5_launched": all(r["int4_launches"] == {"quantize_int4_cuda": 2, "dequantize_int4_cuda": 2}
                           for r in (r0, r1)),
        "int4_identical_to_plain": r0["int4_identical"] and r1["int4_identical"],
        "losses_finite_falling": all(np.isfinite(r0["qgz"]["losses"])) and
        r0["qgz"]["losses"][-1] < r0["qgz"]["losses"][0],
        "ranks_bit_identical": r0["digest"] == r1["digest"] and r0["loco"]["digest"] == r1["loco"]["digest"]
        and r0["control"]["digest"] == r1["control"]["digest"],
        "losses_equal_on_ranks": r0["qgz"]["losses"] == r1["qgz"]["losses"],
        "comms_bytes_formula": r0["wire_bytes"] == want_bytes and list(r0["comms"]) == [str(want_bytes)],
        "loco_error_nonzero": r0["loco"]["error_abs_max"] > 0,
        "loco_k4a_2_k4b_3_per_step": all(r["loco"]["launches"] == {"quantize_int8_cuda": 2 * DP_LOCO_STEPS,
                                                                   "dequantize_int8_cuda": 3 * DP_LOCO_STEPS}
                                         for r in (r0, r1)),
        "qgz_within_5e-2_of_fp32_wire": bool(np.allclose(r0["qgz"]["losses"][:DP_CONTROL_STEPS],
                                                         r0["control"]["losses"], rtol=5e-2, atol=5e-2)),
    }
    q = r0["qgz"]
    res = {"card": smi, "backend": r0["backend"], "ranks_on_one_card": DP_WORLD,
           "payload_path": "CUDA tensors handed to gloo (gloo copies them through host memory itself)",
           "n_tensors": n_tensors, "step_ms": [r["qgz"]["step_ms"] for r in (r0, r1)],
           "tok_s_both_ranks": BENCH_B * BENCH_S / (max(r["qgz"]["step_ms"] for r in (r0, r1)) / 1e3),
           "wire_ms_per_step": [r["qgz"]["wire_ms_per_step"] for r in (r0, r1)],
           "codec_ms_per_step_alone": [r["qgz"]["codec_ms_per_step"] for r in (r0, r1)],
           "collectives": r0["qgz"]["collectives"], "loco_collectives": r0["loco"]["collectives"],
           "peak_mem_gb": [r["peak_mem_gb"] for r in (r0, r1)], "wire_bytes_per_step": r0["wire_bytes"],
           "losses_qgz": q["losses"], "losses_fp32_wire": r0["control"]["losses"], "losses_loco": r0["loco"]["losses"],
           "loco_error_abs_max": r0["loco"]["error_abs_max"], "launches": r0["launches"],
           "int4_launches": r0["int4_launches"], "checks": checks}
    log("  data parallel: " + json.dumps(res))
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"data-parallel phase failed {bad}")
    return res


# ---------------------------------------------------------------- phase 12

FRONTEND_REQUESTS = 16
FRONTEND_ARRIVAL_S = 2.0           # open-loop arrivals at seeded offsets over the first ~2 s
FRONTEND_ARENA_SHARE = 0.4         # device arena: ~40% of the mix's pages
FRONTEND_DEADLINE_S = 120.0        # every request's end-to-end deadline (goodput counts those met)
MIGRATION_AFTER = 8                # decoded tokens before the migration check's export


class StagingMeter:
    """Wraps one engine's ``export_pages``/``import_pages`` (instance
    attributes, so the serving stack's calls go through it): bytes and
    fenced seconds of each direction, and for every import a re-export of
    the same pages held against the imported bytes, plus whether those
    bytes are a block the tier demoted (its crc32 among the demotions')."""

    def __init__(self, engine, tier=None):
        self.kv = engine.kv
        self.export, self.import_ = engine.kv.export_pages, engine.kv.import_pages
        self.d2h_bytes = self.h2d_bytes = 0
        self.d2h_s = self.h2d_s = 0.0
        self.exports = self.imports = 0
        self.demoted_crcs = set()
        self.reexport_equal = []       # (bytes equal, the block was a demoted snapshot's)
        engine.kv.export_pages = self._export
        engine.kv.import_pages = self._import
        if tier is not None:
            demote = tier.demote_sequence

            def demote_sequence(uid):
                handle = demote(uid)
                snap = tier.host.peek_seq(uid)
                if handle is not None and snap is not None:
                    self.demoted_crcs.update(snap.crcs)
                return handle

            tier.demote_sequence = demote_sequence

    def _export(self, arena, pages):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        block = self.export(arena, pages)          # ends in its device -> host copy
        self.d2h_s += time.perf_counter() - t0
        self.d2h_bytes += block.nbytes
        self.exports += 1
        return block

    def _import(self, arena, pages, block):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.import_(arena, pages, block)
        torch.cuda.synchronize()
        self.h2d_s += time.perf_counter() - t0
        self.h2d_bytes += block.nbytes
        self.imports += 1
        again = self.export(out, pages)
        crc = zlib.crc32(np.ascontiguousarray(block).tobytes())
        self.reexport_equal.append((bool(np.array_equal(again, block)), crc in self.demoted_crcs))
        return out

    def rates(self) -> dict:
        return {"staged_d2h_bytes": self.d2h_bytes, "staged_h2d_bytes": self.h2d_bytes,
                "exports": self.exports, "imports": self.imports,
                "d2h_gb_s": self.d2h_bytes / self.d2h_s / 1e9 if self.d2h_s else None,
                "h2d_gb_s": self.h2d_bytes / self.h2d_s / 1e9 if self.h2d_s else None}


class StepMeter:
    """Wraps an engine's ``dispatch_step``/``complete_step``: wall seconds
    and tokens of each step from its dispatch to its readback, and whether
    it was pure decode (every row one token)."""

    def __init__(self, engine):
        self.steps = []
        dispatch, complete = engine.dispatch_step, engine.complete_step
        starts = {}

        def dispatch_step(plan=None):
            t0 = time.perf_counter()
            inf = dispatch(plan)
            if inf is not None:
                starts[id(inf)] = t0
            return inf

        def complete_step(inf):
            out = complete(inf)
            decode = inf.kind == "multi" or all(n == 1 for _, n, _, _ in inf.rows)
            self.steps.append((time.perf_counter() - starts.pop(id(inf)), sum(map(len, out.values())), decode))
            return out

        engine.dispatch_step, engine.complete_step = dispatch_step, complete_step

    def decode_tok_s(self) -> float:
        secs = sum(s for s, _, d in self.steps if d)
        return sum(n for _, n, d in self.steps if d) / secs if secs else 0.0


def frontend_mix(vocab: int, seed: int = 12) -> list:
    """16 open-loop requests: prompts of 64-1024 tokens, two pairs sharing a
    512-token prefix, 32-64 new tokens, two priority classes (every fourth
    request urgent), arrivals at seeded offsets over the first ~2 s."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(64, 1025, FRONTEND_REQUESTS)
    for i in (1, 3, 9, 11):
        lens[i] = max(lens[i], 600)             # long enough to share a 512-token prefix
    prompts = [rng.integers(0, vocab, int(n)).tolist() for n in lens]
    prompts[3] = prompts[1][:512] + prompts[3][512:]
    prompts[11] = prompts[9][:512] + prompts[11][512:]
    arrivals = np.sort(rng.uniform(0.0, FRONTEND_ARRIVAL_S, FRONTEND_REQUESTS))
    return [dict(prompt=p, max_new_tokens=int(rng.integers(32, 65)), arrival_ts=float(t),
                 priority=0.0 if i % 4 == 0 else 1.0, deadline=float(t) + FRONTEND_DEADLINE_S)
            for i, (p, t) in enumerate(zip(prompts, arrivals))]


def migration_check(cfg, state, rng) -> dict:
    """One request alone on its own engine (the same weights, no prefix
    cache): generated by the bare engine, then served, migrated out after
    ``MIGRATION_AFTER`` tokens (``begin_migration`` → every chunk exported →
    ``complete_migration``) and resubmitted with its ``kv_snapshot``.  Both
    runs are batch 1 with the same shapes; the tokens must be equal."""
    econf = dataclasses.replace(engine_config(torch.bfloat16, 128), enable_prefix_cache=False,
                                decode_steps_per_dispatch=1)
    eng = build_engine(cfg, state, econf, device="cuda")
    prompt = rng.integers(0, cfg.vocab_size, 300).tolist()
    golden = eng.generate([prompt], max_new_tokens=40)[0]
    meter = StagingMeter(eng)
    serve = ServingEngine(eng, clock=WallClock())
    req = serve.submit(prompt, max_new_tokens=40)
    for _ in range(200):
        if req.state is RequestState.DECODE and len(req.tokens) >= MIGRATION_AFTER:
            break
        serve.tick()
    exporter = serve.begin_migration(req.uid, chunk_pages=8)
    if exporter is None:
        raise AssertionError(f"migration refused in state {req.state} with {len(req.tokens)} tokens")
    while not exporter.step_chunk():
        pass
    snap = exporter.snapshot
    serve.complete_migration(req.uid)
    again = serve.submit(prompt, max_new_tokens=40, resume_tokens=list(req.tokens), kv_snapshot=snap)
    serve.drain()
    res = {"tokens_equal": list(again.tokens) == golden, "migrated_after": len(req.tokens),
           "snapshot_pages": snap.n_pages, "snapshot_bytes": snap.n_bytes, "snapshot_dtype": snap.dtype,
           "kv_imports": serve.stats.kv_imports, "reexport_equal": all(e for e, _ in meter.reexport_equal),
           "forwards": eng.forward_calls, **meter.rates()}
    del serve, eng
    return res


def phase_serving_frontend(cfg, state, smi: str) -> dict:
    """The serving stack above the engine: ``ServingEngine`` (wall clock) on
    ``build_engine`` with a ``TieredKVManager``, 16 open-loop requests of
    two priority classes into a device arena of ~40% of the mix's pages, so
    KV pressure preempts by demoting to the host tier and re-admission
    promotes back; then the migration check."""
    layers = cfg.num_hidden_layers
    mix = frontend_mix(cfg.vocab_size)
    demand = sum(-(-(len(a["prompt"]) + a["max_new_tokens"]) // PAGE) for a in mix)
    num_pages = int(FRONTEND_ARENA_SHARE * demand) + 1
    econf = dataclasses.replace(engine_config(torch.bfloat16, num_pages), decode_steps_per_dispatch=1)
    eng = build_engine(cfg, state, econf, device="cuda")
    eng.generate([list(range(1, 20))], max_new_tokens=9)   # warm-up: cuBLAS handles, allocator
    eng.kv.prefix_cache.evict(eng.kv.prefix_cache.cached_pages)
    tier = TieredKVManager(eng, config=TierConfig(host_capacity_pages=4 * num_pages))
    staging = StagingMeter(eng, tier)
    steps = StepMeter(eng)
    clock = WallClock()
    serve = ServingEngine(eng, clock=clock)
    serve.attach_tier(tier)
    page_bytes = sum(t[0].numel() * t.element_size() for t in eng.cache)

    acc = get_accelerator()
    acc.synchronize()
    acc.reset_peak_memory_stats()
    reset_launch_counts()
    eng.forward_calls = 0
    clock.reset()
    serve.rebase_epoch()
    t0 = time.perf_counter()
    reqs = serve.run(mix)
    wall = time.perf_counter() - t0
    launches, forwards = paged_attention_cuda.launches, eng.forward_calls
    peak = acc.max_memory_allocated() / 1e9

    summary = serve.summary()
    pc = eng.kv.prefix_cache
    host_used = tier.host.pages_used
    by_class = {}
    for prio in (0.0, 1.0):
        ttfts = [r.ttft for r, a in zip(reqs, mix) if a["priority"] == prio and r.ttft is not None]
        by_class[f"priority_{prio:g}_ttft_s_p50"] = float(np.percentile(ttfts, 50)) if ttfts else None
    checks = {
        "all_done_with_their_tokens": all(r.state is RequestState.DONE and len(r.tokens) == a["max_new_tokens"]
                                          for r, a in zip(reqs, mix)),
        "demoted_and_promoted": tier.stats["demotions"] >= 1 and tier.stats["promotions"] >= 1,
        "promoted_reexport_equals_demoted_bytes": bool(staging.reexport_equal) and all(
            e for e, _ in staging.reexport_equal) and any(d for _, d in staging.reexport_equal),
        "pages_accounted": not eng.state.seqs and eng.kv.allocator.free_pages + pc.cached_pages == num_pages - 1,
        "host_tier_accounted": not serve._parked and host_used == sum(tier.host._lru.values())
        and host_used <= tier.host.capacity_pages,
        "k3_launches_layers_x_forwards": launches == layers * forwards and launches > 0,
    }
    reset_launch_counts()
    migration = migration_check(cfg, state, np.random.default_rng(13))
    mig_launches = paged_attention_cuda.launches
    checks["migration_tokens_equal"] = migration["tokens_equal"] and migration["kv_imports"] == 1 \
        and migration["reexport_equal"]
    checks["migration_k3_launches"] = mig_launches == layers * migration["forwards"]
    res = {"card": smi, "requests": len(reqs), "prompt_tokens": sum(len(a["prompt"]) for a in mix),
           "generated": sum(len(r.tokens) for r in reqs), "arena_pages": num_pages, "mix_pages": demand,
           "page_bytes": page_bytes, "ttft_s": {k: summary["ttft"][k] for k in ("p50", "p99")},
           "tpot_s": {k: summary["tpot"][k] for k in ("p50", "p99")}, **by_class,
           "goodput_rps": summary["goodput_rps"], "decode_tok_s": steps.decode_tok_s(),
           "output_tok_s": sum(len(r.tokens) for r in reqs) / wall, "preemptions": summary["preemptions"],
           "demotions": tier.stats["demotions"], "promotions": tier.stats["promotions"],
           "prefix_demotions": tier.stats["prefix_demotions"], "prefix_promotions": tier.stats["prefix_promotions"],
           "kv_imports": summary["kv_imports"], "kv_import_fallbacks": summary["kv_import_fallbacks"],
           **staging.rates(), "host_pages_after": host_used, "steps": len(steps.steps), "forwards": forwards,
           "k3_launches": launches, "wall_s": wall, "peak_mem_gb": peak, "migration": migration,
           "migration_k3_launches": mig_launches, "checks": checks}
    log("  serving frontend: " + json.dumps(res))
    del serve, tier, eng
    gc.collect()
    torch.cuda.empty_cache()
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"serving-frontend phase failed {bad}")
    return res


# ---------------------------------------------------------------- phase 13

SPEC_MAX_DRAFT = 4
STEP_SET = [(8, 1), (8, 256), ("multi", 8, 2), ("multi", 8, 4), ("multi", 8, 8), ("verify", 8, SPEC_MAX_DRAFT + 1)]
# a token whose two best logits are closer than this share of its best
# logit is a rounding tie: the verify forward's GEMMs take other shapes than
# the decode forward's, so float32 sums may round the other way there
TIE_MARGIN = 1e-4
# in bfloat16 the spec stream may leave the plain one only for a token whose
# logit lies within this many bf16 ulps of the best one: the cache-free model
# that judges it is a bf16 computation too, and orders candidates that close
# (two or three of them) otherwise than either engine
BF16_TIE_ULPS = 4


def pattern_prompts(vocab: int, seed: int = 21) -> list:
    """Two prompts that repeat a 32-token pattern (4 and 6 times), so the
    n-gram drafter proposes from the first decode round on."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, 32).tolist() * n for n in (4, 6)]


def graph_pool_bytes(pool) -> int:
    """Bytes of the caching allocator's segments that belong to a graph pool."""
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot() if tuple(s["segment_pool_id"]) == tuple(pool))


def key_batches(eng, prompts, max_new, rng) -> dict:
    """One real packed batch per step-set key, packed without advancing the
    engine: phase 3's 8 prompts prefilled to their first token (decode, the
    fused rounds, verify with 4 random draft tokens a row) and 8 fresh
    prompts' first 256-token chunk."""
    vocab = eng.cfg.vocab_size
    for uid, (p, n) in enumerate(zip(prompts, max_new)):
        eng.put([uid], [p], max_new_tokens=n)
    while not all(s.in_decode for s in eng.state.seqs.values()):
        eng.step()
    eng.put(list(range(100, 108)), [rng.integers(0, vocab, 300).tolist() for _ in range(8)], max_new_tokens=8)
    decode = [eng.state.seqs[u] for u in range(8)]
    fresh = [eng.state.seqs[u] for u in range(100, 108)]
    out = {}
    for key in STEP_SET:
        if key[0] == "multi":
            for s in decode:
                eng.kv.ensure_capacity(s, key[2])
            rb = eng.state.pack([(s, 1) for s in decode], 1, pad_to=8)
            arrays = (rb.tokens[:, 0], rb.start_pos, rb.block_tables, rb.chunk_lens)
        elif key[0] == "verify":
            for s in decode:
                s.tokens.extend(rng.integers(0, vocab, SPEC_MAX_DRAFT).tolist())
            rb = eng.state.pack([(s, 1 + SPEC_MAX_DRAFT) for s in decode], key[2], pad_to=8)
            for s in decode:
                del s.tokens[-SPEC_MAX_DRAFT:]
            arrays = (rb.tokens, rb.start_pos, rb.block_tables, rb.chunk_lens)
        else:
            work = [(s, 1) for s in decode] if key[1] == 1 else [(s, key[1]) for s in fresh]
            rb = eng.state.pack(work, key[1], pad_to=8)
            arrays = (rb.tokens, rb.start_pos, rb.block_tables, rb.chunk_lens)
        out[key] = tuple(np.ascontiguousarray(a) for a in arrays)
    return out


def graph_equals_eager(eng, key, arrays) -> dict:
    """The key's step run eagerly (``model.hidden`` + the LM head and
    argmax) and one replay of its graph, from the same arena: tokens and
    every arena byte must be identical."""
    fn, prog = eng._step_fn(key)[0], eng._step_fns[key]
    before = [t.clone() for t in eng.cache]
    eager = fn(*(torch.from_numpy(a).cuda() for a in arrays))
    eager_arena = [t.clone() for t in eng.cache]
    for t, s in zip(eng.cache, before):
        t.copy_(s)
    graph = prog.run(arrays)
    torch.cuda.synchronize()
    row = {"tokens_equal": torch.equal(eager, graph),
           "arena_equal": all(torch.equal(a, b) for a, b in zip(eager_arena, eng.cache)),
           "pages_written": int((eager_arena[0] != before[0]).flatten(1).any(1).sum()),
           "capture_s": prog.capture_s, "deltas": prog.counts.deltas}
    del before, eager_arena
    return row


def device_profile(fn) -> tuple:
    """``fn()`` once under torch.profiler: its device rows (kernels,
    memcpy/memset) as {name: (count, device us)}."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: (e.count, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def wall_ms(fn, reps: int = 5) -> float:
    """Median wall ms of ``fn()`` (ending in its readback)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def serve_greedy(eng, prompts, max_new) -> list:
    """Every prompt put at once, stepped until all are done; the streams."""
    uids = list(range(len(prompts)))
    for uid, (p, n) in enumerate(zip(prompts, max_new)):
        eng.put([uid], [p], max_new_tokens=n)
    for _ in range(2000):
        if all(eng.state.seqs[u].done for u in uids):
            break
        eng.step()
    else:
        raise AssertionError("serving made no progress in 2000 steps")
    streams = [list(eng.state.seqs[u].generated) for u in uids]
    for u in uids:
        eng.flush(u)
    return streams


def spec_vs_plain(spec_eng, plain_eng, prompts, max_new) -> dict:
    """The same greedy requests through a spec engine and a spec-less one;
    pages must all return after each."""
    res = {}
    streams = {}
    for name, eng in (("spec", spec_eng), ("plain", plain_eng)):
        pc = eng.kv.prefix_cache
        if pc is not None:
            pc.evict(pc.cached_pages)
        free0 = eng.kv.allocator.free_pages
        streams[name] = serve_greedy(eng, prompts, max_new)
        cached = pc.cached_pages if pc is not None else 0
        res[f"{name}_pages_accounted"] = eng.kv.allocator.free_pages + cached == free0
    st = spec_eng.spec_stats
    pairs = [(a, b) for s, p in zip(streams["spec"], streams["plain"]) for a, b in zip(s, p)]
    res.update(verify_rounds=st.rounds, proposed=st.proposed, accepted=st.accepted, emitted=st.emitted,
               acceptance_rate=st.acceptance_rate, rollback_pages=st.rollback_pages,
               tokens_equal_share=sum(a == b for a, b in pairs) / len(pairs),
               streams_equal=streams["spec"] == streams["plain"])
    return res, streams


def bf16_ulp(x: float) -> float:
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    return 2.0**(math.floor(math.log2(abs(x))) - 7) if x else 2.0**-133


def first_difference_margins(cfg, state, prompts, streams) -> list:
    """Where the spec stream leaves the plain one: the position, the plain
    stream's top-2 logit margin there, and each stream's token's rank (the
    tokens with a strictly larger logit) and gap below the best logit, from
    the cache-free model (plain attention, the weights' dtype) on the prompt
    and the plain tokens before it (the same for both streams up to there)."""
    model = LlamaForCausalLM(dataclasses.replace(cfg, attention_impl="reference"), device="meta")
    model.load_state_dict(state, strict=True, assign=True)
    out = []
    for i, (p, s, q) in enumerate(zip(prompts, streams["spec"], streams["plain"])):
        j = next((j for j, (a, b) in enumerate(zip(s, q)) if a != b), None)
        if j is None:
            continue
        ids = torch.tensor([p + q[:j]], dtype=torch.int64, device="cuda")
        with torch.no_grad():
            logits = model(ids)[0, -1].float()
        top = torch.topk(logits, 2).values
        margin = float(top[0] - top[1])
        out.append({"request": i, "position": j, "margin": margin, "top_logit": float(top[0]),
                    "tie": margin <= TIE_MARGIN * abs(float(top[0])), "spec_token": s[j], "plain_token": q[j],
                    "spec_rank": int((logits > logits[s[j]]).sum()), "plain_rank": int((logits > logits[q[j]]).sum()),
                    "spec_gap": float(top[0] - logits[s[j]]), "plain_gap": float(top[0] - logits[q[j]])})
    return out


def phase_step_graphs(cfg, state, smi: str) -> dict:
    """The step set as CUDA graphs and speculative decoding on Llama-3-8B
    (phase 3's width, depth and weights, bf16), then the float32 exactness
    of speculation at phase 4's setting."""
    layers = cfg.num_hidden_layers
    econf = dataclasses.replace(engine_config(torch.bfloat16, 1024), spec=SpecConfig(max_draft=SPEC_MAX_DRAFT))
    eng = build_engine(cfg, state, econf, device="cuda")
    reset_launch_counts()
    eng.forward_calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = eng.warm_all()
    warm_s = time.perf_counter() - t0
    rewarm = eng.warm_all()
    pool = graph_pool_bytes(eng._graphs.pool)
    captures = {eng._key_label(k): eng._step_fns[k].capture_s for k in STEP_SET}
    log(f"  warm_all: {json.dumps(warm)} in {warm_s:.2f} s; again: {json.dumps(rewarm)}")
    log(f"  capture s by key (warm run included): {json.dumps(captures)}; graph pool {pool} B")
    checks = {"warm_all_captured_6": warm["compiled"] == len(warm["keys"]) == len(eng.step_shape_set()) == 6
              and warm["fallback"] == 0 and eng.step_shape_set() == STEP_SET,
              "rewarm_all_cached": rewarm["cached"] == 6 and rewarm["compiled"] == 0}

    prompts, max_new = serving_mix(cfg.vocab_size)
    batches = key_batches(eng, prompts, [64] * 8, np.random.default_rng(14))
    by_key = {eng._key_label(k): graph_equals_eager(eng, k, a) for k, a in batches.items()}
    log("  graph == eager by key: " + json.dumps(by_key))
    checks["graph_equals_eager_bit_for_bit"] = all(r["tokens_equal"] and r["arena_equal"] and r["pages_written"] > 0
                                                   for r in by_key.values())

    # K3 inside the graph: one replay of the fused rung of 8 rounds
    multi = ("multi", 8, 8)
    rows = device_profile(lambda: eng._step_fns[multi].run(batches[multi]))
    k3_events = sum(n for name, (n, _) in rows.items() if "paged_attention" in name)
    log(f"  profiled replay of {eng._key_label(multi)}: {k3_events} K3 kernel events, {len(rows)} device rows")
    checks["k3_runs_inside_the_graph"] = k3_events == layers * 8
    # and inside the verify graph: its capture recorded one forward of
    # `layers` K3 launches, and a profiled replay shows them on the device
    verify = STEP_SET[-1]
    vprog = eng._step_fns[verify]
    rows = device_profile(lambda: vprog.run(batches[verify]))
    k3_verify_events = sum(n for name, (n, _) in rows.items() if "paged_attention" in name)
    log(f"  profiled replay of {eng._key_label(verify)}: {k3_verify_events} K3 kernel events; "
        f"capture deltas {vprog.counts.deltas}")
    checks["k3_runs_inside_the_verify_graph"] = k3_verify_events == layers and vprog.counts.deltas[:2] == (1, layers)

    # the fused rung of 8 rounds on the same batch, eager (a Python loop of
    # forwards through model.hidden, as the engine dispatched it before the
    # step graphs) and as one replay; device busy share from one profiled
    # round of each over its unprofiled wall time
    arrays = batches[multi]

    def eager():
        eng._forward_multi(8, *(torch.from_numpy(a).cuda() for a in arrays)).cpu()

    def graph():
        eng._step_fns[multi].run(arrays).cpu()

    rounds = {}
    for name, fn in (("eager", eager), ("graph", graph), ("graph_again", graph), ("eager_again", eager)):
        fn()
        rounds[name] = wall_ms(fn) / 8
    for name, fn in (("eager", eager), ("graph", graph)):
        busy = sum(us for _, us in device_profile(fn).values()) / 1e3 / 8
        rounds[f"{name}_device_ms"] = busy
        rounds[f"{name}_busy_share"] = busy / min(rounds[name], rounds[f"{name}_again"])
    # one verify round (8 rows x 5 positions) the same two ways
    rounds["verify_eager"] = wall_ms(lambda: eng._forward_verify(
        *(torch.from_numpy(a).cuda() for a in batches[verify])).cpu())
    rounds["verify_graph"] = wall_ms(lambda: vprog.run(batches[verify]).cpu())
    log(f"  fused rung (per round) and verify round, wall ms ({smi}): " + json.dumps(rounds))
    for u in list(eng.state.seqs):
        eng.flush(u)

    # speculation: phase 3's greedy mix plus two pattern prompts, with and without
    plain_eng = build_engine(cfg, state, engine_config(torch.bfloat16, 1024), device="cuda")
    plain_eng.warm_all()
    mix = prompts + pattern_prompts(cfg.vocab_size)
    # the K3 launches of the serving run's verify rounds: what the verify
    # graph's replays added to the counter over that run
    launches0, rounds0 = vprog.counts.get(paged_attention_cuda), eng.spec_stats.rounds
    spec, streams = spec_vs_plain(eng, plain_eng, mix, max_new + [64, 64])
    verify_launches = vprog.counts.get(paged_attention_cuda) - launches0
    spec["verify_k3_launches"] = verify_launches
    # where a bf16 spec stream leaves the plain one, the spec token must be
    # within a few bf16 ulps of the best logit there
    diffs = first_difference_margins(cfg, state, mix, streams)
    spec["first_differences"] = [{"margin_share": d["margin"] / abs(d["top_logit"]),
                                  "spec_gap_ulps": d["spec_gap"] / bf16_ulp(d["top_logit"]),
                                  "plain_gap_ulps": d["plain_gap"] / bf16_ulp(d["top_logit"]),
                                  "spec_rank": d["spec_rank"], "plain_rank": d["plain_rank"]} for d in diffs]
    log("  speculation, bf16 (seeded random weights: the acceptance rate says nothing of a real model's): "
        + json.dumps(spec))
    checks["verify_rounds"] = spec["verify_rounds"] >= 1
    checks["verify_k3_launches_layers_x_rounds"] = verify_launches == layers * (eng.spec_stats.rounds - rounds0) > 0
    checks["bf16_differences_are_ties"] = all(d["spec_gap"] <= BF16_TIE_ULPS * bf16_ulp(d["top_logit"])
                                              for d in diffs)
    checks["pages_accounted_after_drain"] = spec["spec_pages_accounted"] and spec["plain_pages_accounted"]
    launches, forwards = paged_attention_cuda.launches, eng.forward_calls + plain_eng.forward_calls
    checks["k3_launches_layers_x_forwards"] = launches == layers * forwards and launches > 0
    del eng, plain_eng, batches
    gc.collect()
    torch.cuda.empty_cache()

    # float32 exactness at phase 4's setting
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32, state32 = llama3_8b(2, torch.float32, seed=1)
    rng = np.random.default_rng(2)
    prompts32 = [rng.integers(0, cfg32.vocab_size, n).tolist() for n in (40, 300, 700)] + \
        pattern_prompts(cfg32.vocab_size)
    econf32 = engine_config(torch.float32, 256)
    spec32_eng = build_engine(cfg32, state32, dataclasses.replace(econf32, spec=SpecConfig(max_draft=SPEC_MAX_DRAFT)),
                              device="cuda")
    f32, streams = spec_vs_plain(spec32_eng, build_engine(cfg32, state32, econf32, device="cuda"), prompts32,
                                 [64] * len(prompts32))
    f32["differences"] = first_difference_margins(cfg32, state32, prompts32, streams)
    f32["rounding_ties"] = sum(d["tie"] for d in f32["differences"])
    log("  speculation, float32 (2 layers): " + json.dumps(f32))
    checks["f32_spec_equals_plain_but_ties"] = f32["verify_rounds"] >= 1 and all(d["tie"] for d in f32["differences"])
    del spec32_eng, state32
    gc.collect()
    torch.cuda.empty_cache()

    res = {"card": smi, "warm_all": warm, "warm_all_s": warm_s, "capture_s": captures, "graph_pool_bytes": pool,
           "graph_vs_eager": by_key, "k3_events_in_replay": k3_events, "k3_events_in_verify_replay": k3_verify_events,
           "fused_round": rounds, "spec_bf16": spec, "spec_f32": f32, "k3_launches": launches,
           "verify_k3_launches": verify_launches, "forwards": forwards, "checks": checks}
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"step-graph phase failed {bad}: {json.dumps(res)}")
    return res


# ---------------------------------------------------------------- main


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU visible; the port's smoke run needs one", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    log("== phase 1: environment")
    env = phase_environment()
    log("== phase 2: K3 paged attention vs its plain version")
    k3 = phase_kernels()
    log("== phase 3: serving Llama-3-8B")
    cfg, state = llama3_8b(32, torch.bfloat16, seed=0)
    serving = phase_serving(cfg, state, env["card"])
    phase_profile(cfg, state)
    log("== phase 4: path parity")
    phase_parity_bf16(cfg, state)
    log("== phase 12: the serving frontend on Llama-3-8B (open-loop mix, host KV tier, migration)")
    frontend = phase_serving_frontend(cfg, state, env["card"])
    log("== phase 13: the step set as CUDA graphs, and speculative decoding, on Llama-3-8B")
    graphs = phase_step_graphs(cfg, state, env["card"])
    del state
    torch.cuda.empty_cache()
    phase_parity_f32()
    log("== phase 5: K1/K2a/K2b flash attention vs their plain versions")
    flash = phase_flash_kernels()
    log("== phase 6: training Llama-125M")
    training = phase_training(env["card"])
    log("== phase 7: training parity")
    phase_training_parity_f32()
    phase_training_parity_bf16()
    log("== phase 8: K6a/K6b/K6c block-sparse attention vs their plain versions")
    sparse = phase_sparse_kernels()
    log("== phase 9: the sparse path: DeepSpeedConfig -> SparseSelfAttention forward and backward")
    sparse_path = phase_sparse_path(env["card"])
    log("== phase 10: K4a/K4b/K5a/K5b quantization vs their plain versions")
    quant = phase_quant_kernels()
    log("== phase 11: data-parallel training on two ranks with the ZeRO++ quantized gradient wire")
    dp = phase_data_parallel(env["card"])
    dec, ver = k3["decode"], k3["verify"]
    kernels = [{"name": "paged_attention", "route": "cuda", "source": "deepspeed_tpu_torch/csrc/paged_attention.cu",
                "replaces": "deepspeed_tpu/ops/paged_attention.py:40",
                "launches": serving["k3_launches"] + frontend["k3_launches"] + graphs["k3_launches"],
                # a partition of "launches": phase 13's are the verify
                # rounds of its spec serving run and the rest of the phase
                "launches_by_path": {"serving_step": serving["k3_launches"],
                                     "serving_frontend": frontend["k3_launches"],
                                     "step_graphs": graphs["k3_launches"] - graphs["verify_k3_launches"],
                                     "verify": graphs["verify_k3_launches"]},
                "max_abs_err": max(r["max_abs_err"] for n, r in k3.items() if n != "decode_f32"), "ms": dec["ms"],
                "plain_ms": dec["plain_ms"], "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
                "library_ms": dec["library_ms"], "prefill_ms": k3["prefill"]["ms"],
                "prefill_library_ms": k3["prefill"]["library_ms"], "verify_ms": ver["ms"],
                "verify_plain_ms": ver["plain_ms"], "verify_bound_ms": ver["bound_ms"],
                "verify_library_ms": ver["library_ms"]}]
    replaces = {"flash_fwd": "deepspeed_tpu/ops/flash_attention.py:162",
                "flash_dq": "deepspeed_tpu/ops/flash_attention.py:287",
                "flash_dkv": "deepspeed_tpu/ops/flash_attention.py:309"}
    for name, where in replaces.items():
        row = flash["bench"][name]     # the training path's shapes
        kernels.append({"name": name, "route": "cuda", "source": "deepspeed_tpu_torch/csrc/flash_attention.cu",
                        "replaces": where, "launches": training["launches"][name],
                        "max_abs_err": max(flash[s][name]["max_abs_err"] for s in flash), "ms": row["ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
    replaces = {"sparse_attn_fwd": "deepspeed_tpu/ops/sparse_attention/pallas_kernel.py:35",
                "sparse_attn_dq": "deepspeed_tpu/ops/sparse_attention/pallas_kernel.py:125",
                "sparse_attn_dkv": "deepspeed_tpu/ops/sparse_attention/pallas_kernel.py:152"}
    for name, where in replaces.items():
        row = sparse["timed"]["fixed"][name]     # the entry-point path's layout
        kernels.append({"name": name, "route": "cuda", "source": "deepspeed_tpu_torch/csrc/sparse_attention.cu",
                        "replaces": where, "launches": sparse_path["launches"][name],
                        "max_abs_err": sparse["errs"][name], "ms": row["ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    # no single PyTorch call quantizes per block with an absmax scale: library_ms is null
    for name in QUANT_NAMES:
        row = quant["rows"][name]     # the embedding's shape, the wire's largest tensor
        launches = dp["launches"] if "int8" in name else dp["int4_launches"]
        entry = {"name": name, "route": "cuda", "source": "deepspeed_tpu_torch/csrc/quant.cu",
                 "replaces": QUANT_REPLACES[name], "launches": launches[f"{name}_cuda"],
                 "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
                 "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": None}
        if "int8" in name:   # the grouped launches of one qgZ step (phase 10's step table)
            entry.update(launches_per_step=launches[f"{name}_cuda"] / (DP_WARMUP + DP_TIMED),
                         step_ms=quant["step"]["step_ms"][name], step_bound_ms=quant["step"]["step_bound_ms"][name])
        kernels.append(entry)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
