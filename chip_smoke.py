#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA GPU (Hopper: the kernels are built for sm_90a) and ``nvcc``;
builds every kernel from ``deepspeed_tpu_torch/csrc`` on first use.  Phases:

  1. environment: card name and power limit, versions, kernel build time;
  2. K3 paged attention against its plain PyTorch version at the serving
     shapes of Llama-3-8B (H=32, n_kv=8, D=128, page 16, bf16): decode,
     a prefill chunk, and a mixed step with padding rows and null pages —
     error, kernel / plain / library (SDPA) time and the roofline bound;
  3. serving: ``build_engine`` → ``put`` / ``step`` on Llama-3-8B at full
     width and depth with seeded random weights, continuous batching of 8
     requests with SplitFuse chunking, fused decode and a prefix-cache hit;
     asserts token counts, page accounting and that every layer of every
     forward launched K3;
  4. path parity: the kernel path against the plain path — identical greedy
     streams in float32 (2 layers, full width), and close first-step logits
     in bf16 at full depth;
  5. K1/K2a/K2b flash attention against their plain versions at the
     training shapes of Llama-125M (B 24, S 1024, 12 heads of 64) and of
     Llama-3-8B (B 1, S 4096, 32/8 heads of 128), bf16 and f32, causal and
     full, with a query offset and with Sk > Sq — error, kernel / plain /
     library (SDPA forward, SDPA backward) time and the roofline bound;
  6. training: ``initialize`` → ``train_batch`` on Llama-125M at the JAX
     package's bench configuration (B 24, S 1024, bf16, AdamW, ZeRO-2,
     remat ``flash_saveable``), full width and depth with seeded random
     weights — tokens/s, step time, MFU, peak memory, losses falling on a
     repeated batch, K1/K2a/K2b launches per step (one per layer each), and
     a profiled step;
  7. training parity, kernel path (``attention_impl="flash"``) against the
     plain path (``"chunked"``): 3 float32 AdamW steps at 125M width, and 3
     bf16 steps at Llama-3-8B width (2 layers, S 2048) held against a
     float32 run.

Prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero, without that line, if
there is no GPU or any phase fails.
"""

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.accelerator import get_accelerator
from deepspeed_tpu_torch.inference.v2 import (PagedKVConfig, RaggedInferenceEngineConfig, SchedulerConfig,
                                              build_engine)
from deepspeed_tpu_torch.models.llama import PRESETS, LlamaConfig, LlamaForCausalLM, init_weights_
from deepspeed_tpu_torch.models.llama_cache import LlamaForCausalLMWithCache
from deepspeed_tpu_torch.models.llama_cache import paged_attention as paged_attention_plain
from deepspeed_tpu_torch.ops.op_builder import KERNEL_SOURCES, build_kernel
from deepspeed_tpu_torch.ops.flash_attention import (flash_bwd_plain, flash_delta_plain, flash_dkv_cuda,
                                                     flash_dq_cuda, flash_fwd_cuda, flash_fwd_plain)
from deepspeed_tpu_torch.ops.paged_attention import paged_attention_cuda

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
LAUNCH_COUNTERS = (paged_attention_cuda, flash_fwd_cuda, flash_dq_cuda, flash_dkv_cuda)


def reset_launch_counts() -> None:
    """Every kernel's launch count to 0: done just before each path is driven."""
    for fn in LAUNCH_COUNTERS:
        fn.launches = 0


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
    for name in KERNEL_SOURCES:
        t0 = time.perf_counter()
        output = build_kernel(name)
        log(f"  {name}: nvcc {time.perf_counter() - t0:.2f} s" + ("" if output else " (already built)"))
        for line in output.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"    {line.strip()}")
    log(f"kernels built in {time.perf_counter() - t_all:.2f} s")
    return {"card": smi}


# ---------------------------------------------------------------- phase 2


def make_case(starts, clens, c, dtype, seed):
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
    pages = torch.randn((n_pages, PAGE, 2, N_KV, D), generator=gen, device="cuda").to(dtype)
    q = torch.randn((len(starts), c, H, D), generator=gen, device="cuda").to(dtype)
    return dict(q=q, pages=pages, block_table=bt.cuda(), start_pos=torch.tensor(starts, dtype=torch.int32).cuda(),
                chunk_lens=torch.tensor(clens, dtype=torch.int32).cuda(), page_size=PAGE)


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
    b, c = case["q"].shape[:2]
    starts = case["start_pos"].tolist()
    clens = case["chunk_lens"].tolist()
    live_keys = sum(s + n for s, n in zip(starts, clens) if n > 0)
    live_pages = sum(-(-(s + n) // PAGE) for s, n in zip(starts, clens) if n > 0)
    row_bytes = H * D * esize
    nbytes = (live_keys * 2 * N_KV * D * esize + sum(clens) * row_bytes + b * c * row_bytes +
              4 * (live_pages + 2 * b))
    flops = sum(4 * H * D * (s + j + 1) for s, n in zip(starts, clens) for j in range(n))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_inputs(case):
    """q [B, H, C, D], K/V gathered per sequence [B, H, S, D] (GQA heads
    repeated) and the boolean mask of what each row may see."""
    q, pages, bt = case["q"], case["pages"], case["block_table"]
    b, c = q.shape[:2]
    s_max = max(1, max(s + n for s, n in zip(case["start_pos"].tolist(), case["chunk_lens"].tolist())))
    n_pg = -(-s_max // PAGE)
    g = pages[bt[:, :n_pg].reshape(-1).long()].reshape(b, n_pg * PAGE, 2, N_KV, D)[:, :s_max]
    k = g[:, :, 0].repeat_interleave(H // N_KV, dim=2).transpose(1, 2).contiguous()
    v = g[:, :, 1].repeat_interleave(H // N_KV, dim=2).transpose(1, 2).contiguous()
    qpos = case["start_pos"].long()[:, None] + torch.arange(c, device="cuda")[None, :]
    mask = torch.arange(s_max, device="cuda")[None, None, :] <= qpos[..., None]
    return q.transpose(1, 2).contiguous(), k, v, mask[:, None]


def run_case(name, case, dtype, flush, timed=True) -> dict:
    args = (case["q"], case["pages"], case["block_table"], case["start_pos"], case["chunk_lens"], PAGE)
    got = paged_attention_cuda(*args)
    want = paged_attention_plain(*args)
    torch.cuda.synchronize()
    atol, rtol = TOLERANCE[dtype]
    err = (got.float() - want.float()).abs()
    max_err = float(err.max())
    ok = bool((err <= atol + rtol * want.float().abs()).all())
    pad = case["chunk_lens"] == 0
    if bool(pad.any()) and not bool((got[pad] == 0).all()):
        raise AssertionError(f"{name}: padding rows are not zero")
    if not ok or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: kernel disagrees with the plain version: max |err| {max_err:.3e} "
                             f"(tolerance {atol} + {rtol}·|plain|)")
    row = {"case": name, "max_abs_err": max_err}
    b_ms, b_by = bound_ms(case, dtype)
    row.update(bound_ms=b_ms, bound_by=b_by)
    if timed:
        row["ms"] = time_ms(lambda: paged_attention_cuda(*args), 20, flush)
        row["plain_ms"] = time_ms(lambda: paged_attention_plain(*args), 5, flush)
        qs, ks, vs, mask = sdpa_inputs(case)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        row["library_ms"] = time_ms(lambda: sdpa(qs, ks, vs, attn_mask=mask), 10, flush)
    log(f"  K3 {name}: " + ", ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                                     for k, v in row.items() if k != "case"))
    return row


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
    rows = {}
    for name, (starts, clens, c) in (("decode", decode), ("prefill", prefill), ("mixed", mixed)):
        rows[name] = run_case(name, make_case(starts, clens, c, torch.bfloat16, seed=len(rows)), torch.bfloat16,
                              flush)
    rows["decode_f32"] = run_case("decode_f32", make_case(*decode, torch.float32, seed=7), torch.float32, flush,
                                  timed=False)
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

    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (64, 1024, 300, 700, 128, 512, 900, 100)]
    prompts[7] = prompts[1][:512] + prompts[7]             # shares 32 full pages with request 1
    lens = [len(p) for p in prompts]
    max_new = rng.integers(32, 65, len(prompts)).tolist()
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
           "forwards": forwards, "k3_launches": launches, "prefix_hits": hits,
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
    g = FLASH_SHAPES[shape]
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
    dec = k3["decode"]
    kernels = [{"name": "paged_attention", "route": "cuda", "source": "deepspeed_tpu_torch/csrc/paged_attention.cu",
                "replaces": "deepspeed_tpu/ops/paged_attention.py:40", "launches": serving["k3_launches"],
                "max_abs_err": max(r["max_abs_err"] for n, r in k3.items() if n != "decode_f32"), "ms": dec["ms"],
                "plain_ms": dec["plain_ms"], "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
                "library_ms": dec["library_ms"]}]
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
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
