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
     in bf16 at full depth.

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

from deepspeed_tpu_torch.accelerator import get_accelerator
from deepspeed_tpu_torch.inference.v2 import (PagedKVConfig, RaggedInferenceEngineConfig, SchedulerConfig,
                                              build_engine)
from deepspeed_tpu_torch.models.llama import PRESETS, init_weights_
from deepspeed_tpu_torch.models.llama_cache import LlamaForCausalLMWithCache
from deepspeed_tpu_torch.models.llama_cache import paged_attention as paged_attention_plain
from deepspeed_tpu_torch.ops.op_builder import KERNEL_SOURCES, build_kernel
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
    by a write of ``flush`` (larger than the 50 MB L2), which also keeps
    the card busy while the host enqueues the timed work."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
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
    paged_attention_cuda.launches = 0
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
    dec = k3["decode"]
    kernels = [{"name": "paged_attention", "route": "cuda", "source": "deepspeed_tpu_torch/csrc/paged_attention.cu",
                "replaces": "deepspeed_tpu/ops/paged_attention.py:40", "launches": serving["k3_launches"],
                "max_abs_err": max(r["max_abs_err"] for n, r in k3.items() if n != "decode_f32"), "ms": dec["ms"],
                "plain_ms": dec["plain_ms"], "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
                "library_ms": dec["library_ms"]}]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
