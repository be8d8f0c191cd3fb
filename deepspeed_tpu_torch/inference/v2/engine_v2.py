"""InferenceEngineV2 — FastGen-style continuous batching on a GPU (port of
``deepspeed_tpu/inference/v2/engine_v2.py``).

Reference: ``deepspeed/inference/v2/engine_v2.py:33 InferenceEngineV2``
(``put:124`` takes (uids, token-id lists)) and ``engine_factory.py:69
build_hf_engine``.  The serving loop composes:

  SplitFuseScheduler (scheduler.py)  — token-budget step planning
  StateManager/BlockedKVCache (ragged.py) — page allocation + batch packing
  LlamaForCausalLMWithCache (models/llama_cache.py) — one chunked forward
    serving prefill, continuation and decode
  K3 paged attention (ops/paged_attention.py → csrc/paged_attention.cu)

Against the JAX engine:
  * the same batch and chunk buckets (``_bucket_batch``; chunk 1 or
    ``prefill_chunk``), so scheduling — and therefore the tokens — match;
  * the KV arena (one tensor per layer) is written in place by each
    forward, the counterpart of donating it through ``jit``;
  * the fused k-round decode is a Python loop of k forward calls whose
    tokens stay on the device; ``complete_step`` is the only readback;
  * PyTorch runs eagerly, so there is no step-program cache to compile:
    a ``StepAnatomy`` attached with ``set_anatomy`` records the schedule,
    dispatch, device and sample/accept segments of each step as the JAX
    engine's hooks do, and its compile count stays 0.
  * Speculative decoding, tensor-parallel serving, quantized weights and
    the AOT step set come with later slices: the constructor raises on a
    config that asks for them, and ``set_spec`` on a request that does.
"""

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from ...accelerator import DeviceLike, resolve_device
from ...models.llama import LlamaConfig
from ...models.llama_cache import LlamaForCausalLMWithCache, PagedKVConfig, init_kv_cache
from ...telemetry.step_anatomy import NULL_ANATOMY
from ...utils.logging import logger
from .ragged import BlockedKVCache, RaggedBatch, StateManager
from .scheduler import SchedulerConfig, SplitFuseScheduler, StepPlan


@dataclasses.dataclass(frozen=True)
class RaggedInferenceEngineConfig:
    """ref: inference/v2/config_v2.py RaggedInferenceEngineConfig."""
    kv: PagedKVConfig = PagedKVConfig()
    scheduler: SchedulerConfig = SchedulerConfig()
    max_new_tokens: int = 128
    eos_token_id: Optional[int] = None
    greedy: bool = True
    temperature: float = 1.0
    kv_dtype: torch.dtype = torch.bfloat16
    # KV page reuse across shared prompt prefixes
    # (ref: inference/v2/ragged/prefix_cache_manager.py)
    enable_prefix_cache: bool = True
    # pure-decode rounds run back to back in ONE dispatch, tokens fed
    # device-side from round to round; sequences hitting EOS mid-block
    # have their surplus tokens discarded host-side
    decode_steps_per_dispatch: int = 8
    # not ported yet (later slices): must stay at their defaults
    tensor_parallel: int = 1
    spec: Optional[object] = None


class InFlightStep:
    """A dispatched-but-not-folded engine step: the forward passes are
    enqueued on the device and ``tokens`` is the device tensor of sampled
    tokens, not read back yet; everything else is host state captured at
    dispatch (sequence descriptors by OBJECT identity, so a flush that
    replaced a uid while the step was in flight is detectable)."""

    __slots__ = ("kind", "tokens", "rows", "seqs", "k")

    def __init__(self, kind: str):
        self.kind = kind          # "single" | "multi"
        self.tokens = None        # device tensor: sampled tokens
        self.rows = None          # single: [(uid, n, seq, row_index)]
        self.seqs = None          # multi: descriptor list at dispatch
        self.k = None             # multi: fused rounds in the dispatch


class InferenceEngineV2:
    """Continuous-batching engine over a paged-KV Llama model.

    ``params`` is the model's state dict (tensors or numpy arrays, e.g. from
    ``models/convert.py``); tensors already on ``device`` in ``param_dtype``
    are used in place, not copied, so two engines built from one state dict
    share their weights."""

    def __init__(self, cfg: LlamaConfig, params: Mapping[str, object],
                 engine_config: Optional[RaggedInferenceEngineConfig] = None, device: DeviceLike = "cuda",
                 seed: int = 0):
        self.econfig = engine_config or RaggedInferenceEngineConfig()
        if self.econfig.spec is not None:
            raise NotImplementedError("speculative decoding is not ported yet (ROADMAP.md Queue 1)")
        if self.econfig.tensor_parallel != 1:
            raise NotImplementedError("tensor-parallel serving is not ported yet (ROADMAP.md Queue 1)")
        self.device = resolve_device(device)
        kvcfg = self.econfig.kv
        self.cfg = cfg
        # built on the meta device: the state dict's tensors become the
        # weights (assign=True), so nothing is allocated twice
        model = LlamaForCausalLMWithCache(cfg, page_size=kvcfg.page_size, device="meta")
        state = {k: torch.as_tensor(v).to(device=self.device, dtype=cfg.param_dtype) for k, v in params.items()}
        model.load_state_dict(state, strict=True, assign=True)
        self.model = model.eval().requires_grad_(False)
        self.kv = BlockedKVCache(kvcfg.num_pages, kvcfg.page_size, kvcfg.max_pages_per_seq,
                                 enable_prefix_cache=self.econfig.enable_prefix_cache)
        self.state = StateManager(self.kv, max_batch=self.econfig.scheduler.max_seqs)
        self.scheduler = SplitFuseScheduler(self.econfig.scheduler)
        self.cache = init_kv_cache(cfg, kvcfg, dtype=self.econfig.kv_dtype, device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._max_new: Dict[int, int] = {}
        #: model forward passes run so far (one per layer stack traversal)
        self.forward_calls = 0
        # per-step anatomy (telemetry/step_anatomy.py): NULL by default, one
        # attribute read and one predicate per hook when disabled
        self.anatomy = NULL_ANATOMY
        #: the serving frontend's per-step verify-round accounting; always
        #: empty, as speculative decoding is not ported
        self.last_spec_round: Dict[int, object] = {}
        logger.info(f"InferenceEngineV2: {cfg.num_hidden_layers} layers on {self.device}, attention "
                    f"{cfg.attention_impl}, KV arena {kvcfg.num_pages} pages x {kvcfg.page_size} tokens "
                    f"({self.econfig.kv_dtype})")

    # ---------------------------------------------------------------- put

    def put(self, batch_uids: Sequence[int], batch_tokens: Sequence[Sequence[int]],
            max_new_tokens: Optional[int] = None) -> None:
        """Admit new sequences (ref: engine_v2.py:124 put)."""
        max_pos = self.cfg.max_position_embeddings
        # validate ALL before admitting ANY — a partial put would leave
        # earlier sequences admitted when a later one raises
        for uid, tokens in zip(batch_uids, batch_tokens):
            need = len(tokens) + (max_new_tokens or self.econfig.max_new_tokens)
            if need > max_pos:
                raise ValueError(f"sequence {uid}: prompt+max_new_tokens = {need} exceeds the "
                                 f"model's max_position_embeddings = {max_pos}")
        for uid, tokens in zip(batch_uids, batch_tokens):
            self.state.get_or_create(uid, list(tokens))
            self._max_new[uid] = max_new_tokens or self.econfig.max_new_tokens

    def flush(self, uid: int) -> None:
        self.state.flush(uid)
        self._max_new.pop(uid, None)

    def set_anatomy(self, anatomy):
        """Attach a :class:`~...telemetry.step_anatomy.StepAnatomy` recorder
        (None restores the NULL recorder).  ``dispatch_step`` opens its step
        window and ``complete_step`` closes it, as in the JAX engine; the
        port compiles no step program, so the recorder's compile count
        stays 0 and no segment is ever ``compile_wait``.  The recorder's
        clock should be the serving clock when a frontend drives this
        engine."""
        self.anatomy = anatomy if anatomy is not None else NULL_ANATOMY
        return self.anatomy

    def set_spec(self, uid: int, enabled: bool) -> None:
        """Per-sequence speculation opt-in (the serving frontend's
        per-request control): a no-op for ``enabled=False``; speculative
        decoding itself is not ported (ROADMAP.md Queue 1 item 2)."""
        if enabled:
            raise NotImplementedError("speculative decoding is not ported yet (ROADMAP.md Queue 1 item 2)")

    def preempt(self, uid: int):
        """Evict one sequence under KV pressure (serving frontend): pages
        released, descriptor returned for requeue-with-tokens-preserved.
        Unlike ``flush`` the uid must exist — preempting a finished/unknown
        sequence is a frontend bug, not a no-op."""
        self._max_new.pop(uid, None)
        return self.state.preempt(uid)

    def single_step_page_demand(self, plan: Optional[StepPlan] = None) -> int:
        """KV pages the NEXT step needs beyond what its sequences hold, at
        the guaranteed-progress rung (decode k=1 — the fused multi-decode
        path already self-shrinks k under pressure in ``step``).  The
        serving frontend preflights this against ``allocator.free_pages``
        and preempts until the step fits, instead of letting ``pack`` raise
        mid-step."""
        if plan is None:
            plan = self.scheduler.plan(self.state)
        return (sum(self.kv.pages_needed(s, 1) for s in plan.decode) +
                sum(self.kv.pages_needed(s, n) for s, n in plan.prefill))

    # ------------------------------------------------------------ forward

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _sample(self, row_logits: torch.Tensor) -> torch.Tensor:
        """[B, V] logits → [B] int32 tokens, greedy or categorical."""
        if self.econfig.greedy:
            return torch.argmax(row_logits, dim=-1).to(torch.int32)
        probs = torch.softmax(row_logits.float() / self.econfig.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[:, 0].to(torch.int32)

    @torch.no_grad()
    def _forward_last(self, tokens, start_pos, block_tables, chunk_lens) -> torch.Tensor:
        """One chunked forward; sample from the logits of each row's LAST
        real token (the LM head runs over those rows only)."""
        self.forward_calls += 1
        hidden = self.model.hidden(tokens, start_pos, block_tables, self.cache, chunk_lens)
        last = torch.clamp(chunk_lens.long() - 1, min=0)
        rows = hidden[torch.arange(hidden.shape[0], device=hidden.device), last]   # [B, E]
        return self._sample(self.model.logits(rows))

    # --------------------------------------------------------------- step

    def _dispatch_multi(self, seqs, k: int) -> InFlightStep:
        """Enqueue ``k`` fused decode rounds for a pure-decode batch."""
        batch = self._bucket_batch(len(seqs))
        for s in seqs:
            # capacity for the WHOLE block up front; pack()'s per-token
            # ensure_capacity then finds nothing left to allocate.  Capped
            # at the row's remaining max_new budget: a short-tail row keeps
            # at most `remaining` of the k tokens, and KV writes past its
            # reservation land in the null scratch page — reserving the
            # full k would over-allocate pages the row can never use
            remaining = self._max_new.get(s.uid, self.econfig.max_new_tokens) - len(s.generated)
            self.kv.ensure_capacity(s, min(k, remaining))
        rb: RaggedBatch = self.state.pack([(s, 1) for s in seqs], 1, pad_to=batch)
        anat = self.anatomy
        if anat.enabled:
            anat.note_shape("multi_decode", batch, k)
        toks = self._to_device(rb.tokens[:, 0])
        start_pos = self._to_device(rb.start_pos)
        block_tables = self._to_device(rb.block_tables)
        chunk_lens = self._to_device(rb.chunk_lens)
        out = torch.empty((batch, k), dtype=torch.int32, device=self.device)
        for i in range(k):
            toks = self._forward_last(toks[:, None], start_pos + i, block_tables, chunk_lens)
            out[:, i] = toks
        if anat.enabled:
            anat.mark("dispatch")
        inf = InFlightStep("multi")
        inf.tokens = out
        inf.seqs = list(seqs)
        inf.k = k
        return inf

    def _complete_multi(self, inf: InFlightStep) -> Dict[int, List[int]]:
        anat = self.anatomy
        toks = inf.tokens.cpu().numpy()
        if anat.enabled:
            anat.device_mark()
        out: Dict[int, List[int]] = {}
        eos = self.econfig.eos_token_id
        k = inf.k
        for i, s in enumerate(inf.seqs):
            if self.state.seqs.get(s.uid) is not s:
                continue  # flushed while in flight (pipelined tick)
            before = len(s.generated)
            s.seen_tokens += k
            limit = self._max_new.get(s.uid, self.econfig.max_new_tokens)
            for t in toks[i]:
                s.tokens.append(int(t))
                s.generated.append(int(t))
                if len(s.generated) >= limit or (eos is not None and int(t) == eos):
                    # surplus tokens computed past EOS/limit are discarded;
                    # truncate() clamps the seen boundary past them AND
                    # returns their wholly-surplus KV pages to the arena
                    # this step
                    s.done = True
                    break
            self.state.truncate(s, len(s.tokens))
            self.state.note_progress(s)
            out[s.uid] = list(s.generated[before:])
        if anat.enabled:
            anat.mark("sample_accept")
        return out

    def _bucket_batch(self, n: int) -> int:
        q = self.econfig.scheduler.decode_bucket
        return min(self.state.max_batch, -(-n // q) * q)

    def step(self, plan: Optional[StepPlan] = None) -> Dict[int, List[int]]:
        """Run one scheduled step; returns {uid: [new tokens]} for
        sequences that produced tokens this call — one token per uid on
        the single-step path, up to ``decode_steps_per_dispatch`` on the
        fused decode path.  ``plan`` lets a caller that already planned
        skip the re-plan; it must have been computed against the CURRENT
        state.  ``dispatch_step`` enqueues the device work and
        ``complete_step`` reads the tokens back and folds them."""
        inf = self.dispatch_step(plan)
        if inf is None:
            return {}
        return self.complete_step(inf)

    def dispatch_step(self, plan: Optional[StepPlan] = None) -> Optional[InFlightStep]:
        """Plan (unless given one) and ENQUEUE one step on the device
        without waiting for its outputs.  Returns None when there is
        nothing to run (empty plan).  With a ``StepAnatomy`` attached this
        opens the step window (idempotent: a frontend that planned first
        opened it itself); an empty or failed dispatch closes it here."""
        anat = self.anatomy
        if anat.enabled:
            anat.step_begin()
        inflight = None
        try:
            if plan is None:
                plan = self.scheduler.plan(self.state)
                if anat.enabled:
                    anat.mark("schedule")
            inflight = self._dispatch_inner(plan)
            return inflight
        finally:
            if inflight is None and anat.enabled:
                anat.step_end()

    def _dispatch_inner(self, plan: StepPlan) -> Optional[InFlightStep]:
        k_cfg = self.econfig.decode_steps_per_dispatch
        if k_cfg > 1 and plan.decode and not plan.prefill:
            # OVERSHOOT policy: always run the full k rung and discard
            # surplus tokens host-side (the KV written past a row's limit
            # lies beyond its clamped seen boundary).  k only shrinks when
            # the page arena, per-seq page capacity, or the position table
            # can't take the full block.
            max_pos = self.cfg.max_position_embeddings
            seq_room = min(min(self.kv.max_pages_per_seq * self.kv.page_size, max_pos) - len(s.tokens)
                           for s in plan.decode)
            k = k_cfg
            while k > 1 and (seq_room < k or sum(self.kv.pages_needed(s, k) for s in plan.decode)
                             > self.kv.allocator.free_pages):
                k //= 2
            if k > 1:
                return self._dispatch_multi(plan.decode, k)
        work: List = [(s, 1) for s in plan.decode] + list(plan.prefill)
        if not work:
            return None
        chunk = max(n for _, n in work)
        # chunk buckets: 1 (pure decode) or the prefill quantum
        chunk = 1 if chunk == 1 else self.econfig.scheduler.prefill_chunk
        batch = self._bucket_batch(len(work))
        rb: RaggedBatch = self.state.pack(work, chunk, pad_to=batch)
        anat = self.anatomy
        if anat.enabled:
            anat.note_shape("mixed" if plan.prefill and plan.decode else "prefill" if plan.prefill else "decode",
                            batch, chunk)
        next_tok = self._forward_last(self._to_device(rb.tokens), self._to_device(rb.start_pos),
                                      self._to_device(rb.block_tables), self._to_device(rb.chunk_lens))
        if anat.enabled:
            anat.mark("dispatch")
        inf = InFlightStep("single")
        inf.tokens = next_tok
        inf.rows = [(int(uid), int(rb.chunk_lens[i]), self.state.seqs[uid], i)
                    for i, uid in enumerate(rb.uids) if uid >= 0]
        return inf

    def complete_step(self, inf: InFlightStep) -> Dict[int, List[int]]:
        """Read the in-flight step's tokens back (the step's only device →
        host copy) and fold them into engine state.  Rows whose sequence was
        flushed while the step was in flight are skipped by object
        identity; their tokens are discarded whole, never half-applied.
        Closes the anatomy step window even when the readback raises."""
        try:
            if inf.kind == "multi":
                return self._complete_multi(inf)
            return self._complete_single(inf)
        finally:
            if self.anatomy.enabled:
                self.anatomy.step_end()

    def _complete_single(self, inf: InFlightStep) -> Dict[int, List[int]]:
        anat = self.anatomy
        next_tok = inf.tokens.cpu().numpy()
        if anat.enabled:
            anat.device_mark()
        out: Dict[int, List[int]] = {}
        eos = self.econfig.eos_token_id
        for uid, n, seq, i in inf.rows:
            if self.state.seqs.get(uid) is not seq:
                continue  # flushed while in flight (pipelined tick)
            seq.seen_tokens += n
            self.state.note_progress(seq)
            if seq.in_prefill:
                continue  # mid-prompt chunk: logits not used
            tok = int(next_tok[i])
            seq.tokens.append(tok)
            seq.generated.append(tok)
            out[uid] = [tok]
            if len(seq.generated) >= self._max_new.get(uid, self.econfig.max_new_tokens) or \
                    (eos is not None and tok == eos):
                seq.done = True
        if anat.enabled:
            anat.mark("sample_accept")
        return out

    # ----------------------------------------------------------- generate

    def generate(self, prompts: Sequence[Sequence[int]], max_new_tokens: Optional[int] = None) -> List[List[int]]:
        """Synchronous convenience: admit all prompts, run steps to
        completion, return generated token lists in order."""
        base = max(self.state.seqs.keys(), default=-1) + 1
        uids = [base + u for u in range(len(prompts))]
        self.put(uids, prompts, max_new_tokens=max_new_tokens)
        pending = set(uids)
        while pending:
            before = sum(s.seen_tokens + len(s.generated) for s in self.state.seqs.values())
            self.step()
            after = sum(s.seen_tokens + len(s.generated) for s in self.state.seqs.values())
            if after == before:
                raise RuntimeError("generation step made no progress "
                                   "(token budget / batch capacity exhausted?)")
            for u in list(pending):
                if self.state.seqs[u].done:
                    pending.discard(u)
        outs = [list(self.state.seqs[u].generated) for u in uids]
        for u in uids:
            self.flush(u)
        return outs


def build_engine(cfg: LlamaConfig, params: Mapping[str, object],
                 engine_config: Optional[RaggedInferenceEngineConfig] = None, device: DeviceLike = "cuda",
                 seed: int = 0) -> InferenceEngineV2:
    """Factory (ref: inference/v2/engine_factory.py:69 build_hf_engine —
    there it loads an HF checkpoint; here the weights are a state dict, e.g.
    the JAX package's params through ``models/convert.py``)."""
    return InferenceEngineV2(cfg, params, engine_config, device=device, seed=seed)
