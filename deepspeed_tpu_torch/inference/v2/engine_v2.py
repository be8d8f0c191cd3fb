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
  * the fused k-round decode is a loop of k forward calls whose tokens
    stay on the device; ``complete_step`` is the only readback;
  * the step programs: where the JAX engine jits one program per key of
    ``step_shape_set`` ((batch, chunk), the fused rung's ("multi", batch,
    k), the verify ("verify", batch, max_draft + 1)), the port captures
    one CUDA graph per key on the card (``step_graphs.GraphStep``), lazily
    at the key's first dispatch or up front in ``warm_all``; on the CPU a
    program runs its step eagerly (``step_graphs.EagerStep``).  Captures
    land in the ``StepAnatomy`` compile log as the JAX engine's compiles do;
  * speculative decoding (``spec/``): the n-gram drafter, one verify
    forward over max_draft + 1 positions, accept-longest-prefix and the
    ``truncate`` rollback, greedy-parity by construction;
  * tensor-parallel serving and quantized weights come with later slices:
    the constructor raises on a config that asks for them.
"""

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from ...accelerator import DeviceLike, resolve_device
from ...models.llama import LlamaConfig
from ...models.llama_cache import LlamaForCausalLMWithCache, PagedKVConfig, init_kv_cache
from ...telemetry.step_anatomy import NULL_ANATOMY
from ...utils.logging import logger
from .ragged import BlockedKVCache, RaggedBatch, StateManager
from .scheduler import SchedulerConfig, SplitFuseScheduler, StepPlan
from .spec import SpecConfig, SpecStats, make_drafter
from .step_graphs import EagerStep, GraphSpace, GraphStep, padding_arrays


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
    # pure-decode rounds run back to back in ONE dispatch (one graph on
    # the card), tokens fed device-side from round to round; sequences
    # hitting EOS mid-block have their surplus tokens discarded host-side
    decode_steps_per_dispatch: int = 8
    # not ported yet (a later slice): must stay at its default
    tensor_parallel: int = 1
    # speculative decoding (spec/): a drafter proposes up to k tokens per
    # pure-decode round and ONE (k+1)-position verify dispatch emits
    # accepted+1 of them, greedy-parity by construction.  Greedy only; on
    # pure-decode rounds speculation takes precedence over the fused
    # multi-step rung (which stays the fallback when no row drafts or KV
    # pages are short).  None disables.
    spec: Optional[SpecConfig] = None


class InFlightStep:
    """A dispatched-but-not-folded engine step: the forward passes are
    enqueued on the device and ``tokens`` is the device tensor of sampled
    tokens, not read back yet; everything else is host state captured at
    dispatch (sequence descriptors by OBJECT identity, so a flush that
    replaced a uid while the step was in flight is detectable)."""

    __slots__ = ("kind", "tokens", "rows", "seqs", "drafts", "base_len", "k")

    def __init__(self, kind: str):
        self.kind = kind          # "single" | "multi" | "spec"
        self.tokens = None        # device tensor: sampled tokens / argmax
        self.rows = None          # single: [(uid, n, seq, row_index)]
        self.seqs = None          # multi/spec: descriptor list at dispatch
        self.drafts = None        # spec: per-row draft token lists
        self.base_len = None      # spec: pre-splice history lengths
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
        # speculative decoding: greedy-only (the accept rule is an argmax
        # identity — under sampling, emitted tokens would need the full
        # rejection-sampling correction, not implemented), and the verify
        # slots must be charged against the scheduler's token budget
        if self.econfig.spec is not None and not self.econfig.greedy:
            logger.warning("spec decoding requires greedy sampling "
                           "(accept-longest-prefix parity is an argmax identity); "
                           "disabling speculation")
            self.econfig = dataclasses.replace(self.econfig, spec=None)
        if self.econfig.spec is not None and self.econfig.scheduler.spec_verify_tokens == 0:
            self.econfig = dataclasses.replace(
                self.econfig, scheduler=dataclasses.replace(self.econfig.scheduler,
                                                            spec_verify_tokens=self.econfig.spec.max_draft))
        self.drafter = make_drafter(self.econfig.spec) if self.econfig.spec is not None else None
        self.spec_stats = SpecStats()
        # uid -> (proposed, accepted, rollback_pages) of the LAST step's
        # verify round (cleared every step): the serving frontend folds
        # these into per-request acceptance accounting and metrics
        self.last_spec_round: Dict[int, Tuple[int, int, int]] = {}
        self._spec_on: Dict[int, bool] = {}
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
        #: step-set key -> its program (GraphStep on the card, EagerStep on
        #: the CPU), built lazily at the key's first dispatch or in warm_all
        self._step_fns: Dict[tuple, object] = {}
        self._fresh_compile = False
        #: the capture stream and graph pool of this engine's step graphs
        self._graphs = GraphSpace(self.device) if self.device.type == "cuda" else None
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
        self._spec_on.pop(uid, None)
        self.last_spec_round.pop(uid, None)

    def set_anatomy(self, anatomy):
        """Attach a :class:`~...telemetry.step_anatomy.StepAnatomy` recorder
        (None restores the NULL recorder).  ``dispatch_step`` opens its step
        window and ``complete_step`` closes it, as in the JAX engine; a
        step program built at its first dispatch is a compile
        (``compile_wait``), one built by ``warm_all`` an ``aot`` compile.
        The recorder's clock should be the serving clock when a frontend
        drives this engine."""
        self.anatomy = anatomy if anatomy is not None else NULL_ANATOMY
        return self.anatomy

    def _note_compile(self, key: str) -> None:
        """One step program built at its first dispatch: the dispatch pays
        the build (on the card the warm run and the capture), so its
        segment is tagged ``compile_wait`` and the compile tracker records
        the miss (warm-up vs steady-state — the regression guard)."""
        self._fresh_compile = True
        self.anatomy.note_compile(key)

    def set_spec(self, uid: int, enabled: bool) -> None:
        """Per-sequence speculation opt-in/out (the serving frontend's
        per-request control).  No-op when the engine carries no spec
        config — a request asking for speculation on a spec-less engine
        just decodes normally."""
        if self.econfig.spec is not None:
            self._spec_on[uid] = bool(enabled)

    def preempt(self, uid: int):
        """Evict one sequence under KV pressure (serving frontend): pages
        released, descriptor returned for requeue-with-tokens-preserved.
        Unlike ``flush`` the uid must exist — preempting a finished/unknown
        sequence is a frontend bug, not a no-op."""
        self._max_new.pop(uid, None)
        self._spec_on.pop(uid, None)
        self.last_spec_round.pop(uid, None)
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

    @torch.no_grad()
    def _forward_multi(self, k: int, tokens0, start_pos, block_tables, chunk_lens) -> torch.Tensor:
        """``k`` fused decode rounds, each row's token fed back on the
        device: [B] tokens → [B, k]."""
        out = torch.empty((tokens0.shape[0], k), dtype=torch.int32, device=tokens0.device)
        toks = tokens0
        for i in range(k):
            toks = self._forward_last(toks[:, None], start_pos + i, block_tables, chunk_lens)
            out[:, i] = toks
        return out

    @torch.no_grad()
    def _forward_verify(self, tokens, start_pos, block_tables, chunk_lens) -> torch.Tensor:
        """The speculative verify forward: one chunked forward, the LM head
        over EVERY position, and the argmax there (the model's own
        next-token choice after each fed prefix): [B, W] → [B, W] int32."""
        self.forward_calls += 1
        hidden = self.model.hidden(tokens, start_pos, block_tables, self.cache, chunk_lens)
        return torch.argmax(self.model.logits(hidden), dim=-1).to(torch.int32)

    # ------------------------------------------------------- step programs

    def _step_fn(self, key) -> Tuple[Callable, List[tuple]]:
        """A step-set key's step function over device tensors and the shapes
        of its inputs (tokens, start_pos, block_tables, chunk_lens)."""
        maxp = self.kv.max_pages_per_seq
        if key[0] == "multi":
            _, b, k = key
            return (lambda *a: self._forward_multi(k, *a)), [(b, ), (b, ), (b, maxp), (b, )]
        if key[0] == "verify":
            _, b, w = key
            return self._forward_verify, [(b, w), (b, ), (b, maxp), (b, )]
        b, c = key
        return self._forward_last, [(b, c), (b, ), (b, maxp), (b, )]

    def _build_program(self, key):
        """The program of one step-set key: on the card its warm run and
        capture (``GraphStep``), on the CPU an ``EagerStep``."""
        fn, shapes = self._step_fn(key)
        if self._graphs is not None:
            return GraphStep(self, self._graphs, fn, padding_arrays(shapes))
        return EagerStep(fn, self.device)

    def _program(self, key):
        """The key's program, built at its first dispatch (a compile)."""
        prog = self._step_fns.get(key)
        if prog is None:
            logger.info(f"InferenceEngineV2: building step program {self._key_label(key)}")
            self._note_compile(self._key_label(key))
            prog = self._step_fns[key] = self._build_program(key)
        return prog

    @staticmethod
    def _key_label(key) -> str:
        if key[0] == "multi":
            return f"multi:b{key[1]}:k{key[2]}"
        if key[0] == "verify":
            return f"verify:b{key[1]}:w{key[2]}"
        return f"step:b{key[0]}:c{key[1]}"

    def step_shape_set(self) -> List[tuple]:
        """Enumerate every program key steady-state serving can reach,
        straight from the scheduler's bucket table: batch buckets are the
        ``decode_bucket`` multiples up to ``max_seqs``; chunk buckets are
        {1, prefill_chunk} (the only two the single-step path produces);
        the fused-decode rung adds its halving ladder (k_cfg, k_cfg/2,
        ..., 2 — exactly the pressure fallbacks ``_dispatch_inner``
        walks); a drafter adds one verify width (``max_draft + 1``).  A
        steady-state dispatch outside this set would be an engine bug, and
        the ``engine/recompile_steady_state`` guard would name it."""
        sched = self.econfig.scheduler
        q = sched.decode_bucket
        maxb = self.state.max_batch
        batches = sorted({min(maxb, m * q) for m in range(1, -(-maxb // q) + 1)})
        keys: List[tuple] = [(b, c) for b in batches for c in sorted({1, sched.prefill_chunk})]
        k_cfg = self.econfig.decode_steps_per_dispatch
        if k_cfg > 1:
            ks = set()
            k = k_cfg
            while k > 1:
                ks.add(k)
                k //= 2
            keys += [("multi", b, k) for b in batches for k in sorted(ks)]
        if self.drafter is not None:
            width = self.econfig.spec.max_draft + 1
            keys += [("verify", b, width) for b in batches]
        return keys

    def warm_all(self) -> Dict[str, object]:
        """Build the full reachable step set (``step_shape_set``) up front,
        so steady-state serving never captures inside a dispatch: on the
        card one CUDA graph per key, on the CPU one all-padding eager run
        per key.  Returns ``{"compiled", "cached", "fallback", "keys"}`` as
        the JAX engine's ``warm_all`` does.

        Failure stance: an ``engine.aot_compile`` chaos injection on one key
        leaves that key to be built lazily at its first dispatch; only
        ``InjectedCrash`` (simulated process death) propagates.  A real
        capture error is raised, never served through an eager route.  Each
        key built here lands in the compile log as ``aot=True``, exempt from
        the steady-state-recompile guard."""
        from ...resilience import fault_injection as _fi
        anat = self.anatomy
        compiled = cached = fallback = 0
        keys = self.step_shape_set()
        for key in keys:
            if key in self._step_fns:
                cached += 1
                continue
            label = self._key_label(key)
            try:
                _fi.check("engine.aot_compile")
            except _fi.InjectedCrash:
                raise
            except Exception as e:
                fallback += 1
                logger.warning(f"InferenceEngineV2: building {label} up front failed ({e}); "
                               "it is built at its first dispatch")
                continue
            prog = self._step_fns[key] = self._build_program(key)
            if self._graphs is None:
                # on the CPU a key counts as built after one all-padding
                # dispatch; on the card the capture's warm run is that
                prog.warm(padding_arrays(self._step_fn(key)[1]), self.generator)
            compiled += 1
            anat.note_compile(label, aot=True)
        if anat.enabled and compiled:
            # inside an open step window the build time is attributed
            # explicitly; outside one, mark() is a no-op by design
            anat.mark("aot_compile")
        return {"compiled": compiled, "cached": cached, "fallback": fallback,
                "keys": [self._key_label(k) for k in keys]}

    def warm_verify(self, batch_sizes: Sequence[int]) -> None:
        """Build the speculative verify program for the given raw batch
        sizes (bucketed, width pinned at ``max_draft + 1``) and run one
        ALL-PADDING dispatch per bucket: every row has chunk_len 0 and an
        all-null block table, so KV writes land in the null page 0 and
        engine state is untouched.  No-op without a spec config."""
        if self.drafter is None:
            return
        width = self.econfig.spec.max_draft + 1
        for b in sorted({self._bucket_batch(n) for n in batch_sizes}):
            key = ("verify", b, width)
            self._program(key).run(padding_arrays(self._step_fn(key)[1]))

    # --------------------------------------------------------- speculation

    def _plan_drafts(self, seqs) -> List[List[int]]:
        """Draft up to ``max_draft`` tokens per decode row, then shrink
        under pressure.  Per-row caps keep the verify dispatch feasible by
        construction: a draft never proposes past the row's ``max_new``
        limit (emitting ``accepted + 1`` tokens, only ``remaining - 1``
        drafts can ever be useful), the verify-slot width the scheduler
        charges (``spec_verify_tokens``), the position table, or its page
        capacity.  Aggregate demand self-shrinks the same way the fused
        rung does — halve every draft until the arena can take the round
        AND the round's total fed tokens (1 + draft per row) fit the
        SplitFuse ``token_budget`` — so the KV-pressure preflight's k=1
        guarantee still holds when every draft reaches zero."""
        spec = self.econfig.spec
        sched = self.econfig.scheduler
        width = min(spec.max_draft, sched.spec_verify_tokens or spec.max_draft)
        cap = min(self.kv.max_pages_per_seq * self.kv.page_size, self.cfg.max_position_embeddings)
        drafts: List[List[int]] = []
        for s in seqs:
            if not self._spec_on.get(s.uid, True):
                drafts.append([])
                continue
            limit = self._max_new.get(s.uid, self.econfig.max_new_tokens)
            room = min(width, limit - len(s.generated) - 1, cap - len(s.tokens))
            drafts.append(self.drafter.draft(s.tokens, room) if room > 0 else [])
        while any(drafts) and (sum(1 + len(d) for d in drafts) > sched.token_budget or sum(
                self.kv.pages_needed(s, 1 + len(d)) for s, d in zip(seqs, drafts)) > self.kv.allocator.free_pages):
            drafts = [d[:len(d) // 2] for d in drafts]
        return drafts

    def _dispatch_spec(self, seqs, drafts: List[List[int]]) -> InFlightStep:
        """Enqueue one draft-verify round for a pure-decode batch: feed
        ``[last_sampled, draft_0 .. draft_{d-1}]`` per row through the
        verify program.  The accept fold (``_complete_spec``) accepts the
        longest prefix of drafts matching the model's per-position argmax,
        emits ``accepted + 1`` tokens (the argmax after the last accepted
        draft rides along as the bonus/correction token), and rolls
        rejected tokens' KV back via ``StateManager.truncate``."""
        from ...resilience import fault_injection as _fi
        anat = self.anatomy
        width = self.econfig.spec.max_draft + 1
        batch = self._bucket_batch(len(seqs))
        base_len = [len(s.tokens) for s in seqs]
        # drafts ride in the token history for pack() (sliced back out in
        # the fold — they are verify INPUTS, not accepted output)
        for s, d in zip(seqs, drafts):
            s.tokens.extend(d)
        try:
            rb: RaggedBatch = self.state.pack([(s, 1 + len(d)) for s, d in zip(seqs, drafts)], width, pad_to=batch)
            if anat.enabled:
                anat.mark("verify_plan")
            prog = self._program(("verify", batch, width))
            if anat.enabled:
                anat.note_shape("spec_verify", batch, width)
            _fi.check("engine.verify_step")  # chaos site: device loss mid-verify
            argmax = prog.run((rb.tokens, rb.start_pos, rb.block_tables, rb.chunk_lens))
            if anat.enabled:
                anat.mark("compile_wait" if self._fresh_compile else "dispatch")
        except BaseException:
            # a failed verify dispatch must never bake unverified drafts
            # into the history: restore every row's token list so a caller
            # that survives the error decodes from exactly the pre-round
            # state
            for s, L in zip(seqs, base_len):
                del s.tokens[L:]
            raise
        inf = InFlightStep("spec")
        inf.tokens = argmax
        inf.seqs = list(seqs)
        inf.drafts = drafts
        inf.base_len = base_len
        return inf

    def _complete_spec(self, inf: InFlightStep) -> Dict[int, List[int]]:
        anat = self.anatomy
        seqs, drafts, base_len = inf.seqs, inf.drafts, inf.base_len
        try:
            argmax = inf.tokens.cpu().numpy()
        except BaseException:
            # the deferred readback surfaced a device failure: restore every
            # still-live row's history as the dispatch-path handler does
            for s, L in zip(seqs, base_len):
                if self.state.seqs.get(s.uid) is s:
                    del s.tokens[L:]
            raise
        if anat.enabled:
            anat.device_mark()
        out: Dict[int, List[int]] = {}
        eos = self.econfig.eos_token_id
        self.spec_stats.rounds += 1
        for i, (s, d) in enumerate(zip(seqs, drafts)):
            if self.state.seqs.get(s.uid) is not s:
                continue  # flushed while in flight (pipelined tick)
            L = base_len[i]
            s.seen_tokens += 1 + len(d)
            # g[j] = the model's choice for history index L+j given the
            # prefix through index L-1+j; draft j is accepted iff it
            # equals g[j]
            g = [int(t) for t in argmax[i, :1 + len(d)]]
            a = 0
            while a < len(d) and d[a] == g[a]:
                a += 1
            del s.tokens[L:]
            before = len(s.generated)
            limit = self._max_new.get(s.uid, self.econfig.max_new_tokens)
            for t in d[:a] + [g[a]]:
                s.tokens.append(int(t))
                s.generated.append(int(t))
                if len(s.generated) >= limit or (eos is not None and int(t) == eos):
                    s.done = True
                    break
            # rollback: rejected drafts' KV lies past the accepted boundary
            # — clamp seen_tokens and return wholly-surplus pages to the
            # arena THIS step
            freed = self.state.truncate(s, min(L + a, len(s.tokens)))
            self.state.note_progress(s)
            out[s.uid] = list(s.generated[before:])
            self.spec_stats.proposed += len(d)
            self.spec_stats.accepted += a
            self.spec_stats.emitted += len(out[s.uid])
            self.spec_stats.rollback_pages += freed
            self.last_spec_round[s.uid] = (len(d), a, freed)
        if anat.enabled:
            anat.mark("sample_accept")
        return out

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
        prog = self._program(("multi", batch, k))
        if anat.enabled:
            anat.note_shape("multi_decode", batch, k)
        toks = prog.run((rb.tokens[:, 0], rb.start_pos, rb.block_tables, rb.chunk_lens))
        if anat.enabled:
            anat.mark("compile_wait" if self._fresh_compile else "dispatch")
        inf = InFlightStep("multi")
        inf.tokens = toks
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
        self._fresh_compile = False
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
        anat = self.anatomy
        # per-step spec accounting: entries describe THIS step's verify
        # round only (the serving frontend reads them right after the
        # step's completion)
        self.last_spec_round.clear()
        if self.drafter is not None and plan.decode and not plan.prefill:
            # speculation outranks the fused rung on pure-decode rounds; a
            # round where no row drafts (cold history, per-request opt-out,
            # page pressure shrank every draft to zero) falls through to
            # the fused/single-step rungs
            drafts = self._plan_drafts(plan.decode)
            if anat.enabled:
                anat.mark("draft_plan")
            if any(drafts):
                return self._dispatch_spec(plan.decode, drafts)
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
        prog = self._program((batch, chunk))
        if anat.enabled:
            anat.note_shape("mixed" if plan.prefill and plan.decode else "prefill" if plan.prefill else "decode",
                            batch, chunk)
        next_tok = prog.run((rb.tokens, rb.start_pos, rb.block_tables, rb.chunk_lens))
        if anat.enabled:
            anat.mark("compile_wait" if self._fresh_compile else "dispatch")
        inf = InFlightStep("single")
        inf.tokens = next_tok
        inf.rows = [(int(uid), int(rb.chunk_lens[i]), self.state.seqs[uid], i)
                    for i, uid in enumerate(rb.uids) if uid >= 0]
        return inf

    def wait_step(self, inf: InFlightStep) -> None:
        """Block until a dispatched step's device work is done, without
        folding its tokens into engine state (the serving frontend's
        ``close``: a dropped engine must have nothing in flight)."""
        if inf.tokens is not None and inf.tokens.is_cuda:
            torch.cuda.current_stream(inf.tokens.device).synchronize()

    def complete_step(self, inf: InFlightStep) -> Dict[int, List[int]]:
        """Read the in-flight step's tokens back (the step's only device →
        host copy) and fold them into engine state.  Rows whose sequence was
        flushed while the step was in flight are skipped by object
        identity; their tokens are discarded whole, never half-applied.
        Closes the anatomy step window even when the readback raises."""
        try:
            if inf.kind == "spec":
                return self._complete_spec(inf)
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
