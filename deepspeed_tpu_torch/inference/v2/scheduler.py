"""Dynamic SplitFuse continuous-batching scheduler (the port's own copy of
``deepspeed_tpu/inference/v2/scheduler.py``).

Reference: FastGen's scheduling policy (``deepspeed/inference/v2/engine_v2.py
put()`` + the SplitFuse description in ``blogs/deepspeed-fastgen``): each
engine step runs a *fixed token budget*, filled by (a) every running decode
sequence (1 token each) and (b) chunks of pending prefills — long prompts
are split across steps, short ones fused, keeping step latency flat.

The engine additionally quantises steps to a few batch and chunk-size
buckets, the same buckets as the JAX engine, so that both schedule — and
therefore generate — identically.
"""

import dataclasses
from typing import List, Tuple

from .ragged import SequenceDescriptor, StateManager


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    token_budget: int = 512            # ref: max ragged batch token count
    max_seqs: int = 64                 # ref: max ragged sequence count
    prefill_chunk: int = 128           # SplitFuse chunk quantum
    decode_bucket: int = 8             # decode batch rounds up to a multiple
    # speculative decoding (engine_v2 sets this from SpecConfig.max_draft):
    # the verify-slot width a speculating decode row may grow to.  Verify
    # rounds run ONLY on pure-decode steps (no prefill planned), so plan()
    # keeps charging mixed steps 1 token per bucketed decode row — charging
    # 1+k there would throttle prefill for verify work that cannot happen.
    # The budget is enforced where verify slots are actually planned:
    # engine_v2._plan_drafts caps each row's draft at this width and
    # shrinks the round until its total fed tokens (1 + draft per row) fit
    # token_budget.
    spec_verify_tokens: int = 0


@dataclasses.dataclass
class StepPlan:
    """One engine step = one decode batch + up to one prefill chunk batch."""
    decode: List[SequenceDescriptor]
    prefill: List[Tuple[SequenceDescriptor, int]]   # (seq, n_tokens)

    @property
    def planned_tokens(self) -> int:
        """Real tokens this step will feed: one per decode row plus the
        prefill chunk tokens — the serving ``step_cost`` model's input
        and the step-anatomy row's token-volume attribution (one
        definition, two consumers, no drift)."""
        return len(self.decode) + sum(n for _, n in self.prefill)


class SplitFuseScheduler:

    def __init__(self, config: SchedulerConfig):
        self.config = config
        # optional ordering hook (the serving frontend installs FCFS-with-
        # aging here): ``order_key(seq) -> sortable``, lowest served first.
        # None keeps dict-insertion (put) order — the historical behaviour
        # for direct engine users.
        self.order_key = None

    def plan(self, manager: StateManager) -> StepPlan:
        cfg = self.config
        # paused sequences (mid-KV-migration — serving/kvtransfer) keep
        # their state and pages but take no step work: their pages must stay
        # byte-stable while export chunks overlap the other sequences' steps
        running = [s for s in manager.seqs.values() if not s.done and not s.paused]
        if self.order_key is not None:
            running.sort(key=self.order_key)
        decodes = [s for s in running if s.in_decode]
        prefills = [s for s in running if s.in_prefill and not s.in_decode]

        decodes = decodes[:cfg.max_seqs]
        # TOKEN BUDGET charges the BUCKETED decode count: the compiled step
        # pads the batch to a decode_bucket multiple, and the padded rows
        # flow through the whole program whether or not they carry tokens.
        # The SEQUENCE-SLOT bound below keeps the RAW count — the engine
        # buckets the COMBINED decode+prefill work (_bucket_batch), so a
        # prefill can ride in a padding slot; charging bucketed decode there
        # would starve prefill whenever decode_bucket approaches max_seqs
        n_bucketed = min(cfg.max_seqs,
                         -(-len(decodes) // cfg.decode_bucket) * cfg.decode_bucket) \
            if decodes else 0
        budget = cfg.token_budget - n_bucketed

        plan_prefill: List[Tuple[SequenceDescriptor, int]] = []
        for seq in prefills:
            if budget <= 0 or len(plan_prefill) + len(decodes) >= cfg.max_seqs:
                break
            n = min(seq.remaining_prefill, cfg.prefill_chunk, budget)
            if n <= 0:
                # defensive: unreachable under the current filters (prefills
                # all have remaining_prefill >= 1, budget > 0 checked above)
                # — but a zero-work seq must SKIP, not break: breaking would
                # starve every sequence queued behind it
                continue
            plan_prefill.append((seq, n))
            budget -= n
        return StepPlan(decode=decodes, prefill=plan_prefill)
