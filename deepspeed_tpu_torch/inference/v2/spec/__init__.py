"""Speculative decoding for the SplitFuse hot path: draft k, verify once
(port of ``deepspeed_tpu/inference/v2/spec``: host-side only, copied as is).

Reference: draft-verify speculative decoding (Leviathan et al. 2023) and
SpecInfer-style multi-token verification, specialized to the v2 engine's
paged-KV serving stack.  The decode hot path is one model dispatch per
emitted token; with a drafter proposing ``k`` tokens per pure-decode round
the engine instead runs ONE verify forward over ``k+1`` positions per row
and emits ``accepted + 1`` tokens:

* the VERIFY step feeds ``[last_sampled, draft_0 .. draft_{k-1}]`` through
  the same chunked forward that serves prefill (the KV for every fed
  position is written as a side effect) and returns the argmax at EVERY
  position — the model's own next-token choice after each fed prefix;
* the ACCEPT rule is host-side longest-prefix: draft token ``i`` is
  accepted iff it equals the argmax at position ``i``; the argmax at the
  last accepted position rides along as the bonus/correction token.
  Greedy outputs are therefore byte-identical to non-speculative decode
  *by construction* — every emitted token IS the model's argmax given the
  exact accepted history;
* ROLLBACK is host-side accounting: rejected drafts were fed as inputs
  only (never appended to the sequence's token history), so the engine
  clamps ``seen_tokens`` to the accepted boundary and releases
  wholly-surplus KV pages back to the arena
  (``StateManager.truncate`` / ``BlockedKVCache.release_tail``).  Stale KV
  entries inside the retained trailing page sit beyond the clamped seen
  boundary, are never attended (attention masks at ``start_pos``), and are
  overwritten by the next round's writes at those positions.

The default drafter is a deterministic n-gram / prompt-lookup scan over
the request's OWN token history (prompt + generated): no second model, no
device work.  Drafters are pluggable via
:data:`DRAFTERS` — a small draft model would slot in behind the same
``DraftProvider.draft`` contract.
"""

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Protocol, Sequence, Type

__all__ = ["SpecConfig", "SpecStats", "DraftProvider", "NGramDrafter",
           "DRAFTERS", "make_drafter"]


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Engine-level speculative-decoding configuration
    (``RaggedInferenceEngineConfig.spec``; None disables speculation).

    ``max_draft`` is the ``k`` of the verify program's ``(batch, k+1)``
    bucketing: every verify dispatch compiles at width ``k+1`` and shorter
    drafts ride as ragged rows (``chunk_lens``), so steady-state serving
    keeps ONE verify program per batch bucket."""
    max_draft: int = 4          # k: tokens drafted per pure-decode round
    drafter: str = "ngram"      # DRAFTERS registry key
    max_ngram: int = 3          # longest suffix n-gram tried first
    min_ngram: int = 1          # shortest suffix n-gram worth matching

    def __post_init__(self):
        if self.max_draft < 1:
            raise ValueError(f"spec.max_draft must be >= 1, got {self.max_draft}")
        if not (1 <= self.min_ngram <= self.max_ngram):
            raise ValueError(f"spec n-gram bounds need 1 <= min_ngram <= max_ngram, "
                             f"got [{self.min_ngram}, {self.max_ngram}]")


@dataclasses.dataclass
class SpecStats:
    """Engine-lifetime speculation counters (``engine.spec_stats``)."""
    rounds: int = 0             # verify dispatches run
    proposed: int = 0           # draft tokens fed to verify steps
    accepted: int = 0           # draft tokens accepted (bonus tokens excluded)
    emitted: int = 0            # tokens emitted by verify steps (accepted + bonus)
    rollback_pages: int = 0     # KV pages released by post-verify truncation

    @property
    def acceptance_rate(self):
        """Accepted / proposed over the engine's lifetime; None before the
        first draft."""
        return self.accepted / self.proposed if self.proposed else None


class DraftProvider(Protocol):
    """The drafter contract: propose up to ``max_tokens`` continuation
    tokens for a sequence whose full history (prompt + generated) is
    ``tokens``.  MUST be deterministic in ``tokens`` — the scheduler may
    re-draft the same history after a preemption/failover and greedy
    replay must converge to identical outputs.  Returning ``[]`` opts the
    row out of this round's speculation (it rides the verify dispatch as a
    plain 1-token decode row)."""

    def draft(self, tokens: Sequence[int], max_tokens: int) -> List[int]:
        ...


class _SeqNGramIndex:
    """Incremental n-gram → position index over ONE sequence's history.

    For every n in ``[min_n, max_n]`` it tracks the two most recent start
    positions of every n-gram (``last`` and ``prev``): the trailing suffix
    of the current history is always the single most recent occurrence of
    its own n-gram, so "most recent occurrence strictly before the
    suffix" — the prompt-lookup query — is exactly ``prev``.  Appending a
    token indexes the ``max_n - min_n + 1`` n-grams that END at the new
    position: O(max_ngram) per appended token, replacing the per-round
    right-to-left rescan of the whole history.

    The index pins a strong reference to the token list it mirrors, so
    CPython cannot recycle the list's identity while the entry is cached;
    a truncation below the indexed boundary or a tail-token mismatch
    (a different history behind a reused list) triggers a full rebuild."""

    __slots__ = ("tokens", "min_n", "max_n", "indexed", "tail", "last", "prev")

    def __init__(self, tokens: List[int], min_n: int, max_n: int):
        self.tokens = tokens
        self.min_n, self.max_n = min_n, max_n
        self.indexed = 0
        self.tail: Optional[int] = None   # tokens[indexed - 1] at index time
        self.last: Dict[tuple, int] = {}
        self.prev: Dict[tuple, int] = {}
        self.extend()

    def stale(self) -> bool:
        if len(self.tokens) < self.indexed:
            return True  # truncated below the indexed boundary
        return self.indexed > 0 and self.tokens[self.indexed - 1] != self.tail

    def extend(self) -> None:
        toks, last, prev = self.tokens, self.last, self.prev
        lo, hi = self.indexed, len(toks)
        for end in range(lo + 1, hi + 1):
            for n in range(self.min_n, min(self.max_n, end) + 1):
                i = end - n
                key = tuple(toks[i:end])
                old = last.get(key)
                if old is not None and old != i:
                    prev[key] = old
                last[key] = i
        self.indexed = hi
        self.tail = toks[hi - 1] if hi else None

    def lookup(self, n: int) -> Optional[int]:
        """Start position of the most recent occurrence of the trailing
        ``n``-gram STRICTLY before the trailing suffix itself, or None."""
        L = len(self.tokens)
        key = tuple(self.tokens[L - n:])
        cand = self.last.get(key)
        if cand is None:
            return None
        if cand != L - n:
            # the suffix's own occurrence is always the most recent; a
            # smaller ``last`` can only mean a rebuild raced a mutation —
            # it is still a valid strictly-earlier occurrence
            return cand
        return self.prev.get(key)


class NGramDrafter:
    """Deterministic prompt-lookup drafting: find the most recent earlier
    occurrence of the history's trailing n-gram (longest n first) and
    propose the tokens that followed it.

    Rationale: serving traffic — and small greedy models — repeat
    themselves (copied spans, looping continuations, templated output);
    the sequence's own history is a free draft model with zero device
    cost.  Matching runs on a per-sequence INCREMENTAL
    :class:`_SeqNGramIndex` keyed by the token list's identity (the
    engine mutates one list per live sequence in place): each call
    indexes only the tokens appended since the last call — O(max_ngram)
    per appended token — then answers every n-gram probe with two dict
    lookups, so drafting cost no longer grows with history length.
    Proposals are IDENTICAL to the r12 right-to-left rescan (the
    regression tests in tests/unit/inference/test_spec_index.py replay
    both); ``_scan_draft`` keeps the reference scan for non-list
    histories and those tests."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1,
                 max_cached_seqs: int = 256):
        if not (1 <= min_ngram <= max_ngram):
            raise ValueError(f"need 1 <= min_ngram <= max_ngram, "
                             f"got [{min_ngram}, {max_ngram}]")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        # id(list) -> _SeqNGramIndex, LRU-bounded: entries hold a strong
        # ref to their list (identity safety), so dead sequences' indexes
        # must age out rather than accumulate for the engine's lifetime
        self.max_cached_seqs = max_cached_seqs
        self._indexes: "OrderedDict[int, _SeqNGramIndex]" = OrderedDict()

    def _index_for(self, tokens: List[int]) -> _SeqNGramIndex:
        key = id(tokens)
        idx = self._indexes.get(key)
        if idx is not None and idx.tokens is tokens and not idx.stale():
            idx.extend()
            self._indexes.move_to_end(key)
            return idx
        idx = _SeqNGramIndex(tokens, self.min_ngram, self.max_ngram)
        self._indexes[key] = idx
        self._indexes.move_to_end(key)
        while len(self._indexes) > self.max_cached_seqs:
            self._indexes.popitem(last=False)
        return idx

    def draft(self, tokens: Sequence[int], max_tokens: int) -> List[int]:
        L = len(tokens)
        if max_tokens <= 0 or L < self.min_ngram + 1:
            return []
        if not isinstance(tokens, list):
            # identity-keyed indexing needs the engine's stable mutable
            # list; an immutable/ad-hoc history gets the reference scan
            return self._scan_draft(list(tokens), max_tokens)
        idx = self._index_for(tokens)
        for n in range(min(self.max_ngram, L - 1), self.min_ngram - 1, -1):
            i = idx.lookup(n)
            if i is not None:
                return [int(t) for t in tokens[i + n:i + n + max_tokens]]
        return []

    def _scan_draft(self, toks: List[int], max_tokens: int) -> List[int]:
        """The r12 reference implementation: right-to-left rescan guarded
        on the first suffix token.  O(max_ngram * len(tokens)) per call —
        kept as the non-list fallback and the equivalence oracle for the
        index regression tests."""
        L = len(toks)
        for n in range(min(self.max_ngram, L - 1), self.min_ngram - 1, -1):
            suffix = toks[L - n:]
            first = suffix[0]
            # most recent occurrence strictly before the suffix itself, so
            # the continuation exists and the match can't be the suffix
            for i in range(L - n - 1, -1, -1):
                if toks[i] == first and toks[i:i + n] == suffix:
                    return [int(t) for t in toks[i + n:i + n + max_tokens]]
        return []


#: pluggable drafter registry (SpecConfig.drafter selects by key)
DRAFTERS: Dict[str, Type] = {"ngram": NGramDrafter}


def make_drafter(config: SpecConfig) -> DraftProvider:
    cls = DRAFTERS.get(config.drafter)
    if cls is None:
        raise ValueError(f"unknown drafter '{config.drafter}'; "
                         f"registered: {sorted(DRAFTERS)}")
    return cls(max_ngram=config.max_ngram, min_ngram=config.min_ngram)
