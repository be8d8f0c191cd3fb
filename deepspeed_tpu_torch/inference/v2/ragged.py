"""Ragged-batching state: blocked KV allocator, sequence descriptors,
batch packing.  The port's own copy of ``deepspeed_tpu/inference/v2/ragged.py``
(plain Python and numpy; the port imports nothing of the JAX package).

Reference: ``deepspeed/inference/v2/ragged/`` —
  BlockedAllocator   (blocked_allocator.py)  → :class:`BlockedAllocator`
  BlockedKVCache     (kv_cache.py:40)        → :class:`BlockedKVCache`
  DSSequenceDescriptor (sequence_descriptor.py) → :class:`SequenceDescriptor`
  RaggedBatchWrapper (ragged_wrapper.py:31)  → :class:`RaggedBatch`
  DSStateManager     (ragged_manager.py:19)  → :class:`StateManager`

The per-step metadata are small numpy arrays that the engine copies to the
device once per dispatch.
"""

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class BlockedAllocator:
    """Refcounted free-list allocator over KV pages (ref:
    blocked_allocator.py).  Page 0 is reserved as the null page that unused
    block-table slots reference.  Refcounts exist for prefix caching: a full
    page can be referenced by several sequences plus the
    :class:`PrefixCacheManager`; it returns to the free list only when the
    last reference drops."""

    def __init__(self, num_pages: int):
        assert num_pages >= 2
        self.num_pages = num_pages
        self._free: List[int] = list(range(1, num_pages))
        self._rc = np.zeros(num_pages, np.int32)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def allocate(self, n: int) -> List[int]:
        if n > len(self._free):
            raise RuntimeError(f"KV cache exhausted: need {n} pages, have {len(self._free)}")
        pages, self._free = self._free[:n], self._free[n:]
        self._rc[pages] = 1
        return pages

    def retain(self, pages: Sequence[int]) -> None:
        for p in pages:
            assert self._rc[p] > 0, f"retain of unallocated page {p}"
            self._rc[p] += 1

    def refcount(self, page: int) -> int:
        return int(self._rc[page])

    def free(self, pages: Sequence[int]) -> None:
        for p in pages:
            assert 0 < p < self.num_pages and self._rc[p] > 0
            self._rc[p] -= 1
            if self._rc[p] == 0:
                self._free.append(p)


#: seed of the prefix chain hash — shared by :class:`PrefixCacheManager`
#: and the fleet's router-resident prefix directory
#: (serving/fleet/prefix_directory.py), which must compute IDENTICAL
#: digests from tokens alone to know which replica holds which pages
PREFIX_CHAIN_SEED = 0x9E3779B9


def iter_prefix_chain_hashes(tokens: Sequence[int], page_size: int):
    """Lazily yield the chain hash of each FULL page of ``tokens``:
    ``h_k = hash(h_{k-1}, tokens[k*P:(k+1)*P])`` from
    :data:`PREFIX_CHAIN_SEED`, so a match on ``h_k`` transitively pins
    every earlier token.  This is THE digest rule the prefix cache keys
    pages by and the fleet prefix directory routes on — one rule, two
    consumers, no way to drift.  A generator so hot-path walkers that
    stop at the first miss stop HASHING there too.  Deterministic across
    processes for integer tokens (int/tuple hashing is not salted)."""
    h = PREFIX_CHAIN_SEED
    for i in range(len(tokens) // page_size):
        h = hash((h, tuple(tokens[i * page_size:(i + 1) * page_size])))
        yield h


def prefix_chain_hashes(tokens: Sequence[int], page_size: int) -> List[int]:
    """Materialized form of :func:`iter_prefix_chain_hashes`."""
    return list(iter_prefix_chain_hashes(tokens, page_size))


@dataclasses.dataclass
class SequenceDescriptor:
    """Host-side state of one generation (ref: DSSequenceDescriptor)."""
    uid: int
    tokens: List[int]                      # full token history (prompt + generated)
    pages: List[int] = dataclasses.field(default_factory=list)
    seen_tokens: int = 0                   # tokens whose KV is in cache
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # migration pause (serving/kvtransfer): a paused sequence keeps its
    # state and KV pages but is excluded from step planning, so its pages
    # stay byte-stable while chunks of them are staged device->host between
    # the engine's ongoing decode steps
    paused: bool = False
    # prefix-cache cursor: pages [0, pc_pages) are already published (or came
    # from the cache); pc_hash is the running chain hash at that boundary, so
    # each register() call hashes only NEW full pages (O(1) amortized per
    # token instead of rehashing the whole history every step)
    pc_pages: int = 0
    pc_hash: int = 0

    @property
    def remaining_prefill(self) -> int:
        return len(self.tokens) - self.seen_tokens

    @property
    def in_prefill(self) -> bool:
        return self.remaining_prefill > 0

    @property
    def in_decode(self) -> bool:
        """Generating: the single unseen token is a sampled one (its KV write
        + next-token logits are one C=1 step)."""
        return bool(self.generated) and self.remaining_prefill <= 1


class PrefixCacheManager:
    """KV-page reuse across sequences sharing a token prefix
    (ref: inference/v2/ragged/prefix_cache_manager.py:13).

    Full, token-aligned pages are content-addressed by a *chain hash* over
    the whole token history they terminate — page k of a sequence is keyed
    by H_k = hash(H_{k-1}, tokens[k·P:(k+1)·P]) — so a hit on H_k
    transitively guarantees every earlier token matches too.  Matched pages
    are attached to the new sequence read-only (full pages are immutable:
    KV writes only ever land in the trailing partial page) and the prefill
    skips straight past them.  The cache holds one refcount on every
    registered page, so pages survive their creator's release and are
    evicted LRU only under allocator pressure."""

    _SEED = PREFIX_CHAIN_SEED

    def __init__(self, allocator: "BlockedAllocator", page_size: int):
        self.allocator = allocator
        self.page_size = page_size
        #: optional publish/evict notification sink: ``listener(event,
        #: chain_hash)`` with event ``"publish"`` (a full page entered the
        #: cache — register() or adopt()) or ``"evict"`` (it left).  The
        #: fleet ReplicaPool wires this to the router-resident
        #: PrefixDirectory so routing warmth is pushed, not probed; None
        #: (the default) costs one ``is None`` test per transition.
        self.listener = None
        #: optional eviction demoter: ``demoter(chain_hash, page_id,
        #: tokens, parent_hash)`` called by :meth:`evict` BEFORE the page
        #: is freed (while its KV bytes are still valid to gather) — the
        #: serving kvtier stages the page host-side so the chain stays
        #: warm-on-host instead of going cold.  Must not allocate or free
        #: device pages; None (the default) keeps eviction unchanged.
        self.demoter = None
        # chain hash → (page id, page's token tuple, parent chain hash).
        # The tokens are kept for verification on match: a 64-bit hash
        # collision would otherwise silently attach another prompt's KV
        # pages (wrong output + cross-request prompt leakage); verifying
        # costs O(page_size) per hit.  The parent hash maintains per-entry
        # child counts so eviction only ever removes LEAVES.
        self._pages: Dict[int, Tuple[int, tuple, Optional[int]]] = {}
        # chain hash → set of live CHILD hashes.  Edges are recorded even
        # when the parent entry is currently absent (evicted): if the parent
        # is later re-registered while the child still lives, the edge must
        # already exist or leaf-only eviction would free the parent and
        # strand the child (a count-based scheme can't survive that order)
        self._children: Dict[int, set] = {}
        self._lru: "OrderedDict[int, None]" = OrderedDict()  # chain hash, oldest first
        self.hits = 0
        self.misses = 0

    def _chain(self, tokens: Sequence[int]):
        """Yield (chain_hash, page_index) for each FULL page of ``tokens``
        (delegates to :func:`iter_prefix_chain_hashes` — the one digest
        rule the fleet prefix directory shares; lazy, so a walker that
        stops at the first miss stops hashing there too)."""
        for i, h in enumerate(iter_prefix_chain_hashes(tokens, self.page_size)):
            yield h, i

    def _notify(self, event: str, h: int) -> None:
        if self.listener is not None:
            self.listener(event, h)

    def _walk(self, tokens: Sequence[int]):
        """Yield ``(chain_hash, page_id)`` for the longest run of cached
        full pages covering a prefix of ``tokens`` — the ONE matching rule
        (chain walk, token verification, last-token cap) shared by the
        mutating :meth:`match` and the read-only :meth:`lookup_depth`, so
        routing warmth can never desynchronize from what a subsequent
        match() actually attaches.  Caps at len(tokens)-1: the engine must
        still compute at least one prompt token (its logits seed
        generation)."""
        usable = len(tokens) - 1
        for h, i in self._chain(tokens):
            if (i + 1) * self.page_size > usable:
                return
            entry = self._pages.get(h)
            if entry is None or entry[1] != tuple(tokens[i * self.page_size:(i + 1) * self.page_size]):
                return
            yield h, entry[0]

    def match(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest run of cached pages covering a prefix of ``tokens``,
        plus the chain hash at the match boundary (the caller seeds the
        sequence's register() cursor with it).  Returned pages are retained
        on behalf of the caller."""
        matched: List[int] = []
        h_end = self._SEED
        for h, page in self._walk(tokens):
            matched.append(page)
            h_end = h
            self._lru.move_to_end(h)  # whole chain refreshed root→leaf
        if matched:
            self.allocator.retain(matched)
            self.hits += 1
        elif len(tokens) > self.page_size:
            self.misses += 1
        return matched, h_end

    def lookup_depth(self, tokens: Sequence[int]) -> int:
        """How many leading FULL pages of ``tokens`` this cache holds —
        WITHOUT retaining pages, touching the LRU, or counting a hit/miss.
        The fleet router's prefix-affinity policy probes every replica's
        cache with this to find the warmest one; a mutating probe would
        retain pages on replicas that never receive the request (leaking
        refcounts) and refresh their LRU for traffic they never served.
        Shares :meth:`match`'s traversal (``_walk``), so the reported
        warmth is exactly what a subsequent match() would attach."""
        return sum(1 for _ in self._walk(tokens))

    def register(self, seq: "SequenceDescriptor") -> None:
        """Publish ``seq``'s newly-completed full pages, resuming from the
        sequence's cursor so each page is hashed exactly once.  A hash
        already mapped to a different page keeps the existing mapping
        (dedup would require copying KV — not worth it)."""
        full = min(seq.seen_tokens // self.page_size, len(seq.pages))
        h = seq.pc_hash if seq.pc_pages else self._SEED
        for i in range(seq.pc_pages, full):
            parent = h if i else None
            page_toks = tuple(seq.tokens[i * self.page_size:(i + 1) * self.page_size])
            h = hash((h, page_toks))
            if h not in self._pages:
                self._pages[h] = (seq.pages[i], page_toks, parent)
                if parent is not None:
                    self._children.setdefault(parent, set()).add(h)
                self._lru[h] = None
                self.allocator.retain([seq.pages[i]])
                self._notify("publish", h)
        seq.pc_pages = full
        seq.pc_hash = h if full else seq.pc_hash

    def evict(self, n: int) -> int:
        """Drop up to ``n`` cache-only pages: LRU order, but LEAVES only.

        Freeing a chain's root would make every descendant unmatchable
        (match() walks from page 0) while their pages stay pinned — and a
        plain reversed-LRU walk would be global MRU eviction, thrashing the
        hottest chain first.  Entries with live children are skipped, so a
        cold chain dies leaf-by-leaf from the oldest while a hot chain's
        recently-touched entries survive.  Each freed leaf may expose its
        parent, so the sweep repeats until the quota is met or nothing is
        evictable.  Returns how many pages were freed."""
        freed = 0
        for h in list(self._lru):
            if freed >= n:
                break
            # cascade: freeing a leaf exposes its parent — keep consuming
            # THIS (older) chain before the sweep reaches hotter entries
            while h is not None and freed < n and h in self._pages:
                if self._children.get(h):
                    break  # has live descendants: they would be stranded
                page, toks, parent = self._pages[h]
                if self.allocator.refcount(page) != 1:
                    break  # a live sequence still shares this page
                if self.demoter is not None:
                    # stage the page host-side BEFORE freeing (kvtier)
                    self.demoter(h, page, toks, parent)
                self.allocator.free([page])
                del self._pages[h]
                del self._lru[h]
                self._children.pop(h, None)
                if parent is not None and parent in self._children:
                    self._children[parent].discard(h)
                    if not self._children[parent]:
                        del self._children[parent]
                freed += 1
                self._notify("evict", h)
                h = parent
        return freed

    def held_depth(self, tokens: Sequence[int]) -> int:
        """Leading FULL pages of ``tokens`` this cache holds, WITHOUT the
        last-token usable cap :meth:`lookup_depth` applies — cache-
        population accounting (what a prefix import may skip), not a match
        preview (what a prefill can reuse)."""
        depth = 0
        for h, i in self._chain(tokens):
            entry = self._pages.get(h)
            if entry is None or entry[1] != tuple(
                    tokens[i * self.page_size:(i + 1) * self.page_size]):
                break
            depth += 1
        return depth

    def adopt(self, tokens: Sequence[int], start_page: int,
              page_ids: Sequence[int]) -> None:
        """Insert externally-imported full pages ``start_page ..
        start_page+len(page_ids)-1`` of ``tokens`` (the fleet's hot-prefix
        KV import: the page CONTENT was scattered into the arena by the
        caller; this publishes the chain entries so the next ``match()``
        attaches them).  The caller transfers exactly ONE refcount per page
        to the cache — the allocation it made for the import — matching
        register()'s invariant that the cache holds one reference per
        entry.  A hash already present keeps its existing page and the
        duplicate id is freed (same dedup stance as register)."""
        chain = prefix_chain_hashes(tokens, self.page_size)
        assert start_page + len(page_ids) <= len(chain), \
            (start_page, len(page_ids), len(chain))
        for j, page in enumerate(page_ids):
            i = start_page + j
            h = chain[i]
            if h in self._pages:
                # raced with a local prefill publishing the same page:
                # keep the incumbent, return the duplicate's refcount
                self.allocator.free([page])
                continue
            parent = chain[i - 1] if i else None
            page_toks = tuple(tokens[i * self.page_size:(i + 1) * self.page_size])
            self._pages[h] = (page, page_toks, parent)
            if parent is not None:
                self._children.setdefault(parent, set()).add(h)
            self._lru[h] = None
            self._notify("publish", h)

    def held_digests(self) -> List[int]:
        """Chain hashes of every resident full page, in insertion order —
        the fleet directory's RESYNC snapshot (docs/SERVING.md
        "Control-plane transport"): when the router detects a gap in this
        replica's sequence-numbered publish stream, it pulls exactly this
        set and rebuilds its view instead of guessing."""
        return list(self._pages)

    def chain_tokens(self, h: int) -> Optional[List[int]]:
        """Reconstruct the full token prefix whose last page is chain
        entry ``h`` by walking parent links root-ward — the
        directory-driven warm-up input (the directory stores digests only;
        the DONOR's cache owns the tokens).  None when the chain is absent
        or broken (a concurrent eviction): warm-up just skips it."""
        parts = []
        while h is not None:
            entry = self._pages.get(h)
            if entry is None:
                return None
            _pid, toks, parent = entry
            parts.append(toks)
            h = parent
        return [t for part in reversed(parts) for t in part]

    @property
    def cached_pages(self) -> int:
        return len(self._pages)


class BlockedKVCache:
    """Geometry + allocator pairing (ref: kv_cache.py:40).  The device
    arena itself lives in the engine (one tensor per layer, updated in
    place)."""

    def __init__(self, num_pages: int, page_size: int, max_pages_per_seq: int,
                 enable_prefix_cache: bool = True):
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_pages_per_seq = max_pages_per_seq
        self.allocator = BlockedAllocator(num_pages)
        self.prefix_cache = (PrefixCacheManager(self.allocator, page_size)
                             if enable_prefix_cache else None)

    def pages_needed(self, seq: SequenceDescriptor, new_tokens: int) -> int:
        total = len(seq.tokens) if new_tokens == 0 else seq.seen_tokens + new_tokens
        needed = -(-total // self.page_size)  # ceil
        return max(0, needed - len(seq.pages))

    def ensure_capacity(self, seq: SequenceDescriptor, new_tokens: int) -> None:
        n = self.pages_needed(seq, new_tokens)
        if n:
            if len(seq.pages) + n > self.max_pages_per_seq:
                raise RuntimeError(f"sequence {seq.uid} exceeds max_pages_per_seq={self.max_pages_per_seq}")
            if self.prefix_cache is not None and n > self.allocator.free_pages:
                self.prefix_cache.evict(n - self.allocator.free_pages)
            seq.pages.extend(self.allocator.allocate(n))

    def release(self, seq: SequenceDescriptor) -> None:
        self.allocator.free(seq.pages)
        seq.pages = []

    def export_pages(self, arena, pages: Sequence[int]) -> np.ndarray:
        """Stage KV pages device→host — not ported yet.  The JAX version
        materialises ``np.asarray(arena)`` and checks dtypes by their JAX
        names, which is wrong for a list of CUDA tensors with torch dtypes;
        it moves with the serving stack (ROADMAP.md Queue 1, "Serving stack
        above the engine")."""
        raise NotImplementedError("export_pages is not ported yet: see ROADMAP.md Queue 1, "
                                  "serving stack above the engine (KV page staging)")

    def import_pages(self, arena, pages: Sequence[int], block: np.ndarray):
        """Scatter host-staged KV pages back — not ported yet, see
        :meth:`export_pages`."""
        raise NotImplementedError("import_pages is not ported yet: see ROADMAP.md Queue 1, "
                                  "serving stack above the engine (KV page staging)")

    def arena_stats(self) -> dict:
        """Point-in-time arena occupancy for the ``kv/*`` telemetry
        gauges (docs/OBSERVABILITY.md "Step anatomy"):

          usable                 — allocatable pages (the reserved null
                                   page 0 excluded)
          in_use / free          — pages held by sequences and/or the
                                   prefix cache vs on the free list
          occupancy              — in_use / usable
          free_run_fragmentation — 1 - (longest contiguous free page-id
                                   run / free pages).  Pages are fully
                                   indirected through block tables, so
                                   this measures allocation churn (how
                                   interleaved live pages are), the
                                   input a future multi-page block
                                   allocator would care about; 0.0 when
                                   the free ids form one run (or nothing
                                   is free).
          prefix_cache_pages     — pages pinned by prefix-cache entries
          prefix_cache_share     — prefix_cache_pages / in_use (0 when
                                   the arena is empty)
        O(free log free) for the sorted run scan — a once-per-fleet-round
        export, not a hot-path read."""
        usable = self.num_pages - 1
        free = self.allocator.free_pages
        in_use = usable - free
        frag = 0.0
        if free > 1:
            ids = sorted(self.allocator._free)
            longest = run = 1
            for prev, cur in zip(ids, ids[1:]):
                run = run + 1 if cur == prev + 1 else 1
                if run > longest:
                    longest = run
            frag = 1.0 - longest / free
        pc_pages = self.prefix_cache.cached_pages \
            if self.prefix_cache is not None else 0
        return {
            "usable": usable,
            "in_use": in_use,
            "free": free,
            "occupancy": round(in_use / usable, 6) if usable else 0.0,
            "free_run_fragmentation": round(frag, 6),
            "prefix_cache_pages": pc_pages,
            "prefix_cache_share": round(pc_pages / in_use, 6) if in_use else 0.0,
        }

    def release_tail(self, seq: SequenceDescriptor, keep_pages: int) -> int:
        """Return ``seq``'s pages past the first ``keep_pages`` to the
        allocator (speculative-decode rollback; EOS/limit mid-rung surplus).
        The freed capacity is visible to ``allocator.free_pages`` — and so
        to ``single_step_page_demand`` preflights — the same step.

        Pages the sequence already published to the prefix cache are never
        released here, whatever ``keep_pages`` says: ``register()``'s
        cursor (``pc_pages``) indexes into ``seq.pages``, so dropping a
        published page would shift every later index under the cursor.
        Callers only roll back past the seen/accepted boundary and the
        cache only holds FULL pages below it, so the clamp is a guard, not
        a policy.  Returns how many pages were freed."""
        keep = max(int(keep_pages), seq.pc_pages)
        tail = seq.pages[keep:]
        if tail:
            self.allocator.free(tail)
            del seq.pages[keep:]
        return len(tail)


@dataclasses.dataclass
class RaggedBatch:
    """One step's packed device inputs (ref: RaggedBatchWrapper) — padded
    to the engine's batch and chunk buckets."""
    tokens: np.ndarray        # [B, C] int32 (padded)
    start_pos: np.ndarray     # [B] int32 — context length before this chunk
    block_tables: np.ndarray  # [B, max_pages] int32 (null page 0 padded)
    chunk_lens: np.ndarray    # [B] int32 — real tokens this step (0 = padding row)
    uids: List[int]           # row → uid (len B; padding rows map to -1)

    @property
    def batch(self) -> int:
        return self.tokens.shape[0]


class StateManager:
    """uid → descriptor bookkeeping + batch packing (ref: DSStateManager)."""

    def __init__(self, kv: BlockedKVCache, max_batch: int = 64):
        self.kv = kv
        self.max_batch = max_batch
        self.seqs: Dict[int, SequenceDescriptor] = {}

    def get_or_create(self, uid: int, tokens: Optional[Sequence[int]] = None) -> SequenceDescriptor:
        if uid not in self.seqs:
            seq = SequenceDescriptor(uid=uid, tokens=list(tokens or []))
            pc = self.kv.prefix_cache
            if pc is not None and seq.tokens:
                # reuse cached KV pages for the shared prompt prefix: the
                # matched run is attached read-only and prefill starts after it
                seq.pages, seq.pc_hash = pc.match(seq.tokens)
                seq.pc_pages = len(seq.pages)
                seq.seen_tokens = len(seq.pages) * self.kv.page_size
            self.seqs[uid] = seq
        elif tokens:
            self.seqs[uid].tokens.extend(tokens)
        return self.seqs[uid]

    def note_progress(self, seq: SequenceDescriptor) -> None:
        """Called after ``seen_tokens`` advances: publish newly-completed
        full pages to the prefix cache."""
        if self.kv.prefix_cache is not None:
            self.kv.prefix_cache.register(seq)

    def truncate(self, seq: SequenceDescriptor, n_tokens: int) -> int:
        """Drop KV state past the first ``n_tokens`` of ``seq``'s history:
        clamp ``seen_tokens`` and release wholly-surplus tail pages
        (:meth:`BlockedKVCache.release_tail`).  The paged-KV rollback
        primitive behind speculative decoding (rejected drafts' pages) and
        the fused-decode EOS/limit surplus fix — KV entries beyond the
        clamped boundary inside the retained trailing page are never
        attended (the kernels mask at ``start_pos``) and are overwritten
        by the next step's writes at those positions.  Returns pages
        freed."""
        seq.seen_tokens = min(seq.seen_tokens, int(n_tokens))
        keep = -(-int(n_tokens) // self.kv.page_size)   # ceil
        return self.kv.release_tail(seq, keep)

    def flush(self, uid: int) -> None:
        """Release a sequence's KV + state (ref: engine_v2.py flush)."""
        seq = self.seqs.pop(uid, None)
        if seq is not None:
            self.kv.release(seq)

    def preempt(self, uid: int) -> SequenceDescriptor:
        """KV-pressure eviction: release ``uid``'s pages and drop its state,
        returning the descriptor so the serving frontend can requeue the
        request with its generated tokens preserved.  Full pages the
        sequence published to the prefix cache keep the cache's refcount and
        survive — a resume-prefill of the same token history reattaches them
        via ``match()`` instead of recomputing their KV."""
        seq = self.seqs.pop(uid)
        self.kv.release(seq)
        return seq

    def pack(self, work: List[Tuple[SequenceDescriptor, int]], chunk: int,
             pad_to: Optional[int] = None) -> RaggedBatch:
        """Pack (seq, n_tokens) work items into fixed [B, chunk] buffers.

        B is padded to ``pad_to`` (default ``max_batch``) so steps keep a few
        bucketed shapes across scheduler decisions — padding rows have uid
        -1, chunk_len 0, and an all-null block table."""
        b = pad_to if pad_to is not None else self.max_batch
        assert len(work) <= b, f"{len(work)} work items exceed batch capacity {b}"
        tokens = np.zeros((b, chunk), np.int32)
        start_pos = np.zeros((b, ), np.int32)
        block_tables = np.zeros((b, self.kv.max_pages_per_seq), np.int32)
        chunk_lens = np.zeros((b, ), np.int32)
        uids = [-1] * b
        for i, (seq, n) in enumerate(work):
            self.kv.ensure_capacity(seq, n)
            sl = seq.tokens[seq.seen_tokens:seq.seen_tokens + n]
            tokens[i, :len(sl)] = sl
            start_pos[i] = seq.seen_tokens
            block_tables[i, :len(seq.pages)] = seq.pages
            chunk_lens[i] = n
            uids[i] = seq.uid
        return RaggedBatch(tokens=tokens, start_pos=start_pos, block_tables=block_tables,
                           chunk_lens=chunk_lens, uids=uids)
